"""repro_torch's training slice against the JAX package on seeded numpy
inputs: the data pipeline, the schedules, int8 compression, AdamW on
identical inputs, the two cross entropies with their gradients, and
``make_train_step`` at ``reduced()`` with fp32 compute and fp32 parameters
(qwen3-moe's bf16 parameters would round each update to bf16 in both
packages, where a near tie rounds either way) on the JAX package's weights
carried across by ``models.module.from_numpy``.  Torch runs on one
intra-op thread.  Parameters after an AdamW step are not compared
elementwise: a gradient element near zero may change sign between the
packages and move its parameter by 2·lr, so the optimizer is held on
identical inputs instead."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.data import pipeline as pipe
from repro_torch.models import build_model, module
from repro_torch.optim import adamw, compression as comp, schedules
from repro_torch.train import step as tstep

B, S = 2, 12          # S not a multiple of the CE chunk (8)
STEP_REL = 1e-4       # the step's metrics, losses and grads
PARITY_ARCHS = ("gemma3-1b", "yi-9b", "qwen3-moe-235b-a22b",
                "internvl2-26b", "xlstm-1.3b", "whisper-medium",
                "nemotron-4-15b", "deepseek-67b")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [(path, tree)]


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("frontend", ["none", "patch", "frame"])
def test_batch_at_equals_the_reference(frontend):
    cfg = pipe.DataConfig(vocab_size=300, seq_len=16, global_batch=3, seed=5)
    jcfg = jpipe.DataConfig(vocab_size=300, seq_len=16, global_batch=3,
                            seed=5)
    kw = {"frontend": frontend, "n_frontend_tokens": 4, "d_model": 24}
    for step in (0, 7):
        got = pipe.batch_at(cfg, step, device="cpu", **kw)
        want = jpipe.batch_at(jcfg, step, **kw)
        assert sorted(got) == sorted(want)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
        for key in ("patches", "frames"):
            if key in want:
                assert got[key].dtype == torch.bfloat16
                assert np.array_equal(
                    got[key].float().numpy(),
                    np.asarray(want[key].astype(jnp.float32)))


def test_pipeline_state_and_cursor():
    cfg = pipe.DataConfig(vocab_size=50, seq_len=8, global_batch=2)
    p = pipe.Pipeline(cfg, device="cpu")
    first, second = p.next_batch(), p.next_batch()
    assert p.state.to_dict() == {"step": 2}
    again = pipe.Pipeline(cfg, pipe.DataState.from_dict({"step": 1}),
                          device="cpu")
    assert torch.equal(again.next_batch()["tokens"], second["tokens"])
    assert not torch.equal(first["tokens"], second["tokens"])


# --------------------------------------------------------------------------
# optimizer pieces
# --------------------------------------------------------------------------

def test_schedules_equal_the_reference():
    steps = np.arange(0, 61, dtype=np.int32)
    for got_fn, want_fn in (
            (schedules.warmup_cosine(3e-4, 5, 50),
             jsched.warmup_cosine(3e-4, 5, 50)),
            (schedules.warmup_cosine(1e-2, 0, 20, end_frac=0.2),
             jsched.warmup_cosine(1e-2, 0, 20, end_frac=0.2)),
            (schedules.constant(2e-3), jsched.constant(2e-3))):
        for s in steps:
            got = got_fn(torch.tensor(s, dtype=torch.int32))
            want = want_fn(jnp.asarray(s, jnp.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                       atol=0)


def test_quantize_and_compress_equal_the_reference():
    rng = np.random.RandomState(3)
    x = (rng.randn(64, 33) * 0.02).astype(np.float32)
    x[0, :4] = [0.0, -0.5, 0.5, 1e-9]
    q, s = comp.quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.item(), float(js), rtol=1e-7)
    np.testing.assert_allclose(comp.dequantize(q, s).numpy(),
                               np.asarray(jcomp.dequantize(jq, js)),
                               rtol=0, atol=1e-7)
    grads = {"a": (rng.randn(16, 8) * 0.1).astype(np.float32),
             "b": {"c": (rng.randn(5) * 3).astype(np.float32)}}
    res = {"a": (rng.randn(16, 8) * 1e-3).astype(np.float32),
           "b": {"c": (rng.randn(5) * 1e-2).astype(np.float32)}}
    to_t = lambda t: module.tree_map(torch.from_numpy, t)
    deq, state = comp.compress_grads(to_t(grads),
                                     comp.CompressionState(to_t(res)))
    jdeq, jstate = jcomp.compress_grads(
        jax.tree.map(jnp.asarray, grads),
        jcomp.CompressionState(jax.tree.map(jnp.asarray, res)))
    assert isinstance(state, comp.CompressionState)
    for (path, got), (_, want) in zip(_flat(deq), _flat(jdeq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7, err_msg=str(path))
    for (path, got), (_, want) in zip(_flat(state.residual),
                                      _flat(jstate.residual)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7, err_msg=str(path))
    zero = comp.init(to_t(grads))
    assert all(float(t.abs().sum()) == 0 and t.dtype == torch.float32
               for _, t in _flat(zero.residual))


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_on_identical_inputs(clip):
    """Three updates, each from the same params, moments, step and grads in
    both packages (the reference's outputs carried to the next): params,
    moments, step and global norm within 1e-6 relative; the grads given to
    the port left as they were."""
    rng = np.random.RandomState(11)
    shapes = {"w": (12, 7), "n": {"scale": (7,)}, "e": (30, 4)}
    leaf = lambda shp: rng.randn(*shp).astype(np.float32)
    params = jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))
    kw = {"learning_rate": jsched.warmup_cosine(1e-2, 2, 10),
          "clip_norm": clip}
    jopt = jadamw.AdamW(**kw)
    opt = adamw.AdamW(**{**kw, "learning_rate":
                         schedules.warmup_cosine(1e-2, 2, 10)})
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    to_t = lambda t: module.tree_map(lambda a: torch.from_numpy(
        np.array(a)), t)
    for i in range(3):
        scale = 5.0 if i == 0 else 0.05      # the first update clips
        grads = jax.tree.map(lambda s: leaf(s) * scale, shapes,
                             is_leaf=lambda s: isinstance(s, tuple))
        tg = to_t(grads)
        kept = module.tree_map(torch.clone, tg)
        state = adamw.AdamWState(step=torch.tensor(np.array(jstate.step)),
                                 mu=to_t(jstate.mu), nu=to_t(jstate.nu))
        new_p, new_s, gnorm = opt.update(tg, state, to_t(jparams))
        jparams, jstate, jnorm = jopt.update(
            jax.tree.map(jnp.asarray, grads), jstate, jparams)
        np.testing.assert_allclose(gnorm.item(), float(jnorm), rtol=1e-6)
        np.testing.assert_allclose(
            adamw.global_norm(tg).item(),
            float(jadamw.global_norm(jax.tree.map(jnp.asarray, grads))),
            rtol=1e-6)
        assert int(new_s.step) == int(jstate.step) == i + 1
        for got_tree, want_tree in ((new_p, jparams), (new_s.mu, jstate.mu),
                                    (new_s.nu, jstate.nu)):
            for (path, got), (_, want) in zip(_flat(got_tree),
                                              _flat(want_tree)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-12,
                                           err_msg=f"step {i} {path}")
        for (_, a), (_, b) in zip(_flat(tg), _flat(kept)):
            assert torch.equal(a, b)


def test_adamw_updates_in_place():
    p = {"w": torch.ones(3)}
    opt = adamw.AdamW(learning_rate=0.1)
    state = opt.init(p)
    w, mu = p["w"], state.mu["w"]
    new_p, new_s, _ = opt.update({"w": torch.full((3,), 0.5)}, state, p)
    assert new_p["w"] is w and new_s.mu["w"] is mu
    assert float(w[0]) < 1.0 and float(mu[0]) > 0.0
    assert int(state.step) == 0 and int(new_s.step) == 1


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _ce_inputs(seed=4, b=2, s=13, d=6, v=40):
    rng = np.random.RandomState(seed)
    hidden = rng.randn(b, s, d).astype(np.float32)
    table = (rng.randn(v, d) * 0.3).astype(np.float32)
    labels = rng.randint(0, v, (b, s)).astype(np.int32)
    labels[0, :3] = jstep.IGNORE_LABEL
    labels[1, -2:] = jstep.IGNORE_LABEL
    return hidden, table, labels


@pytest.mark.parametrize("chunk", [4, 5, 13, 16])
def test_chunked_cross_entropy_and_grads(chunk):
    hidden, table, labels = _ce_inputs()

    def jloss(h, t):
        loss, ce = jstep.chunked_cross_entropy(h, t, jnp.asarray(labels),
                                               chunk=chunk, z_loss=1e-3)
        return loss, ce

    (jl, jce), (jgh, jgt) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(table))
    h = torch.from_numpy(hidden).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    loss, ce = tstep.chunked_cross_entropy(h, t, torch.from_numpy(labels),
                                           chunk=chunk, z_loss=1e-3)
    gh, gt = torch.autograd.grad(loss, (h, t))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ce.item(), float(jce), rtol=1e-5)
    assert _rel(gh, jgh) < 1e-5 and _rel(gt, jgt) < 1e-5
    with torch.no_grad():
        again, _ = tstep.chunked_cross_entropy(
            h, t, torch.from_numpy(labels), chunk=chunk, z_loss=1e-3)
    assert again.item() == loss.item()


def test_cross_entropy_and_grads():
    hidden, table, labels = _ce_inputs(5)
    logits = np.einsum("bsd,vd->bsv", hidden, table).astype(np.float32)
    (jl, jce), jg = jax.value_and_grad(
        lambda x: jstep.cross_entropy(x, jnp.asarray(labels)),
        has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss, ce = tstep.cross_entropy(x, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ce.item(), float(jce), rtol=1e-5)
    assert _rel(g, jg) < 1e-5
    # the chunked loss is the same function of the hidden states
    full, _ = tstep.chunked_cross_entropy(
        torch.from_numpy(hidden), torch.from_numpy(table),
        torch.from_numpy(labels), chunk=5)
    np.testing.assert_allclose(full.item(), loss.item(), rtol=1e-5)


def test_step_config_fields_equal_the_reference():
    got = {f.name: f.default for f in dataclasses.fields(
        tstep.TrainStepConfig)}
    want = {f.name: f.default for f in dataclasses.fields(
        jstep.TrainStepConfig)}
    assert got == want
    assert tstep.IGNORE_LABEL == jstep.IGNORE_LABEL


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------

def _models(name):
    fp32 = {"compute_dtype": "float32", "param_dtype": "float32"}
    jcfg = dataclasses.replace(jconfigs.ARCHS[name].reduced(), **fp32)
    cfg = dataclasses.replace(configs.ARCHS[name].reduced(), **fp32)
    jm, m = jbuild(jcfg), build_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, m, jp


def _port_params(jp):
    return module.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    arrs = {"tokens": rng.randint(1, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.randint(1, cfg.vocab_size, (B, S)).astype(np.int32)}
    arrs["labels"][0, :2] = jstep.IGNORE_LABEL
    for key, on in (("patches", cfg.frontend == "patch"),
                    ("frames", cfg.frontend == "frame")):
        if on:
            arrs[key] = (rng.randn(B, cfg.n_frontend_tokens, cfg.d_model)
                         * 0.05).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


STEP_CFG = dict(remat=True, ce_seq_chunk=8)


@pytest.mark.parametrize("name", PARITY_ARCHS)
def test_train_step_equals_the_reference(name):
    jm, m, jp = _models(name)
    cfg = jstep.TrainStepConfig(**STEP_CFG)
    tcfg = tstep.TrainStepConfig(**STEP_CFG)
    jb, tb = _batch(m.cfg, 1)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jm, cfg), has_aux=True))(jp, jb)
    params = _port_params(jp)
    (loss, met), grads = tstep._value_and_grad(
        tstep.make_loss_fn(m, tcfg))(params, tb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=STEP_REL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   rtol=STEP_REL, atol=1e-7)
    port, ref = _flat(grads), _flat(jg)
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, g), (_, w) in zip(port, ref):
        assert g.dtype == params_dtype(params, path)
        assert _rel(g, w) < STEP_REL, path
    if name == "qwen3-moe-235b-a22b":
        assert met["aux"].item() > 0

    jopt = jadamw.AdamW(learning_rate=1e-3)
    opt = adamw.AdamW(learning_rate=1e-3)
    jtrain = jax.jit(jstep.make_train_step(jm, jopt, cfg))
    train = tstep.make_train_step(m, opt, tcfg)
    jstate, state = jopt.init(jp), opt.init(params)
    for i in range(3):
        jp, jstate, jm_ = jtrain(jp, jstate, jb)
        params, state, tm = train(params, state, tb)
        assert sorted(tm) == sorted(jm_)
        keys = ("loss", "ce", "aux", "grad_norm") if i == 0 else ("loss",)
        for key in keys:
            np.testing.assert_allclose(tm[key].item(), float(jm_[key]),
                                       rtol=STEP_REL, atol=1e-7,
                                       err_msg=f"step {i + 1} {key}")
    assert int(state.step) == 3


def params_dtype(params, path):
    node = params
    for k in path:
        node = node[k]
    return node.dtype


def test_microbatches_remat_and_compression():
    jm, m, jp = _models("yi-9b")
    jb, tb = _batch(m.cfg, 2)
    tb["labels"] = tb["tokens"].clone()        # equal counts per microbatch
    jb["labels"] = jb["tokens"]

    def run(pcfg, compress=False):
        params = _port_params(jp)
        opt = adamw.AdamW(learning_rate=1e-3)
        step = tstep.make_train_step(m, opt, tstep.TrainStepConfig(**pcfg))
        if compress:
            return step(params, opt.init(params), tb, comp.init(params))
        return step(params, opt.init(params), tb)

    one = run(dict(STEP_CFG))[2]
    two = run(dict(STEP_CFG, microbatches=2))[2]
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(two[key].item(), one[key].item(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    jtwo = jax.jit(jstep.make_train_step(
        jm, jadamw.AdamW(learning_rate=1e-3),
        jstep.TrainStepConfig(**STEP_CFG, microbatches=2)))(
            jp, jadamw.AdamW().init(jp), jb)[2]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(two[key].item(), float(jtwo[key]),
                                   rtol=STEP_REL, err_msg=key)

    # remat changes no number
    params = _port_params(jp)
    grads = {}
    for remat in (True, False):
        fn = tstep._value_and_grad(tstep.make_loss_fn(
            m, tstep.TrainStepConfig(remat=remat, ce_seq_chunk=8)))
        grads[remat] = fn(params, tb)
    assert grads[True][0][0].item() == grads[False][0][0].item()
    for (_, a), (_, b) in zip(_flat(grads[True][1]), _flat(grads[False][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)

    out = run(dict(STEP_CFG, grad_compression=True), compress=True)
    assert len(out) == 4
    params, state, cstate, met = out
    assert isinstance(cstate, comp.CompressionState)
    assert isinstance(state, adamw.AdamWState)
    assert all(bool(torch.isfinite(r).all()) for _, r in _flat(cstate.residual))
    jout = jax.jit(jstep.make_train_step(
        jm, jadamw.AdamW(learning_rate=1e-3),
        jstep.TrainStepConfig(**STEP_CFG, grad_compression=True)))(
            jp, jadamw.AdamW().init(jp), jb, jcomp.init(jp))
    assert len(jout) == 4
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(met[key].item(), float(jout[3][key]),
                                   rtol=STEP_REL, err_msg=key)


@pytest.mark.parametrize("arch_name", sorted(configs.ARCHS))
def test_train_step_runs_and_improves(arch_name):
    """The port's counterpart of the JAX package's smoke test: three steps
    on one batch, every loss finite, the last below the first."""
    cfg = configs.ARCHS[arch_name].reduced()
    model = build_model(cfg)
    rng = np.random.RandomState(1)
    params = model.init_params(torch.Generator().manual_seed(1), device="cpu")
    optimizer = adamw.AdamW(learning_rate=1e-3)
    opt_state = optimizer.init(params)
    step = tstep.make_train_step(
        model, optimizer, tstep.TrainStepConfig(remat=True, ce_seq_chunk=8))
    tokens = torch.from_numpy(rng.randint(1, cfg.vocab_size, (B, 16))
                              .astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    for key, on in (("patches", cfg.frontend == "patch"),
                    ("frames", cfg.frontend == "frame")):
        if on:
            batch[key] = torch.from_numpy(
                rng.randn(B, cfg.n_frontend_tokens, cfg.d_model) * 0.05).to(
                    getattr(torch, cfg.compute_dtype))
    losses = []
    for _ in range(3):
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses   # same batch: must descend


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipe.batch_at(pipe.DataConfig(10, 4, 1), 0)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_gemma_train_step_runs_the_kernels():
    """On a card: gemma3-1b at full width cut to 2 layers (both local,
    window 512), B=1, S=1024, fp32 compute: one training step through the
    hand kernels (the lse forward, dq and dk/dv once a layer) against the
    same step through the plain attend_chunked: the metrics within 1e-3
    relative, the updated embedding within 1e-3 of its largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.kernels.flash_attention import flash_attention as fa

    cfg = dataclasses.replace(configs.get_arch("gemma3-1b"), n_layers=2,
                              compute_dtype="float32")
    m = build_model(cfg)
    batch = pipe.batch_at(pipe.DataConfig(cfg.vocab_size, 1024, 1), 0)
    out = {}
    for use_kernel in (True, False):
        params = m.init_params(torch.Generator().manual_seed(0))
        opt = adamw.AdamW(learning_rate=1e-4)
        step = tstep.make_train_step(m, opt, tstep.TrainStepConfig(),
                                     use_kernel=use_kernel)
        before = dict(fa.LAUNCHES)
        params, _, met = step(params, opt.init(params), batch)
        torch.cuda.synchronize()
        delta = {k: fa.LAUNCHES[k] - before[k] for k in before}
        out[use_kernel] = (params["embed"]["table"].cpu(), met, delta)
    assert out[True][2] == {"flash_attention": 0, "flash_attention_fwd": 2,
                            "flash_attention_bwd_dq": 2,
                            "flash_attention_bwd_dkv": 2}
    assert not any(out[False][2].values())
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(out[True][1][key].item(),
                                   out[False][1][key].item(), rtol=1e-3)
    assert _rel(out[True][0], out[False][0]) < 1e-3
