"""repro_torch's recurrent and routed blocks against the JAX package —
the selective SSM (with its associative scan), the mLSTM and sLSTM, and the
MoE (global and per-shard dispatch, tokens dropped over capacity, the aux
loss) — on numpy-drawn inputs with the JAX package's weights carried
across by ``models.module.from_numpy``, at 1e-5 in fp32; the port's own
decode-against-forward consistency; and, on a card, a 2-layer gemma3-1b
at full width through the hand flash-attention kernel."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import module as jmodule
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.models import build_model, module, moe, ssm, xlstm

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Torch ops on one intra-op thread, the count restored after (several
    test workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _cfgs(name, **kw):
    """(JAX config, port config) at reduced() with fp32 compute."""
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jconfigs.ARCHS[name].reduced(), **kw),
            dataclasses.replace(configs.ARCHS[name].reduced(), **kw))


def _params(jspec, seed=0):
    """JAX-initialised weights for a JAX spec tree: (jax tree, port tree)."""
    jp = jmodule.init(jax.random.PRNGKey(seed), jspec)
    return jp, module.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(seed, *shape, scale=1.0):
    arr = (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)
    return jnp.asarray(arr), torch.from_numpy(arr)


# --------------------------------------------------------------------------
# SSM, xLSTM
# --------------------------------------------------------------------------

def _ssm_params(seed=25):
    jcfg, _ = _cfgs("hymba-1.5b")
    jp = jmodule.init(jax.random.PRNGKey(seed), jssm.ssm_spec(jcfg, 24))
    # away from the zero/one inits so every term matters
    jp = {k: v + 0.1 * jax.random.normal(jax.random.PRNGKey(seed + i),
                                         v.shape)
          for i, (k, v) in enumerate(sorted(jp.items()))}
    return jp, module.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("s,chunk", [(16, 1024), (21, 8), (7, 4), (1, 4)])
def test_ssm_matches_jax(s, chunk):
    jp, p = _ssm_params()
    ju, tu = _x(26, 2, s, 24)
    jy, jh = jssm.ssm_apply(jp, ju, chunk=chunk)
    y, h = ssm.ssm_apply(p, tu, chunk=chunk)
    _close(y, jy)
    _close(h, jh)
    ju1, tu1 = _x(27, 2, 1, 24)
    jy1, jh1 = jssm.ssm_decode_step(jp, ju1, jh)
    y1, h1 = ssm.ssm_decode_step(p, tu1, h)
    _close(y1, jy1)
    _close(h1, jh1)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_is_jax_s(n):
    a = np.random.RandomState(n).rand(2, n, 3).astype(np.float32)
    b = np.random.RandomState(n + 1).randn(2, n, 3).astype(np.float32)
    want = jax.lax.associative_scan(jssm._assoc_op,
                                    (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = ssm.associative_scan(ssm._assoc_op,
                               (torch.from_numpy(a), torch.from_numpy(b)))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("s,chunk", [(12, 256), (21, 8)])
def test_mlstm_matches_jax(s, chunk):
    jcfg, cfg = _cfgs("xlstm-1.3b")
    jp, p = _params(jxlstm.mlstm_spec(jcfg), seed=28)
    jx, tx = _x(29, 2, s, cfg.d_model)
    jy, jst = jxlstm.mlstm_apply(jcfg, jp, jx, chunk=chunk)
    y, st = xlstm.mlstm_apply(cfg, p, tx, chunk=chunk)
    _close(y, jy)
    for g, w in zip(st, jst):
        _close(g, w)
    jx1, tx1 = _x(30, 2, 1, cfg.d_model)
    jy1, jst1 = jxlstm.mlstm_decode_step(jcfg, jp, jx1, jst)
    y1, st1 = xlstm.mlstm_decode_step(cfg, p, tx1, st)
    _close(y1, jy1)
    for g, w in zip(st1, jst1):
        _close(g, w)


def test_slstm_matches_jax():
    jcfg, cfg = _cfgs("xlstm-1.3b")
    jp, p = _params(jxlstm.slstm_spec(jcfg), seed=31)
    jx, tx = _x(32, 2, 9, cfg.d_model)
    jy, jst = jxlstm.slstm_apply(jcfg, jp, jx)
    y, st = xlstm.slstm_apply(cfg, p, tx)
    _close(y, jy)
    for g, w in zip(st, jst):
        _close(g, w)
    jx1, tx1 = _x(33, 2, 1, cfg.d_model)
    jy1, jst1 = jxlstm.slstm_decode_step(jcfg, jp, jx1, jst)
    y1, st1 = xlstm.slstm_decode_step(cfg, p, tx1, st)
    _close(y1, jy1)
    for g, w in zip(st1, jst1):
        _close(g, w)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("dispatch", ["global", "local"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
def test_moe_matches_jax(name, dispatch, capacity_factor):
    jcfg, cfg = _cfgs(name, moe_dispatch=dispatch,
                      capacity_factor=capacity_factor)
    jp, p = _params(jmoe.moe_spec(jcfg), seed=34)
    jx, tx = _x(35, 3, 11, cfg.d_model)     # continuous router logits
    jy, jaux = jmoe.moe_apply(jcfg, jp, jx)
    y, aux = moe.moe_apply(cfg, p, tx)
    _close(y, jy)
    _close(aux, jaux)
    assert moe.capacity(cfg, 33) == jmoe.capacity(jcfg, 33)
    ref = moe.moe_reference(cfg, p, tx)
    _close(ref, jmoe.moe_reference(jcfg, jp, jx))
    dropped = float((y - ref).abs().max())
    if capacity_factor == 0.5:
        assert dropped > 1e-3            # tokens over capacity dropped
    if capacity_factor == 8.0:
        assert dropped < 1e-5            # nothing dropped: the oracle


# --------------------------------------------------------------------------
# decode against forward (the port alone)
# --------------------------------------------------------------------------

CONSISTENCY = ["yi-9b", "gemma3-1b", "hymba-1.5b", "xlstm-1.3b",
               "nemotron-4-15b"]


def _port_model(name, seed):
    cfg = dataclasses.replace(configs.ARCHS[name].reduced(),
                              compute_dtype="float32", capacity_factor=8.0)
    m = build_model(cfg)
    return m, m.init_params(torch.Generator().manual_seed(seed),
                            device="cpu")


def _rel(got, want) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


@pytest.mark.parametrize("name", CONSISTENCY)
def test_decode_matches_forward(name):
    """Step-by-step decode reproduces the parallel forward pass, as the
    JAX package's tests/test_decode_consistency.py holds it (1e-4 of the
    largest logit), with the port's own torch-drawn weights."""
    m, p = _port_model(name, 0)
    b, s = 2, 12
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        1, m.cfg.vocab_size, (b, s)))
    with torch.no_grad():
        want, _ = m.forward(p, {"tokens": toks})
        cache = m.init_cache(b, s, cache_dtype=torch.float32, device="cpu")
        outs = []
        for t in range(s):
            lg, cache = m.decode_step(p, cache, toks[:, t:t + 1], t)
            outs.append(lg)
    assert _rel(torch.cat(outs, 1), want) < 1e-4


def test_prefill_then_decode_matches_forward():
    m, p = _port_model("yi-9b", 1)
    b, s, pre = 2, 12, 8
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        1, m.cfg.vocab_size, (b, s)))
    with torch.no_grad():
        want, _ = m.forward(p, {"tokens": toks})
        got, cache = m.prefill(p, {"tokens": toks[:, :pre]}, max_seq=s,
                               cache_dtype=torch.float32)
        torch.testing.assert_close(got, want[:, :pre], rtol=2e-3, atol=2e-3)
        for t in range(pre, s):
            lg, cache = m.decode_step(p, cache, toks[:, t:t + 1], t)
            torch.testing.assert_close(lg, want[:, t:t + 1], rtol=2e-3,
                                       atol=2e-3)


@pytest.mark.parametrize("name", ["yi-9b", "hymba-1.5b"])
def test_remat_changes_no_gradient(name):
    """``remat`` wraps each stacked period in torch.utils.checkpoint under
    autograd ("dots" keeps the products' outputs): the loss and every
    parameter's gradient equal those of the run without it."""
    m, p = _port_model(name, 2)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        1, m.cfg.vocab_size, (2, 10)))

    def grads(**kw):
        leaves = module.leaves(p)
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        logits, aux = m.forward(p, {"tokens": toks}, **kw)
        loss = logits.square().mean() + aux
        loss.backward()
        return loss.detach(), [t.grad.clone() for t in leaves]

    want_loss, want = grads(remat=False)
    for policy in ("full", "dots"):
        loss, got = grads(remat=True, remat_policy=policy)
        torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_entry_points_default_to_the_card():
    m = build_model(configs.ARCHS["yi-9b"].reduced())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.from_numpy({"w": np.zeros(3, np.float32)})


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_gemma_forward_runs_the_kernel():
    """On a card: gemma3-1b at full width, cut to 2 layers (both local,
    window 512), B=1, S=1024, fp32 compute: one flash-attention launch a
    layer, and the logits within 1e-3 of the largest of the plain
    attend_chunked run's (run by python3 -m pytest -m cuda on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = dataclasses.replace(configs.get_arch("gemma3-1b"), n_layers=2,
                              compute_dtype="float32")
    m = build_model(cfg)
    p = m.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(1, cfg.vocab_size, (1, 1024),
                         generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        before = dict(fa.LAUNCHES)
        got, _ = m.forward(p, {"tokens": toks})
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] - \
            before["flash_attention"] == 2
        assert fa.LAUNCHES["flash_attention_fwd"] == \
            before["flash_attention_fwd"]
        want, _ = m.forward(p, {"tokens": toks}, use_kernel=False)
    assert _rel(got, want) < 1e-3
