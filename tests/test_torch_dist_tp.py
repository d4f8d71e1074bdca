"""The tensor-parallel layers (heads, MLP and vocabulary over ``model``)
on gloo worlds of 2 and 4, against the port's no-mesh path and the JAX
package.

The harness is ``tests/test_torch_dist_blocked.py``'s: each rank runs
``python -c PORT_SCRIPT`` (a ``file://`` rendezvous under the test's
temporary directory, one intra-op thread, a group timeout; every rank
killed at the first failure or the deadline).  On a world of 2 as
``("model",)`` and a world of 4 as ``("data", "model")`` of (2, 2), for
gemma3-1b (4 heads split 2 a rank, its one KV head whole: every rank's q
heads read it) and yi-9b (its 2 KV heads split too) at ``reduced()`` with
fp32 params and compute and the JAX package's weights, every rank runs:

  * ``forward`` under ``train_rules()``: each rank's vocabulary block of
    the logits, gathered whole and held to the JAX package's;
  * the gradients of ``make_train_step``'s loss (its data-parallel region
    included) under ``train_rules()``, and ``train_rules(fsdp=True)`` on
    the (2, 2) mesh, against the same with no mesh, and one AdamW step;
  * ``make_prefill_step`` and three ``make_serve_step``s under
    ``serve_rules()``: tokens and logits against the JAX package's and the
    no-mesh run's;
  * the gradients again with the backward run after the mesh frame has
    closed (on the card autograd recomputes checkpoints on its device
    thread): bit for bit;
  * each case once on whole leaves and once on blocks (params, tokens and
    the KV cache, held over its KV heads where ``cache_shardings`` splits
    them), which must agree bit for bit, on every rank;
  * ``copy_to``/``reduce_from``/``split`` on a product whose gradients are
    derived by hand, and the vocabulary-parallel cross-entropy (plain and
    chunked) against the whole one, with ignored labels and labels at the
    blocks' edges.

Bounds: logits within 1e-4 of the JAX package's largest logit (the model
tests' bound); the loss and every gradient leaf within 1e-5 of the leaf's
largest magnitude of the no-mesh step (the row-parallel psums and the
cross-entropy add in another order); the cross-entropy within 1e-6; the
hand-derived gradients within 1e-6.  The dry-run of gemma3-1b at full
width cut to 2 of 26 layers (``train_4k``, pod16x16) computes the MLP on
``[16, 4096, 432]`` blocks a rank and fewer FLOPs than the same cell with
every activation whole.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.serve.decode import ServeConfig as JServeConfig
from repro.serve.decode import make_prefill_step as jprefill_step
from repro.serve.decode import make_serve_step as jserve_step
from test_torch_dist_blocked import ENV, _flat, _wait_all

DEADLINE_S = 300            # both worlds, from their start
GROUP_TIMEOUT_S = 120       # a collective no peer answers fails the rank
ARCHS = ["gemma3-1b", "yi-9b"]
MESHES = {2: {"model2": ((2,), ("model",))},
          4: {"2x2": ((2, 2), ("data", "model"))}}
B, S, PRE, STEPS = 4, 16, 8, 3     # batch, train/forward tokens, prompt
REL = 1e-4          # logits against the JAX package (the model tests')
GRAD_REL = 1e-5     # loss and gradients against the no-mesh step
CE_REL = 1e-6       # the vocabulary-parallel cross-entropy
HAND_REL = 1e-6     # copy_to / reduce_from / split against hand values


def _variant(cfgs, name):
    """An arch's ``reduced()`` config, with the fields a name such as
    ``"xlstm-1.3b+n_heads=2"`` sets after its "+" (integers)."""
    arch, *fields = name.split("+")
    cfg = cfgs.ARCHS[arch].reduced()
    return dataclasses.replace(cfg, **{k: int(v) for k, v in (
        f.split("=") for f in fields)})


def _cfg(cfgs, name):
    return dataclasses.replace(_variant(cfgs, name),
                               compute_dtype="float32", param_dtype="float32")


def _inputs(path, archs=ARCHS):
    """The JAX weights, the tokens, and the JAX package's forward logits,
    decode logits and greedy tokens."""
    arrays, dtypes, want = {}, {}, {}
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, 256, (B, S)).astype(np.int32)
    arrays["tokens"] = tokens
    for name in archs:
        model = jbuild(_cfg(jconfigs, name))
        params = model.init_params(jax.random.PRNGKey(0))
        for key, leaf in _flat(jax.tree.map(np.asarray, params)).items():
            dtypes[f"{name}/{key}"] = str(leaf.dtype)
            arrays[f"p/{name}/{key}"] = leaf.astype(np.float32)
        logits, _ = jax.jit(lambda p, t: model.forward(
            p, {"tokens": t}, remat=False))(params, jnp.asarray(tokens))
        want[f"{name}/forward"] = np.asarray(logits)
        prefill = jax.jit(jprefill_step(model, PRE + STEPS, JServeConfig()))
        step = jax.jit(jserve_step(model, JServeConfig()))
        tok, cache = prefill(params, {"tokens": jnp.asarray(tokens[:, :PRE])})
        toks = [np.asarray(tok)]
        for i in range(STEPS):
            tok, logits, cache = step(params, cache, tok, jnp.int32(PRE + i))
            want[f"{name}/decode{i}"] = np.asarray(logits)
            toks.append(np.asarray(tok))
        want[f"{name}/tokens"] = np.concatenate(toks, axis=1)
    np.savez(path, **arrays)
    return dtypes, want


_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.dist import collectives, compat
    from repro_torch.dist import sharding as shd
    from repro_torch.models import build_model, module
    from repro_torch.optim.adamw import AdamW
    from repro_torch.serve.decode import make_prefill_step, make_serve_step
    from repro_torch.train.step import (IGNORE_LABEL, TrainStepConfig,
                                        _data_parallel, _value_and_grad,
                                        chunked_cross_entropy, cross_entropy,
                                        make_loss_fn, make_train_step)

    ARCHS, MESHES, (B, S, PRE, STEPS) = %r, %r, %r
    inputs = dict(np.load(sys.argv[1]))
    dtypes = json.load(open(sys.argv[2]))
    rank, world = int(sys.argv[5]), int(sys.argv[6])
    compat.init_process_group("cpu", init_method=sys.argv[7], rank=rank,
                              world_size=world, timeout_s=float(sys.argv[8]))
    tokens = torch.from_numpy(inputs["tokens"])
    out = {}
    report = {"equal": {}, "ranks": {}, "err": {}, "width": {}, "held": {},
              "hand": {}, "ce": {}}

    def cfg_of(name):
        # "arch+field=int+...": the arch's reduced() with those fields
        arch, *fields = name.split("+")
        cfg = dataclasses.replace(configs.ARCHS[arch].reduced(), **{
            k: int(v) for k, v in (f.split("=") for f in fields)})
        return dataclasses.replace(cfg, compute_dtype="float32",
                                   param_dtype="float32")

    def weights(name):
        tree = {}
        prefix = f"p/{name}/"
        for key, v in inputs.items():
            if not key.startswith(prefix):
                continue
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            dt = getattr(torch, dtypes[key[2:]])
            node[leaf] = torch.from_numpy(v).to(dt, copy=True)
        return tree

    def leaves_of(tree):
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in leaves_of(t)]
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves_of(tree[k])]
        return [tree]

    def bits(ts):
        return [collectives.fingerprint(t.detach()) for t in ts]

    def on_ranks(label, ts):
        prints = collectives.all_ranks(bits(leaves_of(ts)))
        report["ranks"][label] = all(p == prints[0] for p in prints)

    def same(label, got, want, whole=None):
        # bit for bit, blocked against the whole leaves, and on every rank
        # (``whole``: what every rank holds whole, where ``got`` is each
        # rank's own block)
        got, want = leaves_of(got), leaves_of(want)
        report["equal"][label] = (len(got) == len(want) and all(
            g.shape == w.shape and g.dtype == w.dtype
            for g, w in zip(got, want)) and bits(got) == bits(want))
        on_ranks(label, got if whole is None else whole)

    def rel(got, want):
        return max(((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
                   .item() for g, w in zip(leaves_of(got), leaves_of(want)))

    def forward(model, params, mesh, rules):
        with torch.no_grad(), shd.use_mesh(mesh, rules):
            return (model.forward(params, {"tokens": tokens}, remat=False)[0],
                    model.vocab_axes(B, S))

    def grads(model, params, mesh, rules):
        batch = {"tokens": tokens, "labels": tokens}
        fn = _data_parallel(_value_and_grad(make_loss_fn(
            model, TrainStepConfig(ce_seq_chunk=8))), model)
        with shd.use_mesh(mesh, rules):
            (loss, _), g = fn(params, batch)
        g = module.tree_map(lambda x, p: p.with_local(x)
                            if isinstance(p, shd.Block) else x, g, params)
        return loss, shd.gather_tree(g)

    def grads_outside(model, params, mesh, rules):
        # the loss under the frame, the backward after it has closed: on
        # the card autograd recomputes checkpoints on its device thread,
        # where this thread's frame is not active
        fn = make_loss_fn(model, TrainStepConfig(ce_seq_chunk=8))
        live = module.tree_map(lambda p: p.detach().requires_grad_(), params)
        with shd.use_mesh(mesh, rules):
            loss, _ = fn(live, {"tokens": tokens, "labels": tokens})
        g = torch.autograd.grad(loss, module.leaves(live))
        return loss.detach(), list(g)

    def train(model, params, mesh, rules):
        opt = AdamW(learning_rate=1e-3)
        state = opt.init(params)
        step = make_train_step(model, opt, TrainStepConfig(ce_seq_chunk=8))
        with shd.use_mesh(mesh, rules):
            params, state, metrics = step(params, state,
                                          {"tokens": tokens,
                                           "labels": tokens})
        return ([metrics[k] for k in sorted(metrics)],
                shd.gather_tree((params, state.mu, state.nu)))

    def serve(model, params, mesh, rules, blocked):
        batch = {"tokens": tokens[:, :PRE]}
        if blocked:
            batch = shd.shard_tree(batch, shd.held_batch_shardings(
                batch, mesh, rules), mesh)
        specs = []
        with torch.no_grad(), shd.use_mesh(mesh, rules):
            tok, cache = make_prefill_step(model, PRE + STEPS)(params, batch)
            if blocked and not any(isinstance(c, shd.Block)
                                   for c in module.leaves(cache)):
                cache = shd.shard_tree(cache, shd.cache_shardings(
                    model.cache_specs(B, PRE + STEPS), mesh, rules), mesh)
            specs = sorted({str(c.spec) for c in module.leaves(cache)
                            if isinstance(c, shd.Block)})
            toks, logits = [tok], []
            for i in range(STEPS):
                t = toks[-1]
                if blocked:
                    t = shd.shard_tree(t, shd.held_batch_shardings(
                        {"tokens": t}, mesh, rules)["tokens"], mesh)
                tok, lg, cache = make_serve_step(model)(params, cache, t,
                                                        PRE + i)
                toks.append(tok)
                logits.append(lg)
        return toks, logits, shd.gather_tree(cache), specs

    def hand(mesh, key):
        # out = reduce_from(copy_to(x) * w_r) = x * W with W = sum_r w_r;
        # loss = sum(out ** 2): dx = 2 x W^2, dw_r = 2 x^2 W; the loss of
        # sum(split(v) ** 2) psum'd is sum(v ** 2): dv = 2 v, whole
        n = collectives.axis_size(mesh, "model")
        r = collectives.axis_index(mesh, "model")
        x = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64,
                         requires_grad=True)
        base = torch.tensor([0.25, 1.5, -1.0], dtype=torch.float64)
        w = (base * (r + 1)).requires_grad_()
        W = base * sum(range(1, n + 1))
        out = collectives.reduce_from(collectives.copy_to(x, mesh, "model")
                                      * w, mesh, "model")
        (out ** 2).sum().backward()
        v = torch.arange(1.0, 2 * n + 1, dtype=torch.float64,
                         requires_grad=True)
        part = collectives.split(v, mesh, ("model",))
        collectives.reduce_from((part ** 2).sum(), mesh, "model").backward()
        w2 = (base * (r + 1)).requires_grad_()
        bad = collectives.psum(x.detach() * w2, mesh, "model")
        (bad ** 2).sum().backward()
        xd = x.detach()
        report["hand"][key] = {
            "out": rel(out, xd * W),
            "dx": rel(x.grad, 2 * xd * W ** 2),
            "dw": rel(w.grad, 2 * xd ** 2 * W),
            "dv": rel(v.grad, 2 * v.detach()),
            "psum_dw_ratio": (w2.grad / w.grad).mean().item()}

    def ce(mesh, key):
        rng = np.random.RandomState(3)
        v, d = 256, 32
        logits = torch.from_numpy(rng.randn(B, S, v) * 3.0)
        labels = torch.from_numpy(rng.randint(0, v, (B, S)))
        edge = v // collectives.axis_size(mesh, "model")
        labels[0, :6] = torch.tensor([0, edge - 1, edge, edge + 1, v - 1,
                                      IGNORE_LABEL])
        labels[1, ::3] = IGNORE_LABEL
        hidden = torch.from_numpy(rng.randn(B, S, d))
        table = torch.from_numpy(rng.randn(v, d) * 0.5)
        spec = (None, None, "model")
        whole = logits.clone().requires_grad_()
        want = cross_entropy(whole, labels)
        want[0].backward()
        h0, t0 = hidden.clone().requires_grad_(), table.clone().requires_grad_()
        cwant = chunked_cross_entropy(h0, t0, labels, chunk=8)
        cwant[0].backward()
        rules = shd.train_rules()
        with shd.use_mesh(mesh, rules):
            part = collectives.block(logits, mesh, spec).clone() \\
                .requires_grad_()
            got = cross_entropy(part, labels, vocab_axes=("model",))
            got[0].backward()
            h1 = hidden.clone().requires_grad_()
            t1 = collectives.block(table, mesh, ("model", None)).clone() \\
                .requires_grad_()
            cgot = chunked_cross_entropy(h1, t1, labels, chunk=8,
                                         vocab_axes=("model",))
            cgot[0].backward()
        report["ce"][key] = {
            "loss": rel(got, want), "grad": rel(
                part.grad, collectives.block(whole.grad, mesh, spec)),
            "chunked_loss": rel(cgot, cwant), "chunked_dh": rel(h1.grad,
                                                                h0.grad),
            "chunked_dtable": rel(t1.grad, collectives.block(
                t0.grad, mesh, ("model", None)))}
        on_ranks(f"{key}/ce", [got[0], cgot[0], h1.grad])

    for mname, (shape, names) in MESHES[world].items():
        mesh = compat.make_mesh(tuple(shape), tuple(names))
        hand(mesh, mname)
        ce(mesh, mname)
        for name in ARCHS:
            model = build_model(cfg_of(name))
            key = f"{mname}/{name}"
            specs = model.param_specs()

            rules = shd.train_rules()
            whole = weights(name)
            held = shd.shard_tree(whole, shd.tree_shardings(specs, mesh,
                                                            rules), mesh)
            got, axes = forward(model, whole, mesh, rules)
            logits = collectives._gather_whole(got, mesh, (None, None, axes))
            same(f"{key}/forward", forward(model, held, mesh, rules)[0], got,
                 whole=logits)
            report["width"][key] = [got.shape[-1], list(axes)]
            out[f"{key}/forward"] = logits.numpy()

            runs = [("train", shd.train_rules())]
            if "data" in names:
                runs.append(("fsdp", shd.train_rules(fsdp=True)))
            loss0, g0 = grads(model, weights(name), None, None)
            for rname, rules in runs:
                loss, g = grads(model, weights(name), mesh, rules)
                held = shd.shard_tree(weights(name), shd.tree_shardings(
                    specs, mesh, rules), mesh)
                bloss, bg = grads(model, held, mesh, rules)
                label = f"{key}/{rname}"
                if "data" not in names:
                    same(f"{label}/outside", grads_outside(
                        model, weights(name), mesh, rules),
                        [loss, module.leaves(g)])
                report["err"][f"{label}/loss"] = rel(loss, loss0)
                report["err"][f"{label}/grads"] = rel(g, g0)
                same(f"{label}/grads", [bloss, bg], [loss, g])
                held = shd.shard_tree(weights(name), shd.tree_shardings(
                    specs, mesh, rules), mesh)
                bm, bstate = train(model, held, mesh, rules)
                wm, wstate = train(model, weights(name), mesh, rules)
                same(f"{label}/step", [bm, bstate], [wm, wstate])

            rules = shd.serve_rules()
            whole = weights(name)
            held = shd.shard_tree(whole, shd.tree_shardings(specs, mesh,
                                                            rules), mesh)
            toks, logits, cache, specs_b = serve(model, held, mesh, rules,
                                                 True)
            wtoks, wlogits, wcache, _ = serve(model, whole, mesh, rules,
                                              False)
            ntoks, nlogits, _, _ = serve(model, whole, None, None, False)
            same(f"{key}/serve_tokens", toks, wtoks)
            same(f"{key}/serve_logits", logits, wlogits)
            same(f"{key}/serve_cache", cache, wcache)
            report["held"][key] = specs_b
            report["err"][f"{key}/serve_logits"] = rel(wlogits, nlogits)
            out[f"{key}/tokens"] = torch.cat(wtoks, dim=1).numpy()
            out[f"{key}/nomesh_tokens"] = torch.cat(ntoks, dim=1).numpy()
            for i, lg in enumerate(wlogits):
                out[f"{key}/decode{i}"] = lg.numpy()
    %s
    if rank == 0:
        np.savez(sys.argv[3], **out)
        with open(sys.argv[4], "w") as fh:
            json.dump(report, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("PORT_OK")
""")


def port_script(archs, extra: str = "pass", meshes=None) -> str:
    """Each rank's script for ``archs`` (names as ``_variant`` reads them)
    on ``meshes`` ({world: {name: (shape, axis names)}}, ``MESHES`` by
    default); ``extra`` (dedented code) runs after the per-arch cases,
    before rank 0 writes the report."""
    return _SCRIPT % (archs, MESHES if meshes is None else meshes,
                      (B, S, PRE, STEPS), textwrap.dedent(extra).strip())


PORT_SCRIPT = port_script(ARCHS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds, started together once the JAX references are made:
    {world: (arrays, report)} and the JAX logits and tokens."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs = tmp / "inputs.npz"
    dtypes, want = _inputs(inputs)
    (tmp / "dtypes.json").write_text(json.dumps(dtypes))
    procs = {}
    for world in MESHES:
        procs[world] = [subprocess.Popen(
            [sys.executable, "-c", PORT_SCRIPT, str(inputs),
             str(tmp / "dtypes.json"), str(tmp / f"port{world}.npz"),
             str(tmp / f"port{world}.json"), str(r), str(world),
             f"file://{tmp / f'rendezvous{world}'}", str(GROUP_TIMEOUT_S)],
            env=ENV, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
    deadline = time.monotonic() + DEADLINE_S
    out = {}
    for world, ps in procs.items():
        for r, (rc, _, err) in enumerate(_wait_all(ps, deadline)):
            assert rc == 0, f"world {world} rank {r} exited {rc}: " \
                            f"{err[-3000:]}"
        out[world] = (dict(np.load(tmp / f"port{world}.npz")),
                      json.loads((tmp / f"port{world}.json").read_text()))
    return out, want


CASES = [(w, m, a) for w in MESHES for m in MESHES[w] for a in ARCHS]
IDS = [f"{w}-{m}-{a}" for w, m, a in CASES]
MESH_CASES = [(w, m) for w in MESHES for m in MESHES[w]]


def _report(runs, world):
    return runs[0][world][1]


@pytest.mark.parametrize("what", ["forward"] + [f"decode{i}"
                                                for i in range(STEPS)])
@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_tp_logits_match_jax(runs, world, mesh, arch, what):
    got = runs[0][world][0][f"{mesh}/{arch}/{what}"]
    want = runs[1][f"{arch}/{what}"]
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= REL, err


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_tp_forward_returns_the_vocabulary_block(runs, world, mesh, arch):
    """Each rank computes half the vocabulary's logits, over "model"."""
    width, axes = _report(runs, world)["width"][f"{mesh}/{arch}"]
    assert axes == ["model"] and width == 256 // 2


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_tp_decode_tokens_equal(runs, world, mesh, arch):
    """Prefill + 3 greedy steps: the JAX package's tokens, and the no-mesh
    run's."""
    got = runs[0][world][0][f"{mesh}/{arch}/tokens"]
    np.testing.assert_array_equal(got, runs[1][f"{arch}/tokens"])
    np.testing.assert_array_equal(
        got, runs[0][world][0][f"{mesh}/{arch}/nomesh_tokens"])
    assert _report(runs, world)["err"][f"{mesh}/{arch}/serve_logits"] <= REL


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_tp_grads_match_no_mesh(runs, world, mesh, arch):
    """The loss and every gradient leaf against the no-mesh step (fsdp too
    on the (2, 2) mesh), equal on every rank."""
    rep = _report(runs, world)
    rules = ["train"] + (["fsdp"] if mesh == "2x2" else [])
    for r in rules:
        label = f"{mesh}/{arch}/{r}"
        assert rep["err"][f"{label}/loss"] <= GRAD_REL, label
        assert rep["err"][f"{label}/grads"] <= GRAD_REL, label
        assert rep["ranks"][f"{label}/grads"], label


@pytest.mark.parametrize("what", ["forward", "grads", "step", "serve_tokens",
                                  "serve_logits", "serve_cache"])
@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_tp_blocked_equals_whole(runs, world, mesh, arch, what):
    rep = _report(runs, world)
    labels = [k for k in rep["equal"] if k.startswith(f"{mesh}/{arch}/")
              and k.endswith(f"/{what}")]
    assert labels
    for label in labels:
        assert rep["equal"][label] and rep["ranks"][label], label


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_backward_outside_the_frame(runs, arch):
    """The checkpointed periods and CE segments recompute under the
    forward's mesh frame when the backward runs outside it, as autograd's
    device thread runs it on the card: the gradients bit for bit."""
    rep = _report(runs, 2)
    label = f"model2/{arch}/train/outside"
    assert rep["equal"][label] and rep["ranks"][label], label


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_tp_cache_held_by_kv_heads(runs, world, mesh, arch):
    """The blocked cache splits yi-9b's 2 KV heads over "model" (and the
    batch over "data" on the (2, 2) mesh); gemma3-1b's one KV head stays
    whole."""
    specs = _report(runs, world)["held"][f"{mesh}/{arch}"]
    rows = "'data'" if mesh == "2x2" else "None"
    # stacked periods: the leading axis is the layers'
    if arch == "yi-9b":
        assert specs == [f"(None, {rows}, None, 'model', None)"]
    else:
        assert specs == ([f"(None, {rows}, None, None, None)"]
                         if mesh == "2x2" else [])


@pytest.mark.parametrize("world,mesh", MESH_CASES)
def test_tp_collectives_hand_derived(runs, world, mesh):
    """copy_to, reduce_from and split against hand-derived gradients; a
    psum in reduce_from's place doubles the weight's gradient on 2 ranks."""
    got = _report(runs, world)["hand"][mesh]
    for key in ("out", "dx", "dw", "dv"):
        assert got[key] <= HAND_REL, (key, got)
    assert got["psum_dw_ratio"] == pytest.approx(2.0)


@pytest.mark.parametrize("world,mesh", MESH_CASES)
def test_tp_vocab_parallel_cross_entropy(runs, world, mesh):
    rep = _report(runs, world)
    for key, err in rep["ce"][mesh].items():
        assert err <= CE_REL, (key, err)
    assert rep["ranks"][f"{mesh}/ce"]


DRYRUN_LAYERS = 2


@pytest.fixture(scope="module")
def dryrun_cells(monkeypatch_module):
    """gemma3-1b train_4k at pod16x16 cut to 2 layers: the cell, and the
    same with every activation whole (``split_axes`` returning ())."""
    from repro_torch.launch import dryrun
    from repro_torch.models import attention, layers

    full = dryrun.get_arch
    monkeypatch_module.setattr(dryrun, "get_arch", lambda name: dataclasses
                               .replace(full(name), n_layers=DRYRUN_LAYERS))
    counters = []
    split = dryrun.run_cell("gemma3-1b", "train_4k", verbose=False,
                            counter_out=counters)
    for mod in (attention, layers):
        monkeypatch_module.setattr(mod, "split_axes", lambda *a: ())
    whole = dryrun.run_cell("gemma3-1b", "train_4k", verbose=False)
    return split, whole, counters[0]


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_dryrun_mlp_on_blocks(dryrun_cells):
    """The MLP's activations are [16, 4096, 432] a rank (6912 over 16),
    none whole; the vocabulary's logits a rank's 16384 of 262144."""
    _, _, counter = dryrun_cells
    shapes = {shape for _, shape in counter.traffic}
    assert any(s.endswith("[16,4096,432]") for s in shapes)
    assert not any(s.endswith("[16,4096,6912]") for s in shapes)
    assert any(s.endswith("[16,512,16384]") for s in shapes)
    assert not any(s.endswith("[16,512,262144]") for s in shapes)


def test_dryrun_flops_below_whole(dryrun_cells):
    split, whole, _ = dryrun_cells
    assert split["per_device_flops"] < 0.7 * whole["per_device_flops"]
    mem = split["memory_per_device_bytes"]["total_bytes"]
    assert mem < whole["memory_per_device_bytes"]["total_bytes"]
