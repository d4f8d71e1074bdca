"""Hymba's SSM branch, the xLSTM cores and the MoE's shared expert on each
rank's block, on gloo worlds of 2 and 4, against the port's no-mesh path
and the JAX package.

The harness is ``tests/test_torch_dist_tp.py``'s (its ``port_script`` and
``_inputs``, built on ``tests/test_torch_dist_blocked.py``'s processes): a
world of 2 as ``("model",)`` and a world of 4 as ``("data", "model")`` of
(2, 2), for hymba-1.5b (its SSM over 32 of 64 channels a rank, its heads
and KV heads split too), xlstm-1.3b (the mLSTM over 64 of 128 channels
and 2 of 4 heads a rank, the sLSTM's gates over a block of each gate)
and llama4-maverick (the shared expert over 32 of 64 hidden units and
its global dispatch over 2 of 4 experts a rank; on the (2, 2) mesh the
dispatch routes the whole batch from each rank's rows) at ``reduced()``
with fp32 params and compute and the JAX package's weights.
The JAX package's forward and ``repro.serve.decode`` steps give the
reference logits and tokens.  Every rank runs the forward, the gradients
of ``make_train_step``'s loss
(fsdp too on the (2, 2) mesh), one AdamW step, ``make_prefill_step`` and
three ``make_serve_step``s, each on whole leaves and on blocks (params,
tokens, the cache), and the backward after the mesh frame has closed.
Beside them:

  * ``sharding.take_parts`` against a hand cut of each part (whole and
    held leaves, and its gradient whole on every rank); the contiguous
    cut ``take`` makes is not that;
  * the MoE's local and shard_map dispatches with the shared expert under
    the mesh against ``moe_reference`` with no mesh, and the shared
    expert's gradients against the no-mesh dispatch's; the global
    dispatch on blocks of the experts (in a data-parallel region on the
    (2, 2) mesh, with an expert overflowing) against the no-mesh global
    dispatch, the per-shard routing planted above the bound;
  * a train step on the (2, 2) mesh whose data shards count unequal
    tokens: the router's gradient through the whole batch's aux loss;
    the same under fsdp on blocks, where the experts run on their blocks
    of d, with the cotangents entering their all-gather left unweighted
    planted above the bound.

Bounds: logits within 1e-4 of the JAX package's largest logit; the loss
within 1e-5 of the no-mesh step's, and every gradient leaf within 1e-5
of the leaf's largest magnitude (xlstm-1.3b's 2e-5, ``GRAD_BOUND``); the
MoE within 1e-5 (``chip_smoke.py``'s bound).  The
dry-run of hymba-1.5b at full width cut to 2 of 32 layers (``train_4k``,
pod16x16) runs the SSM scan on [16, 1024, 100, 16] blocks a rank and
counts 1/16 of the SSM products' FLOPs; its total falls by the other
15/16, worked out from the shapes, against the same cell with the SSM
whole.
"""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_dist_blocked import ENV, _wait_all
from test_torch_dist_tp import (GRAD_REL, MESHES, REL, STEPS, _inputs,
                                port_script)

DEADLINE_S = 300            # both worlds, from their start
GROUP_TIMEOUT_S = 120       # a collective no peer answers fails the rank
ARCHS = ["hymba-1.5b", "xlstm-1.3b", "llama4-maverick-400b-a17b"]
WORLD_ARCHS = {2: ARCHS, 4: ARCHS}
MOE_TOL = 1e-5              # chip_smoke.py's DIST_MOE_TOL
# the gradients' bound per arch: xlstm-1.3b's mLSTM feeds the row-parallel
# sums' rounding through its exponential gates and its 1/den, and its
# q, k, v and w_up leaves come to about 1.4e-5 of their largest magnitude
# (its loss within 1e-7)
GRAD_BOUND = {"hymba-1.5b": GRAD_REL, "xlstm-1.3b": 2e-5,
              "llama4-maverick-400b-a17b": GRAD_REL}

EXTRA = """
import contextlib


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [(prefix, tree)]


report["parts"], report["moe"] = {}, {}
from repro_torch.models.moe import moe_apply, moe_reference, moe_spec
for mname, (shape, names) in MESHES[world].items():
    mesh = compat.make_mesh(tuple(shape), tuple(names))
    rules = shd.train_rules()
    n = collectives.axis_size(mesh, "model")
    r = collectives.axis_index(mesh, "model")
    di = 4 * n
    c = di // n
    w = torch.arange(3 * 2 * di, dtype=torch.float64).reshape(3, 2 * di)
    hand = torch.cat([w[:, r * c:(r + 1) * c],
                      w[:, di + r * c:di + (r + 1) * c]], dim=1)
    live = w.clone().requires_grad_()
    held = shd.Block(collectives.block(w, mesh, (None, "model")).clone(),
                     (None, "model"), mesh)
    with shd.use_mesh(mesh, rules):
        got = shd.take_parts(live, 1, ("model",), 2)
        got_held = shd.take_parts(held, 1, ("model",), 2)
        contiguous = shd.take(w, 1, ("model",))
        (got ** 2).sum().backward()
    report["parts"][mname] = {
        "whole": torch.equal(got, hand), "held": torch.equal(got_held, hand),
        "contiguous": torch.equal(contiguous, hand),
        "grad": torch.equal(live.grad, 2 * w)}

    cfg = dataclasses.replace(configs.ARCHS["llama4-maverick-400b-a17b"]
                              .reduced(), compute_dtype="float32",
                              capacity_factor=8.0)
    spec = moe_spec(cfg)
    params = module.init(torch.Generator().manual_seed(0), spec,
                         device="cpu")
    x = torch.randn(4, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(0)) * 0.3
    with torch.no_grad():
        ref = moe_reference(cfg, params, x)
    shared = ("w_gate", "w_up", "w_down")

    def run(dispatch, on_mesh, blocked=False):
        c2 = dataclasses.replace(cfg, moe_dispatch=dispatch)
        live = module.tree_map(lambda p: p.detach().clone()
                               .requires_grad_(), params)
        if blocked:
            held = shd.shard_tree(params["shared"], shd.tree_shardings(
                spec["shared"], mesh, rules), mesh)
            live["shared"] = module.tree_map(
                lambda b: b.with_local(b.local.requires_grad_())
                if isinstance(b, shd.Block) else b.requires_grad_(), held)
        with shd.use_mesh(mesh if on_mesh else None,
                          rules if on_mesh else None):
            y, aux = moe_apply(c2, live, x)
        (y ** 2).sum().backward()
        grads = []
        for k in shared:
            leaf = live["shared"][k]
            grads.append(collectives._gather_whole(
                leaf.local.grad, mesh, leaf.spec)
                if isinstance(leaf, shd.Block) else leaf.grad)
        return y.detach(), grads

    _, want = run("global", False)
    for dispatch in ("local", "shardmap"):
        y, g = run(dispatch, True)
        yb, gb = run(dispatch, True, blocked=True)
        key = f"{mname}/{dispatch}"
        report["moe"][key] = {
            "err": (y - ref).abs().max().item(),
            "grad": max(((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(g, want)),
            "blocked_equal": torch.equal(y, yb) and all(
                torch.equal(a, b) for a, b in zip(g, gb))}
        on_ranks(f"{key}/moe", [y] + g)

    # the global dispatch with the experts held as blocks over "model",
    # against the port's no-mesh moe_apply (moe_reference has no
    # capacity); on the (2, 2) mesh inside a data-parallel region of the
    # rows whose first shard's tokens are one token repeated, so that its
    # expert overflows
    from repro_torch.models import moe as moe_mod
    gcfg = dataclasses.replace(cfg, capacity_factor=1.25)
    xg = x.clone()
    xg[:2] = x[0, 0]
    data = tuple(a for a in names if a != "model")
    experts = ("w_gate", "w_up", "w_down")
    whole_shapes = {tuple(params[k].shape) for k in experts}

    def run_global(on_mesh, blocked=True, per_shard=False):
        live = module.tree_map(lambda p: p.detach().clone()
                               .requires_grad_(), params)
        if on_mesh and blocked:
            for k in experts:
                spec = ("model", None, None)
                live[k] = shd.Block(collectives.block(params[k], mesh, spec)
                                    .clone().requires_grad_(), spec, mesh)
        rows = xg
        seen = []
        with contextlib.ExitStack() as st:
            if on_mesh:
                if data:
                    rows = collectives.block(xg, mesh, (data, None, None))
                    st.enter_context(shd.data_region(mesh, data))
                    st.enter_context(shd.use_mesh(compat.submesh(
                        mesh, ["model"]), rules))
                else:
                    st.enter_context(shd.use_mesh(mesh, rules))
                real = collectives._gather_whole

                def recorded(t, m, spec):
                    out = real(t, m, spec)
                    seen.append(tuple(out.shape))
                    return out
                st.enter_context(patched(collectives, "_gather_whole",
                                              recorded))
                if per_shard:
                    st.enter_context(patched(moe_mod, "active_region",
                                                  lambda: None))
            y, aux = moe_apply(gcfg, live, rows)
            (y ** 2).sum().backward()
            flat = moe_mod._global_routing(gcfg, live["router"],
                                           rows.reshape(-1, rows.shape[-1]))
            dropped = int((flat[3] >= gcfg.n_experts * flat[4]).sum())
        grads = []
        for k in ("router",) + experts + tuple("shared/" + s for s in shared):
            leaf = live
            for part in k.split("/"):
                leaf = leaf[part]
            grads.append(collectives._gather_whole(
                leaf.local.grad, mesh, leaf.spec)
                if isinstance(leaf, shd.Block) else leaf.grad)
        counts = torch.tensor([dropped])
        if on_mesh and data:
            y = collectives._gather_whole(y.detach(), mesh, (data, None, None))
            collectives.reduce_sum_(grads + [counts], mesh, data)
        return (y.detach(), aux.detach(), grads, int(counts),
                any(sh in whole_shapes for sh in seen),
                [tuple(live[k].local.shape) if isinstance(live[k], shd.Block)
                 else None for k in experts])

    want_y, want_aux, want_g, want_drop, _, _ = run_global(False)
    y, aux, g, drop, gathered, held_shapes = run_global(True)
    wy, waux, wg, _, _, _ = run_global(True, blocked=False)
    bad_y, bad_aux, _, bad_drop, _, _ = run_global(True, per_shard=True)
    key = f"{mname}/global"
    report["moe"][key] = {
        "err": (y - want_y).abs().max().item(),
        "aux": abs(aux - want_aux).item(),
        "grad": max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(g, want_g)),
        "blocked_equal": torch.equal(y, wy) and torch.equal(aux, waux)
        and all(torch.equal(a, b) for a, b in zip(g, wg)),
        "dropped": drop, "dropped_no_mesh": want_drop,
        "dropped_per_shard": bad_drop,
        "planted": max((bad_y - want_y).abs().max().item(),
                       abs(bad_aux - want_aux).item()),
        "gathered_whole": gathered, "held": held_shapes,
        "experts": gcfg.n_experts}
    on_ranks(f"{key}/moe", [y, aux] + g)

    # a train step on the (2, 2) mesh whose data shards count unequal
    # tokens (labels ignored on the first shard's rows): the aux loss's
    # router gradient against the no-mesh step's
    if data:
        name = "llama4-maverick-400b-a17b"
        model = build_model(cfg_of(name))
        labels = tokens.clone()
        labels[:B // 2, :S // 2 + 3] = IGNORE_LABEL
        batch = {"tokens": tokens, "labels": labels}
        fn = _data_parallel(_value_and_grad(make_loss_fn(
            model, TrainStepConfig(ce_seq_chunk=8))), model)
        (l0, m0), g0 = fn(weights(name), batch)
        with shd.use_mesh(mesh, rules):
            (l1, m1), g1 = fn(weights(name), batch)
        r0 = [leaf for path, leaf in _paths(g0) if path.endswith("router")]
        r1 = [leaf for path, leaf in _paths(g1) if path.endswith("router")]
        report["unequal"] = {
            "loss": rel(l1, l0), "aux": rel(m1["aux"], m0["aux"]),
            "router": rel(r1, r0), "grads": rel(g1, g0), "routers": len(r0)}
        on_ranks("unequal", [l1, g1])

        # the same step under fsdp on blocks: the experts' products on
        # their blocks of d, their gradients the whole batch's; and with
        # the cotangents entering the experts' all-gather unweighted
        frules = shd.train_rules(fsdp=True)

        def fsdp_grads():
            held = shd.shard_tree(weights(name), shd.tree_shardings(
                model.param_specs(), mesh, frules), mesh)
            with shd.use_mesh(mesh, frules):
                (l, _), g = fn(held, batch)
            g = module.tree_map(lambda x, p: p.with_local(x)
                                if isinstance(p, shd.Block) else x, g, held)
            return l, shd.gather_tree(g)

        class Unweighted:
            def __init__(self, real):
                self.real = real

            def __getattr__(self, key):
                return getattr(self.real, key)

            def gather_weighted(self, t, m, names, dim, weight):
                return self.real.gather_weighted(t, m, names, dim,
                                                 torch.ones_like(weight))

        ways = []
        real_blocks = moe_mod._experts_on_embed_blocks

        def on_blocks(*args):
            ways.append(args[3])
            return real_blocks(*args)

        with patched(moe_mod, "_experts_on_embed_blocks", on_blocks):
            l2, g2 = fsdp_grads()
        with patched(moe_mod, "collectives", Unweighted(collectives)):
            _, g3 = fsdp_grads()
        report["unequal_fsdp"] = {
            "loss": rel(l2, l0), "grads": rel(g2, g0),
            "ways": sorted(set(ways)), "planted": rel(g3, g0)}
        on_ranks("unequal_fsdp", [l2, g2])
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds, started together once the JAX references are made:
    {world: (arrays, report)} and the JAX logits and tokens."""
    tmp = tmp_path_factory.mktemp("tp_recurrent")
    inputs = tmp / "inputs.npz"
    dtypes, want = _inputs(inputs, ARCHS)
    (tmp / "dtypes.json").write_text(json.dumps(dtypes))
    procs = {}
    for world in MESHES:
        script = port_script(WORLD_ARCHS[world], EXTRA)
        procs[world] = [subprocess.Popen(
            [sys.executable, "-c", script, str(inputs),
             str(tmp / "dtypes.json"), str(tmp / f"port{world}.npz"),
             str(tmp / f"port{world}.json"), str(r), str(world),
             f"file://{tmp / f'rendezvous{world}'}", str(GROUP_TIMEOUT_S)],
            env=ENV, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
    deadline = time.monotonic() + DEADLINE_S
    cells = _dryrun_cells()          # while the worlds run
    out = {}
    for world, ps in procs.items():
        for r, (rc, _, err) in enumerate(_wait_all(ps, deadline)):
            assert rc == 0, f"world {world} rank {r} exited {rc}: " \
                            f"{err[-3000:]}"
        out[world] = (dict(np.load(tmp / f"port{world}.npz")),
                      json.loads((tmp / f"port{world}.json").read_text()))
    return out, want, cells


CASES = [(w, m, a) for w in MESHES for m in MESHES[w]
         for a in WORLD_ARCHS[w]]
IDS = [f"{w}-{m}-{a}" for w, m, a in CASES]
MESH_CASES = [(w, m) for w in MESHES for m in MESHES[w]]


def _report(runs, world):
    return runs[0][world][1]


@pytest.mark.parametrize("what", ["forward"] + [f"decode{i}"
                                                for i in range(STEPS)])
@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_recurrent_logits_match_jax(runs, world, mesh, arch, what):
    got = runs[0][world][0][f"{mesh}/{arch}/{what}"]
    want = runs[1][f"{arch}/{what}"]
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= REL, err


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_recurrent_decode_tokens_equal(runs, world, mesh, arch):
    """Prefill + 3 greedy steps: the JAX package's tokens, and the no-mesh
    run's."""
    got = runs[0][world][0][f"{mesh}/{arch}/tokens"]
    np.testing.assert_array_equal(got, runs[1][f"{arch}/tokens"])
    np.testing.assert_array_equal(
        got, runs[0][world][0][f"{mesh}/{arch}/nomesh_tokens"])
    assert _report(runs, world)["err"][f"{mesh}/{arch}/serve_logits"] <= REL


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_recurrent_grads_match_no_mesh(runs, world, mesh, arch):
    """The loss and every gradient leaf against the no-mesh step (fsdp too
    on the (2, 2) mesh), equal on every rank."""
    rep = _report(runs, world)
    for r in ["train"] + (["fsdp"] if mesh == "2x2" else []):
        label = f"{mesh}/{arch}/{r}"
        assert rep["err"][f"{label}/loss"] <= GRAD_REL, label
        assert rep["err"][f"{label}/grads"] <= GRAD_BOUND[arch], label
        assert rep["ranks"][f"{label}/grads"], label


@pytest.mark.parametrize("what", ["forward", "grads", "step", "serve_tokens",
                                  "serve_logits", "serve_cache"])
@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_recurrent_blocked_equals_whole(runs, world, mesh, arch, what):
    rep = _report(runs, world)
    labels = [k for k in rep["equal"] if k.startswith(f"{mesh}/{arch}/")
              and k.endswith(f"/{what}")]
    assert labels
    for label in labels:
        assert rep["equal"][label] and rep["ranks"][label], label


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_backward_outside_the_frame(runs, arch):
    """The remat'ed scan steps recompute under the forward's mesh frame
    when the backward runs outside it: the gradients bit for bit."""
    rep = _report(runs, 2)
    label = f"model2/{arch}/train/outside"
    assert rep["equal"][label] and rep["ranks"][label], label


@pytest.mark.parametrize("world,mesh,arch", CASES, ids=IDS)
def test_recurrent_state_held_as_blocks(runs, world, mesh, arch):
    """The blocked cache holds hymba's ``h_ssm`` by its channels and the
    mLSTM's C, n and m by their heads over "model" (beside the KV heads,
    and the rows over "data" on the (2, 2) mesh); the sLSTM's state
    stays whole along its width."""
    specs = set(_report(runs, world)["held"][f"{mesh}/{arch}"])
    rows = "'data'" if mesh == "2x2" else "None"
    # stacked periods: the leading axis is the layers'
    want = {
        "hymba-1.5b": {f"(None, {rows}, None, 'model', None)",
                       f"(None, {rows}, 'model', None)"},
        "xlstm-1.3b": {f"(None, {rows}, 'model', None, None)",
                       f"(None, {rows}, 'model', None)",
                       f"(None, {rows}, 'model')"}
        | ({f"(None, {rows}, None)"} if mesh == "2x2" else set()),
        "llama4-maverick-400b-a17b": {
            f"(None, {rows}, None, 'model', None)"},
    }[arch]
    assert specs == want, specs


@pytest.mark.parametrize("world,mesh", MESH_CASES)
def test_take_parts_against_a_hand_cut(runs, world, mesh):
    got = _report(runs, world)["parts"][mesh]
    assert got["whole"] and got["held"] and got["grad"], got
    assert not got["contiguous"], "a contiguous cut passed the hand check"


@pytest.mark.parametrize("dispatch", ["local", "shardmap", "global"])
@pytest.mark.parametrize("world,mesh", MESH_CASES)
def test_moe_shared_expert_on_blocks(runs, world, mesh, dispatch):
    """The local and shard_map dispatches against ``moe_reference``; the
    global one (experts held as blocks over "model", inside a
    data-parallel region of the rows on the (2, 2) mesh) against the
    port's no-mesh ``moe_apply``, with (token, slot)s dropped, each rank's
    experts a block never gathered whole, and the per-shard routing
    planted above the bound."""
    rep = _report(runs, world)
    got = rep["moe"][f"{mesh}/{dispatch}"]
    assert got["err"] <= MOE_TOL and got["grad"] <= MOE_TOL, got
    assert got["blocked_equal"], got
    assert rep["ranks"][f"{mesh}/{dispatch}/moe"]
    if dispatch != "global":
        return
    assert got["aux"] <= MOE_TOL, got
    assert got["dropped"] >= 1 and got["dropped"] == got["dropped_no_mesh"]
    model_n = 2
    assert all(shape[0] == got["experts"] // model_n
               for shape in got["held"]), got
    assert not got["gathered_whole"], got
    if mesh == "2x2":
        assert got["dropped_per_shard"] != got["dropped"], got
        assert got["planted"] > MOE_TOL, got


def test_moe_aux_gradient_with_unequal_shards(runs):
    """A train step on the (2, 2) mesh whose data shards count unequal
    tokens: the loss, the aux loss and the router's gradient (through the
    whole batch's aux loss) against the no-mesh step's."""
    got = _report(runs, 4)["unequal"]
    assert got["routers"] >= 1, got
    assert got["loss"] <= GRAD_REL and got["aux"] <= GRAD_REL, got
    assert got["router"] <= GRAD_REL, got
    assert got["grads"] <= GRAD_BOUND["llama4-maverick-400b-a17b"], got
    assert _report(runs, 4)["ranks"]["unequal"]


def test_moe_experts_on_embed_blocks_with_unequal_shards(runs):
    """The same step under ``train_rules(fsdp=True)`` on blocks: the
    experts run on their blocks of d (held over "model" and "data"), and
    the loss and every gradient leaf match the no-mesh step's; with the
    cotangents entering the experts' all-gather unweighted (planted) the
    gradients land above the bound."""
    got = _report(runs, 4)["unequal_fsdp"]
    assert got["ways"] == ["held"], got
    assert got["loss"] <= GRAD_REL, got
    assert got["grads"] <= GRAD_BOUND["llama4-maverick-400b-a17b"], got
    assert got["planted"] > MOE_TOL, got
    assert _report(runs, 4)["ranks"]["unequal_fsdp"]


# --------------------------------------------------------------------------
# the dry-run: hymba-1.5b train_4k at pod16x16, cut to 2 layers
# --------------------------------------------------------------------------

DRYRUN_LAYERS = 2
B_RANK, SEQ, D, N_STATE, RANKS = 16, 4096, 1600, 16, 16
CHUNK = 1024


def _dryrun_cells():
    """The cell, and the same with the SSM whole (``ssm_axes`` ()): the
    results and their op counters."""
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer

    full = dryrun.get_arch
    counters = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "get_arch", lambda name: dataclasses.replace(
            full(name), n_layers=DRYRUN_LAYERS))
        split = dryrun.run_cell("hymba-1.5b", "train_4k", verbose=False,
                                counter_out=counters)
        mp.setattr(transformer, "split_axes", lambda *a: ())
        whole = dryrun.run_cell("hymba-1.5b", "train_4k", verbose=False,
                                counter_out=counters)
    return split, whole, counters


def test_dryrun_ssm_scan_on_blocks(runs):
    """The SSM scan's [B, chunk, channels, state] tensors are a rank's 100
    of 1600 channels, none whole; whole in the cell with the SSM whole."""
    _, _, (split, whole) = runs[2]
    block = f"[{B_RANK},{CHUNK},{D // RANKS},{N_STATE}]"
    full = f"[{B_RANK},{CHUNK},{D},{N_STATE}]"
    shapes = {shape for _, shape in split.traffic}
    assert any(s.endswith(block) for s in shapes)
    assert not any(s.endswith(full) for s in shapes)
    assert any(s.endswith(full) for _, s in whole.traffic)


# the SSM products' passes whose output has a rank's 100 channels, with
# their calls a layer: ssm_in's forward (and the period's recompute) and
# its weight gradient, w_dt_proj's the same in fp32, ssm_out's input and
# weight gradients; beside ssm_in's and ssm_out's weight gradients, the
# attention's wo and wq gradients on a rank's 100 of d (its 25 heads of
# 64 stay whole: collectives.whole_product), the same [1600, 100] and
# [100, 1600] products
SSM_KEYS = {("aten.mm", f"bf16[{B_RANK * SEQ},{D // RANKS}]"): 3,
            ("aten.mm", f"f32[{B_RANK * SEQ},{D // RANKS}]"): 2,
            ("aten.mm", f"bf16[{D},{D // RANKS}]"): 2,
            ("aten.mm", f"bf16[{D // RANKS},{D}]"): 2,
            ("aten.mm", f"f32[{D},{D // RANKS}]"): 1}


def test_dryrun_ssm_flops_a_sixteenth(runs):
    """ssm_in, w_dt_proj and ssm_out count 1/16 of a [B*S, D] x [D, D]
    product's FLOPs a pass; the cell's total falls by the other 15/16 of
    them and of the scan's einsum with C, worked out from the shapes: per
    layer the three products 2*B*S*D*D each, four passes (the forward, the
    period's recompute, the backward's two products), and the einsum
    2*B*S*D*N five (the chunk step's recompute besides)."""
    split, whole, (cs, _) = runs[2]
    product = 2 * B_RANK * SEQ * D * D
    for key, calls in SSM_KEYS.items():
        assert cs.flops[key] == DRYRUN_LAYERS * calls * product // RANKS, key
    per_layer = 4 * 3 * product + 5 * 2 * B_RANK * SEQ * D * N_STATE
    want = DRYRUN_LAYERS * per_layer * (RANKS - 1) // RANKS
    got = whole["per_device_flops"] - split["per_device_flops"]
    assert got == want, (got, want)
    assert split["memory_per_device_bytes"]["total_bytes"] \
        < whole["memory_per_device_bytes"]["total_bytes"]
