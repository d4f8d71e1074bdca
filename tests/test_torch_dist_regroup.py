"""The all-gather into one buffer (``dist.collectives._all_gather``) and
the part-wise blocks by one all-to-all (``dist.sharding.take_parts`` on a
``Block``), on a gloo world of 4 ranks.

Each rank runs ``python -c SCRIPT`` (the harness of
``tests/test_torch_dist_long.py``) on a ``("model",)`` mesh of 4:

* ``_all_gather`` of each rank's fp32 block along an outermost dimension
  ([6, 5] on 0, [1, 6, 5] on 1) and along an inner one ([6, 5] on 1):
  equal to the concatenation of every rank's block.  Under
  ``launch.dryrun.OpCounter`` over the real tensors, the outermost cases
  hold at most the input and the result (the parts are received into
  the result's views), where the list of parts and their concatenation
  (the route this one replaced, run beside it) hold the result twice.
* xlstm-1.3b at ``reduced()`` with ``n_heads=2`` (its 2 heads do not
  divide 4 ranks, so the mLSTM runs on C's value rows), fp32 params and
  compute, params held as blocks (``shard_tree``): one decode step
  (``make_prefill_step`` on 16 tokens, then ``make_serve_step``) and the
  gradients of ``make_loss_fn``'s loss, each within 2e-4 of one
  process's largest magnitude (the split steps' bound).  In the decode
  step the all-to-alls receive, per mLSTM layer, a quarter of ``w_up``
  (its core half's block and its gate half's block of each head, in one
  exchange) and a quarter of ``w_down``, and per sLSTM layer a quarter
  of ``w_gates``: to the byte, 1/n of each leaf.  No all-gather, in the decode step or the
  training step, returns one of those leaves whole.
"""
import json
import subprocess
import sys
import textwrap
import time

import pytest

from test_torch_dist_blocked import ENV, _wait_all

DEADLINE_S = 240
GROUP_TIMEOUT_S = 120
WORLD = 4
ARCH = "xlstm-1.3b"
B, PROMPT = 2, 16
TOL = 2e-4            # the split steps' bound

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dist import collectives, compat
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model, module
    from repro_torch.serve.decode import make_prefill_step, make_serve_step
    from repro_torch.train import step as train_step

    ARCH, WORLD, B, PROMPT = %r, %r, %r, %r
    rank = int(sys.argv[2])
    compat.init_process_group("cpu", init_method=sys.argv[3], rank=rank,
                              world_size=WORLD, timeout_s=float(sys.argv[4]))
    mesh = compat.make_mesh((WORLD,), ("model",))
    report = {"gather": {}}

    def part(r, shape):
        n = int(np.prod(shape))
        return torch.arange(n, dtype=torch.float32).reshape(shape) + 1000 * r

    def list_and_cat(t, dim):
        parts = [torch.empty_like(t) for _ in range(WORLD)]
        dist.all_gather(parts, t, group=mesh.get_group("model"))
        return torch.cat(parts, dim=dim)

    for name, shape, dim in (("outer0", (6, 5), 0), ("outer1", (1, 6, 5), 1),
                             ("inner", (6, 5), 1)):
        t = part(rank, shape)
        want = torch.cat([part(r, shape) for r in range(WORLD)], dim=dim)
        peaks = []
        for fn in (lambda: collectives._all_gather(t, mesh, "model", dim),
                   lambda: list_and_cat(t, dim)):
            counter = dryrun.OpCounter()
            counter.track(t)
            with counter:
                out = fn()
            peaks.append(counter.peak_bytes)
        report["gather"][name] = {
            "equal": bool(torch.equal(out, want)),
            "in": t.numel() * 4, "out": want.numel() * 4,
            "peak": peaks[0], "list_peak": peaks[1]}

    cfg = dataclasses.replace(configs.ARCHS[ARCH].reduced(), n_heads=2,
                              compute_dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    whole = model.init_params(torch.Generator().manual_seed(0), device="cpu")

    def blocked(rules):
        return shd.shard_tree(whole, shd.tree_shardings(
            model.param_specs(), mesh, rules), mesh)

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    moved = []
    real_a2a, real_gather = collectives._all_to_all, collectives._all_gather

    def a2a(t, *args):
        out = real_a2a(t, *args)
        moved.append(("a2a", list(out.shape), out.numel() * out.element_size()))
        return out

    def gather(t, *args):
        out = real_gather(t, *args)
        moved.append(("gather", list(out.shape),
                      out.numel() * out.element_size()))
        return out

    collectives._all_to_all, collectives._all_gather = a2a, gather

    # one decode step after a prefill, blocked params, against one process
    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        1, 256, (B, PROMPT)).astype(np.int32))
    prefill = make_prefill_step(model, PROMPT + 1)
    serve = make_serve_step(model)
    with torch.no_grad():
        tok, cache = prefill(whole, {"tokens": prompt})
        _, want, _ = serve(whole, cache, tok, PROMPT)
        rules = shd.serve_rules()
        params = blocked(rules)
        with shd.use_mesh(mesh, rules):
            tok, cache = prefill(params, {"tokens": prompt})
            del moved[:]
            _, got, _ = serve(params, cache, tok, PROMPT)
    report["decode"] = {"err": err(got, want), "moved": list(moved)}

    # the loss's gradients, blocked params, against one process
    batch = batch_at(DataConfig(cfg.vocab_size, PROMPT, B), 0, device="cpu")
    grad_fn = train_step._value_and_grad(train_step.make_loss_fn(
        model, train_step.TrainStepConfig()))
    (want_loss, _), want_grads = grad_fn(whole, batch)
    rules = shd.train_rules()
    params = blocked(rules)
    del moved[:]
    with shd.use_mesh(mesh, rules):
        (loss, _), grads = grad_fn(params, batch)
    grads = shd.gather_tree(module.tree_map(
        lambda g, p: p.with_local(g) if isinstance(p, shd.Block) else g,
        grads, params))
    report["train"] = {
        "loss": abs(float(loss) - float(want_loss)) / abs(float(want_loss)),
        "grads": max(err(g, w) for g, w in zip(module.leaves(grads),
                                               module.leaves(want_grads))),
        "moved": list(moved)}
    collectives._all_to_all, collectives._all_gather = real_a2a, real_gather

    # the leaves take_parts regroups: their whole shapes and bytes
    def leaf(name):
        layer = model.param_specs()["stack"]["scan"][
            "p0" if name != "w_gates" else "p7"]
        spec = layer[name]
        return list(spec.shape[1:]), int(np.prod(spec.shape[1:])) * 4
    report["leaves"] = {n: leaf(n) for n in ("w_up", "w_down", "w_gates")}
    report["pattern"] = list(cfg.layer_pattern)

    if rank == 0:
        with open(sys.argv[1], "w") as fh:
            json.dump(report, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
""") % (ARCH, WORLD, B, PROMPT)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_regroup")
    out = tmp / "report.json"
    procs = [subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(out), str(r),
         f"file://{tmp / 'rendezvous'}", str(GROUP_TIMEOUT_S)],
        env=ENV, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    deadline = time.monotonic() + DEADLINE_S
    for r, (rc, _, err) in enumerate(_wait_all(procs, deadline)):
        assert rc == 0, f"rank {r} exited {rc}: {err[-3000:]}"
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", ["outer0", "outer1", "inner"])
def test_all_gather_equals_the_concatenation(report, case):
    assert report["gather"][case]["equal"], report["gather"][case]


@pytest.mark.parametrize("case", ["outer0", "outer1"])
def test_all_gather_holds_no_parts_beside_the_result(report, case):
    got = report["gather"][case]
    assert got["peak"] <= got["in"] + got["out"], got
    assert got["list_peak"] >= got["in"] + 2 * got["out"], got


def test_value_rows_decode_step_matches_one_process(report):
    assert report["decode"]["err"] <= TOL, report["decode"]["err"]


def test_value_rows_grads_match_one_process(report):
    train = report["train"]
    assert train["loss"] <= TOL and train["grads"] <= TOL, train


def test_decode_receives_a_quarter_of_each_leaf(report):
    """w_up/4 + w_down/4 a mLSTM layer, w_gates/4 a sLSTM layer."""
    leaves = {n: b for n, (_, b) in report["leaves"].items()}
    kinds = report["pattern"]
    want = (kinds.count("mlstm") * (leaves["w_up"] + leaves["w_down"])
            // WORLD
            + kinds.count("slstm") * leaves["w_gates"] // WORLD)
    got = sum(n for kind, _, n in report["decode"]["moved"]
              if kind == "a2a")
    assert got == want, (got, want)


@pytest.mark.parametrize("step", ["decode", "train"])
def test_no_leaf_gathered_whole(report, step):
    whole = [shape for shape, _ in report["leaves"].values()]
    moved = report[step]["moved"]
    assert any(kind == "a2a" for kind, _, _ in moved), moved
    gathered = [shape for kind, shape, _ in moved if kind == "gather"]
    assert not [s for s in gathered if s in whole], gathered
