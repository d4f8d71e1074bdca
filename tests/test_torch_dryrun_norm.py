"""AdamW's global norm summed one period at a time: no stacked gradient is
ever whole on a rank.

* llama4-maverick-400b-a17b ``train_4k`` at full width on the fake group
  of ``pod16x16``, cut to 4 of 48 layers (two periods of one attention
  and one MoE layer), against the same cell with ``global_norm`` the
  whole-leaf gather it replaced: the peak a rank is lower, no tensor of
  the whole stacked expert ``w_down`` shape [2, 128, 8192, 5120] appears
  (in the old cell its gather and fp32 copy do), and the FLOPs are equal.
* The same cell with the experts gathered over "data" in each period
  (``region_period``; their blocks of d undone, ``moe._embed_specs``
  None) against one whose data-parallel region gathers the fsdp leaves
  whole over "data" before the layer stack (``region_period`` the
  identity in it, ``region_params`` taking the stacked leaves too): the
  peak a rank is lower, and no stacked expert leaf of a rank's 8
  experts, or its gradient, appears whole over "data" ([2, 8, 8192,
  5120] and [2, 8, 5120, 8192]; the old cell makes both, the cell with
  the experts on their blocks of d neither), at equal FLOPs.
* On a gloo world of 2: ``global_norm`` over blocks (a stacked leaf split
  on dim 1, an unstacked leaf split on dim 0, an unsplit stacked leaf)
  equals the norm over the whole leaves bit for bit, with chunks of a few
  rows; the same with one period's sum left out differs.
"""
import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from test_torch_dist_blocked import ENV, _wait_all

LAYERS = 4
W_DOWN = "2,128,8192,5120"      # the two periods' experts, whole


def _whole_leaf_norm(tree, like=None):
    """The norm as it was: each split leaf gathered whole at once, its
    fp32 copy and its square whole beside it."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import Block
    from repro_torch.models.module import leaves

    blocks = leaves(like) if like is not None else [None] * len(
        leaves(tree))
    total = 0
    for leaf, held in zip(leaves(tree), blocks):
        if isinstance(held, Block):
            leaf = collectives._gather_whole(leaf, held.mesh, held.spec)
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


@pytest.fixture(scope="module")
def cells():
    """(cell, op counter) with the norm by periods, the same with the
    whole-leaf norm, the same with the fsdp leaves gathered whole over
    "data" as the step begins, and the same with the experts gathered
    over "data" one period at a time (their blocks of d undone)."""
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models import moe, transformer
    from repro_torch.optim import adamw
    from repro_torch.train import step

    full = dryrun.get_arch
    out = []
    for old in ("", "norm", "gather", "period"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dryrun, "get_arch", lambda name: dataclasses.replace(
                full(name), n_layers=LAYERS))
            if old == "norm":
                mp.setattr(adamw, "global_norm", _whole_leaf_norm)
            if old == "gather":
                mp.setattr(transformer, "region_period", lambda tree: tree)
                mp.setattr(step, "region_params", sharding.region_period)
            if old == "period":
                # the experts gathered over "data" in the period
                # (region_period) and run on the whole d, as the gather
                # cell runs them
                mp.setattr(moe, "_embed_specs", lambda *a: None)
            counters = []
            cell = dryrun.run_cell("llama4-maverick-400b-a17b", "train_4k",
                                   verbose=False, counter_out=counters)
            out.append((cell, counters[0]))
    return tuple(out)


def _shapes(counter) -> set:
    return {shape for _, shape in counter.traffic}


def test_norm_peak_lower(cells):
    (new, _), (old, _), _, _ = cells
    got = new["memory_per_device_bytes"]["total_bytes"]
    was = old["memory_per_device_bytes"]["total_bytes"]
    assert got < was, (got, was)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_norm_no_whole_stacked_expert_gradient(cells, dtype):
    """Neither the gathered stacked ``w_down`` gradient nor its fp32 copy
    is ever made; the whole-leaf norm makes both."""
    (_, new), (_, old), _, _ = cells
    shape = f"{dtype}[{W_DOWN}]"
    assert shape not in _shapes(new)
    assert shape in _shapes(old)


def test_norm_flops_equal(cells):
    (new, _), (old, _), _, _ = cells
    assert new["per_device_flops"] == old["per_device_flops"]


def test_region_period_peak_lower(cells):
    _, _, (old, _), (new, _) = cells
    got = new["memory_per_device_bytes"]["total_bytes"]
    was = old["memory_per_device_bytes"]["total_bytes"]
    assert got < was, (got, was)


@pytest.mark.parametrize("shape", ["bf16[2,8,8192,5120]",
                                   "bf16[2,8,5120,8192]"])
def test_region_period_no_stacked_expert_whole_over_data(cells, shape):
    """A rank's stacked expert leaves (``w_down``, and ``w_up``/``w_gate``)
    at the whole d = 5120: the region gathers them, and sums their
    gradients, one period at a time; gathered before the stack, both the
    leaf and its gradient are made whole."""
    (_, cell), _, (_, old), (_, new) = cells
    assert shape not in _shapes(new) | _shapes(cell)
    assert shape in _shapes(old)


def test_region_period_flops_equal(cells):
    _, _, (old, _), (new, _) = cells
    assert new["per_device_flops"] == old["per_device_flops"]


RANK_SCRIPT = r"""
import json, sys
import torch
from repro_torch.dist import compat
from repro_torch.dist.sharding import Block
from repro_torch.optim import adamw

rank, world, url, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
device = compat.init_process_group("cpu", backend="gloo", init_method=url,
                                   rank=rank, world_size=world, timeout_s=60)
mesh = compat.make_mesh((world,), ("model",))
adamw.NORM_CHUNK = 7            # a few rows a chunk
gen = torch.Generator().manual_seed(0)
whole = {"embed": torch.randn(6, 5, generator=gen).to(torch.bfloat16),
         "scan": {"p0": {"w": torch.randn(3, 8, 5, generator=gen),
                         "norm": torch.randn(3, 5, generator=gen)}}}
specs = {"embed": (("model",), None),
         "scan": {"p0": {"w": (None, ("model",), None), "norm": None}}}


def held(t, spec):
    if spec is None:
        return t
    dim = next(i for i, e in enumerate(spec) if e)
    n = t.shape[dim] // world
    return Block(t.narrow(dim, rank * n, n).clone(), spec, mesh)


like = {"embed": held(whole["embed"], specs["embed"]),
        "scan": {"p0": {k: held(whole["scan"]["p0"][k], specs["scan"]["p0"][k])
                        for k in ("w", "norm")}}}
grads = {"embed": like["embed"].local,
         "scan": {"p0": {"w": like["scan"]["p0"]["w"].local,
                         "norm": like["scan"]["p0"]["norm"]}}}
want = adamw.global_norm(whole)
got = adamw.global_norm(grads, like=like)
real = adamw._whole
seen = []


def skip_period(t, held, spec):
    # the planted fault: the stacked split leaf's second period left out
    if isinstance(held, Block) and held.spec[0] is None and len(spec) == 2:
        seen.append(t)
        if len(seen) == 2:
            return torch.zeros_like(real(t, held, spec))
    return real(t, held, spec)


adamw._whole = skip_period
try:
    bad = adamw.global_norm(grads, like=like)
finally:
    adamw._whole = real
json.dump({"equal": bool(torch.equal(got, want)), "want": want.item(),
           "got": got.item(), "bad": bad.item(),
           "bad_differs": not bool(torch.equal(bad, want)),
           "plain": bool(torch.allclose(want, torch.sqrt(sum(
               torch.sum(torch.square(t.float())) for t in (
                   whole["embed"], whole["scan"]["p0"]["w"],
                   whole["scan"]["p0"]["norm"]))), rtol=1e-6))},
          open(f"{out}.{rank}.json", "w"))
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("norm")
    world = 2
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
         f"file://{tmp / 'rendezvous'}", str(tmp / "rank")],
        env=ENV, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    for r, (rc, _, err) in enumerate(_wait_all(procs,
                                               time.monotonic() + 120)):
        assert rc == 0, f"rank {r} exited {rc}: {err[-3000:]}"
    return [json.loads((tmp / f"rank.{r}.json").read_text())
            for r in range(world)]


@pytest.mark.parametrize("rank", [0, 1])
def test_norm_blocks_equal_whole_bit_for_bit(gloo, rank):
    rep = gloo[rank]
    assert rep["equal"], rep
    assert rep["plain"], rep


@pytest.mark.parametrize("rank", [0, 1])
def test_norm_period_skipped_differs(gloo, rank):
    rep = gloo[rank]
    assert rep["bad_differs"] and rep["bad"] < rep["want"], rep
