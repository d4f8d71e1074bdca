"""The dry-run's FLOPs a rank against the JAX package's, at full width on
the fake group of ``pod16x16`` (``train_4k``: B = 256, S = 4096; 16 data
by 16 model ranks), with llama4-maverick-400b-a17b and hymba-1.5b cut to
2 layers (``tests/dryrun_depth.py``'s cut).

* The weights' gradients of layers that stay whole on every model rank
  (llama4's 40 heads and 8 KV heads, hymba's 25 heads and 5 KV heads and
  its vocabulary of 32001, none of which divides 16) are computed on a
  rank's block of d (``collectives.whole_product``): against the same
  cell with that op the plain product, those products count exactly 1/16
  of the whole ones, and the cell's total falls by the other 15/16 of
  them and nothing else.
* The chunked attention's recompute in the backward runs no p.v product
  (``attention._ProbsV``): per (q block, KV chunk) tile, the [., q_chunk,
  dh] products (the p.v forward, again in the period's recompute, and
  dq) count exactly 3/4 of the [., q_chunk, k_chunk] products (q.k in
  the forward and both recomputes, and dp).
* Each cell lands between 0.98x and 1.005x the JAX package's count.  The
  port counts products only, the JAX package's HLO also its fused
  elementwise FLOPs.  Its counts, from ``PYTHONPATH=src python3
  tests/dryrun_depth.py --package repro --arch ARCH --shape train_4k
  --layers 2 --out /tmp/j.json``, are kept as constants.
* ``attend_chunked``'s gradients are equal bit for bit with the recompute
  computing p.v and without, and without it the recompute's FLOPs fall.
"""
import dataclasses

import numpy as np
import pytest
import torch

LAYERS, RANKS = 2, 16
# the JAX package's per_device_flops at 2 layers (command above)
JAX_FLOPS = {"llama4-maverick-400b-a17b": 1.47923575541528e14,
             "hymba-1.5b": 4.3548093304352e13}
LOW, HIGH = 0.98, 1.005
# (d, q heads x head dim, KV heads x head dim, the vocabulary where it
# stays whole, else None) a model
WIDTHS = {"llama4-maverick-400b-a17b": (5120, 40 * 128, 8 * 128, None),
          "hymba-1.5b": (1600, 25 * 64, 5 * 64, 32001)}
# (batch x heads a rank, q_chunk, k_chunk, head dim) of the chunked
# attention's tiles
TILES = {"llama4-maverick-400b-a17b": (16 * 40, 512, 1024, 128),
         "hymba-1.5b": (16 * 25, 512, 1024, 64)}
ARCHS = list(JAX_FLOPS)


def _plain(x, w, mesh, names, dim):
    return torch.matmul(x, w)


@pytest.fixture(scope="module")
def cells():
    """{arch: ((cell, counter), (cell, counter) with the whole layers'
    weight gradients whole)}."""
    from repro_torch.dist import collectives
    from repro_torch.launch import dryrun

    full = dryrun.get_arch
    out = {}
    for arch in ARCHS:
        pair = []
        for whole in (False, True):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(dryrun, "get_arch", lambda name: dataclasses
                           .replace(full(name), n_layers=LAYERS))
                if whole:
                    mp.setattr(collectives, "whole_product", _plain)
                counters = []
                cell = dryrun.run_cell(arch, "train_4k", verbose=False,
                                       counter_out=counters)
                pair.append((cell, counters[0]))
        out[arch] = tuple(pair)
    return out


def _gradients(arch, blocks: int) -> set:
    """The whole layers' weight-gradient products' (op, output shape), on
    blocks of d/``blocks``: wq's and wk's/wv's [d, .] and wo's [., d], and
    the unembedding table's [d, V] in fp32 (whole, torch's product for the
    table's transpose gives it as [V, d])."""
    d, q, kv, vocab = WIDTHS[arch]
    r = d // blocks
    keys = {("aten.mm", f"bf16[{r},{q}]"), ("aten.mm", f"bf16[{r},{kv}]"),
            ("aten.mm", f"bf16[{q},{r}]")}
    if vocab:
        keys |= {("aten.mm", f"f32[{r},{vocab}]"),
                 ("aten.mm", f"f32[{vocab},{r}]")}
    return keys


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_layers_weight_gradients_a_sixteenth(cells, arch):
    """The products on blocks (what the cell adds over the plain one's at
    those shapes: hymba's SSM runs some of them too) come to exactly 1/16
    of the whole products the plain cell runs, and the totals differ by
    the other 15/16 of them."""
    (cell, split), (plain_cell, plain) = cells[arch]

    def added(a, b, keys):
        return sum(a.flops.get(k, 0) - b.flops.get(k, 0) for k in keys)

    blocks = added(split, plain, _gradients(arch, RANKS))
    whole = added(plain, split, _gradients(arch, 1))
    assert blocks > 0 and blocks * RANKS == whole, (blocks, whole)
    fell = plain_cell["per_device_flops"] - cell["per_device_flops"]
    assert fell == whole - blocks, (fell, whole - blocks)


@pytest.mark.parametrize("arch", ARCHS)
def test_recompute_runs_no_dead_product(cells, arch):
    (_, split), _ = cells[arch]
    bh, qc, kc, dh = TILES[arch]
    pv = split.flops[("aten.bmm", f"bf16[{bh},{qc},{dh}]")]
    qk = split.flops[("aten.bmm", f"bf16[{bh},{qc},{kc}]")]
    assert qk > 0 and pv * 4 == qk * 3, (pv, qk)


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_against_the_jax_package(cells, arch):
    (cell, _), _ = cells[arch]
    ratio = cell["per_device_flops"] / JAX_FLOPS[arch]
    assert LOW <= ratio <= HIGH, ratio


def _attend_grads(skip: bool):
    from repro_torch.launch import dryrun
    from repro_torch.models import attention

    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 200, 2, 8).astype(np.float32))
               .requires_grad_() for _ in range(3))
    counter = dryrun.OpCounter()
    with pytest.MonkeyPatch.context() as mp:
        if not skip:
            mp.setattr(attention, "recomputing", lambda: False)
        with counter:
            out = attention.attend_chunked(q, k, v, causal=True, window=96,
                                           k_chunk=32, q_chunk=64)
            grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    return grads, sum(counter.flops.values())


def test_attend_chunked_gradients_equal_without_the_dead_product():
    got, flops = _attend_grads(skip=True)
    want, plain_flops = _attend_grads(skip=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert flops < plain_flops, (flops, plain_flops)
