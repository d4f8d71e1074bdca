"""The one KV head a rank beside split q heads, in the dry-run: yi-9b
``train_4k`` at 2 layers on the fake group of ``pod16x16`` (B = 256,
S = 4096; 16 data by 16 model ranks), whose 32 q heads split over the 16
model ranks (2 a rank) while its 4 KV heads stay whole.

Each rank projects only the KV head its q heads read
(``models.attention._kv_one_head``).  Against the same cell with every KV
head projected and the rank's one read afterwards (the projection before
this layout, patched in):

* k's and v's products (the forward and the period's recompute, [rows,
  KV·hd] against [rows, hd], and their weights' gradients, [d, KV·hd]
  against [d, hd]) count exactly 1/KV of the whole ones;
* the cell's total falls by the other (KV-1)/KV of them and of their
  inputs' gradients (4 products of a size a projection, 3 of them in
  those keys), and by nothing else;
* the cell counts at most 1.005x the JAX package's FLOPs (about 0.91x: the
  reference's partitioner projects part of k and v on every rank).  Its
  figure, from ``PYTHONPATH=src python3 tests/dryrun_depth.py --package
  repro --arch yi-9b --shape train_4k --layers 2 --out /tmp/j.json``, is
  kept as a constant.
"""
import dataclasses

import pytest

ARCH, LAYERS = "yi-9b", 2
JAX_FLOPS = 24827831526999.0       # the command above
HIGH = 1.005
KV, HD, D = 4, 128, 4096
ROWS = 16 * 4096                   # a data rank's batch rows x tokens


def _whole_kv(cfg, params, src, heads):
    """Every KV head projected, the rank's one read afterwards."""
    from repro_torch.dist.sharding import take
    from repro_torch.models import attention

    return tuple(attention._kv_for_heads(
        attention._project(src, take(params[w])), cfg.n_heads, heads)
        for w in ("wk", "wv"))


@pytest.fixture(scope="module")
def cells():
    """((cell, counter), (cell, counter) with every KV head projected)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import attention

    full = dryrun.get_arch
    out = []
    for whole in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dryrun, "get_arch", lambda name: dataclasses.replace(
                full(name), n_layers=LAYERS))
            if whole:
                mp.setattr(attention, "_kv_one_head", _whole_kv)
            counters = []
            cell = dryrun.run_cell(ARCH, "train_4k", verbose=False,
                                   counter_out=counters)
            out.append((cell, counters[0]))
    return out


def _kv_products(counter, heads: int) -> int:
    return sum(counter.flops.get(("aten.mm", f"bf16[{n},{heads * HD}]"), 0)
               for n in (ROWS, D))


def test_kv_products_a_kv_th_of_the_whole(cells):
    (cell, one), (whole_cell, whole) = cells
    mine, every = _kv_products(one, 1), _kv_products(whole, KV)
    assert mine > 0 and mine * KV == every, (mine, every)
    assert _kv_products(one, KV) == 0
    fell = whole_cell["per_device_flops"] - cell["per_device_flops"]
    assert fell * 3 == (every - mine) * 4, (fell, every - mine)


def test_flops_at_most_the_jax_package(cells):
    (cell, _), _ = cells
    ratio = cell["per_device_flops"] / JAX_FLOPS
    assert ratio <= HIGH, ratio
