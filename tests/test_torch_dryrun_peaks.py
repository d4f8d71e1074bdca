"""Two dry-run cells at ``pod16x16``, cut to 1 layer, whose peak a rank
the port held above the JAX package's: yi-9b ``prefill_32k`` (the norm's
fp32 [rows, d] buffers beside its result, and the block's dead norm and
attention outputs held through the FFN) and internvl2-26b ``train_4k``
(its table's gradient all-gathered as 16 received blocks beside their
concatenation).

* The peak a rank is at most the JAX package's.
* The FLOPs a rank are those counted before the repairs, to the FLOP:
  the repairs move bytes, never products.

The JAX package's figures come from ``PYTHONPATH=src python3
tests/dryrun_depth.py --package repro --arch ARCH --shape SHAPE --layers
1 --out /tmp/j.json``, the FLOPs from ``--package repro_torch`` on the
code before the repairs; both are kept as constants.  At 1 layer that
code held yi-9b's cell at 5,195,850,752 B and internvl2's at
19,312,016,944 B.
"""
import dataclasses

import pytest

# (the JAX package's total_bytes, per_device_flops before the repairs)
CELLS = {("yi-9b", "prefill_32k"): (4623851880, 6279242186752.0),
         ("internvl2-26b", "train_4k"): (24318811876, 242483837534208.0)}


@pytest.fixture(scope="module")
def results():
    from repro_torch.launch import dryrun

    full = dryrun.get_arch
    dryrun.get_arch = lambda name: dataclasses.replace(full(name),
                                                       n_layers=1)
    try:
        return {cell: dryrun.run_cell(*cell, verbose=False)
                for cell in CELLS}
    finally:
        dryrun.get_arch = full


@pytest.mark.parametrize("cell", list(CELLS), ids="/".join)
def test_peak_at_most_the_jax_package(results, cell):
    total = results[cell]["memory_per_device_bytes"]["total_bytes"]
    assert total <= CELLS[cell][0], total / CELLS[cell][0]


@pytest.mark.parametrize("cell", list(CELLS), ids="/".join)
def test_flops_unchanged_by_the_repairs(results, cell):
    assert results[cell]["per_device_flops"] == CELLS[cell][1]
