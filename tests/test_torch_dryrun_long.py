"""The long-context decode cell (``long_500k``: B = 1, 524288 cached
positions, ``serve_rules(long_context=True)``) of the dry-run at full
depth on the fake group of ``pod16x16``, against the JAX package's.

Each rank holds its block of every KV cache leaf's sequence (32768 of the
524288 positions: ``cache_shardings`` splits ``cache_seq`` over
``model``) and the decode step attends on it for every head, merging the
softmax stats over the axis (``models.attention.attention_decode_step``).

* The cache's bytes a rank are exactly 1/16 of the whole cache's.
* The attention's products a rank (the scores over the block and p·v)
  are exactly the JAX package's dot FLOPs, and the cell's total is at
  most 1.05x the JAX package's count.  The port counts products only
  (``torch.utils.flop_counter``); the JAX package's HLO also counts its
  fusions' elementwise work (the cache update as a select over the
  block, the fp32 converts), 1.166e9 and 2.151e9 FLOPs here, so the total
  lands near 0.81x.
* The peak a rank is at most 1.05x the JAX package's.

The JAX package's figures, from ``PYTHONPATH=src python3
tests/dryrun_depth.py --package repro --arch ARCH --shape long_500k
--dots --out /tmp/j.json``, are kept as constants.
"""
import math

import pytest

RANKS = 16
HIGH = 1.05
# the JAX package's (per_device_flops, dot_flops, total_bytes) (above)
JAX = {"gemma3-1b": (4656048679.0, 3489660928.0, 2038788268),
       "hymba-1.5b": (8861547499.0, 6710886400.0, 4620656232)}
ARCHS = list(JAX)


@pytest.fixture(scope="module")
def cells():
    """{arch: (result, counter, (cache bytes a rank, whole cache bytes),
    the arch)}."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.dist.sharding import Block
    from repro_torch.models.module import leaves

    out = {}
    for arch in ARCHS:
        counters = []
        result = dryrun.run_cell(arch, "long_500k", verbose=False,
                                 counter_out=counters)
        with dryrun.fake_group(RANKS * RANKS):
            mesh = make_production_mesh()
            _, args, *_ = dryrun.build_cell(arch, "long_500k", mesh)
        held = whole = 0
        kv = [leaf for leaf in leaves(args[1])
              if isinstance(leaf, Block) and leaf.local.ndim >= 4]
        for leaf in kv:
            n = leaf.local.element_size()
            held += leaf.local.numel() * n
            whole += math.prod(leaf.whole_shape()) * n
        out[arch] = (result, counters[0], (held, whole, len(kv)),
                     dryrun.get_arch(arch))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_held_a_sixteenth_a_rank(cells, arch):
    _, _, (held, whole, n), _ = cells[arch]
    assert n > 0 and held * RANKS == whole, (held, whole, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_products_are_the_jax_dots(cells, arch):
    """The scores [B*KV, G, Smax/16] and p·v [B*KV, G, D] products, every
    head on this rank's positions, each 2·B·H·D·Smax/16 a layer."""
    result, counter, _, cfg = cells[arch]
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g, s_loc = cfg.n_heads // kv, 524288 // RANKS
    scores = counter.flops[("aten.bmm", f"bf16[{kv},{g},{s_loc}]")]
    pv = counter.flops[("aten.bmm", f"f32[{kv},{g},{hd}]")]
    each = 2 * cfg.n_heads * hd * s_loc * cfg.n_layers
    assert scores == pv == each, (scores, pv, each)
    assert scores + pv == JAX[arch][1]


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_and_peak_against_the_jax_package(cells, arch):
    result, *_ = cells[arch]
    flops, _, peak = JAX[arch]
    assert result["per_device_flops"] <= HIGH * flops, \
        result["per_device_flops"] / flops
    total = result["memory_per_device_bytes"]["total_bytes"]
    assert total <= HIGH * peak, total / peak
