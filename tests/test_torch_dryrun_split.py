"""The dry-run of the MoE's global dispatch on each rank's experts and of
the mLSTM core on each rank's value rows, at full width on the fake group
of ``pod16x16`` (``train_4k``: B = 256, S = 4096; 16 data by 16 model
ranks).

* llama4-maverick-400b-a17b cut to 2 of 48 layers (one attention layer,
  one MoE layer: 128 experts of 8192, top-1), against the same cell with
  the experts on d's blocks undone (``moe._embed_specs`` made None: each
  rank's 8 experts on the whole d = 5120) and against the cell with the
  experts computed whole on every rank (``moe.split_axes`` made (): all
  128 experts on the whole d): the dispatched tokens ``xe`` are [8, cap,
  d] a rank with ``cap`` the whole batch's capacity, no [128, cap, .]
  tensor appears, no expert product runs on the whole d, each family of
  the experts' products counts exactly 1/16 of the FLOPs with d whole and
  1/256 of the whole cell's, and memory is lower.
* xlstm-1.3b cut to its first layer (an mLSTM: 4 heads of 1024, which do
  not divide 16), against the same cell with the core's value rows whole
  (``xlstm.mlstm_axes`` without them): C's carry is [16, 4, 64, 1024],
  no [16, 4, 1024, 1024] tensor appears, the intra-chunk ``q.k`` is
  computed on a rank's 4 of the 64 (batch, head) pairs, the [., L, L]
  products (``q.k`` and the gradient of the weights times v on the value
  rows) come to exactly 1/16 of the whole cell's, and the total FLOPs
  fall by exactly 15/16 of the value-row and ``q.k`` products, worked out
  from their shapes.
"""
import dataclasses

import pytest

B_RANK, SEQ, RANKS = 16, 4096, 16
E, E_RANK, D, F = 128, 8, 5120, 8192         # llama4: experts, d, expert_d_ff
H, DH, CHUNK = 4, 1024, 256                  # xlstm: heads, head dim, chunk


def _cells(arch: str, layers: int, *patches) -> tuple:
    """(the cell, its op counter), and the same with each of ``patches``
    (``patch(mp)``) applied on its own."""
    from repro_torch.launch import dryrun

    full = dryrun.get_arch
    out = []
    for patch in (None,) + patches:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dryrun, "get_arch", lambda name: dataclasses.replace(
                full(name), n_layers=layers))
            if patch is not None:
                patch(mp)
            counters = []
            cell = dryrun.run_cell(arch, "train_4k", verbose=False,
                                   counter_out=counters)
            out.append((cell, counters[0]))
    return tuple(out)


@pytest.fixture(scope="module")
def experts():
    """(the cell, its counter), the same with d whole, and with every
    expert whole on every rank."""
    from repro_torch.models import moe

    return _cells(
        "llama4-maverick-400b-a17b", 2,
        lambda mp: mp.setattr(moe, "_embed_specs", lambda *a: None),
        lambda mp: mp.setattr(moe, "split_axes", lambda *a: ()))


@pytest.fixture(scope="module")
def value_rows():
    from repro_torch.models import xlstm

    real = xlstm.mlstm_axes
    return _cells("xlstm-1.3b", 1, lambda mp: mp.setattr(
        xlstm, "mlstm_axes", lambda *a: real(*a)[:2] + ((),)))


def _shapes(counter) -> set:
    return {shape for _, shape in counter.traffic}


def _cap() -> int:
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import capacity

    return capacity(get_arch("llama4-maverick-400b-a17b"), 256 * SEQ)


def test_dryrun_experts_dispatched_on_blocks(experts):
    """``xe`` is this rank's 8 experts' rows at the whole batch's capacity
    (10240), never all 128 experts'; whole in the other cell."""
    (_, split), _, (_, whole) = experts
    cap = _cap()
    assert cap == 10240
    assert f"bf16[{E_RANK},{cap},{D}]" in _shapes(split)
    assert not any(s.startswith(f"bf16[{E},{cap},") for s in _shapes(split))
    assert f"bf16[{E},{cap},{D}]" in _shapes(whole)


# the experts' products by their output's trailing dimensions with d
# whole: the gate and up products (and the backward's [cap, f] gradient),
# the down product and the input's gradient, the three weights' gradients;
# and the same families on d's blocks (the gate and up products in one,
# [cap, 2f]; the up product's and the gate's weight gradients in one)
CAP, D_RANK = 10240, D // RANKS
EXPERT_PRODUCTS = (f"{CAP},{F}", f"{CAP},{D}", f"{D},{F}", f"{F},{D}")
ON_BLOCKS = {f"{CAP},{F}": (f"{CAP},{2 * F}", f"{CAP},{F}"),
             f"{CAP},{D}": (f"{CAP},{D_RANK}",),
             f"{D},{F}": (f"{D_RANK},{2 * F}",),
             f"{F},{D}": (f"{F},{D_RANK}",)}


def _family(counter, experts, tails) -> int:
    return sum(counter.flops.get(("aten.bmm", f"bf16[{experts},{t}]"), 0)
               for t in tails)


@pytest.mark.parametrize("tail", EXPERT_PRODUCTS)
def test_dryrun_expert_flops_a_sixteenth(experts, tail):
    """Each rank's 8 experts with d whole: 1/16 of all 128 experts'."""
    _, (_, split), (_, whole) = experts
    got = split.flops[("aten.bmm", f"bf16[{E_RANK},{tail}]")]
    want = whole.flops[("aten.bmm", f"bf16[{E},{tail}]")]
    assert got > 0 and got * RANKS == want, (got, want)


@pytest.mark.parametrize("tail", EXPERT_PRODUCTS)
def test_dryrun_expert_flops_a_256th(experts, tail):
    """Each rank's 8 experts on its block of d: 1/256 of all 128 experts'
    on the whole d."""
    (_, split), _, (_, whole) = experts
    got = _family(split, E_RANK, ON_BLOCKS[tail])
    want = whole.flops[("aten.bmm", f"bf16[{E},{tail}]")]
    assert got > 0 and got * RANKS * RANKS == want, (got, want)


def test_dryrun_no_expert_product_on_whole_d(experts):
    """No expert product takes or gives the whole d = 5120 (its
    [8, ., 5120] or [8, 5120, .] outputs); the cell with d whole runs
    them."""
    (_, split), (_, whole_d), _ = experts

    def on_whole_d(counter):
        return {shape for op, shape in counter.flops if op == "aten.bmm"
                and shape.startswith(f"bf16[{E_RANK},")
                and (shape.endswith(f",{D}]")
                     or shape.startswith(f"bf16[{E_RANK},{D},"))}
    assert not on_whole_d(split), on_whole_d(split)
    assert on_whole_d(whole_d)


def test_dryrun_experts_never_gathered_over_data(experts):
    """A rank's 8 experts' weights (bf16 params) never appear on the
    whole d (their gather over "data"); the cell with d whole gathers
    them."""
    (_, split), (_, whole_d), _ = experts
    gathered = {f"bf16[{E_RANK},{D},{F}]", f"bf16[{E_RANK},{F},{D}]"}
    assert not gathered & _shapes(split)
    assert gathered <= _shapes(whole_d)


def test_dryrun_experts_memory_lower(experts):
    (split, _), _, (whole, _) = experts
    assert split["memory_per_device_bytes"]["total_bytes"] \
        < whole["memory_per_device_bytes"]["total_bytes"]
    assert split["per_device_flops"] < whole["per_device_flops"]


def test_dryrun_mlstm_carry_by_value_rows(value_rows):
    """C's carry is a rank's 64 of each head's 1024 value rows, never
    whole; whole in the other cell."""
    (_, split), (_, whole) = value_rows
    assert f"f32[{B_RANK},{H},{DH // RANKS},{DH}]" in _shapes(split)
    assert f"f32[{B_RANK},{H},{DH},{DH}]" not in _shapes(split)
    assert f"f32[{B_RANK},{H},{DH},{DH}]" in _shapes(whole)


def test_dryrun_mlstm_intra_chunk_products_a_sixteenth(value_rows):
    """q.k (the chunk step and its recompute) on a rank's B*H/16 pairs,
    and the gradient of the intra-chunk weights (contracting a rank's
    value rows): their [., L, L] products come to 1/16 of the whole
    cell's, where q.k takes all B*H pairs."""
    (_, split), (_, whole) = value_rows
    pairs, mine = B_RANK * H, B_RANK * H // RANKS

    def products(counter, p):
        return counter.flops[("aten.bmm", f"f32[{p},{CHUNK},{CHUNK}]")]

    got = products(split, mine) + products(split, pairs)
    want = products(whole, pairs)
    assert products(split, mine) > 0 and got * RANKS == want, (got, want)


def test_dryrun_mlstm_flops_fall_by_the_value_rows(value_rows):
    """The value-row products, per chunk of 256 (16 a layer) at dv = dh
    in the whole cell: C.q and C's update (2*B*H*L*dh*dv each) and the
    intra-chunk weights times v (2*B*H*L*L*dv), each twice in the forward
    (the chunk step and its recompute in the backward); the backward's
    two operand gradients of each once, but C's of the first chunk (its
    zero carry takes none).  Beside them the intra-chunk q.k over the
    key dim (2*B*H*L*L*dh, on a sixteenth of the pairs), twice in the
    forward and its two operand gradients once.  The split cell computes 1/16 of each, so the total
    falls by the other 15/16."""
    (split, _), (whole, _) = value_rows
    n = SEQ // CHUNK
    x = 2 * B_RANK * H * CHUNK * DH * DH
    y = 2 * B_RANK * H * CHUNK * CHUNK * DH
    z = 2 * B_RANK * H * CHUNK * CHUNK * DH     # q.k, dh contracted
    forward = 2 * n * (x + y + x)
    backward = n * (2 * x + 2 * y + 2 * x) - x
    qk = 2 * n * z + n * 2 * z
    want = (forward + backward + qk) * (RANKS - 1) // RANKS
    got = whole["per_device_flops"] - split["per_device_flops"]
    assert got == want, (got, want)
    assert split["memory_per_device_bytes"]["total_bytes"] \
        < whole["memory_per_device_bytes"]["total_bytes"]
