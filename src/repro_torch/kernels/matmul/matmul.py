"""Wrapper of the hand-written CUDA matmul kernel (``csrc/matmul.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.

``split_k`` chooses how many blocks of a thread-block cluster share one
output tile's contraction, so that few output tiles still fill the card;
the launch path is the lean one of ``kernels.Entry``, as in the matvec
wrapper.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import Entry, cuda_index
from repro_torch.kernels.matmul import ref

# (bm, bn, bk) schedules compiled into the library, the registry's: the
# output tile edge is the template's; bk names the schedule (the kernels
# stage k through shared memory 64 deep at the 128 tile, 128 at the 32)
SCHEDULES = ((32, 32, 32), (128, 128, 32))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = 0
# cluster sizes along k the kernel takes, and the element multiple each
# block's k range starts at (csrc/matmul.cu: kSplitAlign)
SPLITS = (1, 2, 4, 8)
SPLIT_ALIGN = 8

plain = ref.matmul

# repro_matmul(a, b, c, m | n << 32, k, dtype | tile << 8 | split << 16 |
# device << 24, stream): the counts packed, as in the matvec wrapper
_SIGNATURES = {"repro_matmul": [ctypes.c_void_p] * 3
               + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]}
_ENTRY = Entry("matmul", "repro_matmul", _SIGNATURES["repro_matmul"],
               "matmul kernel launch")
# repro_matmul_cluster_blocks(dtype, tile, split, device, int* blocks)
_CLUSTER_BLOCKS = Entry("matmul", "repro_matmul_cluster_blocks",
                        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
                        "matmul cluster occupancy query")
_SM_COUNT: dict = {}
_SLOTS: dict = {}


def k_chunk(k: int, s: int) -> int:
    """Elements of k each block of an s-block cluster sums: ceil(k/s)
    rounded up to SPLIT_ALIGN (the last block takes what is left)."""
    if s == 1:
        return k
    share = -(-k // s)
    return -(-share // SPLIT_ALIGN) * SPLIT_ALIGN


def split_k(m: int, n: int, k: int, bm: int, bn: int, bk: int,
            sm_count: int, slots: dict | None = None) -> int:
    """Blocks along k in a cluster, one of SPLITS: for a grid of fewer
    output tiles than SMs, the largest s whose tiles * s blocks all run at
    once, so that the grid fills the card; 1 when the tiles alone reach the
    SM count or k is a single block of the schedule.  ``slots`` maps s to
    the blocks of the tile the card runs at once in clusters of s
    (``cluster_slots``: a cluster sits in one GPC, so at s = 4 or 8 the 128
    tile's clusters take only 120 of an H100's 132 SMs); None counts
    ``sm_count`` blocks for every s.  Every block keeps a non-empty k
    range."""
    tiles = -(-m // bm) * -(-n // bn)
    if k <= bk or tiles >= sm_count:
        return 1
    for s in SPLITS[:0:-1]:
        fits = tiles * s <= (sm_count if slots is None else slots[s])
        if fits and (s - 1) * k_chunk(k, s) < k:
            return s
    return 1


def cluster_slots(index: int, dtype: torch.dtype, bm: int) -> dict:
    """s -> blocks of the ``bm`` tile that CUDA device ``index`` runs at
    once in clusters of s (the CUDA occupancy query), read once per
    device, type and tile."""
    key = (index, dtype, bm)
    slots = _SLOTS.get(key)
    if slots is None:
        slots = {}
        for s in SPLITS:
            blocks = ctypes.c_int(0)
            code = (_CLUSTER_BLOCKS.fn or _CLUSTER_BLOCKS.bind())(
                DTYPES[dtype], bm, s, index, ctypes.byref(blocks))
            if code:
                _CLUSTER_BLOCKS.fail(code)
            slots[s] = blocks.value
        _SLOTS[key] = slots
    return slots


def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once per device."""
    count = _SM_COUNT.get(index)
    if count is None:
        count = _SM_COUNT[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return count


@functools.lru_cache(maxsize=4096)
def _split(index: int, dtype: torch.dtype, m: int, n: int, k: int, bm: int,
           bn: int, bk: int) -> int:
    """``split_k`` on device ``index``, remembered per shape."""
    return split_k(m, n, k, bm, bn, bk, sm_count(index),
                   cluster_slots(index, dtype, bm))


def _check(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
           bk: int) -> None:
    if (bm, bn, bk) not in SCHEDULES:
        raise ValueError(f"no matmul kernel for schedule bm={bm}, bn={bn}, "
                         f"bk={bk}; compiled: {SCHEDULES}")
    ashape, bshape = a.shape, b.shape
    if len(ashape) != 2 or len(bshape) != 2 or ashape[1] != bshape[0]:
        raise ValueError(f"matmul needs a [m,k] and b [k,n], got "
                         f"{tuple(ashape)} and {tuple(bshape)}")
    dtype = a.dtype
    if dtype not in DTYPES or b.dtype != dtype:
        raise ValueError(f"matmul takes float32 or bfloat16 operands of one "
                         f"type, got {dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul operands must be contiguous")
    # the grid is (split * n tiles, m tiles): its y extent is the limit,
    # since split * n / bn stays below 2**31 for any n below it
    if max(ashape[0], ashape[1], bshape[1]) >= 2 ** 31 \
            or -(-ashape[0] // bm) > 65535:
        raise ValueError(f"matmul shape {tuple(ashape)} x {tuple(bshape)} "
                         "exceeds the kernel's index range")


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
           bk: int = 32) -> torch.Tensor:
    """a [m,k] @ b [k,n] -> [m,n] in a's type, fp32 accumulation."""
    global LAUNCHES
    _check(a, b, bm, bn, bk)
    index = cuda_index(a, b)
    if index < 0:
        return plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = a.new_empty((m, n))
    if m and n:
        split = _split(index, a.dtype, m, n, k, bm, bn, bk)
        code = (_ENTRY.fn or _ENTRY.bind())(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m | n << 32, k,
            DTYPES[a.dtype] | bm << 8 | split << 16 | index << 24,
            torch._C._cuda_getCurrentRawStream(index))
        if code:
            _ENTRY.fail(code)
        LAUNCHES += 1
    return out
