"""Wrapper of the hand-written CUDA matmul kernel (``csrc/matmul.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, device_guard, launch_stream, on_cuda
from repro_torch.kernels.matmul import ref

# (bm, bn, bk) schedules compiled into the library: the output tile edge is
# the template's, and k is staged through shared memory 32 deep for both
SCHEDULES = ((32, 32, 32), (128, 128, 32))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = 0

plain = ref.matmul

# repro_matmul(a, b, c, m, n, k, dtype, tile, stream)
_SIGNATURES = {"repro_matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
               + [ctypes.c_void_p]}


def _check(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
           bk: int) -> None:
    if (bm, bn, bk) not in SCHEDULES:
        raise ValueError(f"no matmul kernel for schedule bm={bm}, bn={bn}, "
                         f"bk={bk}; compiled: {SCHEDULES}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul needs a [m,k] and b [k,n], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"matmul takes float32 or bfloat16 operands of one "
                         f"type, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul operands must be contiguous")
    if max(a.shape[0], a.shape[1], b.shape[1]) >= 2 ** 31 \
            or -(-a.shape[0] // bm) > 65535:
        raise ValueError(f"matmul shape {tuple(a.shape)} x {tuple(b.shape)} "
                         "exceeds the kernel's index range")


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
           bk: int = 32) -> torch.Tensor:
    """a [m,k] @ b [k,n] -> [m,n] in a's type, fp32 accumulation."""
    global LAUNCHES
    _check(a, b, bm, bn, bk)
    if not on_cuda(a, b):
        return plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    lib = build.load("matmul", _SIGNATURES)
    with device_guard(a):
        code = lib.repro_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                m, n, k, DTYPES[a.dtype], bm,
                                launch_stream(a))
    build.check(lib, code, "matmul kernel launch")
    LAUNCHES += 1
    return out
