"""Wrapper of the hand-written CUDA matvec kernel (``csrc/matvec.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, device_guard, launch_stream, on_cuda
from repro_torch.kernels.matvec import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = 0

plain = ref.matvec

# repro_matvec(a, x, y, m, k, dtype, stream)
_SIGNATURES = {"repro_matvec": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
               + [ctypes.c_void_p]}


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.dim() != 2 or x.dim() != 1 or a.shape[1] != x.shape[0]:
        raise ValueError(f"matvec needs a [m,k] and x [k], got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    if a.dtype not in DTYPES or x.dtype != a.dtype:
        raise ValueError(f"matvec takes float32 or bfloat16 operands of one "
                         f"type, got {a.dtype} and {x.dtype}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("matvec operands must be contiguous")
    if max(a.shape) >= 2 ** 31:
        raise ValueError(f"matvec shape {tuple(a.shape)} exceeds the "
                         "kernel's index range")


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a [m,k] @ x [k] -> [m] in a's type, fp32 accumulation."""
    global LAUNCHES
    _check(a, x)
    if not on_cuda(a, x):
        return plain(a, x)
    m, k = a.shape
    y = torch.empty((m,), dtype=a.dtype, device=a.device)
    if m == 0:
        return y
    lib = build.load("matvec", _SIGNATURES)
    with device_guard(a):
        code = lib.repro_matvec(a.data_ptr(), x.data_ptr(), y.data_ptr(),
                                m, k, DTYPES[a.dtype], launch_stream(a))
    build.check(lib, code, "matvec kernel launch")
    LAUNCHES += 1
    return y
