"""Wrapper of the hand-written CUDA conv2d kernel (``csrc/conv2d.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, device_guard, launch_stream, on_cuda
from repro_torch.kernels.conv2d import ref

# (bm, bn) output tiles compiled into the library: the registry's 32 and
# the 16 of the JAX package's kernel tests
SCHEDULES = ((32, 32), (16, 16))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 48 * 1024     # bytes of shared memory a launch may stage
LAUNCHES = 0

plain = ref.conv2d

# repro_conv2d(a, w, out, m, n, r, bm, bn, dtype, stream)
_SIGNATURES = {"repro_conv2d": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
               + [ctypes.c_void_p]}


def smem_bytes(r: int, bm: int, bn: int) -> int:
    """Shared memory a block stages: its fp32 halo window and the taps."""
    return 4 * ((bm + r - 1) * (bn + r - 1) + r * r)


def _check(a: torch.Tensor, w: torch.Tensor, bm: int, bn: int) -> None:
    if (bm, bn) not in SCHEDULES:
        raise ValueError(f"no conv2d kernel for tile bm={bm}, bn={bn}; "
                         f"compiled: {SCHEDULES}")
    if a.dim() != 2 or w.dim() != 2 or w.shape[0] != w.shape[1] \
            or w.shape[0] < 1:
        raise ValueError(f"conv2d needs a [m,n] and square taps w [r,r], "
                         f"got {tuple(a.shape)} and {tuple(w.shape)}")
    r = w.shape[0]
    if min(a.shape) < r:
        raise ValueError(f"conv2d taps [{r},{r}] exceed the plane "
                         f"{tuple(a.shape)}")
    if a.dtype not in DTYPES or w.dtype != a.dtype:
        raise ValueError(f"conv2d takes float32 or bfloat16 operands of one "
                         f"type, got {a.dtype} and {w.dtype}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d operands must be contiguous")
    if smem_bytes(r, bm, bn) > SMEM_LIMIT:
        raise ValueError(f"conv2d tile {bm}x{bn} at r={r} stages "
                         f"{smem_bytes(r, bm, bn)} bytes of shared memory, "
                         f"above the kernel's {SMEM_LIMIT}")
    if max(a.shape) >= 2 ** 31 or -(-(a.shape[0] - r + 1) // bm) > 65535:
        raise ValueError(f"conv2d plane {tuple(a.shape)} exceeds the "
                         "kernel's index range")


def conv2d(a: torch.Tensor, w: torch.Tensor, *, bm: int = 32,
           bn: int = 32) -> torch.Tensor:
    """a [m,n] (x) w [r,r] -> [m-r+1, n-r+1] in a's type, fp32
    accumulation."""
    global LAUNCHES
    _check(a, w, bm, bn)
    if not on_cuda(a, w):
        return plain(a, w)
    m, n = a.shape
    r = w.shape[0]
    out = torch.empty((m - r + 1, n - r + 1), dtype=a.dtype, device=a.device)
    lib = build.load("conv2d", _SIGNATURES)
    with device_guard(a):
        code = lib.repro_conv2d(a.data_ptr(), w.data_ptr(), out.data_ptr(),
                                m, n, r, bm, bn, DTYPES[a.dtype],
                                launch_stream(a))
    build.check(lib, code, "conv2d kernel launch")
    LAUNCHES += 1
    return out
