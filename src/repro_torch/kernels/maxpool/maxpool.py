"""Wrapper of the hand-written CUDA maxpool kernel (``csrc/maxpool.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, device_guard, launch_stream, on_cuda
from repro_torch.kernels.maxpool import ref

# (bm, bn) output tiles compiled into the library: the registry's 32 and
# the 8 of the JAX package's kernel tests
SCHEDULES = ((32, 32), (8, 8))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 48 * 1024     # bytes of shared memory a launch may stage
LAUNCHES = 0

plain = ref.maxpool

# repro_maxpool(a, out, m, n, r, s, bm, bn, dtype, stream)
_SIGNATURES = {"repro_maxpool": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
               + [ctypes.c_void_p]}


def smem_bytes(r: int, s: int, bm: int, bn: int) -> int:
    """Shared memory a block stages: the fp32 input span of its tile."""
    return 4 * ((bm - 1) * s + r) * ((bn - 1) * s + r)


def _check(a: torch.Tensor, r: int, s: int, bm: int, bn: int) -> None:
    if (bm, bn) not in SCHEDULES:
        raise ValueError(f"no maxpool kernel for tile bm={bm}, bn={bn}; "
                         f"compiled: {SCHEDULES}")
    if a.dim() != 2:
        raise ValueError(f"maxpool needs a [m,n], got {tuple(a.shape)}")
    if r < 1 or s < 1 or min(a.shape) < r:
        raise ValueError(f"maxpool needs 1 <= r <= min(m, n) and s >= 1, "
                         f"got r={r}, s={s} over {tuple(a.shape)}")
    if a.dtype not in DTYPES:
        raise ValueError(f"maxpool takes float32 or bfloat16, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("maxpool operand must be contiguous")
    if smem_bytes(r, s, bm, bn) > SMEM_LIMIT:
        raise ValueError(f"maxpool tile {bm}x{bn} at r={r}, s={s} stages "
                         f"{smem_bytes(r, s, bm, bn)} bytes of shared "
                         f"memory, above the kernel's {SMEM_LIMIT}")
    if max(a.shape) >= 2 ** 31 or -(-((a.shape[0] - r) // s + 1) // bm) \
            > 65535:
        raise ValueError(f"maxpool plane {tuple(a.shape)} exceeds the "
                         "kernel's index range")


def maxpool(a: torch.Tensor, *, r: int, s: int, bm: int = 32,
            bn: int = 32) -> torch.Tensor:
    """Max over r x r windows of a [m,n] at stride s -> [(m-r)//s+1,
    (n-r)//s+1] in a's type."""
    global LAUNCHES
    _check(a, r, s, bm, bn)
    if not on_cuda(a):
        return plain(a, r=r, s=s)
    m, n = a.shape
    out = torch.empty(((m - r) // s + 1, (n - r) // s + 1), dtype=a.dtype,
                      device=a.device)
    lib = build.load("maxpool", _SIGNATURES)
    with device_guard(a):
        code = lib.repro_maxpool(a.data_ptr(), out.data_ptr(), m, n, r, s,
                                 bm, bn, DTYPES[a.dtype], launch_stream(a))
    build.check(lib, code, "maxpool kernel launch")
    LAUNCHES += 1
    return out
