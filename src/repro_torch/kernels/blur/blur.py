"""Wrapper of the hand-written CUDA blur kernels (``csrc/blur.cu``).

A CUDA tensor launches the kernels on the current stream; a CPU tensor
takes ``plain``, the same arithmetic in PyTorch.  ``LAUNCHES`` counts the
launches of each C entry point: ``blur_direct`` for the fused schedule,
``blur_h`` and ``blur_v`` for the two passes of the separable one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, device_guard, launch_stream, on_cuda

# (bm, bn) output tiles compiled into the library: the JAX op's default
# 128 and the 16 of the JAX package's kernel tests
SCHEDULES = ((128, 128), (16, 16))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448      # bytes of shared memory an H100 block may opt in to
LAUNCHES = {"blur_direct": 0, "blur_h": 0, "blur_v": 0}

# the fp32 roundings of the scales the kernels multiply by
_NINTH = 1.0 / 9.0
_THIRD = 1.0 / 3.0

# repro_blur_<pass>(a, out, m, n, bm, bn, dtype, stream)
_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIGNATURES = {f"repro_{name}": _ARGS for name in LAUNCHES}


def smem_bytes(bm: int, bn: int, taps: tuple) -> int:
    """Shared memory a block stages: the fp32 input window of its tile for
    a (rows, columns) tap extent: (3, 3) direct, (1, 3) h, (3, 1) v."""
    return 4 * (bm + taps[0] - 1) * (bn + taps[1] - 1)


def _scaled(acc: torch.Tensor, scale: float, dtype) -> torch.Tensor:
    return (acc * torch.tensor(scale, dtype=torch.float32,
                               device=acc.device)).to(dtype)


def plain_h(a: torch.Tensor) -> torch.Tensor:
    """The h pass: (a[:, j] + a[:, j+1] + a[:, j+2]) * fp32(1/3) in fp32,
    stored in a's type."""
    on = a.shape[1] - 2
    a32 = a.float()
    return _scaled(a32[:, 0:on] + a32[:, 1:on + 1] + a32[:, 2:on + 2],
                   _THIRD, a.dtype)


def plain_v(h: torch.Tensor) -> torch.Tensor:
    """The v pass: the same sum down three rows of h."""
    om = h.shape[0] - 2
    h32 = h.float()
    return _scaled(h32[0:om] + h32[1:om + 1] + h32[2:om + 2], _THIRD,
                   h.dtype)


def plain(a: torch.Tensor, *, separable: bool = False) -> torch.Tensor:
    """The kernels' arithmetic in PyTorch: fp32 sums in the Pallas order,
    times the fp32 1/9 (or 1/3 per pass), cast to a's type; the separable
    schedule rounds h to a's type between the passes, as the kernel's h
    pass stores it."""
    if separable:
        return plain_v(plain_h(a))
    m, n = a.shape
    om, on = m - 2, n - 2
    a32 = a.float()
    acc = torch.zeros((om, on), dtype=torch.float32, device=a.device)
    for di in range(3):
        for dj in range(3):
            acc = acc + a32[di:di + om, dj:dj + on]
    return _scaled(acc, _NINTH, a.dtype)


def _check(a: torch.Tensor, bm: int, bn: int, taps: tuple) -> None:
    if (bm, bn) not in SCHEDULES:
        raise ValueError(f"no blur kernel for tile bm={bm}, bn={bn}; "
                         f"compiled: {SCHEDULES}")
    if a.dim() != 2 or a.shape[0] < taps[0] or a.shape[1] < taps[1]:
        raise ValueError(f"a blur pass of {taps[0]}x{taps[1]} taps needs a "
                         f"[m,n] with m >= {taps[0]}, n >= {taps[1]}, got "
                         f"{tuple(a.shape)}")
    if a.dtype not in DTYPES:
        raise ValueError(f"blur takes float32 or bfloat16, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("blur operand must be contiguous")
    if smem_bytes(bm, bn, taps) > SMEM_LIMIT:
        raise ValueError(f"blur tile {bm}x{bn} stages "
                         f"{smem_bytes(bm, bn, taps)} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} a block may take")
    if max(a.shape) >= 2 ** 31 or -(-a.shape[0] // bm) > 65535:
        raise ValueError(f"blur plane {tuple(a.shape)} exceeds the kernel's "
                         "index range")


def _pass(name: str, taps: tuple, plain_fn, a: torch.Tensor, bm: int,
          bn: int) -> torch.Tensor:
    """One launch of C entry point ``repro_<name>`` over a, or plain_fn on
    a CPU tensor."""
    _check(a, bm, bn, taps)
    if not on_cuda(a):
        return plain_fn(a)
    m, n = a.shape
    out = torch.empty((m - taps[0] + 1, n - taps[1] + 1), dtype=a.dtype,
                      device=a.device)
    lib = build.load("blur", _SIGNATURES)
    with device_guard(a):
        code = getattr(lib, f"repro_{name}")(
            a.data_ptr(), out.data_ptr(), m, n, bm, bn, DTYPES[a.dtype],
            launch_stream(a))
    build.check(lib, code, f"{name} kernel launch")
    LAUNCHES[name] += 1
    return out


def blur_direct(a: torch.Tensor, *, bm: int = 128,
                bn: int = 128) -> torch.Tensor:
    """The fused 3x3 box mean: [m,n] -> [m-2, n-2]."""
    return _pass("blur_direct", (3, 3), plain, a, bm, bn)


def blur_h(a: torch.Tensor, *, bm: int = 128, bn: int = 128) -> torch.Tensor:
    """Pass 1 of the separable blur, the 1x3 row mean: [m,n] -> [m, n-2]."""
    return _pass("blur_h", (1, 3), plain_h, a, bm, bn)


def blur_v(h: torch.Tensor, *, bm: int = 128, bn: int = 128) -> torch.Tensor:
    """Pass 2, the 3x1 column mean: [m,n] -> [m-2, n]."""
    return _pass("blur_v", (3, 1), plain_v, h, bm, bn)


def blur(a: torch.Tensor, *, bm: int = 128, bn: int = 128,
         separable: bool = False) -> torch.Tensor:
    """3x3 box mean of a [m,n] over its valid region -> [m-2, n-2] in a's
    type: fused, or separable (a 1x3 pass, then a 3x1 pass)."""
    if not separable:
        return blur_direct(a, bm=bm, bn=bn)
    if a.dim() != 2 or min(a.shape) < 3:
        raise ValueError(f"blur needs a [m,n] with m, n >= 3, got "
                         f"{tuple(a.shape)}")
    return blur_v(blur_h(a, bm=bm, bn=bn), bm=bm, bn=bn)
