"""Wrapper of the hand-written CUDA blur kernels (``csrc/blur.cu``).

A CUDA tensor launches the kernels on the current stream; a CPU tensor
takes ``plain``, the same arithmetic in PyTorch.  ``LAUNCHES`` counts the
launches of each C entry point: ``blur_direct`` for the fused schedule,
``blur_h`` and ``blur_v`` for the two passes of the separable one.

``geometry`` picks a launch's path and shape (``kernels.Window``): the
vector path when the input's rows lie on 16 or 8 bytes, its strips sized
by the tile (``VECTOR``) and shortened until the grid fills the card, else
the staged path, one block per output tile.  The launch path is the lean
one of ``kernels.Entry``, as in the matvec wrapper: behind ``_check``'s
refusals it reads the device index once, allocates the output and calls
the bound C entry, which does the device guard.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (Entry, Window, on_cuda, packet_bytes,
                                 store_bytes, strips)

# (bm, bn) output tiles: the JAX op's default 128 and the 16 of the JAX
# package's kernel tests; the staged path compiles them as block tiles
SCHEDULES = ((128, 128), (16, 16))
# the vector path by tile: (block width in threads, most rows a thread walks)
VECTOR = {128: (128, 4), 16: (32, 2)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448      # bytes of shared memory an H100 block may opt in to
LAUNCHES = {"blur_direct": 0, "blur_h": 0, "blur_v": 0}

# the fp32 roundings of the scales the kernels multiply by
_NINTH = 1.0 / 9.0
_THIRD = 1.0 / 3.0

# (rows, columns) of the taps an output of each entry point reads
_TAPS = {"blur_direct": (3, 3), "blur_h": (1, 3), "blur_v": (3, 1)}
_ITEMSIZE = {0: 4, 1: 2}
# repro_blur_<pass>(a, out, m | n << 32, config, stream): ctypes converts
# each argument at a cost of its own, so the counts are packed
_ENTRIES = {name: Entry("blur", f"repro_{name}",
                        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                        + [ctypes.c_void_p], f"{name} kernel launch")
            for name in LAUNCHES}


def smem_bytes(bm: int, bn: int, taps: tuple) -> int:
    """Shared memory a block of the staged path stages: the fp32 input
    window of its tile for a (rows, columns) tap extent: (3, 3) direct,
    (1, 3) h, (3, 1) v."""
    return 4 * (bm + taps[0] - 1) * (bn + taps[1] - 1)


def geometry(taps: tuple, m: int, n: int, itemsize: int, tile: int,
             a_low: int = 0, out_low: int = 0) -> Window:
    """The launch of one pass over an [m, n] plane of ``itemsize``-byte
    elements at tile ``tile``, whose input and output addresses have the
    low bits ``a_low`` and ``out_low``: the vector path when the input rows
    take a 16- or 8-byte packet, its thread owning one packet's columns,
    else the staged path."""
    om, on = m - taps[0] + 1, n - taps[1] + 1
    load = packet_bytes(a_low, n * itemsize)
    if not load:
        return Window(0, 0, 0, 0, -(-om // tile) * -(-on // tile))
    threads, rows, blocks = strips(om, -(-n * itemsize // load),
                                   *VECTOR[tile])
    return Window(load, store_bytes(out_low, on * itemsize, load), threads,
                  rows, blocks)


@functools.lru_cache(maxsize=4096)
def _config(taps: tuple, m: int, n: int, dtype: int, tile: int, a_low: int,
            out_low: int) -> int:
    return geometry(taps, m, n, _ITEMSIZE[dtype], tile, a_low,
                    out_low).config(dtype, tile)


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


def _check(a: torch.Tensor, bm: int, bn: int, taps: tuple) -> tuple:
    """Raises on what the kernels do not take; returns a's shape (read
    once: this runs on every call)."""
    if (bm, bn) not in SCHEDULES:
        raise ValueError(f"no blur kernel for tile bm={bm}, bn={bn}; "
                         f"compiled: {SCHEDULES}")
    shape = a.shape
    if len(shape) != 2 or shape[0] < taps[0] or shape[1] < taps[1]:
        raise ValueError(f"a blur pass of {taps[0]}x{taps[1]} taps needs a "
                         f"[m,n] with m >= {taps[0]}, n >= {taps[1]}, got "
                         f"{tuple(shape)}")
    if a.dtype not in DTYPES:
        raise ValueError(f"blur takes float32 or bfloat16, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("blur operand must be contiguous")
    if smem_bytes(bm, bn, taps) > SMEM_LIMIT:
        raise ValueError(f"blur tile {bm}x{bn} stages "
                         f"{smem_bytes(bm, bn, taps)} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} a block may take")
    if max(shape) >= 2 ** 31 or -(-shape[0] // bm) > 65535:
        raise ValueError(f"blur plane {tuple(shape)} exceeds the kernel's "
                         "index range")
    return shape


def _pass(name: str, plain_fn, a: torch.Tensor, bm: int,
          bn: int) -> torch.Tensor:
    """One launch of C entry point ``repro_<name>`` over a, or plain_fn on
    a CPU tensor."""
    taps = _TAPS[name]
    m, n = _check(a, bm, bn, taps)
    # on_cuda raises for a device other than a card or the CPU
    if not (a.is_cuda or on_cuda(a)):
        return plain_fn(a)
    index = a.get_device()
    out = a.new_empty((m - taps[0] + 1, n - taps[1] + 1))
    pa, po = a.data_ptr(), out.data_ptr()
    entry = _ENTRIES[name]
    code = (entry.fn or entry.bind())(
        pa, po, m | n << 32,
        _config(taps, m, n, DTYPES[a.dtype], bm, pa & 15, po & 15)
        | index << 48, torch._C._cuda_getCurrentRawStream(index))
    if code:
        entry.fail(code)
    LAUNCHES[name] += 1
    return out


def blur_direct(a: torch.Tensor, *, bm: int = 128,
                bn: int = 128) -> torch.Tensor:
    """The fused 3x3 box mean: [m,n] -> [m-2, n-2]."""
    return _pass("blur_direct", plain, a, bm, bn)


def blur_h(a: torch.Tensor, *, bm: int = 128, bn: int = 128) -> torch.Tensor:
    """Pass 1 of the separable blur, the 1x3 row mean: [m,n] -> [m, n-2]."""
    return _pass("blur_h", plain_h, a, bm, bn)


def blur_v(h: torch.Tensor, *, bm: int = 128, bn: int = 128) -> torch.Tensor:
    """Pass 2, the 3x1 column mean: [m,n] -> [m-2, n]."""
    return _pass("blur_v", plain_v, h, bm, bn)


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
