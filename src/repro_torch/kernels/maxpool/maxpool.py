"""Wrapper of the hand-written CUDA maxpool kernel (``csrc/maxpool.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.

``geometry`` picks a launch's path and shape (``kernels.Window``): at
r = s = 2 the vector path when the input's rows lie on 16 or 8 bytes, its
strips sized by the tile (``VECTOR``) and shortened until the grid fills
the card, else the staged path, one block per output tile.  The launch path
is the lean one of ``kernels.Entry``, as in the matvec wrapper.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (Entry, Window, on_cuda, packet_bytes,
                                 store_bytes, strips)
from repro_torch.kernels.maxpool import ref

# (bm, bn) output tiles: the registry's 32 and the 8 of the JAX package's
# kernel tests; the staged path compiles them as block tiles
SCHEDULES = ((32, 32), (8, 8))
# the vector path by tile: (block width in threads, most rows a thread walks)
VECTOR = {32: (128, 4), 8: (32, 1)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 48 * 1024     # bytes of shared memory a launch may stage
LAUNCHES = 0

plain = ref.maxpool

_ITEMSIZE = {0: 4, 1: 2}
# repro_maxpool(a, out, m | n << 32, r | s << 16, config, stream): the
# counts packed, as in the matvec wrapper
_ENTRY = Entry("maxpool", "repro_maxpool",
               [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_void_p],
               "maxpool kernel launch")


def smem_bytes(r: int, s: int, bm: int, bn: int) -> int:
    """Shared memory a block of the staged path stages: the fp32 input span
    of its tile."""
    return 4 * ((bm - 1) * s + r) * ((bn - 1) * s + r)


def geometry(m: int, n: int, r: int, s: int, itemsize: int, tile: int,
             a_low: int = 0, out_low: int = 0) -> Window:
    """The launch over an [m, n] plane of ``itemsize``-byte elements at
    tile ``tile``, whose input and output addresses have the low bits
    ``a_low`` and ``out_low``: at r = s = 2 the vector path when the input
    rows take a 16- or 8-byte packet (a thread owns its columns and half as
    many outputs), else the staged path."""
    om, on = (m - r) // s + 1, (n - r) // s + 1
    load = packet_bytes(a_low, n * itemsize) if r == s == 2 else 0
    if not load:
        return Window(0, 0, 0, 0, -(-om // tile) * -(-on // tile))
    threads, rows, blocks = strips(om, -(-n * itemsize // load),
                                   *VECTOR[tile])
    return Window(load, store_bytes(out_low, on * itemsize, load // 2),
                  threads, rows, blocks)


@functools.lru_cache(maxsize=4096)
def _config(m: int, n: int, r: int, s: int, dtype: int, tile: int,
            a_low: int, out_low: int) -> int:
    return geometry(m, n, r, s, _ITEMSIZE[dtype], tile, a_low,
                    out_low).config(dtype, tile)


def _check(a: torch.Tensor, r: int, s: int, bm: int, bn: int) -> tuple:
    """Raises on what the kernel does not take; returns a's shape (read
    once: this runs on every call)."""
    if (bm, bn) not in SCHEDULES:
        raise ValueError(f"no maxpool kernel for tile bm={bm}, bn={bn}; "
                         f"compiled: {SCHEDULES}")
    shape = a.shape
    if len(shape) != 2:
        raise ValueError(f"maxpool needs a [m,n], got {tuple(shape)}")
    if r < 1 or s < 1 or min(shape) < r:
        raise ValueError(f"maxpool needs 1 <= r <= min(m, n) and s >= 1, "
                         f"got r={r}, s={s} over {tuple(shape)}")
    if a.dtype not in DTYPES:
        raise ValueError(f"maxpool takes float32 or bfloat16, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("maxpool operand must be contiguous")
    if smem_bytes(r, s, bm, bn) > SMEM_LIMIT:
        raise ValueError(f"maxpool tile {bm}x{bn} at r={r}, s={s} stages "
                         f"{smem_bytes(r, s, bm, bn)} bytes of shared "
                         f"memory, above the kernel's {SMEM_LIMIT}")
    if max(shape) >= 2 ** 31 or -(-((shape[0] - r) // s + 1) // bm) \
            > 65535:
        raise ValueError(f"maxpool plane {tuple(shape)} exceeds the "
                         "kernel's index range")
    return shape


def maxpool(a: torch.Tensor, *, r: int, s: int, bm: int = 32,
            bn: int = 32) -> torch.Tensor:
    """Max over r x r windows of a [m,n] at stride s -> [(m-r)//s+1,
    (n-r)//s+1] in a's type."""
    global LAUNCHES
    m, n = _check(a, r, s, bm, bn)
    # on_cuda raises for a device other than a card or the CPU
    if not (a.is_cuda or on_cuda(a)):
        return plain(a, r=r, s=s)
    index = a.get_device()
    out = a.new_empty(((m - r) // s + 1, (n - r) // s + 1))
    pa, po = a.data_ptr(), out.data_ptr()
    code = (_ENTRY.fn or _ENTRY.bind())(
        pa, po, m | n << 32, r | s << 16,
        _config(m, n, r, s, DTYPES[a.dtype], bm, pa & 15, po & 15)
        | index << 48, torch._C._cuda_getCurrentRawStream(index))
    if code:
        _ENTRY.fail(code)
    LAUNCHES += 1
    return out
