"""Wrapper of the hand-written CUDA conv2d kernel (``csrc/conv2d.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.

``geometry`` picks a launch's path and shape (``kernels.Window``): for the
compiled tap counts (``VECTOR_TAPS``) the vector path when the input's rows
lie on 16 or 8 bytes, its strips sized by the tile (``VECTOR``) and
shortened until the grid fills the card, else the staged path, one block
per output tile.  The launch path is the lean one of ``kernels.Entry``, as
in the maxpool wrapper.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (Entry, Window, cuda_index, packet_bytes,
                                 store_bytes, strips)
from repro_torch.kernels.conv2d import ref

# (bm, bn) output tiles: the registry's 32 and the 16 of the JAX package's
# kernel tests; the staged path compiles them as block tiles
SCHEDULES = ((32, 32), (16, 16))
# the vector path by tile: (block width in threads, most rows a thread walks)
VECTOR = {32: (128, 4), 16: (32, 2)}
# tap counts r the vector path compiles: the workload's 3, and the 5 and 7
# of the JAX package's kernel tests and the cold shapes
VECTOR_TAPS = (3, 5, 7)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 48 * 1024     # bytes of shared memory a launch may stage
LAUNCHES = 0

plain = ref.conv2d

_ITEMSIZE = {0: 4, 1: 2}
# repro_conv2d(a, w, out, m | n << 32, r, config, stream): the counts packed,
# as in the maxpool wrapper
_ENTRY = Entry("conv2d", "repro_conv2d",
               [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_void_p],
               "conv2d kernel launch")


def smem_bytes(r: int, bm: int, bn: int) -> int:
    """Shared memory a block of the staged path stages: its fp32 halo
    window and the taps."""
    return 4 * ((bm + r - 1) * (bn + r - 1) + r * r)


def geometry(m: int, n: int, r: int, itemsize: int, tile: int,
             a_low: int = 0, out_low: int = 0) -> Window:
    """The launch over an [m, n] plane of ``itemsize``-byte elements with
    [r, r] taps at tile ``tile``, whose input and output addresses have the
    low bits ``a_low`` and ``out_low``: for r in VECTOR_TAPS the vector
    path when the input rows take a 16- or 8-byte packet, its thread owning
    one packet's columns, else the staged path."""
    om, on = m - r + 1, n - r + 1
    load = packet_bytes(a_low, n * itemsize) if r in VECTOR_TAPS else 0
    if not load:
        return Window(0, 0, 0, 0, -(-om // tile) * -(-on // tile))
    threads, rows, blocks = strips(om, -(-n * itemsize // load),
                                   *VECTOR[tile])
    return Window(load, store_bytes(out_low, on * itemsize, load), threads,
                  rows, blocks)


@functools.lru_cache(maxsize=4096)
def _config(m: int, n: int, r: int, dtype: int, tile: int, a_low: int,
            out_low: int) -> int:
    return geometry(m, n, r, _ITEMSIZE[dtype], tile, a_low,
                    out_low).config(dtype, tile)


def _check(a: torch.Tensor, w: torch.Tensor, bm: int, bn: int) -> tuple:
    """Raises on what the kernel does not take; returns a's shape and r
    (read once: this runs on every call)."""
    if (bm, bn) not in SCHEDULES:
        raise ValueError(f"no conv2d kernel for tile bm={bm}, bn={bn}; "
                         f"compiled: {SCHEDULES}")
    shape, taps = a.shape, w.shape
    if len(shape) != 2 or len(taps) != 2 or taps[0] != taps[1] \
            or taps[0] < 1:
        raise ValueError(f"conv2d needs a [m,n] and square taps w [r,r], "
                         f"got {tuple(shape)} and {tuple(taps)}")
    r = taps[0]
    if min(shape) < r:
        raise ValueError(f"conv2d taps [{r},{r}] exceed the plane "
                         f"{tuple(shape)}")
    if a.dtype not in DTYPES or w.dtype != a.dtype:
        raise ValueError(f"conv2d takes float32 or bfloat16 operands of one "
                         f"type, got {a.dtype} and {w.dtype}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d operands must be contiguous")
    if smem_bytes(r, bm, bn) > SMEM_LIMIT:
        raise ValueError(f"conv2d tile {bm}x{bn} at r={r} stages "
                         f"{smem_bytes(r, bm, bn)} bytes of shared memory, "
                         f"above the kernel's {SMEM_LIMIT}")
    if max(shape) >= 2 ** 31 or -(-(shape[0] - r + 1) // bm) > 65535:
        raise ValueError(f"conv2d plane {tuple(shape)} exceeds the "
                         "kernel's index range")
    return shape, r


def conv2d(a: torch.Tensor, w: torch.Tensor, *, bm: int = 32,
           bn: int = 32) -> torch.Tensor:
    """a [m,n] (x) w [r,r] -> [m-r+1, n-r+1] in a's type, fp32
    accumulation."""
    global LAUNCHES
    (m, n), r = _check(a, w, bm, bn)
    # raises for operands on different devices, or on a device other than
    # a card or the CPU
    index = cuda_index(a, w)
    if index < 0:
        return plain(a, w)
    out = a.new_empty((m - r + 1, n - r + 1))
    pa, po = a.data_ptr(), out.data_ptr()
    code = (_ENTRY.fn or _ENTRY.bind())(
        pa, w.data_ptr(), po, m | n << 32, r,
        _config(m, n, r, DTYPES[a.dtype], bm, pa & 15, po & 15)
        | index << 48, torch._C._cuda_getCurrentRawStream(index))
    if code:
        _ENTRY.fail(code)
    LAUNCHES += 1
    return out
