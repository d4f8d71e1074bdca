"""Wrapper of the hand-written CUDA matvec kernel (``csrc/matvec.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor takes
the plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches.

The launch path is lean, since at the decode workload's shapes the host's
cost per call is larger than the kernel's device time: behind ``_check``'s
refusals it reads the device index once, binds the C entry once
(``kernels.Entry``, which does the device guard in C), allocates the
output and calls the entry.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import Entry, cuda_index
from repro_torch.kernels.matvec import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = 0

plain = ref.matvec

# repro_matvec(a, x, y, m | k << 32, dtype | device << 8, stream): ctypes
# converts each argument at a cost of its own, so the counts go two to one
_SIGNATURES = {"repro_matvec": [ctypes.c_void_p] * 3
               + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]}
_ENTRY = Entry("matvec", "repro_matvec", _SIGNATURES["repro_matvec"],
               "matvec kernel launch")


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    # each shape and type read once: this runs on every call
    ashape, xshape = a.shape, x.shape
    if len(ashape) != 2 or len(xshape) != 1 or ashape[1] != xshape[0]:
        raise ValueError(f"matvec needs a [m,k] and x [k], got "
                         f"{tuple(ashape)} and {tuple(xshape)}")
    dtype = a.dtype
    if dtype not in DTYPES or x.dtype != dtype:
        raise ValueError(f"matvec takes float32 or bfloat16 operands of one "
                         f"type, got {dtype} and {x.dtype}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("matvec operands must be contiguous")
    if ashape[0] >= 2 ** 31 or ashape[1] >= 2 ** 31:
        raise ValueError(f"matvec shape {tuple(ashape)} exceeds the "
                         "kernel's index range")


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a [m,k] @ x [k] -> [m] in a's type, fp32 accumulation."""
    global LAUNCHES
    _check(a, x)
    # cuda_index's common case inline (a Python call saved); anything else
    # goes through it, which raises as on_cuda does
    index = a.get_device()
    if not (a.is_cuda and x.is_cuda and x.get_device() == index):
        index = cuda_index(a, x)
        if index < 0:
            return plain(a, x)
    m, k = a.shape
    y = a.new_empty((m,))
    if m:
        code = (_ENTRY.fn or _ENTRY.bind())(
            a.data_ptr(), x.data_ptr(), y.data_ptr(), m | k << 32,
            DTYPES[a.dtype] | index << 8,
            torch._C._cuda_getCurrentRawStream(index))
        if code:
            _ENTRY.fail(code)
        LAUNCHES += 1
    return y
