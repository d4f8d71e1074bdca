"""Public matmul op: shape hooks, and the kernel or the plain path.

The CUDA kernel masks ragged edges itself, so unlike the JAX package's
ops.py nothing is padded to block multiples and sliced back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import Aval
from repro_torch.kernels.matmul import matmul as _kernel
from repro_torch.kernels.matmul import ref as _ref


def abstract_params(a, b) -> dict:
    """Predictor params from avals — shape-only, safe to call without data
    (the ``repro_torch.api`` tracer derives NN+C features through this
    hook)."""
    m, k = a.shape
    kb, n = b.shape
    if int(kb) != int(k):
        raise ValueError(f"matmul contraction dims disagree: "
                         f"a is {tuple(a.shape)}, b is {tuple(b.shape)}")
    return {"m": int(m), "n": int(n), "k": int(k)}


def out_aval(a, b) -> Aval:
    return Aval((a.shape[0], b.shape[1]), a.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
           bk: int = 32, use_kernel: bool = True) -> torch.Tensor:
    """``use_kernel=False`` is the library path (``torch.matmul`` in fp32);
    otherwise the hand kernel at schedule (bm, bn, bk) on a CUDA tensor, or
    its plain version on a CPU tensor."""
    abstract_params(a, b)
    if not use_kernel:
        return _ref.matmul(a, b)
    return _kernel.matmul(a.contiguous(), b.contiguous(), bm=bm, bn=bn, bk=bk)
