"""Public matvec op: shape hooks, and the kernel or the plain path.

The CUDA kernel handles ragged rows and tails itself, so unlike the JAX
package's ops.py nothing is padded.  It has one schedule (1, 2 or 4 warps
a row, chosen by the kernel from the shape), so the block sizes of the
Pallas signature have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import Aval
from repro_torch.kernels.matvec import matvec as _kernel
from repro_torch.kernels.matvec import ref as _ref


def abstract_params(a, x) -> dict:
    """Predictor params from avals (shape-only; see kernels/matmul/ops.py)."""
    m, k = a.shape
    if x.shape and int(x.shape[0]) != int(k):
        raise ValueError(f"matvec contraction dims disagree: "
                         f"a is {tuple(a.shape)}, x is {tuple(x.shape)}")
    return {"m": int(m), "k": int(k)}


def out_aval(a, x) -> Aval:
    return Aval((a.shape[0],), a.dtype)


def matvec(a: torch.Tensor, x: torch.Tensor, *,
           use_kernel: bool = True) -> torch.Tensor:
    """``use_kernel=False`` is the library path (``torch.mv`` in fp32);
    otherwise the hand kernel on a CUDA tensor, or its plain version on a
    CPU tensor.  x is cast to a's type first, as in the JAX package."""
    abstract_params(a, x)
    if not use_kernel:
        return _ref.matvec(a, x)
    # no copy, and no no-op conversion call, for operands that are ready
    if x.dtype != a.dtype:
        x = x.to(a.dtype)
    return _kernel.matvec(a.contiguous(), x.contiguous())
