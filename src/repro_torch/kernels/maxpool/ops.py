"""Public maxpool op: shape hooks, and the kernel or the library path.

Every valid output's window lies inside the plane, and the CUDA kernel
masks the ragged edge of the output grid itself, so unlike the JAX
package's ops.py nothing is padded with -inf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import Aval
from repro_torch.kernels.maxpool import maxpool as _kernel


def abstract_params(a, *, r: int, s: int) -> dict:
    """Predictor params from avals (shape-only; see kernels/matmul/ops.py).
    ``r``/``s`` are static keyword operands and ride along as params."""
    m, n = a.shape
    return {"m": int(m), "n": int(n), "r": int(r), "s": int(s)}


def out_aval(a, *, r: int, s: int) -> Aval:
    m, n = a.shape
    return Aval(((m - r) // s + 1, (n - r) // s + 1), a.dtype)


def library(a: torch.Tensor, *, r: int, s: int) -> torch.Tensor:
    """``F.max_pool2d``: the counterpart of the jnp path XLA compiled."""
    return F.max_pool2d(a[None, None], r, s)[0, 0]


def maxpool(a: torch.Tensor, *, r: int, s: int, bm: int = 32, bn: int = 32,
            use_kernel: bool = True) -> torch.Tensor:
    """``use_kernel=False`` is the library path; otherwise the hand kernel
    at tile (bm, bn) on a CUDA tensor, or its plain version on a CPU
    tensor."""
    abstract_params(a, r=r, s=s)
    if not use_kernel:
        return library(a, r=r, s=s)
    return _kernel.maxpool(a.contiguous(), r=r, s=s, bm=bm, bn=bn)
