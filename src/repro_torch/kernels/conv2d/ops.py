"""Public conv2d op: shape hooks, and the kernel or the library path.

The CUDA kernel masks ragged edges itself, so unlike the JAX package's
ops.py the output grid is not padded to block multiples.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import Aval, cudnn_fp32
from repro_torch.kernels.conv2d import conv2d as _kernel


def abstract_params(a, w) -> dict:
    """Predictor params from avals (shape-only; see kernels/matmul/ops.py)."""
    m, n = a.shape
    return {"m": int(m), "n": int(n), "r": int(w.shape[0])}


def out_aval(a, w) -> Aval:
    r = w.shape[0]
    return Aval((a.shape[0] - r + 1, a.shape[1] - r + 1), a.dtype)


def library(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` (cuDNN on a card) in fp32 with TF32 off, cast to a's
    type: the counterpart of the jnp path XLA compiled."""
    with cudnn_fp32():
        out = F.conv2d(a.float()[None, None], w.float()[None, None])[0, 0]
    return out.to(a.dtype)


def conv2d(a: torch.Tensor, w: torch.Tensor, *, bm: int = 32, bn: int = 32,
           use_kernel: bool = True) -> torch.Tensor:
    """``use_kernel=False`` is the library path; otherwise the hand kernel
    at tile (bm, bn) on a CUDA tensor, or its plain version on a CPU
    tensor."""
    abstract_params(a, w)
    if not use_kernel:
        return library(a, w)
    return _kernel.conv2d(a.contiguous(), w.contiguous(), bm=bm, bn=bn)
