"""Int8 error-feedback gradient compression: the port of
``repro.optim.compression``.

Quantise per tensor to int8 before the (conceptual) data-parallel
all-reduce and keep the quantisation residual locally, adding it back into
the next step's gradient (error feedback).  ``torch.round`` rounds half to
even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.module import tree_map


class CompressionState(NamedTuple):
    residual: Any


def init(params) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, state: CompressionState
                   ) -> tuple[Any, CompressionState]:
    """Returns (decompressed grads as seen post-all-reduce, new residuals)."""
    def one(g, r):
        g = g.to(torch.float32) + r
        q, s = quantize(g)
        deq = dequantize(q, s)
        return deq, g - deq

    pairs = tree_map(one, grads, state.residual)
    deq = tree_map(lambda t: t[0], pairs)
    res = tree_map(lambda t: t[1], pairs)
    return deq, CompressionState(residual=res)
