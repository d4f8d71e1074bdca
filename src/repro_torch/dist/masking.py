"""Attention-mask semantics shared by the dense attention paths.

The port's own copy of the JAX package's ``dist/masking.py``: one definition
of visibility (causal / sliding-window / pad-sentinel) for
``models.attention``'s full and chunked paths.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
PAD_SENTINEL = 10 ** 9       # k positions >= this are padding (never visible)


def mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
              window: int) -> torch.Tensor:
    """[Sq,Sk] fp32 additive bias: 0 where visible, NEG_INF elsewhere
    ([1,Sk] when neither mask depends on the query, as in JAX)."""
    ok = k_pos[None, :] < PAD_SENTINEL
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)
