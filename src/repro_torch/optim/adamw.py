"""AdamW with decoupled weight decay and global-norm clipping: the port of
``repro.optim.adamw``.

State layout mirrors the param tree (mu/nu leaves), and ``AdamWState`` is a
NamedTuple whose field names are the checkpoint keys (``opt/.step``,
``opt/.mu/...``, ``opt/.nu/...``), as the reference's are.

The arithmetic is the reference's, in its order: the norm over every
gradient leaf in fp32, the gradients scaled by ``min(1, clip / norm)``,
the moments, the bias corrections in fp32, and the decay inside the
learning-rate product.  Where the reference's launcher donates params and
state to the jitted step, ``update`` writes the new params and moments
into the tensors it is given (under ``torch.no_grad``) and returns them,
with a new step counter; the gradients it is given are left as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.models.module import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        first = leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    def _lr(self, step):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return self.learning_rate

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - torch.pow(b1, step.to(torch.float32))
        bc2 = 1 - torch.pow(b2, step.to(torch.float32))
        lr = self._lr(step)
        for g, p, m, v in zip(leaves(grads), leaves(params),
                              leaves(state.mu), leaves(state.nu)):
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            mhat = m / bc1
            vhat = v / bc2
            p.sub_(lr * (mhat / (torch.sqrt(vhat) + self.eps)
                         + self.weight_decay * p))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)
