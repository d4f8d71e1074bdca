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

The global norm takes each leaf in one canonical order, on whole leaves
and on blocks alike: a stacked leaf (one under a ``scan`` key, whose axis
0 is the layer periods', ``models.module.stack``) one period at a time,
i = 0, 1, ...; each period, and each other leaf, in chunks along its axis
0 of at most NORM_CHUNK elements, each chunk's fp32 2-norm in one
reduction (``torch.linalg.vector_norm``, which casts as it reads); the
norm is then the 2-norm of those chunk norms, in tree order.  A leaf
whose periods fit in a chunk so costs one reduction a period, and the
fp32 transient is at most one chunk's.

Params held as blocks (``dist.sharding.Block``) get moments held as
blocks of the same spec, and their gradients are this rank's blocks
(plain tensors).  The update then runs on the blocks, elementwise in the
order above, so it is exact.  The norm gathers a split gradient whole
one period at a time (a leaf that is not stacked whole at once), takes
its chunks' norms in the order above and frees it before the next: no
stacked gradient is ever whole on a rank, and the norm is the global
view's to the bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.dist import collectives
from repro_torch.dist.collectives import names_of
from repro_torch.dist.sharding import Block, local
from repro_torch.models.module import leaves, stacked, tree_map


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

        def zeros(p):
            if isinstance(p, Block):
                return p.with_local(torch.zeros_like(p.local))
            return torch.zeros_like(p)

        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def _lr(self, step):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return self.learning_rate

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        gnorm = global_norm(grads, like=params)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - torch.pow(b1, step.to(torch.float32))
        bc2 = 1 - torch.pow(b2, step.to(torch.float32))
        lr = self._lr(step)
        for g, p, m, v in zip(leaves(grads), map(local, leaves(params)),
                              map(local, leaves(state.mu)),
                              map(local, leaves(state.nu))):
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            mhat = m / bc1
            vhat = v / bc2
            p.sub_(lr * (mhat / (torch.sqrt(vhat) + self.eps)
                         + self.weight_decay * p))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm


# elements of a gradient the norm reduces at a time (a cast chunk's fp32
# copy is the norm's transient where the reduction makes one)
NORM_CHUNK = 1 << 24


def global_norm(tree, like=None) -> torch.Tensor:
    """The 2-norm over every leaf of ``tree``, in the module docstring's
    order.  Where the matching leaf of ``like`` (the params) is a Block,
    the leaf is this rank's block, gathered whole a period at a time."""
    blocks = leaves(like) if like is not None else [None] * len(
        leaves(tree))
    norms = []
    for leaf, held, by_period in zip(leaves(tree), blocks, stacked(tree)):
        spec = held.spec if isinstance(held, Block) else ()
        if not by_period:
            norms += _chunk_norms(_whole(leaf, held, spec))
            continue
        if spec and names_of(spec[0]):
            raise ValueError(f"global_norm: a stacked leaf split on its "
                             f"periods' axis ({spec})")
        for period in leaf:
            norms += _chunk_norms(_whole(period, held, spec[1:]))
    return torch.linalg.vector_norm(torch.stack(norms))


def _whole(t: torch.Tensor, held, spec) -> torch.Tensor:
    if isinstance(held, Block):
        return collectives._gather_whole(t, held.mesh, spec)
    return t


def _chunk_norms(x: torch.Tensor) -> list:
    """The fp32 2-norms of ``x``'s chunks along its axis 0 (a row at
    least, NORM_CHUNK elements at most where the rows allow), in order."""
    x = x.reshape(1) if x.ndim == 0 else x
    rows = max(1, NORM_CHUNK // max(1, x.numel() // max(1, len(x))))
    return [torch.linalg.vector_norm(
        part.float() if part.dtype.itemsize > 4 else part, dtype=torch.float32)
        for part in x.split(rows)]
