"""Logical-axis sharding rules, the active-mesh context and ``constrain``:
the port of the JAX package's ``dist/sharding.py`` for one device.

Models annotate every parameter and activation with *logical* axis names
("batch", "seq", "embed", "heads", "expert", ...).  A :class:`ShardingRules`
maps each logical axis to zero or more *physical* mesh axes.  Resolution
(``ShardingRules.spec``) keeps the reference's two invariants:

  * **dedup** — a physical mesh axis is used by at most one dimension of a
    tensor (first logical axis wins);
  * **divisibility** — a physical axis is only assigned when the dimension
    size is divisible by the mesh axis size (partial assignment of a tuple
    rule keeps the divisible prefix).

``spec`` returns a plain tuple (one entry per dimension: None, an axis name
or a tuple of names) where the reference returns a ``PartitionSpec``.

With no mesh active, or under ``use_mesh(None, None)``, ``constrain`` is an
exact no-op, as in the reference: the model code is annotated throughout
and runs unchanged on one device.  A mesh that actually shards over
``torch.distributed`` — ``constrain`` under an active mesh,
``tree_shardings``/``batch_shardings``, ring attention and the shard_map
MoE — waits for the dist slice and raises ``NotImplementedError`` here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Mapping, Optional, Sequence, Union

# A rule value: no sharding, one mesh axis, or an ordered tuple of mesh axes.
Physical = Union[None, str, tuple]

DIST_SLICE = ("sharding over a device mesh waits for the port's dist slice "
              "(torch.distributed); one device runs with no mesh active")


def _axis_sizes(mesh) -> dict:
    """{axis_name: size} for anything mesh-shaped (incl. test fakes)."""
    return dict(zip(tuple(mesh.axis_names), tuple(mesh.devices.shape)))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Immutable logical->physical axis mapping.

    Derive variants with ``ShardingRules({**rules.rules, "seq": "model"})``.
    """

    rules: Mapping[str, Physical]

    def physical(self, logical: Optional[str]) -> tuple:
        """Candidate physical axes for one logical axis (may be empty)."""
        if logical is None:
            return ()
        phys = self.rules.get(logical)
        if phys is None:
            return ()
        return (phys,) if isinstance(phys, str) else tuple(phys)

    def spec(self, logical_axes: Sequence[Optional[str]], *,
             shape: Optional[Sequence[int]] = None, mesh=None) -> tuple:
        """Partition spec, as a tuple, for a tensor with the given logical
        axes.  ``shape`` enables the divisibility check; ``mesh`` enables
        the membership check (rules may name axes the mesh does not have)
        and supplies axis sizes."""
        sizes = _axis_sizes(mesh) if mesh is not None else {}
        used: set = set()
        entries: list = []
        for i, name in enumerate(logical_axes):
            dim = None if shape is None else shape[i]
            kept: list = []
            prod = 1
            for ax in self.physical(name):
                if mesh is not None and ax not in sizes:
                    continue
                if ax in used:
                    continue
                n = sizes.get(ax, 1)
                if dim is not None and dim % (prod * n):
                    continue
                kept.append(ax)
                used.add(ax)
                prod *= n
            if not kept:
                entries.append(None)
            elif len(kept) == 1:
                entries.append(kept[0])
            else:
                entries.append(tuple(kept))
        return tuple(entries)


def train_rules(fsdp: bool = False, seq_parallel: bool = False) -> ShardingRules:
    """Training layout: batch over (pod, data), tensor parallel over model.

    ``fsdp`` additionally shards the weight "embed" dimension over the data
    axis (ZeRO-3 style); ``seq_parallel`` shards the activation sequence
    axis over the model axis (pairs with ring attention).
    """
    return ShardingRules({
        "batch": ("pod", "data"),
        "seq": "model" if seq_parallel else None,
        "embed": "data" if fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": "model",
        "layers": None,
        "cache_seq": None,
        "heads_act": None,
        "kv_heads_act": None,
    })


def serve_rules(long_context: bool = False) -> ShardingRules:
    """Decode layout: weights tensor-parallel, activations replicated per
    TP rank ("heads_act"/"kv_heads_act" -> None).  ``long_context`` shards
    the KV cache over the sequence ("cache_seq" -> model)."""
    return ShardingRules({
        "batch": ("pod", "data"),
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": "model",
        "layers": None,
        "cache_seq": "model" if long_context else None,
        "heads_act": None,
        "kv_heads_act": None,
    })


# --------------------------------------------------------------------------
# Active-mesh context
# --------------------------------------------------------------------------

_STATE = threading.local()


def _stack() -> list:
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    return stack


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[ShardingRules] = None):
    """Activate ``(mesh, rules)`` for the enclosing calls of this thread.

    ``use_mesh(None, None)`` pushes an explicit "no mesh" frame — inside it
    ``constrain`` is a no-op even when an outer frame holds a mesh.
    """
    _stack().append((mesh, rules))
    try:
        yield mesh
    finally:
        _stack().pop()


def active_mesh():
    stack = _stack()
    return stack[-1][0] if stack else None


def active_rules() -> Optional[ShardingRules]:
    stack = _stack()
    return stack[-1][1] if stack else None


def constrain(x, *logical_axes: Optional[str]):
    """``x`` itself with no mesh active; under an active mesh the axes are
    checked and the sharding raises (the dist slice)."""
    mesh = active_mesh()
    rules = active_rules()
    if mesh is None or rules is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"constrain: {len(logical_axes)} logical axes for "
                         f"rank-{x.ndim} tensor {tuple(x.shape)}")
    raise NotImplementedError(DIST_SLICE)
