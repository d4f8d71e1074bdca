"""Lightweight param-spec module system (t5x-style logical axes): the port
of the JAX package's ``models/module.py``.

Models are pure functions over trees (nested dicts) of tensors.  Parameters
are *declared* as ``ParamSpec`` trees carrying shape, torch dtype, logical
axis names and an init rule; the tree can then be

  * materialised  -> ``init(generator, tree, device)``
  * shape-only    -> ``shape_tree(tree)``  (tensors on the ``meta`` device)

and the JAX package's arrays (parameters, caches) carry across with
``from_numpy``.  Logical axis names ("embed", "heads", "mlp", "vocab",
"layers", ...) map to mesh axes through
:class:`repro_torch.dist.sharding.ShardingRules`.

``init`` draws each leaf from its own ``torch.Generator``, seeded from the
caller's generator's seed and the leaf's index — the counterpart of the
reference's ``fold_in(rng, i)``.  torch's generator gives other numbers
than JAX's for the same seed, so parity tests carry the JAX package's
weights across with ``from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of a single parameter tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    logical_axes: tuple[Optional[str], ...] = ()
    init: str = "normal"          # normal | zeros | ones | embed | scaled
    init_scale: float = 1.0
    fan_in_axes: tuple[int, ...] = ()   # axes contracted by the consumer

    def __post_init__(self):
        if self.logical_axes and len(self.logical_axes) != len(self.shape):
            raise ValueError(
                f"logical_axes {self.logical_axes} rank-mismatch shape {self.shape}"
            )

    # -- materialisation -------------------------------------------------
    def instantiate(self, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        noise = torch.randn(self.shape, generator=generator,
                            dtype=torch.float32, device=device)
        if self.init == "embed":
            return (noise * self.init_scale).to(self.dtype)
        # variance-scaling (fan-in) init, the default for projection weights
        fan_in = 1
        for ax in (self.fan_in_axes or tuple(range(len(self.shape) - 1))):
            fan_in *= self.shape[ax]
        std = self.init_scale / math.sqrt(max(fan_in, 1))
        return (noise * std).to(self.dtype)

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of nested dicts (and of the trees in ``rest``,
    which share ``tree``'s structure); keys in sorted order, as JAX's tree
    functions take them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def leaves(tree: PyTree) -> list:
    """The leaves of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def stacked(tree: PyTree, under: bool = False) -> list:
    """Per leaf of ``tree`` (:func:`leaves`' order): whether it lies under
    a ``scan`` key, where the layer periods are stacked on axis 0
    (:func:`stack`)."""
    if isinstance(tree, dict):
        return [flag for k in sorted(tree)
                for flag in stacked(tree[k], under or k == "scan")]
    return [under]


def _fold_in(seed: int, index: int) -> int:
    """A 63-bit seed for leaf ``index`` of a tree drawn from ``seed``
    (splitmix64 of the pair, so neighbouring leaves get unrelated
    streams)."""
    z = (seed * 0x9E3779B97F4A7C15 + index + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


def init(generator: torch.Generator, tree: PyTree,
         device="cuda") -> PyTree:
    """Materialise a ParamSpec tree on ``device`` (the card unless the
    caller asks for the CPU).  Leaf i draws from a generator of its own on
    the device, seeded from ``generator.initial_seed()`` and i."""
    device = resolve_device(device)
    seed = generator.initial_seed()
    count = iter(range(len(leaves(tree))))   # leaf index, in tree_map order

    def one(spec: ParamSpec) -> torch.Tensor:
        g = torch.Generator(device=device)
        g.manual_seed(_fold_in(seed, next(count)))
        return spec.instantiate(g, device)

    return tree_map(one, tree)


def shape_tree(tree: PyTree) -> PyTree:
    """Tensors on the ``meta`` device for every spec (no allocation);
    leaves that are already tensors pass through unchanged."""
    return tree_map(lambda s: s.meta() if is_spec(s) else s, tree)


def stack(spec: ParamSpec, n: int, axis_name: str = "layers") -> ParamSpec:
    """Prepend a stacking axis (for the stacked layer periods)."""
    return dataclasses.replace(
        spec,
        shape=(n,) + spec.shape,
        logical_axes=((axis_name,) + (spec.logical_axes or (None,) * len(spec.shape))),
        fan_in_axes=tuple(a + 1 for a in (spec.fan_in_axes or tuple(range(len(spec.shape) - 1)))),
    )


def stack_tree(tree: PyTree, n: int, axis_name: str = "layers") -> PyTree:
    return tree_map(lambda s: stack(s, n, axis_name), tree)


def count_params(tree: PyTree) -> int:
    total = 0
    for leaf in leaves(tree):
        total += int(np.prod(leaf.shape)) if leaf.shape else 1
    return total


def param_bytes(tree: PyTree) -> int:
    total = 0
    for leaf in leaves(tree):
        size = int(np.prod(leaf.shape)) if leaf.shape else 1
        total += size * leaf.dtype.itemsize
    return total


def _tensor(leaf, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: through
        # float32 and back, exact both ways
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr).to(device)


def from_numpy(tree: PyTree, *, device="cuda") -> PyTree:
    """The same tree of tensors on ``device`` for a nested dict of numpy
    arrays (or anything ``np.asarray`` takes, such as the JAX package's
    arrays): how its parameters and caches carry across.  Types are kept;
    bfloat16 arrives exactly."""
    device = resolve_device(device)
    return tree_map(lambda leaf: _tensor(leaf, device), tree)
