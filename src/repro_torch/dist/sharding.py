"""Logical-axis sharding rules, the active-mesh context, ``constrain`` and
the blocked layout: the port of the JAX package's ``dist/sharding.py``.

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

**Held state is blocked.**  The reference's launchers and dry-run place
every leaf as its shard on each device (``in_shardings`` from
``tree_shardings``).  The port's counterpart is :func:`shard_tree`: each
leaf that its resolved spec splits becomes a :class:`Block`, this rank's
block of it (``collectives.block``) with the spec and mesh beside it; a
leaf the spec leaves whole stays a tensor.  Params, AdamW's moments, the
KV cache and the batch inputs are held so under a mesh.  A block is made
whole only where it is used and only along the axes the layer does not
compute on (:func:`gather_tree`, :func:`take`: an all-gather whose
backward is this rank's block of the gradient): per layer in the
transformer stack, inside each checkpointed period, and at the embedding,
final norm and unembedding.  The gather is exact, so a step over blocks
gives the values of the same step over whole leaves, bit for bit.  The
steps take either: whole leaves keep the *global view* (every rank holds
whole tensors), blocks are used where the caller passes them.

**Layers compute on this rank's block where the rules split them.**
With no mesh active, or under ``use_mesh(None, None)``, ``constrain`` is
an exact no-op, as in the reference.  Under an active mesh (a
``DeviceMesh`` from ``dist.compat.make_mesh``) it resolves the spec,
checks the rank and returns ``x`` itself.  The reference's
``with_sharding_constraint`` makes XLA compute the attention heads, the
MLP and the vocabulary tensor-parallel over ``model``; the port does the
same explicitly, Megatron's layout: where :func:`split_axes` (the mesh
axes the active rules put on one dimension of an activation, after dedup
and divisibility) names axes for the ``heads``, ``kv_heads``, ``mlp`` or
``vocab`` dimension, the layer computes on this rank's block
(``models.attention``, ``models.layers``, the cross-entropy of
``train.step``), with ``collectives.copy_to`` on its whole input and
``collectives.reduce_from`` on a row-parallel output.  :func:`take` gives
the weight block the layer computes with: a :class:`Block` held so is used
as it is, other axes gathered; a whole leaf is cut at use
(``collectives.split``), so the global view and the blocked layout run the
same program.  Where the spec leaves the dimension whole the layer gathers
its weights and computes whole, as before.  Under ``train_rules(
seq_parallel=True)`` dedup gives ``model`` to the sequence, so the ring
path computes every layer whole.  Hymba's SSM branch runs on this rank's
``mlp`` channels, the mLSTM on its channels and, where the rules split
them, its heads, the sLSTM's gate product on its block of each gate
(``models.ssm``, ``models.xlstm``; :func:`take_parts` cuts a leaf whose
axis concatenates parts; where its heads do not divide the axes the
mLSTM's core runs on this rank's block of C's value rows), the MoE's
shared expert is the split MLP and its experts compute on this rank's
block of them (the global and local dispatches; the shard_map dispatch is
a region of its own).  A cache is blocked over its batch axis and, where
the rules split them, its KV heads, SSM channels and mLSTM heads or C's
value rows (:func:`cache_shardings`): the layers write this rank's block
of each; under ``serve_rules(long_context=True)`` the KV leaves are
blocked over their sequence instead, and the decode step attends on this
rank's positions (``models.attention.attention_decode_step``).  A
data-parallel region (:func:`data_region`) makes its batch axes known to
the layers it runs.
``tree_shardings``/``batch_shardings`` give per leaf the resolved spec and
its DTensor placements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Union

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

from repro_torch.dist import collectives
from repro_torch.dist.collectives import names_of

# A rule value: no sharding, one mesh axis, or an ordered tuple of mesh axes.
Physical = Union[None, str, tuple]



def _axis_sizes(mesh) -> dict:
    """{axis_name: size} for a ``DeviceMesh`` (``mesh_dim_names``, its
    shape) or anything JAX-mesh-shaped (``axis_names``,
    ``devices.shape``: the test fakes)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))
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


class Region(NamedTuple):
    """A data-parallel region (``train.step._data_parallel``,
    ``serve.decode``'s steps): the whole ``mesh``, the batch ``axes`` it
    cut this rank's rows over (blocks in ``local_batch``'s order, the first
    axis outermost), and ``weight``, the factor the region multiplies this
    rank's gradients by before summing them over ``axes`` (None where no
    gradient is taken)."""

    mesh: Any
    axes: tuple
    weight: Optional[torch.Tensor] = None


def _regions() -> list:
    regions = getattr(_STATE, "regions", None)
    if regions is None:
        regions = _STATE.regions = []
    return regions


@contextlib.contextmanager
def data_region(mesh, axes: tuple, weight: Optional[torch.Tensor] = None):
    """Make a data-parallel region known to the layers it runs (this
    thread's enclosing calls): a layer that the reference computes over
    the whole batch at once (``models.moe``'s global dispatch) reads the
    batch axes from :func:`active_region` and reduces over them.  The
    region's model runs under ``use_mesh`` of the rest of the mesh
    inside it."""
    _regions().append(Region(mesh, tuple(axes), weight))
    try:
        yield
    finally:
        _regions().pop()


def active_region() -> Optional[Region]:
    regions = _regions()
    return regions[-1] if regions else None


def region_period(tree: Any) -> Any:
    """Params as a data-parallel region that takes gradients uses them:
    each Block held split over the region's batch axes (fsdp) gathered
    whole over them (a Block of the rest of its spec, or a tensor), its
    gradient multiplied by the region's weight, summed over the batch
    axes and cut to this rank's block in the backward
    (``collectives.gather_summed``); every other leaf as it is, its
    gradient summed after the region (``train.step``).  A stacked layer
    period's leaves (``models.transformer``) are so gathered and reduced
    one period at a time, inside the period's checkpoint: no stacked
    leaf or its gradient is ever whole over the batch axes (the MoE's
    global dispatch takes its experts' blocks as they are held instead,
    ``models.moe``).  ``tree`` as it is outside such a region."""
    region = active_region()
    if region is None or region.weight is None:
        return tree

    def one(leaf):
        if not split_over(leaf, region.axes):
            return leaf
        axes = set(region.axes)
        over = tuple(e if set(names_of(e)) & axes else None
                     for e in leaf.spec)
        rest = tuple(None if o else e for e, o in zip(leaf.spec, over))
        whole = collectives.gather_summed(leaf.local, leaf.mesh, over,
                                          region.axes, region.weight)
        return Block(whole, rest, leaf.mesh) if any(rest) else whole

    return _map(one, tree)


def region_params(params: Any) -> Any:
    """:func:`region_period` of every leaf of a model's params but the
    stacked layer periods' (under a ``scan`` key), which the layer stack
    takes one period at a time."""
    if isinstance(params, dict):
        return {k: v if k == "scan" else region_params(v)
                for k, v in params.items()}
    return region_period(params)


def split_over(leaf, axes) -> bool:
    """Whether ``leaf`` is a Block whose spec names one of the mesh axes
    ``axes``."""
    return isinstance(leaf, Block) and any(
        set(names_of(e)) & set(axes) for e in leaf.spec)


def bind_frame(fn):
    """``fn`` run under the mesh frame and data-parallel region active
    now, wherever it is called: a checkpoint's recompute runs on
    autograd's device thread on the card, where this thread's frames are
    not active."""
    if not _stack() and not _regions():
        return fn
    mesh, rules, region = active_mesh(), active_rules(), active_region()

    def run(*args, **kwargs):
        with contextlib.ExitStack() as frames:
            if region is not None:
                frames.enter_context(data_region(*region))
            frames.enter_context(use_mesh(mesh, rules))
            return fn(*args, **kwargs)
    return run


def constrain(x, *logical_axes: Optional[str]):
    """``x`` itself: with no mesh active at once; under an active mesh
    after the rank check and the spec's resolution.  Activations keep the
    global view (module docstring): only held state is blocked."""
    mesh = active_mesh()
    rules = active_rules()
    if mesh is None or rules is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"constrain: {len(logical_axes)} logical axes for "
                         f"rank-{x.ndim} tensor {tuple(x.shape)}")
    rules.spec(logical_axes, shape=x.shape, mesh=mesh)
    return x


def split_axes(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
               dim: int) -> tuple:
    """The mesh axes of more than one rank that the active rules put on
    dimension ``dim`` of a tensor with ``logical_axes`` and ``shape``, after
    dedup and divisibility (what ``constrain`` resolves); () with no mesh
    active.  The layers compute on this rank's block of that dimension
    where it names any."""
    mesh, rules = active_mesh(), active_rules()
    if mesh is None or rules is None:
        return ()
    sizes = _axis_sizes(mesh)
    entry = rules.spec(logical_axes, shape=shape, mesh=mesh)[dim]
    if not any(sizes[n] > 1 for n in names_of(entry)):
        return ()
    return names_of(entry)


# --------------------------------------------------------------------------
# Tree / batch shardings
# --------------------------------------------------------------------------

class Sharding(NamedTuple):
    """One leaf's layout on a mesh: ``spec``, the entries of the
    reference's ``NamedSharding.spec``, and ``placements``, the DTensor
    placement per mesh dimension (``Shard(i)`` where tensor dim i uses
    that axis, else ``Replicate()``)."""

    spec: tuple
    placements: tuple


def _placed(spec: tuple, mesh) -> Sharding:
    dim_of = {}
    for dim, entry in enumerate(spec):
        for name in names_of(entry):
            dim_of[name] = dim
    placements = tuple(Shard(dim_of[name]) if name in dim_of else Replicate()
                       for name in _axis_sizes(mesh))
    return Sharding(spec, placements)


def _sharding(axes, shape, mesh, rules: ShardingRules) -> Sharding:
    return _placed(rules.spec(axes, shape=shape, mesh=mesh), mesh)


def tree_shardings(tree: Any, mesh, rules: ShardingRules) -> Any:
    """A :class:`Sharding` per leaf of a ParamSpec tree (params, optimizer
    state, caches)."""
    from repro_torch.models.module import tree_map

    def one(spec):
        axes = spec.logical_axes or (None,) * len(spec.shape)
        return _sharding(axes, spec.shape, mesh, rules)

    return tree_map(one, tree)


# the cache dimensions the blocked layout splits: the rows, the sequence
# (``serve_rules(long_context=True)``: the decode step attends on this
# rank's positions), and the state the layers compute on blocks of (the KV
# heads, hymba's SSM channels, the mLSTM's heads or its C's value rows)
_CACHE_AXES = ("batch", "cache_seq", "kv_heads", "mlp", "heads",
               "value_rows")

# an mLSTM C's trailing logical axes: [heads, value rows, key columns]
_MLSTM_C = ("heads", "head_dim", "head_dim")


def cache_logical(logical_axes: Sequence[Optional[str]]) -> tuple:
    """A cache leaf's logical axes as the blocked layout reads them: an
    mLSTM C's value rows (its first ``head_dim``, v's head dim) named
    ``"value_rows"``, which the rules split as the mLSTM's ``mlp``
    channels (after dedup: only where its heads take no axis)."""
    axes = tuple(logical_axes)
    if axes[-3:] == _MLSTM_C:
        return axes[:-2] + ("value_rows", "head_dim")
    return axes


def cache_shardings(tree: Any, mesh, rules: ShardingRules) -> Any:
    """A :class:`Sharding` per leaf of a cache's ParamSpec tree in the
    blocked layout: the entries of its "batch", "cache_seq", "kv_heads",
    "mlp" and "heads" dimensions, and of an mLSTM C's value rows
    (:func:`cache_logical`), only (module docstring).  Under
    ``serve_rules(long_context=True)`` the sequence takes ``model`` (the
    KV heads then stay whole: dedup), so each rank holds ``Smax / n``
    positions of every KV leaf; the sLSTM's state stays whole."""
    from repro_torch.models.module import tree_map

    rules = ShardingRules({**rules.rules, "value_rows": rules.rules.get(
        "mlp")})

    def one(spec):
        axes = cache_logical(spec.logical_axes or (None,) * len(spec.shape))
        resolved = _sharding(axes, spec.shape, mesh, rules).spec
        return _placed(tuple(e if ax in _CACHE_AXES else None
                             for e, ax in zip(resolved, axes)), mesh)

    return tree_map(one, tree)


# Logical axes of the model-input tensors, by input name.
_BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "patches": ("batch", "seq", "embed"),
    "frames": ("batch", "seq", "embed"),
}


def batch_shardings(batch_specs: Mapping[str, Any], mesh,
                    rules: ShardingRules) -> dict:
    """A :class:`Sharding` per model input, from anything with a
    ``.shape`` (tensors, or shape-only stand-ins)."""
    out = {}
    for key, sds in batch_specs.items():
        shape = tuple(sds.shape)
        axes = _BATCH_AXES.get(key, ("batch",) + (None,) * (len(shape) - 1))
        out[key] = _sharding(tuple(axes[:len(shape)]), shape, mesh, rules)
    return out


# --------------------------------------------------------------------------
# The blocked layout
# --------------------------------------------------------------------------

class Block:
    """This rank's block ``local`` of one leaf under ``spec`` on ``mesh``
    (module docstring).  It is a leaf of the param, optimizer, cache and
    batch trees: ``module.tree_map`` hands it over whole, torch's pytree
    sees its one tensor.  ``shape``, ``dtype`` and ``device`` are the
    block's; indexing takes a period of a stacked leaf, whose leading
    ("layers") axis no rule splits."""

    __slots__ = ("local", "spec", "mesh")

    def __init__(self, local: torch.Tensor, spec, mesh):
        self.local, self.spec, self.mesh = local, tuple(spec), mesh

    @property
    def shape(self) -> torch.Size:
        return self.local.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def whole_shape(self) -> tuple:
        sizes = _axis_sizes(self.mesh)
        out = []
        for n, entry in zip(self.local.shape, self.spec):
            for name in names_of(entry):
                n *= sizes[name]
            out.append(n)
        return tuple(out)

    def with_local(self, local: torch.Tensor) -> "Block":
        return Block(local, self.spec, self.mesh)

    def __getitem__(self, i) -> "Block":
        if names_of(self.spec[0]):
            raise ValueError(f"Block: indexing splits axis 0 ({self.spec})")
        return Block(self.local[i], self.spec[1:], self.mesh)

    def __repr__(self) -> str:
        return (f"Block({tuple(self.local.shape)} of {self.whole_shape()}, "
                f"{self.local.dtype}, spec={self.spec})")


pytree.register_pytree_node(
    Block, lambda b: ([b.local], (b.spec, b.mesh)),
    lambda values, ctx: Block(values[0], *ctx),
    serialized_type_name="repro_torch.dist.sharding.Block")


def local(leaf):
    """The tensor this rank holds for ``leaf`` (a Block's block)."""
    return leaf.local if isinstance(leaf, Block) else leaf


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, NamedTuples, tuples and
    lists (and of the trees in ``rest``, of the same structure)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _splits(spec, mesh) -> bool:
    sizes = _axis_sizes(mesh)
    return any(sizes[name] > 1 for entry in spec for name in names_of(entry))


def shard_tree(tree: Any, shardings: Any, mesh) -> Any:
    """Each tensor leaf of ``tree`` that its :class:`Sharding` (the
    matching tree of ``tree_shardings``, ``cache_shardings`` or
    ``batch_shardings``) splits, as a :class:`Block` holding a copy of this
    rank's block, so that the whole leaf can be freed; other leaves as
    they are."""
    def one(leaf, sh):
        if not isinstance(leaf, torch.Tensor) or sh is None \
                or not _splits(sh.spec, mesh):
            return leaf
        part = collectives.block(leaf, mesh, sh.spec)
        return Block(part.clone(memory_format=torch.contiguous_format),
                     sh.spec, mesh)

    return _map(one, tree, shardings)


def gather_tree(tree: Any) -> Any:
    """``tree`` with every :class:`Block` made whole on every rank
    (``collectives.gather``: differentiable, its backward this rank's
    block of the gradient); other leaves as they are.  The models call it
    where a leaf is used; checkpoints and tests call it for whole
    leaves."""
    return _map(lambda leaf: collectives.gather(leaf.local, leaf.mesh,
                                                leaf.spec)
                if isinstance(leaf, Block) else leaf, tree)


def whole_shape(leaf) -> tuple:
    """The whole leaf's shape, for a Block or a tensor."""
    return leaf.whole_shape() if isinstance(leaf, Block) else tuple(leaf.shape)


def take(leaf, dim: Optional[int] = None, axes: tuple = ()):
    """The tensor a layer computes with for one param leaf: with ``axes``
    (the active mesh's, :func:`split_axes`) this rank's block of dimension
    ``dim`` over them, whole along every other dimension; without, the
    whole leaf.  A :class:`Block` held over exactly those axes there is
    used as it is, its other axes gathered (``collectives.gather``); a
    Block held otherwise is gathered whole first; a whole tensor is cut to
    its block (``collectives.split``: its backward all-gathers the
    gradient)."""
    if isinstance(leaf, Block):
        spec = leaf.spec
        if axes and tuple(names_of(spec[dim])) == tuple(axes):
            rest = tuple(None if i == dim else e for i, e in enumerate(spec))
            if not any(names_of(e) for e in rest):
                return leaf.local
            return collectives.gather(leaf.local, leaf.mesh, rest)
        leaf = collectives.gather(leaf.local, leaf.mesh, spec)
    if not axes:
        return leaf
    spec = tuple(tuple(axes) if i == dim else None for i in range(leaf.ndim))
    return collectives.split(leaf, active_mesh(), spec)


def take_parts(leaf, dim: int, axes: tuple, parts):
    """:func:`take` for a leaf whose dimension ``dim`` concatenates equal
    parts (the mLSTM's ``w_up`` = [core_in | gate], the sLSTM's
    ``w_gates`` = [z | i | f | o]): with ``axes``, this rank's block of
    each part, concatenated in the parts' order, whole along every other
    dimension; without, the whole leaf.  ``parts`` is their count, or a
    tuple: ``dim`` then concatenates that many equal segments, the i-th of
    ``parts[i]`` equal parts (the mLSTM's ``w_up`` on value rows, (1, H):
    the core half's block and the gate half's block of each head).  A
    contiguous block of the concatenated axis (what a :class:`Block` holds
    there) is not that: on 4 ranks ranks 0-1 would hold only the first
    half's channels.  A Block held over ``axes`` on ``dim`` (one mesh axis
    of more than one rank among them) is regrouped by one all-to-all
    (:func:`_regroup`), so each rank receives 1/n of the leaf; another
    Block is gathered whole first.  A whole leaf is cut by
    ``collectives.split``, a segment at a time (its backward all-gathers
    the gradient)."""
    segments = (parts,) if isinstance(parts, int) else tuple(parts)
    if isinstance(leaf, Block):
        regrouped = _regroup(leaf, dim, axes, segments)
        if regrouped is not None:
            return regrouped
        leaf = collectives.gather(leaf.local, leaf.mesh, leaf.spec)
    if not axes:
        return leaf
    blocks = []
    for seg, count in zip(leaf.chunk(len(segments), dim), segments):
        shape = tuple(seg.shape)
        grouped = seg.reshape(shape[:dim] + (count, shape[dim] // count)
                              + shape[dim + 1:])
        spec = tuple(tuple(axes) if i == dim + 1 else None
                     for i in range(grouped.ndim))
        blocks.append(collectives.split(grouped, active_mesh(), spec)
                      .flatten(dim, dim + 1))
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim)


def _regroup(leaf: "Block", dim: int, axes: tuple, segments: tuple):
    """:func:`take_parts` of a Block held over ``axes`` on ``dim`` (its
    other split axes gathered first, as :func:`take` does), by one
    all-to-all over the one axis of more than one rank among ``axes``:
    rank s holds positions [s·D/n, (s+1)·D/n) of the concatenated
    dimension, rank r wants its block of each part, and each position
    has one owner either side, so each rank sends and receives D/n.  The
    pieces rank r receives, in the senders' order, are its wanted
    positions in ascending order.  None where this does not apply."""
    mesh = leaf.mesh
    spec = leaf.spec
    live = [a for a in names_of(spec[dim])
            if collectives.axis_size(mesh, a) > 1]
    if not axes or tuple(names_of(spec[dim])) != tuple(axes) \
            or len(live) != 1:
        return None
    n = collectives.axis_size(mesh, live[0])
    held = leaf.local.shape[dim]
    seg, rem = divmod(held * n, len(segments))
    if rem or any(seg % count or (seg // count) % n for count in segments):
        return None
    runs, send, recv = _regroup_plan(held, n, collectives.axis_index(
        mesh, live[0]), segments)
    rest = tuple(None if i == dim else e for i, e in enumerate(spec))
    local_ = leaf.local
    if any(names_of(e) for e in rest):
        local_ = collectives.gather(local_, mesh, rest)
    pieces = [local_.narrow(dim, start, size) for start, size in runs]
    sent = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)
    return collectives.exchange(sent, mesh, live[0], dim, send, recv)


@functools.lru_cache(maxsize=None)
def _regroup_plan(held: int, n: int, me: int, segments: tuple) -> tuple:
    """(the runs (start, size) of held positions rank ``me`` sends, in the
    order it sends them, the count it sends to each rank, the count it
    receives from each) for :func:`_regroup`: the n·held positions are
    ``len(segments)`` equal segments, the i-th of ``segments[i]`` equal
    parts, and rank r wants its block of each part, in ascending order."""
    seg = held * n // len(segments)

    def wanted(r):
        out = []
        for i, count in enumerate(segments):
            part = seg // count
            step = part // n
            out.extend(i * seg + p * part + r * step + j
                       for p in range(count) for j in range(step))
        return out

    lo, hi = me * held, (me + 1) * held
    runs, send = [], []
    for r in range(n):
        got = [i - lo for i in wanted(r) if lo <= i < hi]
        send.append(len(got))
        for i in got:
            if runs and runs[-1][0] + runs[-1][1] == i:
                runs[-1][1] += 1
            else:
                runs.append([i, 1])
    recv = [sum(1 for i in wanted(me) if s * held <= i < (s + 1) * held)
            for s in range(n)]
    return tuple(map(tuple, runs)), tuple(send), tuple(recv)


def held_batch_shardings(batch_specs: Mapping[str, Any], mesh,
                         rules: ShardingRules) -> dict:
    """``batch_shardings`` with the batch dimension's entry only: how the
    blocked layout holds the model inputs (their sequence stays whole,
    for a ring to split)."""
    return {k: _placed(sh.spec[:1] + (None,) * (len(sh.spec) - 1), mesh)
            for k, sh in batch_shardings(batch_specs, mesh, rules).items()}


def local_batch(batch: Mapping[str, Any], mesh, rules: ShardingRules
                ) -> tuple:
    """(this rank's block of every model input along the batch dimension,
    the mesh axes that dimension is split over) for a batch of whole
    tensors or Blocks (``held_batch_shardings``'): a data-parallel
    region's inputs.  A sequence the
    rules put on the mesh (``seq_parallel``) stays whole, for the ring to
    split."""
    whole = {k: v for k, v in batch.items() if not isinstance(v, Block)}
    specs = {k: sh.spec for k, sh in batch_shardings(whole, mesh,
                                                     rules).items()}
    specs.update((k, v.spec) for k, v in batch.items()
                 if isinstance(v, Block))
    axes = tuple(dict.fromkeys(n for spec in specs.values()
                               for n in names_of(spec[0])))
    part = {k: v.local if isinstance(v, Block)
            else collectives.block(v, mesh, specs[k][:1])
            for k, v in batch.items()}
    return part, axes
