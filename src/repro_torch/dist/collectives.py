"""The collectives of ``jax.lax`` that torch lacks, over a ``DeviceMesh``.

The JAX package has no counterpart module: there ``shard_map`` slices
global arrays per ``in_specs``, runs the body per device with
``axis_index``, ``ppermute`` and ``psum``, and assembles global outputs per
``out_specs``.  The port is multi-process SPMD and keeps the same *global
view* at its entry points: every rank holds the whole (replicated) input
tensors, an SPMD region takes this rank's block with :func:`shard`,
computes, exchanges with :func:`ppermute` / :func:`psum` / :func:`pmean`,
and returns the whole output on every rank with :func:`unshard`.  A spec is
a tuple with one entry per dimension: None, a mesh axis name, or a tuple
of names (blocks ordered with the first name outermost), as
``ShardingRules.spec`` returns.

Each collective is a ``torch.autograd.Function``; every rank computes the
same loss on the same global outputs, and the backward rules keep every
rank's gradient the whole, true one:

  * ``ppermute``: the inverse permutation;
  * ``psum``: a psum of the cotangents (``pmean`` divides by the size);
  * ``unshard`` (the output gather): this rank's block of the cotangent,
    divided by the size of the mesh axes the spec does not name (ranks
    along them computed the same block redundantly).  It does *not* sum
    over ranks: that would count the gradient once per rank;
  * ``shard``: the cotangent placed in zeros of the whole shape and summed
    over the whole mesh — the contributions of every rank, each once.

Transport (``mesh.transport``, see ``dist.compat``): under gloo a CUDA
tensor is copied to host memory and back around each collective and the
bytes and seconds are counted there; under NCCL tensors go as they are.  A
collective that fails raises; nothing retries.
"""
from __future__ import annotations

import time
from typing import Sequence

import torch
import torch.distributed as dist


def names_of(entry) -> tuple:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(name)


def _ranks(mesh, name: str) -> list:
    """Global ranks along ``name`` through this rank, by coordinate."""
    return dist.get_process_group_ranks(mesh.get_group(name))


# --------------------------------------------------------------------------
# transport
# --------------------------------------------------------------------------

def _to_wire(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.contiguous()
    link = mesh.transport
    if link.staged and t.is_cuda:
        t0 = time.perf_counter()
        t = t.cpu()
        link.host_s += time.perf_counter() - t0
        link.host_bytes += t.numel() * t.element_size()
    return t


def _from_wire(w: torch.Tensor, like: torch.Tensor, mesh) -> torch.Tensor:
    if w.device == like.device:
        return w
    link = mesh.transport
    t0 = time.perf_counter()
    out = w.to(like.device)
    link.host_s += time.perf_counter() - t0
    link.host_bytes += w.numel() * w.element_size()
    return out


def _all_reduce(t: torch.Tensor, mesh, names: Sequence[str]) -> torch.Tensor:
    """Sum of ``t`` over the mesh axes ``names`` (a new tensor)."""
    names = [n for n in names if axis_size(mesh, n) > 1]
    if not names:
        return t.clone()
    w = _to_wire(t, mesh)
    if w is t:
        w = t.clone()
    for name in names:
        dist.all_reduce(w, group=mesh.get_group(name))
    return _from_wire(w, t, mesh)


def reduce_sum_(tensors: Sequence[torch.Tensor], mesh,
                names: Sequence[str]) -> None:
    """In place, each of ``tensors`` summed over the mesh axes ``names``
    (outside autograd: the data-parallel gradient reduction).  Every
    tensor goes through the group's all-reduce, on an axis of one too."""
    for t in tensors:
        w = _to_wire(t, mesh)
        for name in names:
            dist.all_reduce(w, group=mesh.get_group(name))
        if w is not t:
            t.copy_(_from_wire(w, t, mesh))


def _all_gather(t: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, name)
    if n == 1:
        return t
    w = _to_wire(t, mesh)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=mesh.get_group(name))
    return _from_wire(torch.cat(parts, dim=dim), t, mesh)


def _pack(tensors: list) -> torch.Tensor:
    """One flat buffer of ``tensors`` (one dtype): one message a hop."""
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("ppermute: tensors of one dtype only, got "
                         f"{[t.dtype for t in tensors]}")
    if len(tensors) == 1:
        return tensors[0].contiguous()
    return torch.cat([t.reshape(-1) for t in tensors])


def _unpack(flat: torch.Tensor, like: list) -> list:
    parts = flat.split([t.numel() for t in like])
    return [p.view(t.shape) for p, t in zip(parts, like)]


def _ppermute(tensors: list, mesh, name: str, perm) -> list:
    """Each rank sends ``tensors`` (packed into one message) to its
    destination in ``perm`` and receives its source's: the send and the
    receive of the hop posted together, then waited for.  A rank no pair
    sends to gets zeros."""
    me = axis_index(mesh, name)
    ranks = _ranks(mesh, name)
    group = mesh.get_group(name)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if me in dst or me in src:
        raise ValueError(f"ppermute: {perm} maps rank {me} of {name!r} to "
                         f"itself")
    wire = _to_wire(_pack(tensors), mesh)
    recv = torch.empty_like(wire)
    ops = [dist.P2POp(dist.isend, wire, ranks[dst[0]], group)] if dst else []
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[src[0]], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not src:
        return [torch.zeros_like(t) for t in tensors]
    return _unpack(_from_wire(recv, tensors[0], mesh), tensors)


def block(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view)."""
    for dim, entry in enumerate(spec):
        names = names_of(entry)
        if not names:
            continue
        blocks, index = 1, 0
        for name in names:
            size = axis_size(mesh, name)
            blocks *= size
            index = index * size + axis_index(mesh, name)
        length = t.shape[dim] // blocks
        t = t.narrow(dim, index * length, length)
    return t


def _redundancy(mesh, spec) -> int:
    """The number of ranks holding each block of an output under ``spec``:
    the product of the sizes of the mesh axes it does not name."""
    named = {n for entry in spec for n in names_of(entry)}
    out = 1
    for name in mesh.mesh_dim_names:
        if name not in named:
            out *= axis_size(mesh, name)
    return out


# --------------------------------------------------------------------------
# differentiable collectives
# --------------------------------------------------------------------------

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, name, perm, *tensors):
        ctx.mesh, ctx.name, ctx.perm = mesh, name, perm
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(_ppermute(list(tensors), mesh, name, perm))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=d, device=v) if g is None else g
                 for g, (s, d, v) in zip(grads, ctx.like)]
        inverse = [(d, s) for s, d in ctx.perm]
        return (None, None, None,
                *_ppermute(grads, ctx.mesh, ctx.name, inverse))


def ppermute(tensors, mesh, name: str, perm):
    """``jax.lax.ppermute`` along ``name`` of one tensor or a sequence of
    them of one dtype (one message a hop); ``perm`` is a list of (source,
    destination) coordinates."""
    single = isinstance(tensors, torch.Tensor)
    out = _PPermute.apply(mesh, name, [tuple(p) for p in perm],
                          *([tensors] if single else tensors))
    return out[0] if single else out


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, *others):
        ctx.like = [(o.shape, o.dtype, o.device) for o in others]
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.like))


def tie(t: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``t``'s values, with ``others`` made inputs of it (zero gradient).

    Autograd runs the backward of a node only where its output reaches the
    loss.  A rank that leaves a collective's output unused (the ring's
    causal skip) would then drop that collective's backward while its
    peers wait for it; tying the output to one that is used keeps the
    backward collectives the same on every rank."""
    return _Tie.apply(t, *others)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, names, t):
        ctx.mesh, ctx.names = mesh, names
        return _all_reduce(t, mesh, names)

    @staticmethod
    def backward(ctx, g):
        return None, None, _all_reduce(g, ctx.mesh, ctx.names)


def psum(t: torch.Tensor, mesh, names) -> torch.Tensor:
    """``jax.lax.psum`` over one mesh axis or a tuple of them."""
    return _PSum.apply(mesh, names_of(names), t)


def pmean(t: torch.Tensor, mesh, names) -> torch.Tensor:
    """``jax.lax.pmean`` over one mesh axis or a tuple of them."""
    size = 1
    for name in names_of(names):
        size *= axis_size(mesh, name)
    return psum(t, mesh, names) / size


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, specs, *tensors):
        ctx.mesh, ctx.specs = mesh, specs
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(block(t, mesh, spec).clone(
            memory_format=torch.contiguous_format)
            for t, spec in zip(tensors, specs))

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, spec, (shape, dtype, device) in zip(grads, ctx.specs,
                                                   ctx.like):
            full = torch.zeros(shape, dtype=dtype, device=device)
            if g is not None:
                block(full, ctx.mesh, spec).copy_(g)
            out.append(_all_reduce(full, ctx.mesh, ctx.mesh.mesh_dim_names))
        return (None, None, *out)


def shard(tensors, mesh, specs):
    """Enter an SPMD region: this rank's block of each whole tensor under
    its spec (``shard_map``'s ``in_specs``); one tensor and one spec, or
    sequences of both.

    The inputs of a region enter together, as one autograd node: its
    backward (an all-reduce per input) then runs after every gradient of
    the region has arrived, on every rank in the same order, though the
    ranks' graphs differ where a rank skips work (the ring's causal
    skip).  Separate nodes would let the autograd engine order the
    collectives differently on two ranks, which deadlocks them."""
    if isinstance(tensors, torch.Tensor):
        return _Shard.apply(mesh, (tuple(specs),), tensors)[0]
    return _Shard.apply(mesh, tuple(tuple(s) for s in specs), *tensors)


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, spec, t):
        ctx.mesh, ctx.spec = mesh, spec
        out = t
        for dim, entry in enumerate(spec):
            for name in reversed(names_of(entry)):
                out = _all_gather(out, mesh, name, dim)
        return t.clone() if out is t else out

    @staticmethod
    def backward(ctx, g):
        part = block(g, ctx.mesh, ctx.spec)
        return None, None, part / _redundancy(ctx.mesh, ctx.spec)


def unshard(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """Leave an SPMD region: the whole output on every rank from each
    rank's block under ``spec`` (``shard_map``'s ``out_specs``)."""
    return _Unshard.apply(mesh, tuple(spec), t)


# --------------------------------------------------------------------------
# checks across ranks
# --------------------------------------------------------------------------

_HASH_CHUNK = 1 << 24


def fingerprint(t: torch.Tensor) -> int:
    """An exact hash of ``t``'s bits (any two tensors that differ in one
    bit differ here but for a 2**-64 chance), computed on its device."""
    flat = t.detach().contiguous().reshape(-1)
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    bits = flat.view(ints[flat.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for i, start in enumerate(range(0, bits.numel(), _HASH_CHUNK)):
        part = bits[start:start + _HASH_CHUNK].to(torch.int64)
        mult = torch.arange(part.numel(), dtype=torch.int64,
                            device=t.device) * 2654435761 + 2 * i + 1
        total = total * 1000003 + (part * mult).sum()
    return int(total.item()) ^ (bits.numel() << 1)


def all_ranks(value) -> list:
    """``value`` (picklable) from every rank of the default group."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out
