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
    over the whole mesh — the contributions of every rank, each once;
  * ``gather`` (a held block made whole where it is used,
    ``dist.sharding``'s blocked layout): this rank's block of the
    cotangent;
  * ``gather_summed`` (a param held split over a data-parallel region's
    batch axes, made whole where the region uses it): the cotangent
    times the region's weight, summed over the region's batch axes, then
    this rank's block of it — the region's gradient reduction of that
    leaf, made where it is used (a stacked leaf one period at a time);
  * ``scatter_sum`` (each rank's partial tensor summed over a
    data-parallel region's batch axes, this rank's block of one dimension
    kept: the MoE's dispatched tokens on a block of d under fsdp): the
    all-gather of the cotangent, divided by the region's weight;
  * ``gather_weighted`` (its transpose: the experts' outputs made whole
    along d): the cotangent times the region's weight, reduce-scattered.

A product that stays whole on every rank of some mesh axes (attention
heads or a vocabulary that do not divide them) computes its weight's
gradient on this rank's block of one dimension over those axes and
all-gathers it (``whole_product``): the forward and the input's gradient
as ``torch.matmul``'s.

The tensor-parallel layers (``models``: heads, MLP and vocabulary blocks
over ``model``, Megatron's layout) keep the same convention, that every
rank holds the whole true gradient of a tensor every rank holds whole:

  * ``copy_to`` (a whole input entering this rank's block of a
    column-parallel product): identity forward, a psum of the cotangents
    backward — each rank's cotangent is its block's share;
  * ``reduce_from`` (a row-parallel product's partial output): a psum
    forward, identity backward — the summed output's cotangent is already
    whole on every rank.  ``psum``'s backward would count it once per rank;
  * ``split`` (a whole leaf cut to this rank's block at use): the block
    forward, the all-gather of every rank's block of the cotangent
    backward, so a whole leaf gets its whole gradient;
  * ``pmax`` (the cross-entropy's stabiliser): no gradient.

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


def _all_reduce(t: torch.Tensor, mesh, names: Sequence[str],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) of ``t`` over the mesh axes ``names`` (a new
    tensor)."""
    names = [n for n in names if axis_size(mesh, n) > 1]
    if not names:
        return t.clone()
    w = _to_wire(t, mesh)
    if w is t:
        w = t.clone()
    for name in names:
        dist.all_reduce(w, op=op, group=mesh.get_group(name))
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


# torch 2.13 renames all_gather_into_tensor (deprecated there)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _all_gather(t: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``name``, concatenated on ``dim`` in the
    ranks' order: received into one [n, *t.shape] buffer
    (``all_gather_into_tensor``), then its rank dimension merged into
    ``dim``.  Where ``dim`` is the outermost of more than one element that
    merge is a view, so the parts land straight in the result; elsewhere
    it is one copy."""
    n = axis_size(mesh, name)
    if n == 1:
        return t
    dim %= t.ndim
    w = _to_wire(t, mesh)
    out = torch.empty((n,) + tuple(w.shape), dtype=w.dtype, device=w.device)
    # flat: gloo checks the first dimension, n times the input's
    _ALL_GATHER(out.view(-1), w.reshape(-1), group=mesh.get_group(name))
    return _from_wire(out.movedim(0, dim).flatten(dim, dim + 1), t, mesh)


# torch 2.13 renames reduce_scatter_tensor (deprecated there)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _reduce_scatter(t: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    """The sum of ``t`` over the mesh axes ``names``, this rank's block of
    dimension ``dim`` of it (the first name outermost): a
    reduce-scatter per axis of more than one rank."""
    dim %= t.ndim
    for name in names_of(names):
        n = axis_size(mesh, name)
        if n == 1:
            continue
        parts = t.unflatten(dim, (n, t.shape[dim] // n)).movedim(dim, 0)
        w = _to_wire(parts, mesh)
        out = torch.empty(w[0].numel(), dtype=w.dtype, device=w.device)
        # flat: gloo checks the first dimension, n times the output's
        _REDUCE_SCATTER(out, w.reshape(-1), group=mesh.get_group(name))
        t = _from_wire(out.view(w.shape[1:]), t, mesh)
    return t


def _all_to_all(t: torch.Tensor, mesh, name: str, send: list,
                recv: list) -> torch.Tensor:
    """``t``'s rows (dimension 0) in consecutive pieces of ``send[i]``
    rows to the i-th rank along ``name``; the pieces received, ``recv[i]``
    rows from the i-th, in the ranks' order (``all_to_all_single``)."""
    w = _to_wire(t, mesh)
    out = torch.empty((sum(recv),) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    dist.all_to_all_single(out, w, list(recv), list(send),
                           group=mesh.get_group(name))
    return _from_wire(out, t, mesh)


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


def block_index(mesh, names) -> tuple:
    """(this rank's block index, the number of blocks) along one spec
    entry's mesh axes, the first name outermost."""
    blocks, index = 1, 0
    for name in names_of(names):
        size = axis_size(mesh, name)
        blocks *= size
        index = index * size + axis_index(mesh, name)
    return index, blocks


def block(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view)."""
    for dim, entry in enumerate(spec):
        if not names_of(entry):
            continue
        index, blocks = block_index(mesh, entry)
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


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, names, t):
        ctx.mesh, ctx.names = mesh, names
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, None, _all_reduce(g, ctx.mesh, ctx.names)


def copy_to(t: torch.Tensor, mesh, names) -> torch.Tensor:
    """``t`` itself, whose cotangent is psum'd over ``names`` in the
    backward: put on a whole input that each rank uses for its block of a
    column-parallel product (module docstring)."""
    return _CopyTo.apply(mesh, names_of(names), t)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, names, t):
        ctx.mesh, ctx.names = mesh, names
        return _all_reduce(t, mesh, names)

    @staticmethod
    def backward(ctx, g):
        return None, None, g


def reduce_from(t: torch.Tensor, mesh, names) -> torch.Tensor:
    """The psum of each rank's partial ``t`` over ``names``, whose
    cotangent passes through unchanged: a row-parallel product's output
    (module docstring)."""
    return _ReduceFrom.apply(mesh, names_of(names), t)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, name, dim, send, recv, t):
        ctx.mesh, ctx.name, ctx.dim = mesh, name, dim
        ctx.send, ctx.recv = send, recv
        out = _all_to_all(t.movedim(dim, 0).contiguous(), mesh, name, send,
                          recv)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        back = _all_to_all(g.movedim(ctx.dim, 0).contiguous(), ctx.mesh,
                           ctx.name, ctx.recv, ctx.send)
        return (None,) * 5 + (back.movedim(0, ctx.dim).contiguous(),)


def exchange(t: torch.Tensor, mesh, name: str, dim: int, send, recv
             ) -> torch.Tensor:
    """An all-to-all along ``name`` on dimension ``dim``: ``t``'s
    consecutive pieces of ``send[i]`` along it go to the i-th rank, and
    the result holds the pieces received, ``recv[i]`` from the i-th, in
    the ranks' order.  Its backward sends each piece of the cotangent
    back to the rank it came from."""
    return _Exchange.apply(mesh, name, dim % t.ndim, tuple(send),
                           tuple(recv), t)


def pmax(t: torch.Tensor, mesh, names) -> torch.Tensor:
    """The elementwise max of ``t`` over ``names``, outside autograd."""
    return _all_reduce(t.detach(), mesh, names_of(names),
                       op=dist.ReduceOp.MAX)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, spec, t):
        ctx.mesh, ctx.spec = mesh, spec
        return block(t, mesh, spec).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return None, None, _gather_whole(g.contiguous(), ctx.mesh, ctx.spec)


def split(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of a whole ``t`` under ``spec`` (a copy), whose
    backward all-gathers every rank's block of the cotangent: a whole
    leaf used on this rank's block gets its whole gradient."""
    return _Split.apply(mesh, tuple(spec), t)


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


def _gather_whole(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole tensor from every rank's block of it under ``spec``."""
    for dim, entry in enumerate(spec):
        for name in reversed(names_of(entry)):
            t = _all_gather(t, mesh, name, dim)
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, spec, t):
        ctx.mesh, ctx.spec = mesh, spec
        out = _gather_whole(t, mesh, spec)
        return t.clone() if out is t else out

    @staticmethod
    def backward(ctx, g):
        return None, None, block(g, ctx.mesh, ctx.spec).clone(
            memory_format=torch.contiguous_format)


def gather(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """A held block made whole for its use: the all-gather of every rank's
    block under ``spec``.  Its backward is this rank's block of the
    gradient (a copy, so the whole gradient is freed), neither divided nor
    summed over ranks: every rank computes the whole gradient of what it
    computed, and a data-parallel region sums the ranks' shares itself."""
    return _Gather.apply(mesh, tuple(spec), t)


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, spec, names, weight, t):
        ctx.mesh, ctx.spec, ctx.names, ctx.weight = mesh, spec, names, weight
        out = _gather_whole(t, mesh, spec)
        return t.view_as(t) if out is t else out

    @staticmethod
    def backward(ctx, g):
        g = (g * ctx.weight.to(g.dtype)).contiguous()
        reduce_sum_([g], ctx.mesh, ctx.names)
        g = block(g, ctx.mesh, ctx.spec).clone(
            memory_format=torch.contiguous_format)
        return None, None, None, None, g


def gather_summed(t: torch.Tensor, mesh, spec, names, weight: torch.Tensor
                  ) -> torch.Tensor:
    """``t`` made whole along ``spec``, whose backward multiplies the cotangent by ``weight``, sums it
    over the mesh axes ``names`` (``reduce_sum_``, in their order) and
    takes this rank's block of it under ``spec``: a data-parallel
    region's reduction of one leaf's gradient, where the leaf is used."""
    return _GatherSummed.apply(mesh, tuple(spec), tuple(names), weight, t)


def _along(dim: int, names: tuple, ndim: int) -> tuple:
    """The spec naming ``names`` on dimension ``dim`` only."""
    return tuple(names if i == dim % ndim else None for i in range(ndim))


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, names, dim, weight, t):
        ctx.mesh, ctx.names, ctx.dim, ctx.weight = mesh, names, dim, weight
        out = _reduce_scatter(t, mesh, names, dim)
        return t.clone() if out is t else out

    @staticmethod
    def backward(ctx, g):
        whole = _gather_whole(g.contiguous(), ctx.mesh,
                              _along(ctx.dim, ctx.names, g.ndim))
        return None, None, None, None, (whole.float()
                                        / ctx.weight).to(g.dtype)


def scatter_sum(t: torch.Tensor, mesh, names, dim: int,
                weight: torch.Tensor) -> torch.Tensor:
    """The sum over the data-parallel region's batch axes ``names`` of
    each rank's partial ``t``, this rank's block of dimension ``dim`` of
    it; in the backward the cotangent (every rank's block of the whole
    batch's gradient) all-gathered and divided by ``weight``, the factor
    the region multiplies this rank's upstream gradients by."""
    return _ScatterSum.apply(mesh, names_of(names), dim, weight, t)


class _GatherWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, names, dim, weight, t):
        ctx.mesh, ctx.names, ctx.dim, ctx.weight = mesh, names, dim, weight
        out = _gather_whole(t, mesh, _along(dim, names, t.ndim))
        return t.clone() if out is t else out

    @staticmethod
    def backward(ctx, g):
        g = (g.float() * ctx.weight).to(g.dtype)
        return None, None, None, None, _reduce_scatter(g, ctx.mesh,
                                                       ctx.names, ctx.dim)


def gather_weighted(t: torch.Tensor, mesh, names, dim: int,
                    weight: torch.Tensor) -> torch.Tensor:
    """Every rank's block of ``t`` along dimension ``dim`` over the
    region's batch axes ``names``, made whole; in the backward each rank's
    cotangent (its own tokens' share) times ``weight``, summed over the
    axes and cut to this rank's block: the transpose of
    :func:`scatter_sum`, so that what lies between the two computes the
    whole batch's gradient."""
    return _GatherWeighted.apply(mesh, names_of(names), dim, weight, t)


class _CutWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, spec, weight, t):
        ctx.mesh, ctx.spec, ctx.weight = mesh, spec, weight
        ctx.like = (t.shape, t.dtype, t.device)
        return block(t, mesh, spec).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        full = torch.zeros(shape, dtype=dtype, device=device)
        block(full, ctx.mesh, ctx.spec).copy_(g.float() / ctx.weight)
        return None, None, None, full


def cut_weighted(t: torch.Tensor, mesh, spec, weight: torch.Tensor
                 ) -> torch.Tensor:
    """This rank's block of a whole ``t`` under ``spec`` (over a
    data-parallel region's batch axes), whose cotangent already holds the
    whole batch's gradient of the block: in the backward it is divided by
    ``weight`` and placed in zeros of the whole shape, so that the
    region's weighted sum of the ranks' gradients assembles the whole
    leaf's from every rank's block (the global view of a leaf used as
    :func:`scatter_sum`'s layout holds it)."""
    return _CutWeighted.apply(mesh, tuple(spec), weight, t)


class _WholeProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, names, dim, x, w):
        ctx.mesh, ctx.names, ctx.dim = mesh, names, dim
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[3]:
            dx = torch.matmul(g, w.t())
        if ctx.needs_input_grad[4]:
            index, blocks = block_index(ctx.mesh, ctx.names)
            n = w.shape[ctx.dim] // blocks
            rows = slice(index * n, (index + 1) * n)
            x2, g2 = x.flatten(0, -2), g.flatten(0, -2)
            if ctx.dim == 0:
                dw = torch.matmul(x2[:, rows].t(), g2)
            else:
                dw = torch.matmul(x2.t(), g2[:, rows])
            dw = _gather_whole(dw, ctx.mesh,
                               _along(ctx.dim, ctx.names, 2))
        return None, None, None, dx, dw


def whole_product(x: torch.Tensor, w: torch.Tensor, mesh, names,
                  dim: int) -> torch.Tensor:
    """``torch.matmul(x, w)`` (``w`` 2-D) of a layer that every rank of the
    mesh axes ``names`` computes whole, on the same ``x`` and with the
    same cotangent: the forward and x's gradient as torch's, w's gradient
    computed on this rank's block of its dimension ``dim`` over ``names``
    and all-gathered, so every rank holds the whole gradient of a
    sixteenth of the work on a mesh axis of 16."""
    return _WholeProduct.apply(mesh, names_of(names), dim, x, w)


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
