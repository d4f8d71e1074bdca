"""Mixture-of-Experts MLP with capacity-based top-k routing (static shapes):
the port of the JAX package's ``models/moe.py``.

Dispatch uses index-gather: positions within each expert are computed with
a cumsum over the one-hot routing matrix, tokens above capacity are dropped
(weights renormalised), and the gathered [E, C, d] activations run the
expert FFN batched over E.  The reference's scatters (``.at[].set(mode=
"drop")``, ``.at[].add``) become an explicit mask with ``index_put_`` —
destinations past the table are dropped, never written — and accumulating
``index_add_``/``index_put_``, where duplicate tokens add.

``moe_reference`` is the dense oracle used by the tests.  The shared
expert is ``layers.mlp`` (on this rank's block of its hidden width under a
mesh that splits ``mlp``) in every dispatch but the shard_map one, which
carries it on its f-shard.  The shard_map
dispatch (``moe_apply_shardmap``) is an SPMD region on
``torch.distributed`` (``dist.collectives``): every rank takes its block of
the tokens (data axes) and of the experts (``model``), and one psum over
``model`` combines them.

Under a mesh whose rules split ``expert`` (the reference's constraints on
the dispatched tokens and the hidden units), the global and local
dispatches compute this rank's block of the experts only: the routing, the
positions, the combine weights and the aux loss are computed whole on
every rank, as a replicated layer, the experts' weights are this rank's
block (``dist.sharding.take``: held as a Block over ``expert``, or cut at
use), the rows of the dispatch table that belong to its experts run the
FFN, their weighted outputs are scattered into the tokens and summed over
the axes (``collectives.reduce_from``); the tokens and the combine weights
enter through ``collectives.copy_to``, so the router's and the input's
gradients are whole on every rank.  The psum adds the experts in another
order than one process's ``index_add_``.

Inside a data-parallel region (``dist.sharding.data_region``: the train
step's and the serve steps' regions, where each rank runs the model on its
rows) the global dispatch routes the whole batch, as the reference does:
the capacity is the whole batch's, each (token, slot)'s position adds to
its place among this rank's tokens the counts of every earlier slot over
all shards and of its slot in the shards before this one (each rank's
per-slot, per-expert counts all-gathered), and the aux loss sums the
densities and the mean probabilities over the batch axes before their
product.  The local dispatch routes each shard as in the reference, whose
aux loss is the whole batch's too.

**The experts on blocks of d under fsdp.**  Where the region takes
gradients and holds the experts' weights split over its batch axes on
their ``embed`` dimension (``train_rules(fsdp=True)``), the global
dispatch computes as the reference's layout does: there the dispatched
tokens are constrained ``("expert", None, "embed")`` and, having no batch
axis to give ``data``, lie on d's blocks, and each rank uses the weights'
blocks as it holds them.  The weights are never gathered over the batch
axes (``transformer``'s period leaves them to the dispatch,
:func:`region_held`): the whole batch's dispatched tokens are
reduce-scattered onto this rank's block of d, the gate and up products
run on the held blocks with their partial sums psum'd over the batch
axes, and the down product's block of d is all-gathered before the
combine (:func:`_experts_on_embed_blocks`).  Each expert product is
1/D of the whole-d one on D data ranks.  Elsewhere (no fsdp, serving,
the local and shard_map dispatches) d stays whole, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist.collectives import names_of
from repro_torch.dist.sharding import (Block, _axis_sizes, active_mesh,
                                       active_region, active_rules,
                                       constrain, gather_tree, region_period,
                                       split_axes, take)
from repro_torch.models.layers import gelu, mlp, mlp_spec, row_chunks
from repro_torch.models.module import ParamSpec


def moe_spec(cfg: ArchConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    spec = {
        "router": ParamSpec((d, e), torch.float32, ("embed", "expert"),
                            init_scale=0.1),
        "w_gate": ParamSpec((e, d, f), torch.float32, ("expert", "embed", "expert_mlp"),
                            fan_in_axes=(1,)),
        "w_up": ParamSpec((e, d, f), torch.float32, ("expert", "embed", "expert_mlp"),
                          fan_in_axes=(1,)),
        "w_down": ParamSpec((e, f, d), torch.float32, ("expert", "expert_mlp", "embed"),
                            fan_in_axes=(1,)),
    }
    if cfg.shared_expert:
        spec["shared"] = mlp_spec(cfg.mlp_kind, d, cfg.expert_d_ff)
    return spec


def _act(cfg: ArchConfig, g: torch.Tensor) -> torch.Tensor:
    return F.silu(g) if cfg.mlp_kind != "geglu" else gelu(g)


def _shared(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The shared expert's output [B*S, d] in fp32: ``layers.mlp``, as the
    reference calls it, so under a mesh that splits ``mlp`` it computes on
    this rank's block of its hidden width (its weights whole or held as
    blocks)."""
    kind = cfg.mlp_kind if cfg.mlp_kind != "geglu" else "swiglu"
    y = mlp(kind, params["shared"], x)
    return y.reshape(-1, x.shape[-1]).float()


def _route(cfg: ArchConfig, router_w, x_flat):
    """x_flat: [N,d] -> (expert_idx [N,k], weights [N,k], probs [N,E])."""
    logits = torch.matmul(x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    weights, expert_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return expert_idx, weights, probs


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, 4)


def _positions(expert_idx: torch.Tensor, e: int) -> torch.Tensor:
    """Position of each (token, slot) within its expert [..., N, k],
    slot-major so that earlier slots (higher router weight) win capacity;
    leading axes are independent shards."""
    *lead, n, k = expert_idx.shape
    onehot = F.one_hot(expert_idx, e)                          # [...,N,k,E]
    oh = onehot.transpose(-3, -2).reshape(*lead, k * n, e)     # slot-major
    pos = torch.cumsum(oh, dim=-2) - 1
    return (pos * oh).sum(-1).reshape(*lead, k, n).transpose(-1, -2)


def _whole_batch_positions(expert_idx: torch.Tensor, e: int, region
                           ) -> torch.Tensor:
    """:func:`_positions` of this rank's tokens [N,k] in the whole batch of
    a data-parallel region: slot-major, the shards in the batch rows'
    order.  A (token, slot)'s position is its place among this shard's
    tokens of that slot and expert, plus the counts of every earlier slot
    over all shards and of its slot in the shards before this one (each
    rank's counts [k, E] all-gathered over the batch axes)."""
    n, k = expert_idx.shape
    onehot = F.one_hot(expert_idx, e)                          # [N,k,E]
    within = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    counts = onehot.sum(0)                                     # [k,E]
    every = collectives._gather_whole(counts[None], region.mesh,
                                      (region.axes, None, None))
    index, _ = collectives.block_index(region.mesh, region.axes)
    totals = every.sum(0)
    offset = torch.cumsum(totals, dim=0) - totals + every[:index].sum(0)
    slots = torch.arange(k, device=expert_idx.device)[None, :]
    return within + offset[slots, expert_idx]


class _OverWeight(torch.autograd.Function):
    """Identity forward; the cotangent divided by ``weight`` backward."""

    @staticmethod
    def forward(ctx, t, weight):
        ctx.save_for_backward(weight)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        weight, = ctx.saved_tensors
        return g / weight.to(g.dtype), None


def _aux(expert_idx: torch.Tensor, probs: torch.Tensor, e: int,
         region=None):
    """Switch-style load-balancing loss: e * sum(density * mean prob).
    In a data-parallel ``region`` over the whole batch: the densities
    (no gradient) and the probabilities' sums are summed over the batch
    axes before their product, so every rank gets the whole batch's loss.
    The sum's backward is the identity (``reduce_from``), so each rank's
    gradient reaches its own tokens' probabilities, divided by the
    region's weight, which the region multiplies the rank's gradients by
    before their sum."""
    if region is None:
        density = F.one_hot(expert_idx[..., 0].reshape(-1), e).float().mean(0)
        return e * torch.sum(density * probs.mean(0))
    _, shards = collectives.block_index(region.mesh, region.axes)
    n = expert_idx[..., 0].numel() * shards
    first = F.one_hot(expert_idx[..., 0].reshape(-1), e).float().sum(0)
    density = collectives._all_reduce(first.detach(), region.mesh,
                                      region.axes) / n
    p = probs.reshape(-1, e).sum(0)
    if region.weight is not None:
        p = _OverWeight.apply(p, region.weight)
    p = collectives.reduce_from(p, region.mesh, region.axes) / n
    return e * torch.sum(density * p)


def _expert_block(e: int, axes: tuple) -> tuple:
    """(the first expert, the number of experts) of this rank's block over
    ``axes`` (all of them without)."""
    if not axes:
        return 0, e
    index, blocks = collectives.block_index(active_mesh(), axes)
    return index * (e // blocks), e // blocks


def _expert_weights(params: dict, axes: tuple, dtype) -> tuple:
    """w_gate, w_up, w_down on this rank's experts (whole without
    ``axes``), in ``dtype``."""
    return tuple(take(params[k], 0, axes).to(dtype)
                 for k in ("w_gate", "w_up", "w_down"))


def _data_shards(x_batch: int) -> int:
    """Number of data-parallel shards the local dispatch should use."""
    mesh = active_mesh()
    if mesh is None:
        return 1
    sizes = _axis_sizes(mesh)
    d = sizes.get("data", 1) * sizes.get("pod", 1)
    while d > 1 and x_batch % d:
        d //= 2
    return max(d, 1)


def moe_apply_local(cfg: ArchConfig, params: dict, x: torch.Tensor) -> tuple:
    """Per-data-shard dispatch: each data shard's tokens routed to a
    per-shard expert capacity (one shard with no mesh active)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    n = b * s
    shards = _data_shards(b)
    nl = n // shards
    cap = max(4, int(nl * k * cfg.capacity_factor / e))
    x_s = x.reshape(shards, nl, d)
    x_s = constrain(x_s, "batch", None, "embed")
    dev = x.device

    logits = torch.matmul(x_s.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    weights, expert_idx = torch.topk(probs, k, dim=-1)         # [S,NL,k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    probs = probs.reshape(shards * nl, e)

    pos_in_expert = _positions(expert_idx, e)
    fits = pos_in_expert < cap
    weights = weights * fits

    flat_dest = expert_idx * cap + torch.where(fits, pos_in_expert, e * cap)
    token_ids = torch.arange(nl, device=dev)[None, :, None].expand(
        shards, nl, k)
    shard_ids = torch.arange(shards, device=dev)[:, None, None].expand(
        shards, nl, k)
    # as the reference: scatter into e*cap+1 slots, whatever lies past the
    # table into the extra one, which is sliced off (no data-dependent
    # shape, so no device sync)
    index = (shard_ids, torch.clamp(flat_dest, max=e * cap))
    slots = (shards, e * cap + 1)
    table = torch.zeros(slots, dtype=torch.long, device=dev)
    table.index_put_(index, token_ids)
    occupied = torch.zeros(slots, dtype=torch.bool, device=dev)
    occupied.index_put_(index, torch.ones_like(token_ids, dtype=torch.bool))
    w_slot = torch.zeros(slots, dtype=torch.float32, device=dev)
    w_slot.index_put_(index, weights)
    table, occupied, w_slot = (a[:, :e * cap] for a in (table, occupied,
                                                         w_slot))
    dispatch = constrain(table.reshape(shards, e, cap), "batch", "expert", None)
    occupied = constrain(occupied.reshape(shards, e, cap),
                         "batch", "expert", None)
    w_slot = constrain(w_slot.reshape(shards, e, cap), "batch", "expert", None)

    # this rank's experts where the rules split them (module docstring)
    axes = split_axes(("batch", "expert", None, "embed"), (shards, e, cap, d),
                      1)
    lo, e_loc = _expert_block(e, axes)
    mesh = active_mesh()
    if axes:
        x_s = collectives.copy_to(x_s, mesh, axes)
        w_slot = collectives.copy_to(w_slot, mesh, axes)
    mine = slice(lo, lo + e_loc)
    dispatch, occupied, w_slot = (a[:, mine] for a in (dispatch, occupied,
                                                       w_slot))
    xe = torch.gather(x_s, 1, dispatch.reshape(shards, e_loc * cap, 1)
                      .expand(shards, e_loc * cap, d)).reshape(
        shards, e_loc, cap, d) * occupied[..., None].to(x.dtype)

    dtype = x.dtype
    w_gate, w_up, w_down = _expert_weights(params, axes, dtype)
    g = torch.einsum("xecd,edf->xecf", xe, w_gate)
    u = torch.einsum("xecd,edf->xecf", xe, w_up)
    h = _act(cfg, g) * u
    ye = torch.einsum("xecf,efd->xecd", h, w_down)

    y = _combine_slots(ye, w_slot, occupied, dispatch, nl)
    if axes:
        y = collectives.reduce_from(y, mesh, axes)
    y = constrain(y, "batch", None, "embed")

    if cfg.shared_expert:
        y = y + _shared(cfg, params, x).reshape(shards, nl, d)

    aux = _aux(expert_idx, probs, e, active_region())
    y = y.reshape(b, s, d).to(x.dtype)
    return constrain(y, "batch", "seq", "embed"), aux


def _combine_slots(ye, w_slot, occupied, dispatch, nl: int) -> torch.Tensor:
    """The local dispatch's combine, y [shards, nl, d] in fp32: each slot
    of ye [shards, E_loc, cap, d] adds its output, times its weight and
    occupancy in ye's type, to its token (an empty slot points at token 0
    and adds zeros).  Over blocks of slots in their order
    (``layers.row_chunks``), so each token's slots add in the order one
    scatter of every slot adds them, and no fp32 buffer of every slot is
    made."""
    shards, d = ye.shape[0], ye.shape[-1]
    per = ye[0].numel() // d
    scatter_shard = torch.arange(shards, device=ye.device)[:, None].expand(
        shards, per).reshape(-1)
    rows, w, occ, tok = (ye.reshape(-1, d), w_slot.reshape(-1),
                         occupied.reshape(-1), dispatch.reshape(-1))
    y = torch.zeros((shards, nl, d), dtype=torch.float32, device=ye.device)
    for lo, hi in row_chunks(rows.shape[0], d):
        part = (rows[lo:hi] * w[lo:hi, None].to(ye.dtype)
                * occ[lo:hi, None].to(ye.dtype))
        y.index_put_((scatter_shard[lo:hi], tok[lo:hi]), part.float(),
                     accumulate=True)
    return y


def _combine_tokens(ye_rows, src, weights) -> torch.Tensor:
    """The global dispatch's combine, y [N, d] in fp32: token t adds, for
    each of its k slots in order, the row ``src[t, j]`` of this rank's
    experts' outputs ye_rows [E_loc*cap, d] in fp32 times ``weights[t,
    j]``, or zeros where ``src[t, j]`` lies outside ye_rows (another
    rank's expert, or dropped).  Over blocks of whole tokens
    (``layers.row_chunks``): the reference's XLA fuses its gather, weight
    and scatter into one pass, where one block of every token would hold
    three fp32 [N*k, d] buffers."""
    (n, k), (slots, d) = src.shape, ye_rows.shape
    held = (src >= 0) & (src < slots)
    src = torch.clamp(src, 0, slots - 1)
    token_ids = torch.arange(n, device=ye_rows.device)[:, None].expand(n, k)
    y = torch.zeros((n, d), dtype=torch.float32, device=ye_rows.device)
    for lo, hi in row_chunks(n, k * d):
        part = ye_rows[src[lo:hi].reshape(-1)]
        part = part.float() * weights[lo:hi].reshape(-1)[:, None]
        part = torch.where(held[lo:hi].reshape(-1)[:, None], part, 0.0)
        y.index_add_(0, token_ids[lo:hi].reshape(-1), part)
    return y


def moe_apply_shardmap(cfg: ArchConfig, params: dict, x: torch.Tensor):
    """Explicit-collective expert parallelism: the reference's shard_map
    dispatch.  Routing is computed on every rank (identical across the
    model axis); each rank gathers and computes only its ``e_loc`` local
    experts' tokens from its block of tokens, scatters the weighted outputs
    into a zero buffer, and one [nl, d] psum over ``model`` combines them
    (the shared expert rides the same psum, partial over its f-shard);
    ``aux`` is pmean'ed over the data axes.  Capacity is per rank.

    As in the reference it is ``moe_apply_local`` with no mesh, a model
    axis of one, experts the model axis does not divide, or a batch the
    data axes do not divide.  Where the reference has no data axis to name
    it fails; here the tokens are then whole on every rank."""
    mesh = active_mesh()
    if mesh is None:
        return moe_apply_local(cfg, params, x)
    sizes = _axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    if e % model_n or model_n == 1:
        return moe_apply_local(cfg, params, x)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = 1
    for a in batch_axes:
        dp *= sizes[a]
    if b % dp:
        return moe_apply_local(cfg, params, x)
    e_loc = e // model_n
    nl = (b // dp) * s
    cap = max(4, int(nl * k * cfg.capacity_factor / e))

    x_spec = ((batch_axes if len(batch_axes) > 1 else batch_axes[0])
              if batch_axes else None, None, None)
    w_spec = ("model", None, None)
    experts = gather_tree([params[k] for k in ("w_gate", "w_up", "w_down")])
    inputs = [x, params["router"], *experts]
    specs = [x_spec, (None, None), w_spec, w_spec, w_spec]
    if cfg.shared_expert:                      # f-dim sharded over 'model'
        sh = gather_tree(params["shared"])
        inputs += [sh["w_gate"], sh["w_up"], sh["w_down"]]
        specs += [(None, "model"), (None, "model"), ("model", None)]
    x_loc, router, wg, wu, wd, *shared = collectives.shard(inputs, mesh,
                                                           specs)

    bl, sl, _ = x_loc.shape
    t = x_loc.reshape(bl * sl, d)
    dev = x.device
    expert_idx, weights, probs = _route(cfg, router, t)        # [nl, k]
    pos_in_expert = _positions(expert_idx, e)
    fits = pos_in_expert < cap
    weights = weights * fits
    flat_dest = expert_idx * cap + torch.where(fits, pos_in_expert, e * cap)
    token_ids = torch.arange(bl * sl, device=dev)[:, None].expand(bl * sl, k)
    index = (torch.clamp(flat_dest, max=e * cap),)   # e*cap: the extra slot
    table = torch.zeros(e * cap + 1, dtype=torch.long, device=dev)
    table.index_put_(index, token_ids)
    occupied = torch.zeros(e * cap + 1, dtype=torch.bool, device=dev)
    occupied.index_put_(index, torch.ones_like(token_ids, dtype=torch.bool))
    w_slot = torch.zeros(e * cap + 1, dtype=torch.float32, device=dev)
    w_slot = w_slot.index_put(index, weights)
    table, occupied, w_slot = (a[:e * cap] for a in (table, occupied,
                                                      w_slot))

    m_idx = collectives.axis_index(mesh, "model")
    mine = slice(m_idx * e_loc, (m_idx + 1) * e_loc)
    disp_l = table.reshape(e, cap)[mine]                         # [e_loc,cap]
    occ_l = occupied.reshape(e, cap)[mine]
    ws_l = w_slot.reshape(e, cap)[mine]

    xe = t[disp_l.reshape(-1)].reshape(e_loc, cap, d)
    xe = xe * occ_l[..., None].to(t.dtype)
    g = torch.einsum("ecd,edf->ecf", xe, wg.to(t.dtype))
    u = torch.einsum("ecd,edf->ecf", xe, wu.to(t.dtype))
    h = _act(cfg, g) * u
    ye = torch.einsum("ecf,efd->ecd", h, wd.to(t.dtype))
    contrib = ye * (ws_l * occ_l)[..., None].to(ye.dtype)
    y_part = torch.zeros((bl * sl, d), dtype=t.dtype, device=dev).index_add(
        0, disp_l.reshape(-1), contrib.reshape(-1, d))

    if shared:
        shg, shu, shd_w = shared
        hs = _act(cfg, t @ shg.to(t.dtype)) * (t @ shu.to(t.dtype))
        y_part = y_part + hs @ shd_w.to(t.dtype)

    y = collectives.psum(y_part, mesh, "model")
    aux = _aux(expert_idx, probs, e)
    if batch_axes:
        aux = collectives.pmean(aux, mesh, batch_axes)
    y = collectives.unshard(y.reshape(bl, sl, d), mesh, x_spec)
    return y, collectives.unshard(aux, mesh, ())


def moe_apply(cfg: ArchConfig, params: dict, x: torch.Tensor) -> tuple:
    """x: [B,S,d] -> (y [B,S,d], aux_loss scalar)."""
    if cfg.moe_dispatch == "shardmap":
        return moe_apply_shardmap(cfg, params, x)
    if cfg.moe_dispatch == "local":
        return moe_apply_local(cfg, params, x)
    b, s, d = x.shape
    n = b * s
    e = cfg.n_experts
    x_flat = x.reshape(n, d)
    dev = x.device

    expert_idx, weights, probs, flat_dest, cap = _global_routing(
        cfg, params["router"], x_flat)
    k = expert_idx.shape[1]

    # token ids into the [E, cap] dispatch table; past-the-table
    # destinations (tokens over capacity) are dropped
    token_ids = torch.arange(n, device=dev)[:, None].expand(n, k)
    index = (torch.clamp(flat_dest, max=e * cap),)   # e*cap: the extra slot
    table = torch.zeros(e * cap + 1, dtype=torch.long, device=dev)
    table.index_put_(index, token_ids)
    occupied = torch.zeros(e * cap + 1, dtype=torch.bool, device=dev)
    occupied.index_put_(index, torch.ones_like(token_ids, dtype=torch.bool))
    dispatch = table[:e * cap].reshape(e, cap)
    occupied = occupied[:e * cap].reshape(e, cap)

    # this rank's experts where the rules split them (module docstring)
    axes = split_axes(("expert", None, "embed"), (e, cap, d), 0)
    lo, e_loc = _expert_block(e, axes)
    mesh = active_mesh()
    if axes:
        x_flat = collectives.copy_to(x_flat, mesh, axes)
        weights = collectives.copy_to(weights, mesh, axes)
    mine = slice(lo, lo + e_loc)
    xe = x_flat[dispatch[mine]] * occupied[mine, :, None].to(x.dtype)
    xe = constrain(xe, "expert", None, "embed")

    dtype = x.dtype
    region = active_region()
    how = _embed_specs(cfg, params, axes, region)
    if how:
        ye = _experts_on_embed_blocks(cfg, params, axes, how, xe, region)
    else:
        experts = {k: region_period(params[k]) for k in EXPERTS}
        w_gate, w_up, w_down = _expert_weights(experts, axes, dtype)
        g = torch.einsum("ecd,edf->ecf", xe, w_gate)
        u = torch.einsum("ecd,edf->ecf", xe, w_up)
        h = _act(cfg, g) * u
        h = constrain(h, "expert", None, "expert_mlp")
        ye = torch.einsum("ecf,efd->ecd", h, w_down)  # [E_loc,cap,d]

    y = _combine_tokens(ye.reshape(e_loc * cap, d), flat_dest - lo * cap,
                        weights)
    if axes:
        y = collectives.reduce_from(y, mesh, axes)

    if cfg.shared_expert:
        y = y + _shared(cfg, params, x)

    aux = _aux(expert_idx, probs, e, active_region())
    y = y.reshape(b, s, d).to(x.dtype)
    return constrain(y, "batch", "seq", "embed"), aux


# the experts' weights, and the dimension of each that holds d
EXPERTS = ("w_gate", "w_up", "w_down")
_EMBED_DIM = {"w_gate": 1, "w_up": 1, "w_down": 2}


def region_held(cfg: ArchConfig, path: tuple) -> bool:
    """Whether a data-parallel region leaves the param at key ``path`` to
    the layer (``transformer``'s period passes it by
    ``dist.sharding.region_period`` as it is held): the global dispatch's
    experts, which :func:`moe_apply` takes on their embed blocks or passes
    by ``region_period`` itself."""
    return (cfg.moe_dispatch not in ("local", "shardmap")
            and path[-2:-1] == ("moe",) and path[-1] in EXPERTS)


def _embed_specs(cfg: ArchConfig, params: dict, axes: tuple, region):
    """Whether, and how, the global dispatch computes on the experts'
    blocks of d (module docstring): in a data-parallel region that takes
    gradients, where each expert weight is held, or the active rules
    would hold it, over ``axes`` (this rank's experts) on its expert
    dimension, over exactly the region's batch axes on its embed
    dimension, and whole along the rest: "held" for Blocks so held,
    "whole" for whole leaves (the global view), else None."""
    if region is None or region.weight is None:
        return None
    blocks = {isinstance(params[k], Block) for k in EXPERTS}
    if len(blocks) != 1:
        return None
    held = blocks.pop()
    rules, specs = active_rules(), moe_spec(cfg)
    for k in EXPERTS:
        leaf = params[k]
        if held:
            got = leaf.spec
        else:
            got = rules.spec(specs[k].logical_axes, shape=leaf.shape,
                             mesh=region.mesh)
        want = [()] * len(got)
        want[0], want[_EMBED_DIM[k]] = tuple(axes), tuple(region.axes)
        if [tuple(names_of(e)) for e in got] != want:
            return None
    return "held" if held else "whole"


def _experts_on_embed_blocks(cfg: ArchConfig, params: dict, axes: tuple,
                             how: str, xe: torch.Tensor, region
                             ) -> torch.Tensor:
    """This rank's experts' outputs [E_loc, cap, d] for its dispatched
    tokens ``xe`` [E_loc, cap, d] (its tokens at their whole-batch slots,
    zeros elsewhere), computed as the reference's fsdp layout does, on the
    blocks of d over the region's batch axes (module docstring): the
    whole batch's tokens on this rank's block of d (a reduce-scatter), the
    gate and up products on the [E_loc, d/D, f] blocks in one product and
    their partial sums psum'd, the activation whole, the down product on
    the [E_loc, f, d/D] block, all-gathered along d.  The cotangent
    entering the all-gather is weighted by the region's weight and the
    one leaving the reduce-scatter divided by it, so the weights' blocks
    get the whole batch's gradient and x the rank's own share.  ``how``:
    "held", the blocks as the Blocks hold them (the region sums their
    gradients no more); "whole", cut from whole leaves
    (``collectives.cut_weighted``)."""
    mesh, names, weight = region.mesh, region.axes, region.weight
    dtype = xe.dtype

    def block(k):
        if how == "held":
            return params[k].local.to(dtype)
        spec = [None] * params[k].ndim
        spec[_EMBED_DIM[k]] = names
        return collectives.cut_weighted(take(params[k], 0, axes), mesh,
                                        spec, weight).to(dtype)

    w_gate, w_up, w_down = (block(k) for k in EXPERTS)
    f = w_gate.shape[-1]
    xs = collectives.scatter_sum(xe, mesh, names, -1, weight)  # [E,cap,d/D]
    gu = torch.einsum("ecd,edf->ecf", xs, torch.cat([w_gate, w_up], -1))
    g, u = collectives.psum(gu, mesh, names).split(f, dim=-1)
    h = _act(cfg, g) * u
    h = constrain(h, "expert", None, "expert_mlp")
    ye = torch.einsum("ecf,efd->ecd", h, w_down)                # [E,cap,d/D]
    return collectives.gather_weighted(ye, mesh, names, -1, weight)


def _global_routing(cfg: ArchConfig, router_w, x_flat) -> tuple:
    """The global dispatch's routing of x_flat [N,d]: (expert_idx [N,k],
    weights [N,k] with the dropped (token, slot)s zeroed, probs [N,E],
    each (token, slot)'s place in the flat [E*cap] table (E*cap where it
    is dropped), cap).  Over the whole batch inside a data-parallel region
    (module docstring), else over x_flat's tokens."""
    e = cfg.n_experts
    region = active_region()
    expert_idx, weights, probs = _route(cfg, router_w, x_flat)
    if region is None:
        cap = capacity(cfg, x_flat.shape[0])
        pos_in_expert = _positions(expert_idx, e)              # [N,k]
    else:
        _, shards = collectives.block_index(region.mesh, region.axes)
        cap = capacity(cfg, x_flat.shape[0] * shards)
        pos_in_expert = _whole_batch_positions(expert_idx, e, region)
    fits = pos_in_expert < cap
    weights = weights * fits
    flat_dest = expert_idx * cap + torch.where(fits, pos_in_expert, e * cap)
    return expert_idx, weights, probs, flat_dest, cap


def moe_reference(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense oracle: every token through its top-k experts, no capacity."""
    b, s, d = x.shape
    n = b * s
    x_flat = x.reshape(n, d)
    expert_idx, weights, _ = _route(cfg, params["router"], x_flat)
    dtype = x.dtype

    def expert_fn(e_id, xs):
        g = xs @ params["w_gate"][e_id].to(dtype)
        u = xs @ params["w_up"][e_id].to(dtype)
        return (_act(cfg, g) * u) @ params["w_down"][e_id].to(dtype)

    y = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    rows = torch.arange(n, device=x.device)
    for slot in range(cfg.moe_top_k):
        all_out = torch.stack([expert_fn(e, x_flat)
                               for e in range(cfg.n_experts)])
        sel = all_out[expert_idx[:, slot], rows]               # [N,d]
        y = y + sel.float() * weights[:, slot:slot + 1]
    if cfg.shared_expert:
        y = y + _shared(cfg, params, x)
    return y.reshape(b, s, d).to(x.dtype)
