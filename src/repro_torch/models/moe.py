"""Mixture-of-Experts MLP with capacity-based top-k routing (static shapes):
the port of the JAX package's ``models/moe.py``.

Dispatch uses index-gather: positions within each expert are computed with
a cumsum over the one-hot routing matrix, tokens above capacity are dropped
(weights renormalised), and the gathered [E, C, d] activations run the
expert FFN batched over E.  The reference's scatters (``.at[].set(mode=
"drop")``, ``.at[].add``) become an explicit mask with ``index_put_`` —
destinations past the table are dropped, never written — and accumulating
``index_add_``/``index_put_``, where duplicate tokens add.

``moe_reference`` is the dense oracle used by the tests.  The shard_map
dispatch (``moe_apply_shardmap``) is an SPMD region on
``torch.distributed`` (``dist.collectives``): every rank takes its block of
the tokens (data axes) and of the experts (``model``), and one psum over
``model`` combines them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist.sharding import _axis_sizes, active_mesh, constrain
from repro_torch.models.layers import gelu, mlp, mlp_spec
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
    """The shared expert's output [B*S, d] in fp32."""
    kind = cfg.mlp_kind if cfg.mlp_kind != "geglu" else "swiglu"
    return mlp(kind, params["shared"], x).reshape(-1, x.shape[-1]).float()


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


def _aux(expert_idx: torch.Tensor, probs: torch.Tensor, e: int):
    """Switch-style load-balancing loss: e * sum(density * mean prob)."""
    density = F.one_hot(expert_idx[..., 0].reshape(-1), e).float().mean(0)
    return e * torch.sum(density * probs.mean(0))


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
    # the reference scatters into e*cap+1 slots and drops what lies past
    # them; the extra slot is sliced off, so only real slots are kept here
    keep = flat_dest < e * cap
    index = (shard_ids[keep], flat_dest[keep])
    table = torch.zeros((shards, e * cap), dtype=torch.long, device=dev)
    table.index_put_(index, token_ids[keep])
    occupied = torch.zeros((shards, e * cap), dtype=torch.bool, device=dev)
    occupied.index_put_(index, torch.ones_like(token_ids[keep],
                                               dtype=torch.bool))
    w_slot = torch.zeros((shards, e * cap), dtype=torch.float32, device=dev)
    w_slot.index_put_(index, weights[keep])
    dispatch = constrain(table.reshape(shards, e, cap), "batch", "expert", None)
    occupied = constrain(occupied.reshape(shards, e, cap),
                         "batch", "expert", None)
    w_slot = constrain(w_slot.reshape(shards, e, cap), "batch", "expert", None)

    xe = torch.gather(x_s, 1, dispatch.reshape(shards, e * cap, 1).expand(
        shards, e * cap, d)).reshape(shards, e, cap, d) \
        * occupied[..., None].to(x.dtype)
    xe = constrain(xe, "batch", "expert", None, "embed")

    dtype = x.dtype
    g = torch.einsum("xecd,edf->xecf", xe, params["w_gate"].to(dtype))
    u = torch.einsum("xecd,edf->xecf", xe, params["w_up"].to(dtype))
    h = _act(cfg, g) * u
    h = constrain(h, "batch", "expert", None, "expert_mlp")
    ye = torch.einsum("xecf,efd->xecd", h, params["w_down"].to(dtype))
    ye = constrain(ye, "batch", "expert", None, "embed")

    # combine via scatter-from-experts: each slot adds its weighted output
    # to its token (empty slots point at token 0 and add zeros)
    contrib = (ye * w_slot[..., None].to(ye.dtype)
               * occupied[..., None].to(ye.dtype))
    scatter_shard = torch.arange(shards, device=dev)[:, None].expand(
        shards, e * cap).reshape(-1)
    y = torch.zeros((shards, nl, d), dtype=torch.float32, device=dev)
    y.index_put_((scatter_shard, dispatch.reshape(-1)),
                 contrib.reshape(-1, d).float(), accumulate=True)
    y = constrain(y, "batch", None, "embed")

    if cfg.shared_expert:
        y = y + _shared(cfg, params, x).reshape(shards, nl, d)

    aux = _aux(expert_idx, probs, e)
    y = y.reshape(b, s, d).to(x.dtype)
    return constrain(y, "batch", "seq", "embed"), aux


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
    inputs = [x, params["router"], params["w_gate"], params["w_up"],
              params["w_down"]]
    specs = [x_spec, (None, None), w_spec, w_spec, w_spec]
    if cfg.shared_expert:                      # f-dim sharded over 'model'
        sh = params["shared"]
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
    keep = flat_dest < e * cap
    index = (flat_dest[keep],)
    table = torch.zeros(e * cap, dtype=torch.long, device=dev)
    table.index_put_(index, token_ids[keep])
    occupied = torch.zeros(e * cap, dtype=torch.bool, device=dev)
    occupied.index_put_(index, torch.ones_like(token_ids[keep],
                                               dtype=torch.bool))
    w_slot = torch.zeros(e * cap, dtype=torch.float32, device=dev)
    w_slot = w_slot.index_put(index, weights[keep])

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
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = capacity(cfg, n)
    x_flat = x.reshape(n, d)
    dev = x.device

    expert_idx, weights, probs = _route(cfg, params["router"], x_flat)
    pos_in_expert = _positions(expert_idx, e)                  # [N,k]
    fits = pos_in_expert < cap
    weights = weights * fits

    # token ids into the [E, cap] dispatch table; past-the-table
    # destinations (tokens over capacity) are dropped
    flat_dest = expert_idx * cap + torch.where(fits, pos_in_expert, e * cap)
    token_ids = torch.arange(n, device=dev)[:, None].expand(n, k)
    keep = flat_dest < e * cap
    table = torch.zeros(e * cap, dtype=torch.long, device=dev)
    table.index_put_((flat_dest[keep],), token_ids[keep])
    occupied = torch.zeros(e * cap, dtype=torch.bool, device=dev)
    occupied.index_put_((flat_dest[keep],),
                        torch.ones_like(token_ids[keep], dtype=torch.bool))
    dispatch = table.reshape(e, cap)
    occupied = occupied.reshape(e, cap)

    xe = x_flat[dispatch] * occupied[..., None].to(x.dtype)     # [E,cap,d]
    xe = constrain(xe, "expert", None, "embed")

    dtype = x.dtype
    g = torch.einsum("ecd,edf->ecf", xe, params["w_gate"].to(dtype))
    u = torch.einsum("ecd,edf->ecf", xe, params["w_up"].to(dtype))
    h = _act(cfg, g) * u
    h = constrain(h, "expert", None, "expert_mlp")
    ye = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(dtype))  # [E,cap,d]

    # combine: scatter-add expert outputs back to tokens, weighted
    flat_src = flat_dest.reshape(-1)                           # [N*k] via [N,k]
    gathered = ye.reshape(e * cap, d)[torch.clamp(flat_src, 0, e * cap - 1)]
    gathered = gathered.float() * weights.reshape(-1)[:, None]
    gathered = torch.where((flat_src < e * cap)[:, None], gathered, 0.0)
    y = torch.zeros((n, d), dtype=torch.float32, device=dev)
    y.index_add_(0, token_ids.reshape(-1), gathered)

    if cfg.shared_expert:
        y = y + _shared(cfg, params, x)

    aux = _aux(expert_idx, probs, e)
    y = y.reshape(b, s, d).to(x.dtype)
    return constrain(y, "batch", "seq", "embed"), aux


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
