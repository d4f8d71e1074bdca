"""xLSTM blocks: matrix-memory mLSTM (chunkwise-parallel) and sLSTM — the
port of the JAX package's ``models/xlstm.py``.

mLSTM training/prefill uses the *chunkwise* form: a sequential loop over
sequence chunks carrying the stabilised state (C, n, m), quadratic
attention-like compute inside each chunk — O(S*chunk) instead of O(S^2).
The sLSTM is a per-step loop (the reference's ``lax.scan``).  Each chunk
and each step is recomputed in the backward (``layers.scan_step``, the
reference's ``jax.checkpoint``).  Decode is the O(1) recurrent step.
Stabilisation follows the xLSTM paper (max-state m).

Under a mesh whose rules split ``mlp`` (and the heads) the cores compute
on this rank's block, Megatron's layout: the mLSTM's up product is
column-parallel on this rank's channels of each half of ``w_up``
(``dist.sharding.take_parts``), q, k, v and the gates are row-parallel
sums over those channels (then this rank's heads of them where the heads
split), the chunkwise core and its state (C, n, m) run on this rank's
heads, and ``w_down`` is row-parallel.  Where the heads do not divide the
axes the core runs on this rank's block of C's value rows (the ``d`` of
``C[h, d, e]``, v's head dim) instead: v is cut to those rows after its
sum, ``num``, ``C_new``, the intra-chunk product with v and ``h_tilde``
are computed per value row, the intra-chunk ``q.k`` on this rank's block
of the (batch, head) pairs, gathered whole (:func:`_intra_qk`), and q,
k, the gates, ``den``, ``n`` and ``m`` stay whole on every rank; the
gate and ``w_down``'s rows are then cut in ``h_tilde``'s per-head layout
(``take_parts`` with H parts).  The
sLSTM's gate product is column-parallel on this rank's block of each of
z, i, f and o, gathered whole for the recurrence (:func:`_slstm_gates`).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist.sharding import (active_mesh, constrain, split_axes,
                                       take, take_parts)
from repro_torch.models.layers import apply_norm, norm_spec, scan_step
from repro_torch.models.module import ParamSpec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_spec(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di = 2 * d                        # projection factor 2 (xLSTM-1.3b recipe)
    h = cfg.n_heads
    dh = di // h
    return {
        "norm": norm_spec(cfg.norm_kind, d),
        "w_up": ParamSpec((d, 2 * di), torch.float32, ("embed", "mlp")),
        "wq": ParamSpec((di, h, dh), torch.float32, ("mlp", "heads", "head_dim")),
        "wk": ParamSpec((di, h, dh), torch.float32, ("mlp", "heads", "head_dim")),
        "wv": ParamSpec((di, h, dh), torch.float32, ("mlp", "heads", "head_dim")),
        "w_if": ParamSpec((di, 2 * h), torch.float32, ("mlp", None), init_scale=0.1),
        "b_if": ParamSpec((2 * h,), torch.float32, (None,), init="zeros"),
        "w_down": ParamSpec((di, d), torch.float32, ("mlp", "embed")),
    }


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bse,ehd->bshd") in x's type."""
    e, h, d = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(e, h * d)).unflatten(
        -1, (h, d))


def mlstm_axes(cfg: ArchConfig, b: int, s: int, di: int) -> tuple:
    """(the mesh axes the active rules split the mLSTM's ``mlp`` channels
    over, those of its heads, those of C's value rows); ((), (), ()) where
    they stay whole.  The heads split only where the channels do, over the
    same axes; the value rows where the channels split and the heads do
    not, over the channels' axes, if they divide each head's rows."""
    axes = split_axes(("batch", "seq", "mlp"), (b, s, di), 2)
    if not axes:
        return (), (), ()
    dh = di // cfg.n_heads
    heads = split_axes(("batch", "seq", "heads", "head_dim"),
                       (b, s, cfg.n_heads, dh), 2)
    if heads and heads != axes:
        raise ValueError(f"mLSTM: heads over {heads}, channels over {axes}")
    _, blocks = collectives.block_index(active_mesh(), axes)
    rows = axes if not heads and dh % blocks == 0 else ()
    return axes, heads, rows


def _mlstm_up(params, u, axes, rows, n_heads):
    """(core_in, gate): the up product, column-parallel on this rank's
    block of each half of ``w_up`` where ``axes``; with ``rows`` the gate
    half is cut in ``h_tilde``'s per-head layout (each head's block of
    value rows)."""
    if axes:
        u = collectives.copy_to(u, active_mesh(), axes)
    w = take_parts(params["w_up"], 1, axes, (1, n_heads) if rows else 2)
    if rows:
        # two products, so core_in comes contiguous for q, k and v
        core_w, gate_w = w.chunk(2, dim=1)
        return (torch.matmul(u, core_w.to(u.dtype)),
                torch.matmul(u, gate_w.to(u.dtype)))
    up = torch.matmul(u, w.to(u.dtype))
    half = up.shape[-1] // 2
    return up[..., :half], up[..., half:]


def _mlstm_inputs(params, core_in, axes, heads, rows=()):
    """q, k, v [B,S,H,dh] in core_in's type and the gates (log_i, log_f)
    [B,S,H] in fp32.  With ``axes`` (core_in this rank's channels) each is
    a row-parallel product on this rank's rows of its weight (the block
    the rules hold), summed over the axes; with ``heads`` then this rank's
    heads of it; with ``rows`` v then this rank's value rows [B,S,H,dh/r]
    of each head."""
    mesh = active_mesh()

    def whole(t):
        return collectives.reduce_from(t, mesh, axes) if axes else t

    q, k, v = (whole(_heads(core_in, take(params[w], 0, axes)))
               for w in ("wq", "wk", "wv"))
    g = whole(torch.matmul(core_in.float(),
                           take(params["w_if"], 0, axes).float())) \
        + params["b_if"]
    h2 = g.shape[-1] // 2
    log_i = g[..., :h2]                               # pre-activation ~ log input gate
    log_f = F.logsigmoid(g[..., h2:])                 # sigmoid forget gate
    if heads:
        def mine(t):
            return collectives.split(t, mesh, (None, None, tuple(heads))
                                     + (None,) * (t.ndim - 3))
        q, k, v, log_i, log_f = map(mine, (q, k, v, log_i, log_f))
    if rows:
        v = collectives.split(v, mesh, (None,) * (v.ndim - 1) + (tuple(rows),))
    return q, k, v, log_i, log_f


def _mlstm_down(params, h_tilde, gate, axes, heads, rows, n_heads):
    """The gated output product: h_tilde [B,S,C] (this rank's heads, this
    rank's value rows of every head, or every head) to [B,S,d],
    row-parallel over ``axes``: on ``w_down``'s rows in h_tilde's layout
    (with ``rows`` each head's block of value rows, ``take_parts`` with H
    parts)."""
    mesh = active_mesh()
    if axes and not heads and not rows:
        h_tilde = collectives.split(h_tilde, mesh, (None, None, tuple(axes)))
    gated = h_tilde * F.silu(gate)
    w_down = (take_parts(params["w_down"], 0, rows, n_heads) if rows
              else take(params["w_down"], 0, axes))
    y = torch.matmul(gated, w_down.to(gated.dtype))
    return collectives.reduce_from(y, mesh, axes) if axes else y


def _per_rows(rows):
    """What a computation on this rank's value rows applies to a whole
    tensor it shares with the whole computations (``den``, ``n``):
    ``collectives.copy_to`` over ``rows``, whose backward sums the ranks'
    shares of its cotangent, so the whole tensors' gradients are whole on
    every rank; the identity without ``rows``."""
    if not rows:
        return lambda t: t
    mesh = active_mesh()
    return lambda t: collectives.copy_to(t, mesh, rows)


def _intra_qk(q, k, rows):
    """The intra-chunk product q.k [B,L,L,H] over the whole key dim.  With
    ``rows``, where they divide the B*H (batch, head) pairs, each rank
    computes its block of the pairs (q and k cut by ``collectives.split``,
    whose backward gathers their gradients whole, as q and k are on every
    rank) and the blocks are gathered whole (``collectives.gather``, whose
    backward takes this rank's pairs of a cotangent that is whole and the
    same on every rank).  Each pair's product contracts dh as the whole
    einsum does, so no sum changes its order."""
    b, L, h, dh = q.shape
    if rows:
        mesh = active_mesh()
        _, blocks = collectives.block_index(mesh, rows)
    if not rows or (b * h) % blocks:
        return torch.einsum("blhd,bjhd->bljh", q, k)
    spec = (tuple(rows), None, None)

    def pairs(t):
        return collectives.split(t.transpose(1, 2).reshape(b * h, L, dh),
                                 mesh, spec)

    part = torch.bmm(pairs(q), pairs(k).transpose(1, 2))   # [P/r,L,L]
    qk = collectives.gather(part, mesh, spec)              # [B*H,L,L]
    return qk.reshape(b, h, L, L).permute(0, 2, 3, 1)


def _mlstm_chunk(scale, carry, chunk, rows=()):
    """Chunkwise mLSTM step.  carry: (C [B,H,dv,dh], n [B,H,dh], m [B,H]);
    v and C hold dv value rows (dh, or this rank's block of them over
    ``rows``)."""
    shared = _per_rows(rows)
    C, n, m = carry
    q, k, v, log_i, log_f = chunk         # q,k: [B,L,H,dh]; v: [B,L,H,dv]
    q, k, v = q.float(), k.float(), v.float()
    L = q.shape[1]
    F_ = torch.cumsum(log_f, dim=1)                        # [B,L,H]
    # intra-chunk log weights: logD[b,i,j,h] = F_i - F_j + log_i_j  (j <= i)
    logD = F_[:, :, None, :] - F_[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    logD = torch.where(tri[None, :, :, None], logD, NEG_INF)
    # per-query stabiliser across {carried state, intra-chunk keys}
    m_inter = m[:, None, :] + F_                           # [B,L,H]
    m_new_q = torch.maximum(m_inter, logD.amax(dim=2))     # [B,L,H]
    g = torch.exp(m_inter - m_new_q)                       # carried-state factor
    D = torch.exp(logD - m_new_q[:, :, None, :])           # [B,L,L,H]
    qk = _intra_qk(q, k, rows) * scale                     # [B,L,L,H]
    w_intra = D * qk
    num = (torch.einsum("blh,bhde,blhe->blhd", shared(g), C,
                        shared(q) * scale)
           + torch.einsum("bljh,bjhd->blhd", shared(w_intra), v))  # [B,L,H,dv]
    den = (g * torch.einsum("bhd,blhd->blh", n, q * scale)
           + w_intra.sum(dim=2))                           # [B,L,H]
    h_tilde = num / shared(torch.maximum(den.abs(),
                                         torch.exp(-m_new_q)))[..., None]
    # end-of-chunk state update
    m_end = torch.maximum(m + F_[:, -1],
                          (F_[:, -1:, :] - F_ + log_i).amax(dim=1))
    decay_old = torch.exp(m + F_[:, -1] - m_end)           # [B,H]
    w_end = torch.exp(F_[:, -1:, :] - F_ + log_i - m_end[:, None, :])  # [B,L,H]
    C_new = (shared(decay_old)[..., None, None] * C
             + torch.einsum("blh,blhd,blhe->bhde", shared(w_end), v,
                            shared(k)))
    n_new = decay_old[..., None] * n + torch.einsum("blh,blhd->bhd", w_end, k)
    return (C_new, n_new, m_end), h_tilde


def mlstm_apply(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
                chunk: int = 256, state=None) -> tuple:
    """mLSTM block forward.  x: [B,S,d] -> (y [B,S,d], final state).
    Under a mesh that splits the heads the state is this rank's heads';
    where it splits the value rows, C is this rank's rows of every head
    (n and m whole)."""
    b, s, d = x.shape
    di = 2 * d
    dh = di // cfg.n_heads
    axes, heads, rows = mlstm_axes(cfg, b, s, di)
    u = apply_norm(cfg.norm_kind, params["norm"], x, impl=cfg.norm_impl)
    core_in, gate = _mlstm_up(params, u, axes, rows, cfg.n_heads)
    q, k, v, log_i, log_f = _mlstm_inputs(params, core_in, axes, heads, rows)
    h, dv = q.shape[2], v.shape[3]

    if state is None:
        f32 = {"dtype": torch.float32, "device": x.device}
        state = (torch.zeros((b, h, dv, dh), **f32),
                 torch.zeros((b, h, dh), **f32),
                 torch.zeros((b, h), **f32))

    L = min(chunk, s)
    n_chunks = -(-s // L)
    pad = n_chunks * L - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG_INF)
        log_f = F.pad(log_f, (0, 0, 0, pad))   # f=1 would drift m; 0 ok
    scale = dh ** -0.5
    # the reference's jax.checkpoint
    step = scan_step(functools.partial(_mlstm_chunk, rows=rows) if rows
                     else _mlstm_chunk)
    hs = []
    for chunk_in in zip(*(t.split(L, dim=1)
                          for t in (q, k, v, log_i, log_f))):
        state, h_c = step(scale, state, chunk_in)
        hs.append(h_c)
    h_tilde = torch.cat(hs, dim=1)[:, :s]
    h_tilde = h_tilde.reshape(b, s, h * dv).to(x.dtype)
    y = _mlstm_down(params, h_tilde, gate, axes, heads, rows, cfg.n_heads)
    return constrain(y, "batch", "seq", "embed"), state


def _state_specs(state, heads, rows) -> tuple:
    """Per leaf of (C, n, m), the spec of this rank's block: C, n and m
    over ``heads`` on their head axis, or C over ``rows`` on its value
    rows (n and m whole)."""
    if heads:
        return tuple((None, tuple(heads)) + (None,) * (t.ndim - 2)
                     for t in state)
    c_spec = (None, None, tuple(rows), None) if rows else (None,) * 4
    return (c_spec,) + tuple((None,) * t.ndim for t in state[1:])


def _own_state(state, heads, rows, n_heads, dh):
    """(the state on this rank's heads or value rows, whether it was given
    whole): a decode cache holds either the whole state or this rank's
    block (``dist.sharding.cache_shardings``), told apart by C's shape."""
    whole = tuple(state[0].shape[1:3]) == (n_heads, dh)
    if not (heads or rows) or not whole:
        return state, False
    mesh = active_mesh()
    return tuple(collectives.block(t, mesh, spec) for t, spec in zip(
        state, _state_specs(state, heads, rows))), True


def mlstm_decode_step(cfg: ArchConfig, params: dict, x: torch.Tensor,
                      state) -> tuple:
    """One token through an mLSTM block.  x: [B,1,d].  The new state comes
    back as the state was given: whole, or this rank's heads or value
    rows."""
    b, _, d = x.shape
    di = 2 * d
    dh = di // cfg.n_heads
    axes, heads, rows = mlstm_axes(cfg, b, 1, di)
    (C, n, m), whole = _own_state(state, heads, rows, cfg.n_heads, dh)
    u = apply_norm(cfg.norm_kind, params["norm"], x, impl=cfg.norm_impl)
    core_in, gate = _mlstm_up(params, u, axes, rows, cfg.n_heads)
    q, k, v, log_i, log_f = (t[:, 0] for t in _mlstm_inputs(
        params, core_in, axes, heads, rows))
    m_new = torch.maximum(log_f + m, log_i)
    f_p = torch.exp(log_f + m - m_new)[..., None]
    i_p = torch.exp(log_i - m_new)[..., None]
    k32, v32, q32 = k.float(), v.float(), q.float() * (dh ** -0.5)
    shared = _per_rows(rows)
    C_new = shared(f_p)[..., None] * C + shared(i_p)[..., None] * torch.einsum(
        "bhd,bhe->bhde", v32, shared(k32))
    n_new = f_p * n + i_p * k32
    num = torch.einsum("bhde,bhe->bhd", C_new, shared(q32))
    den = torch.einsum("bhd,bhd->bh", n_new, q32)
    h_tilde = num / shared(torch.maximum(den.abs(),
                                         torch.exp(-m_new)))[..., None]
    h_tilde = h_tilde.reshape(b, 1, -1).to(x.dtype)
    y = _mlstm_down(params, h_tilde, gate, axes, heads, rows, cfg.n_heads)
    new = (C_new, n_new, m_new)
    if whole:
        mesh = active_mesh()
        new = tuple(collectives._gather_whole(t, mesh, spec) for t, spec
                    in zip(new, _state_specs(new, heads, rows)))
    return y, new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_spec(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {
        "norm": norm_spec(cfg.norm_kind, d),
        "w_gates": ParamSpec((d, 4 * d), torch.float32, ("embed", "mlp")),
        "r_gates": ParamSpec((h, dh, 4 * dh), torch.float32,
                             ("heads", "head_dim", None), fan_in_axes=(1,)),
        "b_gates": ParamSpec((4 * d,), torch.float32, (None,), init="zeros"),
        "w_out": ParamSpec((d, d), torch.float32, ("embed", "embed")),
    }


def _slstm_cell(params, h_heads, carry, x_row):
    """One sLSTM step.  carry: (c,n,m,hprev) each [B,d]; x_row: [B,4d]."""
    c, n, m, hprev = carry
    b, d = c.shape
    dh = d // h_heads
    hp = hprev.reshape(b, h_heads, dh)
    rec = torch.einsum("bhd,hde->bhe", hp, params["r_gates"].float())
    gates = x_row + rec.reshape(b, 4 * d) + params["b_gates"]
    zt, it, ft, ot = torch.chunk(gates, 4, dim=-1)
    z = torch.tanh(zt)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def _slstm_gates(params, u) -> torch.Tensor:
    """The input gates xg [B,S,4d] in fp32, whole.  Under a mesh that
    splits ``mlp`` the product is column-parallel on this rank's block of
    each of z, i, f and o (``take_parts``) and gathered whole once: the
    reference's cell feeds head j's recurrent output to the j-th quarter
    of the concatenated gates, so no rank's channels close under the
    recurrence, which runs whole on every rank."""
    b, s, d = u.shape
    axes = split_axes(("batch", "seq", "mlp"), (b, s, d), 2)
    if not axes:
        return torch.matmul(u.float(), take(params["w_gates"]).float())
    mesh = active_mesh()
    part = torch.matmul(collectives.copy_to(u.float(), mesh, axes),
                        take_parts(params["w_gates"], 1, axes, 4).float())
    part = part.unflatten(-1, (4, -1))
    whole = collectives.gather(part, mesh, (None,) * (part.ndim - 1)
                               + (tuple(axes),))
    return whole.flatten(-2)


def slstm_apply(cfg: ArchConfig, params: dict, x: torch.Tensor,
                state=None) -> tuple:
    """sLSTM block forward (sequential over S).  x: [B,S,d]."""
    b, s, d = x.shape
    u = apply_norm(cfg.norm_kind, params["norm"], x, impl=cfg.norm_impl)
    xg = _slstm_gates(params, u)                              # [B,S,4d]
    if state is None:
        z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (z, z, z, z)
    step = scan_step(_slstm_cell)       # the reference's jax.checkpoint
    hs = []
    for x_row in xg.unbind(1):      # one gradient buffer, not one per step
        state, h_t = step(params, cfg.n_heads, state, x_row)
        hs.append(h_t)
    y = torch.matmul(torch.stack(hs, dim=1).to(x.dtype),
                     params["w_out"].to(x.dtype))
    return constrain(y, "batch", "seq", "embed"), state


def slstm_decode_step(cfg: ArchConfig, params: dict, x: torch.Tensor,
                      state) -> tuple:
    u = apply_norm(cfg.norm_kind, params["norm"], x, impl=cfg.norm_impl)
    xg = _slstm_gates(params, u)[:, 0]
    state, h = _slstm_cell(params, cfg.n_heads, state, xg)
    y = torch.matmul(h.to(x.dtype), params["w_out"].to(x.dtype))[:, None]
    return y, state
