"""xLSTM blocks: matrix-memory mLSTM (chunkwise-parallel) and sLSTM — the
port of the JAX package's ``models/xlstm.py``.

mLSTM training/prefill uses the *chunkwise* form: a sequential loop over
sequence chunks carrying the stabilised state (C, n, m), quadratic
attention-like compute inside each chunk — O(S*chunk) instead of O(S^2).
The sLSTM is a per-step loop (the reference's ``lax.scan``).  Decode is
the O(1) recurrent step.  Stabilisation follows the xLSTM paper (max-state
m).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models.layers import apply_norm, norm_spec
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


def _mlstm_gates(params, u):
    """u: [B,S,di] -> (log_i, log_f): [B,S,H] in fp32."""
    h2 = params["w_if"].shape[1] // 2
    g = torch.matmul(u.float(), params["w_if"].float()) + params["b_if"]
    log_i = g[..., :h2]                               # pre-activation ~ log input gate
    log_f = F.logsigmoid(g[..., h2:])                 # sigmoid forget gate
    return log_i, log_f


def _mlstm_chunk(scale, carry, chunk):
    """Chunkwise mLSTM step.  carry: (C [B,H,dh,dh], n [B,H,dh], m [B,H])."""
    C, n, m = carry
    q, k, v, log_i, log_f = chunk         # q,k,v: [B,L,H,dh]; gates: [B,L,H]
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
    qk = torch.einsum("blhd,bjhd->bljh", q, k) * scale     # [B,L,L,H]
    w_intra = D * qk
    num = (torch.einsum("blh,bhde,blhe->blhd", g, C, q * scale)
           + torch.einsum("bljh,bjhd->blhd", w_intra, v))  # [B,L,H,dh]
    den = (g * torch.einsum("bhd,blhd->blh", n, q * scale)
           + w_intra.sum(dim=2))                           # [B,L,H]
    h_tilde = num / torch.maximum(den.abs(), torch.exp(-m_new_q))[..., None]
    # end-of-chunk state update
    m_end = torch.maximum(m + F_[:, -1],
                          (F_[:, -1:, :] - F_ + log_i).amax(dim=1))
    decay_old = torch.exp(m + F_[:, -1] - m_end)           # [B,H]
    w_end = torch.exp(F_[:, -1:, :] - F_ + log_i - m_end[:, None, :])  # [B,L,H]
    C_new = (decay_old[..., None, None] * C
             + torch.einsum("blh,blhd,blhe->bhde", w_end, v, k))
    n_new = decay_old[..., None] * n + torch.einsum("blh,blhd->bhd", w_end, k)
    return (C_new, n_new, m_end), h_tilde


def mlstm_apply(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
                chunk: int = 256, state=None) -> tuple:
    """mLSTM block forward.  x: [B,S,d] -> (y [B,S,d], final state)."""
    b, s, d = x.shape
    di = 2 * d
    h = cfg.n_heads
    dh = di // h
    u = apply_norm(cfg.norm_kind, params["norm"], x, impl=cfg.norm_impl)
    up = torch.matmul(u, params["w_up"].to(x.dtype))
    core_in, gate = up[..., :di], up[..., di:]
    q = _heads(core_in, params["wq"])
    k = _heads(core_in, params["wk"])
    v = _heads(core_in, params["wv"])
    log_i, log_f = _mlstm_gates(params, core_in)

    if state is None:
        f32 = {"dtype": torch.float32, "device": x.device}
        state = (torch.zeros((b, h, dh, dh), **f32),
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
    hs = []
    for c in range(n_chunks):
        part = slice(c * L, (c + 1) * L)
        state, h_c = _mlstm_chunk(scale, state, tuple(
            t[:, part] for t in (q, k, v, log_i, log_f)))
        hs.append(h_c)
    h_tilde = torch.cat(hs, dim=1)[:, :s]
    h_tilde = h_tilde.reshape(b, s, di).to(x.dtype)
    gated = h_tilde * F.silu(gate)
    y = torch.matmul(gated, params["w_down"].to(x.dtype))
    return constrain(y, "batch", "seq", "embed"), state


def mlstm_decode_step(cfg: ArchConfig, params: dict, x: torch.Tensor,
                      state) -> tuple:
    """One token through an mLSTM block.  x: [B,1,d]."""
    b, _, d = x.shape
    di = 2 * d
    h = cfg.n_heads
    dh = di // h
    C, n, m = state
    u = apply_norm(cfg.norm_kind, params["norm"], x, impl=cfg.norm_impl)
    up = torch.matmul(u, params["w_up"].to(x.dtype))
    core_in, gate = up[..., :di], up[..., di:]
    q = _heads(core_in, params["wq"])[:, 0]
    k = _heads(core_in, params["wk"])[:, 0]
    v = _heads(core_in, params["wv"])[:, 0]
    log_i, log_f = _mlstm_gates(params, core_in)
    log_i, log_f = log_i[:, 0], log_f[:, 0]                  # [B,H]
    m_new = torch.maximum(log_f + m, log_i)
    f_p = torch.exp(log_f + m - m_new)[..., None]
    i_p = torch.exp(log_i - m_new)[..., None]
    k32, v32, q32 = k.float(), v.float(), q.float() * (dh ** -0.5)
    C_new = f_p[..., None] * C + i_p[..., None] * torch.einsum(
        "bhd,bhe->bhde", v32, k32)
    n_new = f_p * n + i_p * k32
    num = torch.einsum("bhde,bhe->bhd", C_new, q32)
    den = torch.einsum("bhd,bhd->bh", n_new, q32)
    h_tilde = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h_tilde = h_tilde.reshape(b, 1, di).to(x.dtype)
    y = torch.matmul(h_tilde * F.silu(gate), params["w_down"].to(x.dtype))
    return y, (C_new, n_new, m_new)


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


def slstm_apply(cfg: ArchConfig, params: dict, x: torch.Tensor,
                state=None) -> tuple:
    """sLSTM block forward (sequential over S).  x: [B,S,d]."""
    b, s, d = x.shape
    u = apply_norm(cfg.norm_kind, params["norm"], x, impl=cfg.norm_impl)
    xg = torch.matmul(u.float(), params["w_gates"].float())   # [B,S,4d]
    if state is None:
        z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (z, z, z, z)
    hs = []
    for t in range(s):
        state, h_t = _slstm_cell(params, cfg.n_heads, state, xg[:, t])
        hs.append(h_t)
    y = torch.matmul(torch.stack(hs, dim=1).to(x.dtype),
                     params["w_out"].to(x.dtype))
    return constrain(y, "batch", "seq", "embed"), state


def slstm_decode_step(cfg: ArchConfig, params: dict, x: torch.Tensor,
                      state) -> tuple:
    u = apply_norm(cfg.norm_kind, params["norm"], x, impl=cfg.norm_impl)
    xg = torch.matmul(u.float(), params["w_gates"].float())[:, 0]
    state, h = _slstm_cell(params, cfg.n_heads, state, xg)
    y = torch.matmul(h.to(x.dtype), params["w_out"].to(x.dtype))[:, None]
    return y, state
