"""Selective SSM (Mamba-style) core, used by the Hymba hybrid blocks: the
port of the JAX package's ``models/ssm.py``.

Training/prefill uses a *chunked* associative scan: a sequential loop over
sequence chunks carrying the SSM state (the reference's ``lax.scan``), with
a parallel prefix scan inside each chunk — ``associative_scan``, ported
with the reference's own recursion (pairs combined, the odd prefix
recursed on, the even elements filled in), so the products and sums come
in its order.  Decode is the O(1) recurrent step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.module import ParamSpec


def ssm_spec(cfg: ArchConfig, d_inner: int) -> dict:
    n = cfg.ssm_state
    return {
        "w_dt": ParamSpec((d_inner,), torch.float32, (None,), init="zeros"),
        "w_dt_proj": ParamSpec((d_inner, d_inner), torch.float32, ("state", None),
                               init_scale=0.01),
        "w_B": ParamSpec((d_inner, n), torch.float32, ("state", None)),
        "w_C": ParamSpec((d_inner, n), torch.float32, ("state", None)),
        "A_log": ParamSpec((d_inner, n), torch.float32, ("state", None), init="zeros"),
        "D": ParamSpec((d_inner,), torch.float32, (None,), init="ones"),
    }


def _discretize(params, u):
    """u: [B,S,di] -> (A_bar [B,S,di,n], Bx [B,S,di,n], C [B,S,n])."""
    u32 = u.float()
    dt = F.softplus(torch.matmul(u32, params["w_dt_proj"].float())
                    + params["w_dt"])                         # [B,S,di]
    A = -torch.exp(params["A_log"].float()) - 1e-3            # [di,n], strictly stable
    B = torch.matmul(u32, params["w_B"].float())
    C = torch.matmul(u32, params["w_C"].float())
    A_bar = torch.exp(dt[..., None] * A[None, None])          # [B,S,di,n]
    Bx = (dt * u32)[..., None] * B[:, :, None, :]             # [B,S,di,n]
    return A_bar, Bx, C


def _assoc_op(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (len(even) - len(odd) is
    0 or 1)."""
    n = even.shape[1] + odd.shape[1]
    if odd.shape[1] < even.shape[1]:
        odd = F.pad(odd, (0,) * (2 * (odd.dim() - 2)) + (0, 1))
    out = torch.stack([even, odd], dim=2).flatten(1, 2)
    return out[:, :n]


def associative_scan(fn, elems: tuple) -> tuple:
    """Inclusive scan of ``fn`` along axis 1 — ``jax.lax.associative_scan``'s
    recursion, element for element."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = fn(tuple(e[:, 0:-1:2] for e in elems),
                 tuple(e[:, 1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:, :-1] for e in odd),
                  tuple(e[:, 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def ssm_apply(params: dict, u: torch.Tensor, *, chunk: int = 1024,
              h0: torch.Tensor | None = None) -> tuple:
    """Run the selective SSM over a full sequence.

    u: [B,S,di]  ->  (y: [B,S,di], h_final: [B,di,n])
    """
    b, s, di = u.shape
    n = params["w_B"].shape[1]
    A_bar, Bx, C = _discretize(params, u)
    h = torch.zeros((b, di, n), dtype=torch.float32, device=u.device) \
        if h0 is None else h0

    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        # padded steps: A_bar=1, Bx=0 leaves the state untouched
        A_bar = F.pad(A_bar, (0, 0, 0, 0, 0, pad), value=1.0)
        Bx = F.pad(Bx, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    ys = []
    for c in range(n_chunks):
        part = slice(c * chunk, (c + 1) * chunk)
        a_i, b_i, c_i = A_bar[:, part], Bx[:, part].clone(), C[:, part]
        # fold carried state into the first element of the chunk
        b_i[:, 0] += a_i[:, 0] * h
        _, h_all = associative_scan(_assoc_op, (a_i, b_i))
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, c_i))  # [B,chunk,di]
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + u.float() * params["D"]
    return y.to(u.dtype), h


def ssm_decode_step(params: dict, u: torch.Tensor, h: torch.Tensor) -> tuple:
    """One token.  u: [B,1,di], h: [B,di,n] -> (y [B,1,di], h')."""
    A_bar, Bx, C = _discretize(params, u)
    h_new = A_bar[:, 0] * h + Bx[:, 0]                        # [B,di,n]
    y = torch.einsum("bdn,bn->bd", h_new, C[:, 0])[:, None]   # [B,1,di]
    y = y + u.float() * params["D"]
    return y.to(u.dtype), h_new
