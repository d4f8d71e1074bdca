"""Selective SSM (Mamba-style) core, used by the Hymba hybrid blocks: the
port of the JAX package's ``models/ssm.py``.

Training/prefill uses a *chunked* associative scan: a sequential loop over
sequence chunks carrying the SSM state (the reference's ``lax.scan``), with
a parallel prefix scan inside each chunk — ``associative_scan``, ported
with the reference's own recursion (pairs combined, the odd prefix
recursed on, the even elements filled in), so the products and sums come
in its order.  Each chunk's step is recomputed in the backward
(``layers.scan_step``, the reference's ``jax.checkpoint``) and makes its
own A_bar and Bx from the chunk's slice of dt, u, B and C, so only those
[B,S,di] coefficients and each chunk's carried state are kept, never a
[B,S,di,n] tensor whole.  Decode is the O(1) recurrent step.

Under a mesh whose rules split ``mlp`` (the caller's ``axes``), the SSM
runs on this rank's block of the ``d_inner`` channels (the recurrence is
independent per channel): :func:`_coefficients` says which products
contract over every channel and how.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist.sharding import active_mesh, take
from repro_torch.models.layers import scan_step
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


def _coefficients(params, u, axes: tuple = ()):
    """u: [B,S,di] -> (u fp32, dt [B,S,di], A [di,n], B [B,S,n], C [B,S,n]).

    With ``axes`` (the mesh axes the rules split ``mlp`` over) ``u`` is
    this rank's block of the channels and so are dt and A: ``u`` is
    gathered whole once for the products that contract over every
    channel (``w_dt_proj``'s columns of this rank, ``w_B``, ``w_C``), and
    ``w_dt``, ``A_log``'s rows and (in the callers) ``D`` are this rank's
    block.  B and C are whole on every rank; their gradient's partial
    shares are summed (``copy_to``), as are the whole input's of dt's
    product."""
    u32 = u.float()
    w_dt, w_dt_proj, A_log = params["w_dt"], params["w_dt_proj"], params["A_log"]
    w_B, w_C = params["w_B"].float(), params["w_C"].float()
    if axes:
        mesh = active_mesh()
        whole = collectives.gather(u32, mesh, (None,) * (u.ndim - 1)
                                   + (tuple(axes),))
        dt_in = collectives.copy_to(whole, mesh, axes)
        w_dt_proj = take(w_dt_proj, 1, axes)
        w_dt, A_log = take(w_dt, 0, axes), take(A_log, 0, axes)
        B = collectives.copy_to(torch.matmul(whole, w_B), mesh, axes)
        C = collectives.copy_to(torch.matmul(whole, w_C), mesh, axes)
    else:
        dt_in = u32
        B, C = torch.matmul(u32, w_B), torch.matmul(u32, w_C)
    dt = F.softplus(torch.matmul(dt_in, w_dt_proj.float()) + w_dt)  # [B,S,di]
    A = -torch.exp(A_log.float()) - 1e-3      # [di,n], strictly stable
    return u32, dt, A, B, C


def _expand(dt, u32, A, B):
    """(A_bar [B,S,di,n], Bx [B,S,di,n]): elementwise, so a slice of the
    sequence gives that slice of the whole's values."""
    A_bar = torch.exp(dt[..., None] * A[None, None])
    Bx = (dt * u32)[..., None] * B[:, :, None, :]
    return A_bar, Bx


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


def _chunk_step(A, h, dt_c, u_c, B_c, C_c):
    """One chunk: its A_bar and Bx from the chunk's coefficients, the
    carried state folded into its first element, the associative scan;
    returns (the state after it, y [B,chunk,di]).  Remat'ed in the loop:
    only the carry and the chunk's slices are kept for the backward."""
    a_i, b_i = _expand(dt_c, u_c, A, B_c)
    b_i[:, 0] += a_i[:, 0] * h
    _, h_all = associative_scan(_assoc_op, (a_i, b_i))
    y = torch.einsum("bcdn,bcn->bcd", h_all, C_c)
    return h_all[:, -1].clone(), y


def ssm_apply(params: dict, u: torch.Tensor, *, chunk: int = 1024,
              h0: torch.Tensor | None = None, axes: tuple = ()) -> tuple:
    """Run the selective SSM over a full sequence.

    u: [B,S,di]  ->  (y: [B,S,di], h_final: [B,di,n]); with ``axes`` (see
    :func:`_coefficients`) u, y and the state are this rank's channels.
    """
    b, s, di = u.shape
    n = params["w_B"].shape[1]
    u32, dt, A, B, C = _coefficients(params, u, axes)
    h = torch.zeros((b, di, n), dtype=torch.float32, device=u.device) \
        if h0 is None else h0

    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    xs = (dt, u32, B, C)
    if pad:
        # padded steps: dt=0 gives A_bar=1, Bx=0, leaving the state as it is
        xs = tuple(F.pad(t, (0, 0, 0, pad)) for t in xs)
    step = scan_step(_chunk_step)       # the reference's jax.checkpoint
    ys = []
    for chunk_in in zip(*(t.split(chunk, dim=1) for t in xs)):
        h, y = step(A, h, *chunk_in)
        ys.append(y)                                          # [B,chunk,di]
    y = torch.cat(ys, dim=1)[:, :s]
    D = take(params["D"], 0, axes)
    y = y + u32 * D
    return y.to(u.dtype), h


def ssm_decode_step(params: dict, u: torch.Tensor, h: torch.Tensor,
                    axes: tuple = ()) -> tuple:
    """One token.  u: [B,1,di], h: [B,di,n] -> (y [B,1,di], h'); with
    ``axes`` u and y are this rank's channels, and h is either every
    channel or this rank's (a cache holds either,
    ``dist.sharding.cache_shardings``; told apart by its shape): h' comes
    back as h was given."""
    whole = bool(axes) and h.shape[1] != u.shape[-1]
    spec = (None, tuple(axes), None)
    if whole:
        h = collectives.block(h, active_mesh(), spec)
    u32, dt, A, B, C = _coefficients(params, u, axes)
    A_bar, Bx = _expand(dt, u32, A, B)
    h_new = A_bar[:, 0] * h + Bx[:, 0]                        # [B,di,n]
    y = torch.einsum("bdn,bn->bd", h_new, C[:, 0])[:, None]   # [B,1,di]
    y = y + u32 * take(params["D"], 0, axes)
    if whole:
        h_new = collectives._gather_whole(h_new, active_mesh(), spec)
    return y.to(u.dtype), h_new
