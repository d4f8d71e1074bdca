"""Public flash-attention op: pads the sequence dims, runs the kernels.

``attention`` is differentiable: a ``torch.autograd.Function`` routes the
backward through the two backward kernels (the dq sweep and the dk/dv sweep,
with the forward's saved log-sum-exp), so neither pass materialises the
[Sq, Sk] score matrix in device memory — the counterpart of the JAX
package's ``jax.custom_vjp``.  A call that needs no gradient runs the
forward kernel that writes no lse.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import Aval
from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def abstract_params(q, k, v) -> dict:
    """Predictor params from avals (shape-only).  This entry point is
    [B, H, S, D]; the runtime registry's ``flash_attention`` variant set is
    built over ``models.attention`` ([B, S, H, D]) and carries its own hook
    with the same param keys."""
    b, h, s, d = q.shape
    return {"b": int(b), "h": int(h), "s": int(s), "d": int(d)}


def out_aval(q, k, v) -> Aval:
    return Aval(tuple(q.shape), q.dtype)


def _pad(q, k, v, bq, bk):
    sq, sk = q.shape[2], k.shape[2]
    pq, pk = (-sq) % bq, (-sk) % bk
    if pq:
        q = F.pad(q, (0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, pk))
    return q.contiguous(), k.contiguous(), v.contiguous(), sq, sk


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, bq, bk):
        qp, kp, vp, sq, sk = _pad(q, k, v, bq, bk)
        out, lse = _kernel.flash_attention_fwd(
            qp, kp, vp, causal=causal, window=window, bq=bq, bk=bk,
            sk_orig=sk)
        ctx.save_for_backward(qp, kp, vp, out, lse)
        ctx.args = (causal, window, bq, bk, sq, sk)
        return out if out.shape[2] == sq else out[:, :, :sq].contiguous()

    @staticmethod
    def backward(ctx, dout):
        qp, kp, vp, out, lse = ctx.saved_tensors
        causal, window, bq, bk, sq, sk = ctx.args
        h, kv = qp.shape[1], kp.shape[1]
        # no copy where none is needed: a cast to the same type, a pad by
        # nothing, a group sum over groups of one change no bit
        dop = dout if dout.dtype == out.dtype else dout.to(out.dtype)
        if qp.shape[2] != sq:
            dop = F.pad(dop, (0, 0, 0, qp.shape[2] - sq))
        dop = dop.contiguous()
        # delta_i = rowsum(do * o), fp32, outside the kernels as in JAX
        delta = (dop.float() * out.float()).sum(dim=-1)
        # the kernels return q's type, which k and v share
        dq, dk, dv = _kernel.flash_attention_bwd(
            qp, kp, vp, dop, lse, delta, causal=causal, window=window, bq=bq,
            bk=bk, sk_orig=sk)
        if h != kv:
            # GQA: sum the per-q-head dk/dv over each group
            b, _, skp, d = dk.shape
            dk = dk.reshape(b, kv, h // kv, skp, d).sum(dim=2)
            dv = dv.reshape(b, kv, h // kv, skp, d).sum(dim=2)
        return (dq[:, :, :sq], dk[:, :, :sk], dv[:, :, :sk],
                None, None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, bq: int = 256,
              bk: int = 256, use_kernel: bool = True) -> torch.Tensor:
    """q: [B,H,Sq,D]; k, v: [B,KV,Sk,D] -> [B,H,Sq,D] in q's type.
    ``use_kernel=False`` is the plain oracle (differentiable by autograd);
    otherwise the hand kernels on a CUDA tensor, their plain versions on a
    CPU tensor."""
    if not use_kernel:
        return _ref.attention(q, k, v, causal=causal, window=window)
    sq = q.shape[2]
    bq = min(bq, sq) if sq % min(bq, sq) == 0 else bq
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, bq, bk)
    qp, kp, vp, sq, sk = _pad(q, k, v, bq, bk)
    out = _kernel.flash_attention(qp, kp, vp, causal=causal, window=window,
                                  bq=bq, bk=bk, sk_orig=sk)
    return out[:, :, :sq]
