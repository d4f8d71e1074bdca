"""GQA attention paths in the model layout [B, S, H, D]: the port of the
JAX package's ``models.attention`` ``attend_full`` and ``attend_chunked``.

  * ``attend_full``    — O(S^2) reference (small seqs / tests).
  * ``attend_chunked`` — q-block x KV-chunk tiling with online softmax:
    peak score memory O(B*H*q_chunk*k_chunk) instead of O(B*H*Sq*Sk).  The
    plain-torch adaptation of flash attention, with Python loops in place
    of ``lax.map``/``lax.scan``; the hand kernels in
    ``kernels/flash_attention`` are the card's hot-path variant.

Both keep the JAX order of work: scores in q's type, then fp32; the
probabilities cast back to q's type before the product with v.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.masking import NEG_INF, PAD_SENTINEL, mask_bias


def _positions(n: int, offset: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) + offset


def attend_full(q, k, v, *, causal: bool, window: int = 0,
                q_offset: int = 0) -> torch.Tensor:
    """Naive reference attention.  q:[B,Sq,H,D] k,v:[B,Sk,H,D]."""
    scale = q.shape[-1] ** -0.5
    sq, sk = q.shape[1], k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    bias = mask_bias(_positions(sq, q_offset, q.device),
                     _positions(sk, 0, q.device), causal, window)
    probs = torch.softmax(scores + bias[None, None], dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(q.dtype), v)


def _chunk_body(scale, causal, window, q, q_pos, carry, kv_chunk):
    """Online-softmax update for one KV chunk."""
    acc, m, l = carry
    k_c, v_c, k_pos = kv_chunk
    s = torch.einsum("bshd,bthd->bhst", q, k_c).float() * scale
    s = s + mask_bias(q_pos, k_pos, causal, window)[None, None]
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhst,bthd->bhsd", p.to(q.dtype), v_c).float()
    return acc, m_new, l


def _attend_kv_scan(q, k_r, v_r, p_r, q_pos, *, causal,
                    window) -> torch.Tensor:
    """Online softmax over pre-chunked KV.  q:[B,Sq,H,D]; k_r:[N,B,C,H,D]."""
    b, sq, h, d = q.shape
    scale = d ** -0.5
    carry = (torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device),
             torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                        device=q.device),
             torch.zeros((b, h, sq), dtype=torch.float32, device=q.device))
    for chunk in zip(k_r, v_r, p_r):
        carry = _chunk_body(scale, causal, window, q, q_pos, carry, chunk)
    acc, _, l = carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attend_chunked(q, k, v, *, causal: bool, window: int = 0,
                   k_chunk: int = 1024, q_chunk: int = 512,
                   q_offset: int = 0) -> torch.Tensor:
    """Flash-style attention: q-block x kv-chunk tiling, online softmax."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sk <= k_chunk:
        return attend_full(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)
    n_chunks = -(-sk // k_chunk)
    pad = n_chunks * k_chunk - sk
    k_pos = torch.arange(n_chunks * k_chunk, device=q.device)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.where(k_pos < sk, k_pos, PAD_SENTINEL + k_pos)
    k_r = k.reshape(b, n_chunks, k_chunk, h, d).transpose(0, 1)
    v_r = v.reshape(b, n_chunks, k_chunk, h, d).transpose(0, 1)
    p_r = k_pos.reshape(n_chunks, k_chunk)

    if sq <= q_chunk:
        return _attend_kv_scan(q, k_r, v_r, p_r,
                               _positions(sq, q_offset, q.device),
                               causal=causal, window=window)
    nq = -(-sq // q_chunk)
    qpad = nq * q_chunk - sq
    q_pos = _positions(nq * q_chunk, q_offset, q.device)
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, qpad))
    blocks = [_attend_kv_scan(q[:, i * q_chunk:(i + 1) * q_chunk], k_r, v_r,
                              p_r, q_pos[i * q_chunk:(i + 1) * q_chunk],
                              causal=causal, window=window)
              for i in range(nq)]
    return torch.cat(blocks, dim=1)[:, :sq]
