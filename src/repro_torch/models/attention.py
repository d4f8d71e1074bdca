"""GQA attention in the model layout [B, S, H, D]: the port of the JAX
package's ``models/attention.py``.

  * ``attend_full``    — O(S^2) reference (small seqs / tests).
  * ``attend_chunked`` — q-block x KV-chunk tiling with online softmax:
    peak score memory O(B*H*q_chunk*k_chunk) instead of O(B*H*Sq*Sk).  The
    plain-torch adaptation of flash attention, with Python loops in place
    of ``lax.map``/``lax.scan``.
  * ``attend_local``   — block-banded sliding window, O(S*2w).
  * ``attend_decode``  — one query position against a KV cache, GQA in
    grouped form.

``attention()``'s full-sequence branch, ``attend_chunked`` in the
reference, runs on a CUDA tensor through the hand flash-attention kernel
(``kernels.flash_attention.ops.attention``, the counterpart of the Pallas
kernel the reference names as the TPU hot path), with k and v un-expanded:
the kernel does GQA itself.  On a CPU tensor, or with ``use_kernel=False``,
it is the port's ``attend_chunked``.  There is no fallback: a kernel that
fails to build or launch, or a head dim it does not take, raises.  With
``ring=True`` under a mesh whose ``model`` axis splits the sequence, the
branch is ``dist.ring_attention.ring_attention`` instead (k and v
expanded), and the decode step with ``stream_kv`` reads the cache through
``ring_decode``, as in the reference.

The torch paths keep the JAX order of work: scores in q's type, then fp32;
the probabilities cast back to q's type before the product with v.
``attention_decode_step`` writes the new token's k and v into the cache
tensors it is given, in place (the reference's ``dynamic_update_slice``
on a carry that aliases).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.masking import NEG_INF, PAD_SENTINEL, mask_bias
from repro_torch.dist.ring_attention import ring_attention, ring_decode
from repro_torch.dist.sharding import _axis_sizes, active_mesh, constrain
from repro_torch.kernels import on_cuda
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import rope
from repro_torch.models.module import ParamSpec


def attention_spec(cfg: ArchConfig, cross: bool = False) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamSpec((d, h, hd), torch.float32, ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), torch.float32, ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), torch.float32, ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), torch.float32, ("heads", "head_dim", "embed"),
                        fan_in_axes=(0, 1)),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one product in x's type."""
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(
        -1, (h, k))


def _project_qkv(cfg, params, x, kv_src=None):
    kv_src = x if kv_src is None else kv_src
    q = _project(x, params["wq"])
    k = _project(kv_src, params["wk"])
    v = _project(kv_src, params["wv"])
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bshd,hdk->bsk") as one product in ``dtype``."""
    h, hd, d = wo.shape
    return torch.matmul(out.to(dtype).flatten(-2),
                        wo.to(dtype).reshape(h * hd, d))


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,T,KV,D] -> [B,T,H,D] by repeating each kv head H/KV times."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


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


def attend_local(q, k, v, *, window: int, q_offset: int = 0) -> torch.Tensor:
    """Block-banded sliding-window attention: O(S*2w) compute/memory.

    Queries are blocked at the window size; block i attends only blocks
    {i-1, i} (every key within (p-w, p] lives there)."""
    b, s, h, d = q.shape
    w = window
    nb = -(-s // w)
    pad = nb * w - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    qb = q.reshape(b, nb, w, h, d)
    kb = k.reshape(b, nb, w, h, d)
    vb = v.reshape(b, nb, w, h, d)
    # previous block (block -1 is zeros, masked out by positions)
    k_prev = F.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    v_prev = F.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    k2 = torch.cat([k_prev, kb], dim=2)                 # [b,nb,2w,h,d]
    v2 = torch.cat([v_prev, vb], dim=2)
    scale = d ** -0.5
    s_ = torch.einsum("bnqhd,bnkhd->bnhqk", qb, k2).float() * scale
    dev = q.device
    q_pos = torch.arange(nb * w, device=dev).reshape(nb, w) + q_offset
    k_pos = q_pos[:, :1] // w * w - w + torch.arange(2 * w, device=dev)[None, :]
    valid = (k_pos >= 0) & (k_pos < s + q_offset)
    ok = (k_pos[:, None, :] <= q_pos[:, :, None]) \
        & (q_pos[:, :, None] - k_pos[:, None, :] < w) \
        & valid[:, None, :]
    s_ = torch.where(ok[None, :, None], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p.to(q.dtype), v2)
    return out.reshape(b, nb * w, h, d)[:, :s]


def attend_decode(q, k_cache, v_cache, cache_index, *, window: int = 0,
                  start=None) -> torch.Tensor:
    """Single-position decode.  q:[B,1,H,D]; caches:[B,Smax,KV,D].

    GQA is computed in *grouped* form (no KV expansion: the cache is read
    once).  ``start`` [B] masks each slot's cache before its admission
    index (continuous batching)."""
    b, one, h, d = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = d ** -0.5
    smax = k_cache.shape[1]
    pos = torch.arange(smax, device=q.device)
    visible = (pos <= cache_index)[None, :]
    if window > 0:
        visible = visible & (pos > cache_index - window)[None, :]
    if start is not None:
        # slot b was admitted at start[b]; anything before that is a
        # previous tenant's stale cache
        visible = visible & (pos[None, :] >= start[:, None])
    q = constrain(q, "batch", "seq", "heads_act", "head_dim")
    qg = q.reshape(b, one, kv, g, d)
    s = torch.einsum("bikgd,btkd->bkgit", qg, k_cache).float() * scale
    s = constrain(s, "batch", "kv_heads_act", None, "seq", "cache_seq")
    s = torch.where(visible[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgit,btkd->bikgd", p.to(q.dtype), v_cache)
    out = out.reshape(b, one, h, d)
    return constrain(out, "batch", "seq", "heads_act", "head_dim")


def _ring_mesh(s: int):
    """The active mesh when the reference's ring would shard a sequence of
    ``s`` (a ``model`` axis of more than one device that divides ``s``),
    else None: with none the ring is the dense path, as there."""
    mesh = active_mesh()
    n = _axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    return mesh if n > 1 and s % n == 0 else None


def _attend_kernel(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    """The hand flash-attention kernel on q [B,S,H,D] and un-expanded k, v
    [B,T,KV,D]: the kernel takes [B,H,S,D], does GQA itself and masks the
    padding of ragged lengths through ``sk_orig``."""
    out = fa_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def attention(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              positions: Optional[torch.Tensor] = None,
              use_rope: bool = True,
              kv_src: Optional[torch.Tensor] = None,
              k_chunk: int = 1024, return_kv: bool = False,
              local_block: bool = False, ring: bool = False,
              use_kernel: bool = True):
    """Full-sequence attention (train / prefill).  Cross-attn via kv_src.

    With ``return_kv`` also returns the post-rope (k, v) in cache layout
    [B,S,KV,D] so prefill can populate the decode cache.  ``local_block``
    switches windowed layers to the O(S*2w) banded path.  The chunked
    branch runs the hand kernel on a CUDA tensor unless ``use_kernel`` is
    False (module docstring)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x, kv_src)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        kv_pos = positions if kv_src is None else torch.arange(
            k.shape[1], device=x.device)[None, :]
        k = rope(k, kv_pos, cfg.rope_theta)
    kv = (k, v)
    ring_mesh = _ring_mesh(s) if ring and kv_src is None else None
    if local_block and window > 0 and causal and s > window:
        out = attend_local(q, _expand_kv(k, cfg.n_heads),
                           _expand_kv(v, cfg.n_heads), window=window)
    elif ring_mesh is not None:
        out = ring_attention(q, _expand_kv(k, cfg.n_heads),
                             _expand_kv(v, cfg.n_heads), mesh=ring_mesh,
                             axis_name="model", causal=causal, window=window)
    else:
        if use_kernel and on_cuda(q, k, v):
            out = _attend_kernel(q, k, v, causal=causal, window=window)
        else:
            out = attend_chunked(q, _expand_kv(k, cfg.n_heads),
                                 _expand_kv(v, cfg.n_heads), causal=causal,
                                 window=window, k_chunk=k_chunk)
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    y = _out_proj(out, params["wo"], x.dtype)
    y = constrain(y, "batch", "seq", "embed")
    if return_kv:
        return y, kv
    return y


def attention_decode_step(cfg: ArchConfig, params: dict, x: torch.Tensor,
                          cache: dict, cache_index, *,
                          window: int = 0, use_rope: bool = True,
                          update_cache: bool = True, start=None,
                          stream_kv: bool = False) -> tuple:
    """One decode step.  x:[B,1,d]; cache: {"k","v"}: [B,Smax,KV,D].

    With ``update_cache`` the new token's k and v are written into
    ``cache["k"]``/``cache["v"]`` at ``cache_index`` in place, and the same
    dict is returned.  ``stream_kv`` reads the cache through the decode
    ring (``dist.ring_attention.ring_decode``): with ``serve_rules(
    long_context=True)`` each rank reads its ``cache_seq`` shard and only
    softmax stats travel; with no mesh active it is the dense
    ``attend_decode``, as in the reference."""
    dtype = x.dtype
    index = int(cache_index)
    q = _project(x, params["wq"])
    k_new = _project(x, params["wk"])
    v_new = _project(x, params["wv"])
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    q = constrain(q, "batch", "seq", "heads_act", "head_dim")
    k_new = constrain(k_new, "batch", "seq", "kv_heads", "head_dim")
    k_new = constrain(k_new, "batch", "seq", "kv_heads_act", "head_dim")
    v_new = constrain(v_new, "batch", "seq", "kv_heads", "head_dim")
    v_new = constrain(v_new, "batch", "seq", "kv_heads_act", "head_dim")
    pos = torch.full((x.shape[0], 1), index, dtype=torch.int32,
                     device=x.device)
    if start is not None:
        pos = pos - start[:, None]        # request-local rope positions
    if use_rope:
        q = rope(q, pos, cfg.rope_theta)
        k_new = rope(k_new, pos, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    if update_cache:
        # one token slice of each cache, written in place
        k_cache[:, index:index + 1] = k_new.to(k_cache.dtype)
        v_cache[:, index:index + 1] = v_new.to(v_cache.dtype)
    if stream_kv:
        out = ring_decode(q, k_cache.to(dtype), v_cache.to(dtype), index,
                          window=window, start=start)
    else:
        out = attend_decode(q, k_cache.to(dtype), v_cache.to(dtype), index,
                            window=window, start=start)
    y = _out_proj(out, params["wo"], dtype)
    return y, cache
