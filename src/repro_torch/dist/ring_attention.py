"""Blockwise ring attention over one mesh axis (sequence parallelism): the
port of the JAX package's ``dist/ring_attention.py`` on
``torch.distributed``.

The sequence axis of q, k, v is sharded over ``axis_name``; each rank keeps
its q block resident while k/v blocks rotate around the ring
(``collectives.ppermute``, each hop's send and receive posted together).
Per hop the rank folds the visiting k/v block into an online-softmax
accumulator (the same update as ``attend_chunked``), so the only
collective is the neighbour exchange.  Numerics match the dense
``models.attention.attend_full`` for causal, non-causal and sliding-window
masks; uneven ``seq % n`` is handled by padding the sequence and masking
the pad keys with ``PAD_SENTINEL``.

The first hop folds the rank's own (diagonal) block, which every query can
see under any supported mask, so the running max is finite from step one
and fully-masked later blocks contribute exact zeros.  Under a causal mask
those blocks are *skipped*: at hop ``step`` the ranks with ``idx < step``
hold a block that wrapped around the ring and lies wholly in their causal
future.  The fold is skipped there (a Python branch on this rank's
coordinate, the reference's ``lax.cond``); the rotation runs on every rank
at every hop, since a rank that skipped its send and receive would
deadlock the ring; under autograd a skipping rank ties the block it did
not fold into its accumulator (``collectives.tie``), so that the backward
rotation also runs on every rank.

Global view (``dist.collectives``): the functions take the whole q, k, v
on every rank and return the whole output on every rank; the per-hop fold
is plain torch products, as the reference's ring is einsums, not a Pallas
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives
from repro_torch.dist.masking import NEG_INF, PAD_SENTINEL, mask_bias
from repro_torch.dist.sharding import _axis_sizes, active_mesh


def _causal_skip_possible(step: int, n: int, s_loc: int,
                          q_offset: int) -> bool:
    """True when ring hop ``step`` presents a fully causally-masked k/v
    block to the ranks with ``idx < step``: their block wrapped around the
    ring (src = idx - step + n), so its smallest key position
    ``src * s_loc`` exceeds their largest query position
    ``idx * s_loc + s_loc - 1 + q_offset`` — independent of idx, hence
    static per hop; ``idx`` only decides *which* ranks skip.  A window
    mask only removes further visibility, so the causal criterion stays
    safe with ``window > 0``."""
    return step > 0 and (n - step - 1) * s_loc >= q_offset


def _ring(n: int) -> list:
    """One hop to the next coordinate: (j, j + 1 mod n)."""
    return [(j, (j + 1) % n) for j in range(n)]


def _merge(a: tuple, b: tuple) -> tuple:
    acc1, m1, l1 = a
    acc2, m2, l2 = b
    m_new = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m_new)
    a2 = torch.exp(m2 - m_new)
    return (acc1 * a1[..., None] + acc2 * a2[..., None], m_new,
            l1 * a1 + l2 * a2)


def ring_decode(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cache_index, *, mesh=None,
                axis_name: str = "model", window: int = 0,
                start=None) -> torch.Tensor:
    """Decode-time ring attention over a sequence-sharded KV cache.

    q: [B,1,H,D]; caches: [B,Smax,KV,D] with ``cache_seq`` sharded over
    ``axis_name`` (``serve_rules(long_context=True)``).  The KV shards never
    move: each rank computes grouped online-softmax *stats* (acc, m, l) over
    its resident shard and only the [B,KV,G]-shaped stats rotate around the
    ring.  A shard whose keys are all masked for some row yields m =
    NEG_INF (finite, so no NaN); its (acc, l) are annihilated by alpha = 0
    when a visible shard folds in, and the shard holding ``cache_index`` is
    always visible.

    The reference merges the stats in ring order from each rank, so its
    ranks differ in the last bits; here every rank merges the n shards'
    stats in coordinate order, so the ranks' outputs are bit-equal.
    Degenerates to ``attend_decode`` with no mesh, a 1-rank ring, or a
    cache length the ring cannot split evenly.
    """
    if mesh is None:
        mesh = active_mesh()
    b, one, h, d = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    n = _axis_sizes(mesh).get(axis_name, 1) if mesh is not None else 1
    if mesh is None or n <= 1 or smax % n != 0:
        from repro_torch.models.attention import attend_decode
        return attend_decode(q, k_cache, v_cache, cache_index,
                             window=window, start=start)
    g = h // kv
    s_loc = smax // n
    scale = d ** -0.5
    index = int(cache_index)
    dev = q.device
    if start is None:
        start = torch.zeros((b,), dtype=torch.int32, device=dev)

    kv_spec = (None, axis_name, None, None)
    q, k_loc, v_loc = collectives.shard((q, k_cache, v_cache), mesh,
                                        ((None,) * 4, kv_spec, kv_spec))
    idx = collectives.axis_index(mesh, axis_name)
    pos = idx * s_loc + torch.arange(s_loc, device=dev)
    visible = (pos <= index)[None, :] & (pos[None, :] >= start[:, None])
    if window > 0:
        visible = visible & (pos > index - window)[None, :]
    q0 = q[:, 0].reshape(b, kv, g, d)
    sc = torch.einsum("bkgd,btkd->bkgt", q0, k_loc).float() * scale
    sc = torch.where(visible[:, None, None, :], sc, NEG_INF)
    m = sc.amax(dim=-1)                                   # [B,KV,G]
    p = torch.exp(sc - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgt,btkd->bkgd", p, v_loc.float())

    stats = {idx: (acc, m, l)}
    vis = (acc, m, l)
    for hop in range(1, n):
        vis = collectives.ppermute(vis, mesh, axis_name, _ring(n))
        stats[(idx - hop) % n] = vis
    run = stats[0]
    for src in range(1, n):
        run = _merge(run, stats[src])
    acc, m, l = run
    out = acc / torch.clamp(l, min=1e-30)[..., None]      # [B,KV,G,D]
    out = out.reshape(b, 1, h, d).to(q.dtype)
    return collectives.unshard(out, mesh, (None,) * 4)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh=None, axis_name: str = "model", causal: bool = True,
                   window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """q, k, v: [B, S, H, D] (kv heads pre-expanded) -> [B, S, H, D].

    ``mesh`` defaults to the active mesh; on a 1-rank ring (or no mesh at
    all) this degenerates to the chunked dense path, so callers can use it
    unconditionally.
    """
    if mesh is None:
        mesh = active_mesh()
    b, s, h, d = q.shape
    sizes = _axis_sizes(mesh) if mesh is not None else {}
    n = sizes.get(axis_name, 1)
    if mesh is None or n <= 1:
        from repro_torch.models.attention import attend_chunked
        return attend_chunked(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)

    pad = (-s) % n
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    s_loc = (s + pad) // n
    scale = d ** -0.5

    # shard batch over whatever data axes the mesh has (when divisible)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = 1
    for a in batch_axes:
        dp *= sizes[a]
    b_spec = None
    if batch_axes and b % dp == 0:
        b_spec = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    spec = (b_spec, axis_name, None, None)

    q_loc, k_cur, v_cur = collectives.shard((q, k, v), mesh, (spec,) * 3)
    idx = collectives.axis_index(mesh, axis_name)
    bl, dev = q_loc.shape[0], q.device
    offs = torch.arange(s_loc, device=dev)
    q_pos = idx * s_loc + offs + q_offset
    acc = torch.zeros((bl, h, s_loc, d), dtype=torch.float32, device=dev)
    m = torch.full((bl, h, s_loc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bl, h, s_loc), dtype=torch.float32, device=dev)
    for step in range(n):
        src = (idx - step) % n            # block index k_cur came from
        k_pos = src * s_loc + offs
        k_pos = torch.where(k_pos < s, k_pos, PAD_SENTINEL + k_pos)
        skip = (causal and _causal_skip_possible(step, n, s_loc, q_offset)
                and idx < step)
        if skip and torch.is_grad_enabled() and k_cur.requires_grad:
            acc = collectives.tie(acc, k_cur, v_cur)
        if not skip:
            sc = torch.einsum("bshd,bthd->bhst", q_loc, k_cur).float() * scale
            sc = sc + mask_bias(q_pos, k_pos, causal, window)[None, None]
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhst,bthd->bhsd", p.to(q_loc.dtype), v_cur).float()
            m = m_new
        if step != n - 1:
            k_cur, v_cur = collectives.ppermute((k_cur, v_cur), mesh,
                                                axis_name, _ring(n))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.transpose(1, 2).to(q_loc.dtype)
    out = collectives.unshard(out, mesh, spec)
    return out[:, :s] if pad else out
