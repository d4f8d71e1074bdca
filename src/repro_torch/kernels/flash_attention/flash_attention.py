"""Wrapper of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``), with the JAX package's signatures.

A CUDA tensor launches the kernels on the current stream; a CPU tensor takes
the plain versions in ``ref.py``.  ``LAUNCHES`` counts launches per C entry
point, one per TPU kernel replaced.  As in the JAX package, the caller pads
Sq to a multiple of ``bq`` and Sk to one of ``bk`` (``ops.py`` does), and
``sk_orig`` masks the padded keys; the kernels tile by their own compiled
tiles, chosen by head dim, so any (bq, bk) the padding allows is served.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, device_guard, launch_stream, on_cuda
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (32, 64, 128, 256)          # compiled into the library
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448      # bytes of shared memory an H100 block may opt in to
LAUNCHES = {"flash_attention": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}

plain = ref.flash_attention
plain_fwd = ref.flash_attention_fwd
plain_bwd = ref.flash_attention_bwd
plain_bwd_dq = ref.flash_attention_bwd_dq
plain_bwd_dkv = ref.flash_attention_bwd_dkv

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# each: the tensors, then b, h, kv, sq, sk, d, sk_orig, causal, window, dtype,
# then the stream
_SIGNATURES = {
    "repro_flash_attention": [_PTR] * 4 + [_INT] * 10 + [_PTR],
    "repro_flash_attention_fwd": [_PTR] * 5 + [_INT] * 10 + [_PTR],
    "repro_flash_attention_bwd_dq": [_PTR] * 7 + [_INT] * 10 + [_PTR],
    "repro_flash_attention_bwd_dkv": [_PTR] * 8 + [_INT] * 10 + [_PTR],
}


# The sweeps' tiles by head dim, as csrc/flash_attention.cu compiles them:
# (warps a block, warps sharing 16 own rows, streamed rows a step), the
# forward's from FwdCfg, the backward's from BwdCfg.  A block owns 16 *
# warps / split rows (queries for the forward and dq, keys for dk/dv).
FWD_TILES = {32: (4, 1, 64), 64: (8, 1, 32), 128: (8, 1, 64),
             256: (16, 2, 16)}
BWD_TILES = {32: {"dq": (4, 1, 64), "dkv": (4, 1, 32)},
             64: {"dq": (8, 1, 32), "dkv": (8, 1, 32)},
             128: {"dq": (8, 1, 32), "dkv": (8, 1, 32)},
             256: {"dq": (8, 2, 16), "dkv": (8, 2, 16)}}


def _tile(warps: int, split: int, stream: int) -> dict:
    return {"warps": warps, "threads": 32 * warps, "split": split,
            "own": 16 * warps // split, "stream": stream}


def fwd_tiles(d: int) -> dict:
    """The compiled tile of the forward at head dim ``d``: warps and
    threads a block, own (query) and streamed (key) rows."""
    return _tile(*FWD_TILES[d])


def bwd_tiles(kernel: str, d: int) -> dict:
    """The compiled tile of backward ``kernel`` ("dq" or "dkv") at head dim
    ``d``: warps and threads a block, own and streamed rows."""
    return _tile(*BWD_TILES[d][kernel])


def smem_bytes(kernel: str, d: int, itemsize: int = 4) -> int:
    """Shared memory a block of ``kernel`` ("fwd", "dq", "dkv") stages at
    head dim ``d`` for operands of ``itemsize`` bytes: its own rows (Q for
    the forward; two own tiles for the backward) and two stages of two
    streamed tiles in the operands' type, rows of d + 16/itemsize elements,
    and for dk/dv two stages of the streamed rows' lse and delta."""
    tile = fwd_tiles(d) if kernel == "fwd" else bwd_tiles(kernel, d)
    own_tiles = 1 if kernel == "fwd" else 2
    tiles = itemsize * (d + 16 // itemsize) * (own_tiles * tile["own"]
                                                + 4 * tile["stream"])
    return tiles + (4 * 2 * 2 * tile["stream"] if kernel == "dkv" else 0)


def _check(q, k, v, bq, bk, sk_orig, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash attention needs q [B,H,Sq,D] and k, v "
                         f"[B,KV,Sk,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"flash attention needs H % KV == 0, got H={h}, "
                         f"KV={kv}")
    if sq % bq or sk % bk:
        raise ValueError(f"flash attention needs Sq % bq == 0 and Sk % bk "
                         f"== 0 (ops.attention pads), got Sq={sq}, bq={bq}, "
                         f"Sk={sk}, bk={bk}")
    if not 0 <= sk_orig <= sk or window < 0:
        raise ValueError(f"flash attention needs 0 <= sk_orig <= Sk and "
                         f"window >= 0, got sk_orig={sk_orig}, Sk={sk}, "
                         f"window={window}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 "
                         f"operands of one type, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention operands must be contiguous")
    if b * h > 65535 or max(sq, sk) > 65535 * 64:
        raise ValueError(f"flash attention shape {tuple(q.shape)} exceeds "
                         "the kernels' grid (B*H <= 65535, Sq and Sk <= "
                         "65535*64)")


def _check_kernel(q):
    """What only the CUDA kernels refuse: an uncompiled head dim, or a
    staged tile set above the shared memory a block can take."""
    d = q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"no flash-attention kernel for head dim {d}; "
                         f"compiled: {HEAD_DIMS}")
    for kernel in ("fwd", "dq", "dkv"):
        need = smem_bytes(kernel, d, q.element_size())
        if need > SMEM_LIMIT:
            raise ValueError(f"flash-attention {kernel} tiles at head dim "
                             f"{d} stage {need} bytes of shared memory, "
                             f"above the card's {SMEM_LIMIT}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its storage does not start on 16 bytes:
    the kernels copy rows by 16-byte cp.async."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_bwd(q, do, lse, delta):
    b, h, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError(f"flash attention backward needs do like q "
                         f"{tuple(q.shape)} {q.dtype}, contiguous; got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"flash attention backward needs {name} fp32 "
                             f"[{b},{h},{sq}], contiguous; got "
                             f"{tuple(t.shape)} {t.dtype}")


def _dims(q, k, sk_orig, causal, window):
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    return (b, h, kv, sq, sk, d, sk_orig or sk, int(bool(causal)),
            int(window), DTYPES[q.dtype])


def _launch(entry: str, q, tensors, dims) -> None:
    lib = build.load("flash_attention", _SIGNATURES)
    with device_guard(q):
        code = getattr(lib, entry)(*(t.data_ptr() for t in tensors), *dims,
                                   launch_stream(q))
    build.check(lib, code, f"{entry} kernel launch")
    LAUNCHES[entry.removeprefix("repro_")] += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 256,
                    bk: int = 256, sk_orig: int = 0) -> torch.Tensor:
    """q: [B,H,Sq,D]; k, v: [B,KV,Sk,D] with H % KV == 0, Sq % bq == 0 and
    Sk % bk == 0 -> out [B,H,Sq,D] in q's type."""
    _check(q, k, v, bq, bk, sk_orig, window)
    if not on_cuda(q, k, v):
        return plain(q, k, v, causal=causal, window=window, sk_orig=sk_orig)
    _check_kernel(q)
    out = torch.empty_like(q)
    _launch("repro_flash_attention", q, (*map(_aligned, (q, k, v)), out),
            _dims(q, k, sk_orig, causal, window))
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, bq: int = 256,
                        bk: int = 256, sk_orig: int = 0) -> tuple:
    """(out [B,H,Sq,D], lse fp32 [B,H,Sq]) — the forward with residuals."""
    _check(q, k, v, bq, bk, sk_orig, window)
    if not on_cuda(q, k, v):
        return plain_fwd(q, k, v, causal=causal, window=window,
                         sk_orig=sk_orig)
    _check_kernel(q)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("repro_flash_attention_fwd", q,
            (*map(_aligned, (q, k, v)), out, lse),
            _dims(q, k, sk_orig, causal, window))
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True, window=0,
                           bq=256, bk=256, sk_orig=0) -> torch.Tensor:
    """dq [B,H,Sq,D] in q's type (``_fa_bwd_dq_kernel``)."""
    _check(q, k, v, bq, bk, sk_orig, window)
    _check_bwd(q, do, lse, delta)
    if not on_cuda(q, k, v, do, lse, delta):
        return plain_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                            window=window, sk_orig=sk_orig)
    _check_kernel(q)
    dq = torch.empty_like(q)
    _launch("repro_flash_attention_bwd_dq", q,
            (*map(_aligned, (q, k, v, do)), lse, delta, dq),
            _dims(q, k, sk_orig, causal, window))
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            window=0, bq=256, bk=256, sk_orig=0) -> tuple:
    """(dk, dv) per q head [B,H,Sk,D] in q's type
    (``_fa_bwd_dkv_kernel``)."""
    _check(q, k, v, bq, bk, sk_orig, window)
    _check_bwd(q, do, lse, delta)
    if not on_cuda(q, k, v, do, lse, delta):
        return plain_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                             window=window, sk_orig=sk_orig)
    _check_kernel(q)
    b, h, _, d = q.shape
    dk = torch.empty((b, h, k.shape[2], d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch("repro_flash_attention_bwd_dkv", q,
            (*map(_aligned, (q, k, v, do)), lse, delta, dk, dv),
            _dims(q, k, sk_orig, causal, window))
    return dk, dv


def flash_attention_bwd(q, k, v, do, lse, delta, *, causal=True, window=0,
                        bq=256, bk=256, sk_orig=0) -> tuple:
    """(dq [B,H,Sq,D], dk, dv per q head [B,H,Sk,D]) — the caller group-sums
    dk/dv over GQA groups."""
    kw = {"causal": causal, "window": window, "bq": bq, "bk": bk,
          "sk_orig": sk_orig}
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
