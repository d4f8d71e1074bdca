"""Plain PyTorch versions of the flash-attention kernels.

``attention`` is the naive GQA oracle (the counterpart of the JAX package's
``kernels/flash_attention/ref.py``), differentiable by autograd.  The other
functions are the plain versions of the CUDA kernels in
``csrc/flash_attention.cu``, with the kernels' signatures: whole-matrix
torch arithmetic (no tiles, no autograd) over the padded operands, with the
same masks — causal, sliding window, and keys at or past ``sk_orig``
invisible — and the same finite ``NEG_INF``, so that a row that sees no key
averages every key's value as the Pallas kernels' online softmax makes it.
All math is fp32; outputs are cast to q's type once, lse and delta stay fp32.
"""
import torch

NEG_INF = -1e30


def visible(sq: int, sk: int, *, causal: bool, window: int, sk_orig: int,
            device) -> torch.Tensor:
    """[sq, sk] bool: query i sees key j."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    ok = kp < (sk_orig or sk)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (qp - kp < window)
    return ok


def _expand(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B,KV,S,D] -> [B,H,S,D] in fp32, each KV head repeated H/KV times."""
    return x.float().repeat_interleave(h // x.shape[1], dim=1)


def attention(q, k, v, *, causal=True, window=0):
    """q: [B,H,Sq,D]; k, v: [B,KV,Sk,D] -> [B,H,Sq,D] in q's type."""
    b, h, sq, d = q.shape
    k, v = _expand(k, h), _expand(v, h)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * (d ** -0.5)
    ok = visible(sq, k.shape[2], causal=causal, window=window, sk_orig=0,
                 device=q.device)
    s = torch.where(ok[None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def _scores(q, k, causal, window, sk_orig):
    """fp32 scaled scores [B,H,Sq,Sk] and the visibility mask."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), _expand(k, q.shape[1]).transpose(-1, -2)) \
        * (d ** -0.5)
    ok = visible(q.shape[2], k.shape[2], causal=causal, window=window,
                 sk_orig=sk_orig, device=q.device)
    return s, ok


def flash_attention_fwd(q, k, v, *, causal=True, window=0, sk_orig=0):
    """(out [B,H,Sq,D] in q's type, lse fp32 [B,H,Sq]) — ``_fa_fwd_kernel``."""
    s, ok = _scores(q, k, causal, window, sk_orig)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.matmul(p, _expand(v, q.shape[1])) / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def flash_attention(q, k, v, *, causal=True, window=0, sk_orig=0):
    """out [B,H,Sq,D] in q's type — ``_fa_kernel``."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               sk_orig=sk_orig)[0]


def _probs(q, k, v, do, lse, delta, causal, window, sk_orig):
    """p = where(visible, exp(s - lse), 0) and ds = p·(dp - delta), fp32."""
    s, ok = _scores(q, k, causal, window, sk_orig)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.float(), _expand(v, q.shape[1]).transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           window=0, sk_orig=0):
    """dq [B,H,Sq,D] in q's type — ``_fa_bwd_dq_kernel``."""
    _, ds = _probs(q, k, v, do, lse, delta, causal, window, sk_orig)
    dq = torch.matmul(ds, _expand(k, q.shape[1])) * (q.shape[-1] ** -0.5)
    return dq.to(q.dtype)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            window=0, sk_orig=0):
    """(dk, dv) per q head [B,H,Sk,D] in q's type — ``_fa_bwd_dkv_kernel``."""
    p, ds = _probs(q, k, v, do, lse, delta, causal, window, sk_orig)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * (q.shape[-1] ** -0.5)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd(q, k, v, do, lse, delta, *, causal=True, window=0,
                        sk_orig=0):
    """(dq, dk, dv), dk and dv per q head — ``flash_attention_bwd``."""
    kw = {"causal": causal, "window": window, "sk_orig": sk_orig}
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
