"""The port's flash-attention op at Sq != Sk (cross-attention) and at a
causal Sq below Sk, against the JAX package's Pallas op in interpret mode.

Whisper's decoder cross-attends over 1500 encoder frames, so the kernels
see separate query and key lengths, each padded to its own tile multiple,
with ``sk_orig`` masking the padded keys.  On the CPU the port's wrappers
take their plain versions; the ``cuda`` twin holds the hand kernels against
those plain versions on the card at the shapes ``chip_smoke.py``'s
``FA_EDGES`` gives whisper-medium.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

TOL = 1e-4        # test_flash_attention_op_matches_pallas's fp32 tolerance
# (Sq, Sk, causal): cross-attention both ways round, and a causal Sq < Sk
SEQS = [(40, 150, False), (150, 40, False), (64, 100, True)]
HEADS = [(4, 2), (4, 4)]
HEAD_DIMS = [32, 64]


def _draw(rng, h, kv, sq, sk, d, b=2):
    """q, k scaled by 0.5 and v standard normal, as the JAX tests draw
    them; the same float32 values in both packages."""
    xs = [(rng.randn(b, h, sq, d) * 0.5).astype(np.float32),
          (rng.randn(b, kv, sk, d) * 0.5).astype(np.float32),
          rng.randn(b, kv, sk, d).astype(np.float32)]
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


def _grad_close(got: torch.Tensor, want, tol=TOL):
    """Within tol of the largest magnitude above 1 (absolute below)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h,kv", HEADS)
@pytest.mark.parametrize("sq,sk,causal", SEQS)
def test_flash_attention_cross_matches_pallas(sq, sk, causal, h, kv, d):
    """fp32, bq = bk = 32: the op without gradients (the no-lse kernel's
    plain version) and with them (the lse forward's) against the Pallas op
    at 1e-4, and dq, dk, dv of sum(sin(o)) against jax.grad through it."""
    rng = np.random.RandomState(sq * 7 + sk * 3 + h * 11 + kv + d + causal)
    (jq, jk, jv), (tq, tk, tv) = _draw(rng, h, kv, sq, sk, d)
    kw = {"causal": causal, "window": 0, "bq": 32, "bk": 32}

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jfa_ops.attention(q, k, v, **kw)))

    want = np.asarray(jfa_ops.attention(jq, jk, jv, **kw))
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)

    out = fa_ops.attention(tq, tk, tv, **kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, h, sq, d)
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa_ops.attention(*leaves, **kw)
    assert out.requires_grad
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    torch.sin(out).sum().backward()
    for leaf, w in zip(leaves, want_grads):
        assert leaf.grad.shape == leaf.shape
        _grad_close(leaf.grad, w)


# (B, H, KV, Sq, Sk, D, causal, sk_orig): whisper-medium's cross-attention
# (2048 decoder tokens over 1500 frames padded to 1536) and its encoder's
# ragged non-causal self-attention, as chip_smoke.py's FA_EDGES rows
CARD_CASES = [(1, 16, 16, 2048, 1536, 64, False, 1500),
              (1, 16, 16, 1536, 1536, 64, False, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_cross_kernels_match_plain(dtype):
    """On a card: the four kernels at whisper-medium's Sq != Sk and ragged
    encoder shapes against their plain versions (fp32 1e-4, bf16 3e-2,
    gradients relative to their largest magnitude above 1), each launched
    twice and held equal bit for bit; then the op's forward and gradients
    at the cross shape against autograd through the plain oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = 1e-4 if dtype == "float32" else 3e-2
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = dict(fa_kernel.LAUNCHES)
    for b, h, kv, sq, sk, d, causal, sk_orig in CARD_CASES:
        q, do = (torch.randn(b, h, sq, d, generator=gen, device="cuda")
                 .mul(0.5).to(td) for _ in range(2))
        k, v = (torch.randn(b, kv, sk, d, generator=gen, device="cuda")
                .mul(0.5).to(td) for _ in range(2))
        for t in (k, v):            # zero padding, as ops.attention pads
            t[:, :, sk_orig:] = 0
        if sq == sk:
            for t in (q, do):
                t[:, :, sk_orig:] = 0
        pkw = {"causal": causal, "window": 0, "sk_orig": sk_orig}
        kw = dict(pkw, bq=256, bk=256)
        want_o, want_lse = fa_kernel.plain_fwd(q, k, v, **pkw)
        out = fa_kernel.flash_attention(q, k, v, **kw)
        o, lse = fa_kernel.flash_attention_fwd(q, k, v, **kw)
        assert torch.equal(fa_kernel.flash_attention(q, k, v, **kw), out)
        o2, lse2 = fa_kernel.flash_attention_fwd(q, k, v, **kw)
        assert torch.equal(o2, o) and torch.equal(lse2, lse)
        torch.cuda.synchronize()
        for got in (out, o):
            torch.testing.assert_close(got.float(), want_o.float(), rtol=tol,
                                       atol=tol)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
        delta = (do.float() * want_o.float()).sum(-1)
        grads = fa_kernel.flash_attention_bwd(q, k, v, do, want_lse, delta,
                                              **kw)
        again = fa_kernel.flash_attention_bwd(q, k, v, do, want_lse, delta,
                                              **kw)
        wants = fa_kernel.plain_bwd(q, k, v, do, want_lse, delta, **pkw)
        torch.cuda.synchronize()
        for got, repeat, want in zip(grads, again, wants):
            assert torch.equal(got, repeat)
            scale = max(1.0, want.float().abs().max().item())
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol * scale)
    n = len(CARD_CASES)
    assert {e: fa_kernel.LAUNCHES[e] - before[e] for e in before} == \
        {"flash_attention": 2 * n, "flash_attention_fwd": 2 * n,
         "flash_attention_bwd_dq": 2 * n, "flash_attention_bwd_dkv": 2 * n}
    # the differentiable op at the cross shape, the padding its own
    b, h, kv, sq, sk, d, causal, sk_orig = CARD_CASES[0]
    q = torch.randn(b, h, sq, d, generator=gen, device="cuda").mul(0.5)
    k, v = (torch.randn(b, kv, sk_orig, d, generator=gen, device="cuda")
            .mul(0.5) for _ in range(2))
    leaves = [t.to(td).requires_grad_() for t in (q, k, v)]
    plain = [t.to(td).requires_grad_() for t in (q, k, v)]
    out = fa_ops.attention(*leaves, causal=causal)
    want = fa_ops.attention(*plain, causal=causal, use_kernel=False)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.sin(out.float()).sum().backward()
    torch.sin(want.float()).sum().backward()
    for got, ref in zip(leaves, plain):
        scale = max(1.0, ref.grad.float().abs().max().item())
        torch.testing.assert_close(got.grad.float(), ref.grad.float(),
                                   rtol=tol, atol=tol * scale)
