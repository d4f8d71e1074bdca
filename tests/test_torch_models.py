"""repro_torch models/dist: the port's ``attend_full``/``attend_chunked`` and
``mask_bias`` against the JAX package's ``repro.models.attention`` and
``repro.dist.masking`` on the same numpy-drawn inputs, at 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import masking as jmasking
from repro.models import attention as jattn
from repro_torch.dist import masking
from repro_torch.models import attention as attn


def _qkv(seed, b, sq, sk, h, d, scale=0.5):
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(b, sq, h, d) * scale).astype(np.float32),
          (rng.randn(b, sk, h, d) * scale).astype(np.float32),
          rng.randn(b, sk, h, d).astype(np.float32)]
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (False, 0, 0),
                                                    (True, 7, 0),
                                                    (True, 0, 24),
                                                    (False, 5, 9)])
def test_mask_bias_matches_jax(causal, window, q_offset):
    sentinel = masking.PAD_SENTINEL
    assert (masking.NEG_INF, sentinel) == (jmasking.NEG_INF,
                                           jmasking.PAD_SENTINEL)
    k_pos = np.arange(40)
    k_pos = np.where(k_pos < 33, k_pos, sentinel + k_pos)
    q_pos = np.arange(20) + q_offset
    want = np.asarray(jmasking.mask_bias(jnp.asarray(q_pos),
                                         jnp.asarray(k_pos), causal, window))
    got = masking.mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                            causal, window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (False, 0, 0),
                                                    (True, 6, 0),
                                                    (True, 0, 16)])
def test_attend_full_matches_jax(causal, window, q_offset):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 24, 40, 3, 8)
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    want = np.asarray(jattn.attend_full(jq, jk, jv, **kw))
    got = attn.attend_full(tq, tk, tv, **kw)
    assert tuple(got.shape) == (2, 24, 3, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "sq,sk,q_chunk,k_chunk,causal,window,q_offset",
    [(64, 64, 32, 64, True, 0, 0),        # sk <= k_chunk: the full path
     (50, 70, 64, 32, True, 0, 0),        # padded keys, one q block
     (70, 70, 32, 32, True, 0, 0),        # padded q blocks and keys
     (96, 96, 32, 32, False, 0, 0),       # non-causal, no padding
     (70, 90, 32, 16, True, 12, 0),       # sliding window
     (40, 72, 16, 32, True, 0, 32),       # a decode-style q offset
     (33, 65, 16, 16, False, 9, 5)])      # window without causality
def test_attend_chunked_matches_jax(sq, sk, q_chunk, k_chunk, causal, window,
                                    q_offset):
    (jq, jk, jv), (tq, tk, tv) = _qkv(sq + sk, 2, sq, sk, 2, 16)
    kw = {"causal": causal, "window": window, "q_chunk": q_chunk,
          "k_chunk": k_chunk, "q_offset": q_offset}
    want = np.asarray(jattn.attend_chunked(jq, jk, jv, **kw))
    got = attn.attend_chunked(tq, tk, tv, **kw)
    assert tuple(got.shape) == (2, sq, 2, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the chunked path and the full reference compute the same function
    full = attn.attend_full(tq, tk, tv, causal=causal, window=window,
                            q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_attend_paths_keep_q_dtype_in_bf16():
    """Scores in q's type, then fp32; probabilities cast back to q's type:
    bf16 in, bf16 out, within bf16 rounding of the JAX paths."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, 1, 48, 48, 2, 16)
    jq, jk, jv = (x.astype(jnp.bfloat16) for x in (jq, jk, jv))
    tq, tk, tv = (x.bfloat16() for x in (tq, tk, tv))
    for fn, jfn, kw in ((attn.attend_full, jattn.attend_full, {}),
                        (attn.attend_chunked, jattn.attend_chunked,
                         {"q_chunk": 16, "k_chunk": 16})):
        got = fn(tq, tk, tv, causal=True, **kw)
        assert got.dtype == torch.bfloat16
        want = np.float32(jfn(jq, jk, jv, causal=True, **kw))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                                   atol=3e-2)
