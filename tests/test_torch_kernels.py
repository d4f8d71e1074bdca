"""repro_torch kernels: the port's matmul/matvec and flash-attention ops
against the JAX package's Pallas kernels (interpret mode) and its ref
oracles, and its conv2d/maxpool/blur ops against the JAX ref oracles and
jnp paths (the Pallas conv2d, maxpool and blur kernels need ``pl.load``,
which jax 0.9.0 lacks; the blur kernels' arithmetic is also held to a jnp
restatement of the Pallas bodies), on the same numpy-drawn inputs; the
backend rule; the build's failure modes; and, on a card, the CUDA kernels
against their plain versions."""
import ctypes
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.blur import ops as jbl_ops, ref as jbl_ref
from repro.kernels.conv2d import ops as jmc_ops, ref as jmc_ref
from repro.kernels.flash_attention import flash_attention as jfa_kernel
from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref
from repro.kernels.matmul import ops as jmm_ops, ref as jmm_ref
from repro.kernels.matvec import ops as jmv_ops, ref as jmv_ref
from repro.kernels.maxpool import ops as jmp_ops, ref as jmp_ref
from repro_torch.kernels import Aval, build, cuda_index, cudnn_fp32, \
    on_cuda, resolve_device
from repro_torch.kernels.blur import blur as bl_kernel
from repro_torch.kernels.blur import ops as bl_ops, ref as bl_ref
from repro_torch.kernels.conv2d import conv2d as mc_kernel, ops as mc_ops
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.matmul import matmul as mm_kernel, ops as mm_ops
from repro_torch.kernels.matvec import matvec as mv_kernel, ops as mv_ops
from repro_torch.kernels.maxpool import maxpool as mp_kernel, ops as mp_ops

# dtype name -> (jax dtype, torch dtype, tolerance of tests/test_kernels.py)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dtype):
    """The same values in both packages: drawn as float32, then cast."""
    x = rng.randn(*shape).astype(np.float32)
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(out: torch.Tensor, want, tol):
    np.testing.assert_allclose(out.float().numpy(), np.float32(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (100, 70, 130),
                                   (33, 257, 65), (1, 1, 1), (128, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas_and_ref(m, n, k, dtype):
    rng = np.random.RandomState(m * 7 + n * 3 + k)
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (k, n), dtype)
    tol = DTYPES[dtype][2]
    out = mm_ops.matmul(ta, tb, bm=32, bn=32, bk=32)
    assert out.dtype == DTYPES[dtype][1] and tuple(out.shape) == (m, n)
    _close(out, jmm_ops.matmul(ja, jb, bm=32, bn=32, bk=32), tol)
    _close(out, jmm_ref.matmul(ja, jb), tol)
    # the 128 schedule and the library path compute the same function
    _close(mm_ops.matmul(ta, tb, bm=128, bn=128, bk=32), jmm_ref.matmul(ja, jb),
           tol)
    _close(mm_ops.matmul(ta, tb, use_kernel=False), jmm_ref.matmul(ja, jb),
           tol)


@pytest.mark.parametrize("m,k", [(64, 64), (100, 70), (257, 513), (1, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matvec_matches_pallas_and_ref(m, k, dtype):
    rng = np.random.RandomState(m * 7 + k)
    ja, ta = _pair(rng, (m, k), dtype)
    jx, tx = _pair(rng, (k,), dtype)
    tol = DTYPES[dtype][2]
    out = mv_ops.matvec(ta, tx)
    assert out.dtype == DTYPES[dtype][1] and tuple(out.shape) == (m,)
    _close(out, jmv_ops.matvec(ja, jx, bm=32, bk=32), tol)
    _close(out, jmv_ref.matvec(ja, jx), tol)
    _close(mv_ops.matvec(ta, tx, use_kernel=False), jmv_ref.matvec(ja, jx),
           tol)


def test_matvec_casts_x_to_a_dtype():
    rng = np.random.RandomState(0)
    ja, ta = _pair(rng, (40, 24), "bfloat16")
    x = rng.randn(24).astype(np.float32)
    out = mv_ops.matvec(ta, torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    _close(out, jmv_ops.matvec(ja, jnp.asarray(x), bm=32, bk=32), 2e-2)


# conv2d tolerances of tests/test_kernels.py: a bf16 result rounds to 8
# bits after up to 49 accumulated products
CONV_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 5e-1)}


@pytest.mark.parametrize("m,n,r", [(64, 64, 3), (100, 90, 5), (41, 77, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_matches_ref_and_jnp_path(m, n, r, dtype):
    rng = np.random.RandomState(m * 7 + n * 3 + r)
    ja, ta = _pair(rng, (m, n), dtype)
    jw, tw = _pair(rng, (r, r), dtype)
    rtol, atol = CONV_TOL[dtype]
    want = np.float32(jmc_ref.conv2d(ja, jw))
    np.testing.assert_allclose(np.float32(jmc_ops.conv2d(ja, jw,
                                                         use_kernel=False)),
                               want)
    for kw in ({"bm": 16, "bn": 16}, {"bm": 32, "bn": 32},
               {"use_kernel": False}):
        out = mc_ops.conv2d(ta, tw, **kw)
        assert out.dtype == DTYPES[dtype][1]
        assert tuple(out.shape) == (m - r + 1, n - r + 1)
        np.testing.assert_allclose(out.float().numpy(), want, rtol=rtol,
                                   atol=atol)
    # the plain version repeats the JAX oracle's arithmetic in fp32
    if dtype == "float32":
        np.testing.assert_allclose(mc_kernel.plain(ta, tw).numpy(), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,n,r,s", [(64, 64, 2, 2), (100, 90, 3, 2),
                                     (65, 43, 5, 1), (32, 32, 4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_equals_ref_exactly(m, n, r, s, dtype):
    """max only selects, so every path equals the JAX oracle bit for bit."""
    rng = np.random.RandomState(m * 7 + n * 3 + r + s)
    ja, ta = _pair(rng, (m, n), dtype)
    want = np.float32(jmp_ref.maxpool(ja, r=r, s=s))
    np.testing.assert_array_equal(
        np.float32(jmp_ops.maxpool(ja, r=r, s=s, use_kernel=False)), want)
    for kw in ({"bm": 8, "bn": 8}, {"bm": 32, "bn": 32},
               {"use_kernel": False}):
        out = mp_ops.maxpool(ta, r=r, s=s, **kw)
        assert out.dtype == DTYPES[dtype][1]
        assert tuple(out.shape) == ((m - r) // s + 1, (n - r) // s + 1)
        np.testing.assert_array_equal(out.float().numpy(), want)


def test_maxpool_propagates_nan_like_jnp():
    rng = np.random.RandomState(3)
    x = rng.randn(20, 17).astype(np.float32)
    x[5, 6] = np.nan
    want = np.asarray(jmp_ref.maxpool(jnp.asarray(x), r=3, s=2))
    assert np.isnan(want).any()
    for kw in ({}, {"use_kernel": False}):
        np.testing.assert_array_equal(
            mp_ops.maxpool(torch.from_numpy(x), r=3, s=2, **kw).numpy(), want)


@pytest.mark.parametrize("m,n", [(66, 66), (128, 100), (51, 200)])
@pytest.mark.parametrize("schedule", list(jbl_ops.HOST_SCHEDULES))
def test_blur_schedules_match_jax_schedules(m, n, schedule):
    rng = np.random.RandomState(m + n)
    ja, ta = _pair(rng, (m, n), "float32")
    out = bl_ops.HOST_SCHEDULES[schedule](ta)
    assert tuple(out.shape) == (m - 2, n - 2) and out.dtype == torch.float32
    for want in (jbl_ops.HOST_SCHEDULES[schedule](ja), jbl_ref.blur(ja)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert bl_ops.SCHEDULE_FEATURES[schedule] == \
        jbl_ops.SCHEDULE_FEATURES[schedule]


def test_blur_op_and_its_unported_kernel():
    """The op's two paths: ``use_kernel=False`` is the plain blur, as in
    JAX; the default runs the hand kernels, whose plain version a CPU
    tensor takes (the kernel is ported now; the registry's variants stay
    the host schedules)."""
    rng = np.random.RandomState(1)
    ja, ta = _pair(rng, (40, 30), "float32")
    np.testing.assert_allclose(bl_ops.blur(ta, use_kernel=False).numpy(),
                               np.asarray(jbl_ops.blur(ja, use_kernel=False)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(bl_ref.blur(ta).numpy(),
                                  bl_ops.blur(ta, use_kernel=False).numpy())
    for separable in (False, True):
        assert torch.equal(bl_ops.blur(ta, separable=separable),
                           bl_kernel.plain(ta, separable=separable))
    assert list(bl_ops.HOST_SCHEDULES) == list(jbl_ops.HOST_SCHEDULES)


@pytest.mark.parametrize("m,n", [(66, 66), (128, 100), (51, 200)])
@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("tile", [16, 128])
def test_blur_kernel_path_matches_jax_ref(m, n, separable, tile):
    """``ops.blur(use_kernel=True)`` on CPU tensors (the kernels' plain
    version) against the JAX oracle and the JAX op's plain path at
    ``tests/test_kernels.py``'s 1e-5, at the JAX blur tests' shapes."""
    rng = np.random.RandomState(m * 3 + n)
    ja, ta = _pair(rng, (m, n), "float32")
    out = bl_ops.blur(ta, bm=tile, bn=tile, separable=separable)
    assert tuple(out.shape) == (m - 2, n - 2) and out.dtype == torch.float32
    for want in (jbl_ref.blur(ja), jbl_ops.blur(ja, use_kernel=False)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def _pallas_blur_bodies(a, separable):
    """The Pallas blur bodies (src/repro/kernels/blur/blur.py:21-48) over
    the whole valid region in jnp: direct from a zero fp32 accumulator,
    times 1/9; separable as the h body stored in a's type (the Pallas
    out_shape), then the v body."""
    m, n = a.shape
    om, on = m - 2, n - 2
    if not separable:
        tile = a.astype(jnp.float32)
        acc = jnp.zeros((om, on), jnp.float32)
        for di in range(3):
            for dj in range(3):
                acc += tile[di:di + om, dj:dj + on]
        return (acc * (1.0 / 9.0)).astype(a.dtype)
    tile = a.astype(jnp.float32)
    h = ((tile[:, 0:on] + tile[:, 1:on + 1] + tile[:, 2:on + 2])
         * (1.0 / 3.0)).astype(a.dtype)
    tile = h.astype(jnp.float32)
    return ((tile[0:om] + tile[1:om + 1] + tile[2:om + 2])
            * (1.0 / 3.0)).astype(a.dtype)


@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blur_kernel_arithmetic_is_the_pallas_bodies(separable, dtype):
    """The kernels' plain version equals the Pallas bodies bit for bit,
    bf16 included: the separable path rounds h to bf16 between the passes
    as the Pallas kernel stores it, which is seen to matter because the
    unrounded sum differs."""
    rng = np.random.RandomState(7)
    ja, ta = _pair(rng, (51, 200), dtype)
    got = bl_kernel.plain(ta, separable=separable).float().numpy()
    want = np.asarray(_pallas_blur_bodies(ja, separable), np.float32)
    np.testing.assert_array_equal(got, want)
    if separable and dtype == "bfloat16":
        t = ta.float()
        h = (t[:, :-2] + t[:, 1:-1] + t[:, 2:]) * torch.tensor(1.0 / 3.0)
        unrounded = ((h[:-2] + h[1:-1] + h[2:]) * torch.tensor(1.0 / 3.0))
        assert not np.array_equal(unrounded.bfloat16().float().numpy(),
                                  want)


# --------------------------------------------------------------------------
# flash attention: the port's op and wrappers against the JAX Pallas kernels
# in interpret mode (each call about 0.5-1.7 s here), on the JAX tests' grid
# --------------------------------------------------------------------------

FA_MASKS = [(True, 0), (False, 0), (True, 16)]
FA_HEADS = [(8, 2), (4, 4), (6, 1)]


def _fa_draw(rng, h, kv, dtype, scale, sq=100, b=2, d=32):
    """q, k scaled as the JAX tests draw them, v standard normal; the same
    values in both packages."""
    xs = [rng.randn(b, h, sq, d) * scale, rng.randn(b, kv, sq, d) * scale,
          rng.randn(b, kv, sq, d)]
    jd, td, _ = DTYPES[dtype]
    xs = [x.astype(np.float32) for x in xs]
    return ([jnp.asarray(x, jd) for x in xs],
            [torch.from_numpy(x).to(td) for x in xs])


@pytest.mark.parametrize("h,kv", FA_HEADS)
@pytest.mark.parametrize("causal,window", FA_MASKS)
def test_flash_attention_op_matches_pallas(h, kv, causal, window):
    """fp32: the op without gradients (the no-lse kernel) and with them (the
    lse kernel of the autograd forward) against the Pallas op at 1e-4."""
    rng = np.random.RandomState(h * 10 + kv + 100 * causal + window)
    (jq, jk, jv), (tq, tk, tv) = _fa_draw(rng, h, kv, "float32", 0.5)
    kw = {"causal": causal, "window": window, "bq": 32, "bk": 32}
    want = np.asarray(jfa_ops.attention(jq, jk, jv, **kw))
    out = fa_ops.attention(tq, tk, tv, **kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, h, 100, 32)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)
    grad_in = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa_ops.attention(*grad_in, **kw)
    assert out.requires_grad
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    # the plain oracle path is the JAX oracle's arithmetic
    np.testing.assert_allclose(
        fa_ops.attention(tq, tk, tv, causal=causal, window=window,
                         use_kernel=False).numpy(),
        np.asarray(jfa_ref.attention(jq, jk, jv, causal=causal,
                                     window=window)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,kv,causal,window", [(8, 2, True, 0),
                                                (4, 4, False, 0),
                                                (6, 1, True, 16)])
def test_flash_attention_op_bf16_matches_pallas(h, kv, causal, window):
    rng = np.random.RandomState(h * 10 + kv + window)
    (jq, jk, jv), (tq, tk, tv) = _fa_draw(rng, h, kv, "bfloat16", 0.5)
    kw = {"causal": causal, "window": window, "bq": 32, "bk": 32}
    want = np.float32(jfa_ops.attention(jq, jk, jv, **kw))
    out = fa_ops.attention(tq, tk, tv, **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


def _grad_close(got: torch.Tensor, want, tol=1e-4):
    """Within tol of the largest magnitude above 1 (absolute below)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("h,kv,causal,window", [(8, 2, True, 0),
                                                (4, 4, False, 0),
                                                (6, 1, True, 16)])
def test_flash_attention_grads_match_jax(h, kv, causal, window):
    """The autograd backward (the dq and dk/dv sweeps, delta and the GQA
    group sum in torch) against jax.grad through the Pallas op, and against
    autograd through the plain oracle, on the JAX backward tests' draws."""
    rng = np.random.RandomState(7 * h + kv + window)
    (jq, jk, jv), (tq, tk, tv) = _fa_draw(rng, h, kv, "float32", 0.4)
    kw = {"causal": causal, "window": window, "bq": 32, "bk": 32}

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jfa_ops.attention(q, k, v, **kw)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    torch.sin(fa_ops.attention(*leaves, **kw)).sum().backward()
    plain = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    torch.sin(fa_ops.attention(*plain, causal=causal, window=window,
                               use_kernel=False)).sum().backward()
    for leaf, ref_leaf, w in zip(leaves, plain, want):
        assert leaf.grad.shape == leaf.shape
        _grad_close(leaf.grad, w)
        _grad_close(ref_leaf.grad, w)


@pytest.mark.parametrize("h,kv,causal,window", [(6, 2, True, 16),
                                                (4, 4, False, 24)])
def test_flash_attention_wrappers_match_pallas_kernels(h, kv, causal, window):
    """The three wrapper functions against the JAX kernel functions at a
    ragged Sq (100 padded to 128) with ``sk_orig`` masking the padded keys;
    the padded query rows see no key under the window, so they average
    every key's value, in both packages, and must stay finite."""
    rng = np.random.RandomState(h + kv + window)
    (jq, jk, jv), (tq, tk, tv) = _fa_draw(rng, h, kv, "float32", 0.5)
    jpad = [jnp.pad(x, ((0, 0), (0, 0), (0, 28), (0, 0))) for x in
            (jq, jk, jv)]
    tpad = [torch.nn.functional.pad(x, (0, 0, 0, 28)) for x in (tq, tk, tv)]
    kw = {"causal": causal, "window": window, "bq": 32, "bk": 32,
          "sk_orig": 100}
    want_o = np.asarray(jfa_kernel.flash_attention(*jpad, **kw))
    out = fa_kernel.flash_attention(*tpad, **kw)
    np.testing.assert_allclose(out.numpy(), want_o, rtol=1e-4, atol=1e-4)
    jo, jlse = jfa_kernel.flash_attention_fwd(*jpad, **kw)
    out, lse = fa_kernel.flash_attention_fwd(*tpad, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-4,
                               atol=1e-4)
    assert lse.dtype == torch.float32 and torch.isfinite(out).all()
    # the rows past the last key's window are blind: m stays NEG_INF
    assert (lse[:, :, 99 + window:] == -1e30).all()
    assert (lse[:, :, :99 + window] > -1e29).all()
    do = rng.randn(*tpad[0].shape).astype(np.float32)
    do[:, :, 100:] = 0.0
    delta = (do * np.asarray(jo)).sum(-1)
    jgrads = jfa_kernel.flash_attention_bwd(*jpad, jnp.asarray(do), jlse,
                                            jnp.asarray(delta), **kw)
    grads = fa_kernel.flash_attention_bwd(*tpad, torch.from_numpy(do), lse,
                                          torch.from_numpy(delta), **kw)
    assert tuple(grads[1].shape) == (2, h, 128, 32)        # per q head
    for got, want in zip(grads, jgrads):
        _grad_close(got, want)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 as ``cvt.rna.tf32.f32`` rounds: to the nearest
    of 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rounding_is_to_nearest_ties_away():
    """The integer add-and-mask rounding that the backward kernels (and
    ``_tf32`` here) use gives ``cvt.rna.tf32.f32``'s result: the nearest
    value with 10 mantissa bits, ties away from zero, for normal and
    subnormal x, ties and both signs included."""
    rng = np.random.RandomState(5)
    x = np.concatenate([
        rng.randn(4000) * 10.0 ** rng.uniform(-30, 30, 4000),
        rng.randn(200) * 1e-40,                         # subnormal
        np.float32([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                    0.0, -0.0])]).astype(np.float32)    # ties
    got = _tf32(torch.from_numpy(x)).numpy().astype(np.float64)
    xd = x.astype(np.float64)
    tiny = np.float64(2.0 ** -126)
    exp = np.floor(np.log2(np.maximum(np.abs(xd), tiny)))
    ulp = 2.0 ** (np.maximum(exp, -126) - 10)
    scaled = np.abs(xd) / ulp
    want = np.sign(xd) * np.floor(scaled + 0.5) * ulp
    np.testing.assert_array_equal(got, want)
    assert got[-5] == 1 + 2 ** -10 and got[-4] == 1 + 2 ** -9
    assert got[-3] == -(1 + 2 ** -10)


def _mm_tf32(a, b, terms):
    """a @ b from tf32 products on fp32 sums: the 3xTF32 split (lo·hi +
    hi·lo + hi·hi) the backward kernels run, or one hi·hi product."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _bwd_tf32(q, k, v, do, lse, delta, causal, window, sk_orig, terms):
    """The five backward products (S, dP, dQ, dK, dV) on emulated tf32."""
    h, d = q.shape[1], q.shape[-1]
    k, v = fa_ref._expand(k, h), fa_ref._expand(v, h)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    s = _mm_tf32(q, k.transpose(-1, -2), terms) * scale
    ok = fa_ref.visible(q.shape[2], k.shape[2], causal=causal, window=window,
                        sk_orig=sk_orig, device=q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (_mm_tf32(do, v.transpose(-1, -2), terms) - delta[..., None])
    return (_mm_tf32(ds, k, terms) * scale,
            _mm_tf32(ds.transpose(-1, -2), q, terms) * scale,
            _mm_tf32(p.transpose(-1, -2), do, terms))


@pytest.mark.parametrize("h,kv", FA_HEADS)
@pytest.mark.parametrize("causal,window", FA_MASKS)
def test_3xtf32_backward_holds_the_fp32_tolerance(h, kv, causal, window):
    """The tolerance argument of the tensor-core backward, on the CPU: the
    backward with all five products split 3xTF32 stays within 1e-4 of the
    fp32 backward (relative to the largest gradient above 1) at the JAX
    tests' grid (Sq = Sk = 100 padded to 128, sk_orig masking the pad),
    while one tf32 product (1xTF32) leaves it."""
    rng = np.random.RandomState(h + kv + window)
    q, k = (torch.from_numpy((rng.randn(2, n, 128, 32) * 0.5)
                             .astype(np.float32)) for n in (h, kv))
    v, do = (torch.from_numpy(rng.randn(2, n, 128, 32).astype(np.float32))
             for n in (kv, h))
    for t in (q, k, v, do):
        t[:, :, 100:] = 0
    kw = {"causal": causal, "window": window, "sk_orig": 100}
    o, lse = fa_ref.flash_attention_fwd(q, k, v, **kw)
    delta = (do * o).sum(-1)
    wants = fa_ref.flash_attention_bwd(q, k, v, do, lse, delta, **kw)

    def worst(terms):
        gots = _bwd_tf32(q, k, v, do, lse, delta, causal, window, 100, terms)
        return max(((g - w).abs().max() / max(1.0, w.abs().max().item()))
                   .item() for g, w in zip(gots, wants))

    assert worst(3) < 1e-4 / 20
    assert worst(1) > 1e-4


def _fwd_tf32(q, k, v, causal, window, sk_orig, terms, tile):
    """The forward as the tensor-core kernel computes it: per step of
    ``tile`` keys, S = Q·Kᵀ and P·V on emulated tf32 (``_mm_tf32``), the
    online softmax on fp32 between them, each step's P·V added to the
    alpha-scaled carried O in fp32; out and lse = m + log l."""
    b, h, sq, d = q.shape
    k, v = fa_ref._expand(k, h), fa_ref._expand(v, h)
    sk = k.shape[2]
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    ok = fa_ref.visible(sq, sk, causal=causal, window=window,
                        sk_orig=sk_orig, device=q.device)
    acc = torch.zeros(b, h, sq, d)
    m = torch.full((b, h, sq), fa_ref.NEG_INF)
    l = torch.zeros(b, h, sq)
    for k0 in range(0, sk, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        s = _mm_tf32(q, kt.transpose(-1, -2), terms) * scale
        s = torch.where(ok[:, k0:k0 + tile], s, fa_ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _mm_tf32(p, vt, terms)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return acc / l[..., None], m + torch.log(l)


def _fwd_err(got, want) -> float:
    """The worst error of out and lse, each element's relative to its
    magnitude above 1 (a blind row's lse is near -1e30)."""
    errs = []
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, dtype=np.float32))
        errs.append(((g - w).abs() / w.abs().clamp(min=1.0)).max().item())
    return max(errs)


@pytest.mark.parametrize("h,kv", FA_HEADS)
@pytest.mark.parametrize("causal,window", FA_MASKS)
def test_3xtf32_forward_holds_the_fp32_tolerance(h, kv, causal, window):
    """The tolerance argument of the tensor-core forward, on the CPU: the
    forward with both products split 3xTF32, stepped at the kernel's tile
    of keys (``FWD_TILES``), stays within 1e-4/20 of the fp32 forward and
    of the JAX Pallas forward (interpret mode) at the JAX tests' grid (Sq =
    Sk = 100 padded to 128, sk_orig masking the pad, the padded query rows
    blind under a window), while one tf32 product (1xTF32) leaves 1e-4."""
    rng = np.random.RandomState(h + kv + window + 3)
    (jq, jk, jv), (tq, tk, tv) = _fa_draw(rng, h, kv, "float32", 0.5)
    jpad = [jnp.pad(x, ((0, 0), (0, 0), (0, 28), (0, 0))) for x in
            (jq, jk, jv)]
    q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 28)) for x in (tq, tk, tv))
    kw = {"causal": causal, "window": window, "sk_orig": 100}
    tile = fa_kernel.fwd_tiles(32)["stream"]
    want = fa_ref.flash_attention_fwd(q, k, v, **kw)
    jwant = jfa_kernel.flash_attention_fwd(*jpad, bq=32, bk=32, **kw)
    got = _fwd_tf32(q, k, v, causal, window, 100, 3, tile)
    assert _fwd_err(got, want) < 1e-4 / 20
    assert _fwd_err(got, jwant) < 1e-4 / 20
    assert _fwd_err(_fwd_tf32(q, k, v, causal, window, 100, 1, tile),
                    want) > 1e-4


def test_3xtf32_forward_holds_attention_blocks_budget():
    """At attention_block's q/k/v (B=4, H=8, S=512, D=32, causal, drawn
    uniform in [-0.5, 0.5) as the workload draws them), the 3xTF32 forward
    at the kernel's tile stays within the workloads' 1e-5 of the fp32
    forward, relative to its largest magnitude above 1."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy((rng.rand(4, 8, 512, 32) - 0.5)
                                .astype(np.float32)) for _ in range(3))
    tile = fa_kernel.fwd_tiles(32)["stream"]
    out, _ = _fwd_tf32(q, k, v, True, 0, 512, 3, tile)
    want = fa_ref.flash_attention(q, k, v, causal=True)
    scale = max(1.0, want.abs().max().item())
    assert (out - want).abs().max().item() / scale < 1e-5


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("sq", [128, 100])
def test_attention_backward_makes_no_copy_it_does_not_need(h, kv, sq):
    """The op's backward skips the pad of an unpadded dO, the group sum
    over groups of one and same-type casts: its gradients equal, bit for
    bit, those of the full host path (pad, cast, group sum) around the same
    kernels' plain versions."""
    rng = np.random.RandomState(h + kv + sq)
    q, k, v = (torch.from_numpy((rng.randn(1, n, sq, 32) * 0.5)
                                .astype(np.float32)) for n in (h, kv, kv))
    dout = torch.from_numpy(rng.randn(1, h, sq, 32).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.attention(*leaves, bq=32, bk=32)
    out.backward(dout)
    qp, kp, vp, _, _ = fa_ops._pad(q, k, v, 32, 32)
    op, lse = fa_kernel.flash_attention_fwd(qp, kp, vp, bq=32, bk=32,
                                            sk_orig=sq)
    dop = torch.nn.functional.pad(dout.to(op.dtype),
                                  (0, 0, 0, qp.shape[2] - sq)).contiguous()
    delta = (dop.float() * op.float()).sum(dim=-1)
    dq, dkh, dvh = fa_kernel.flash_attention_bwd(qp, kp, vp, dop, lse, delta,
                                                 bq=32, bk=32, sk_orig=sq)
    g, skp = h // kv, kp.shape[2]
    want = (dq[:, :, :sq].to(qp.dtype),
            dkh.reshape(1, kv, g, skp, 32).sum(dim=2).to(kp.dtype)[:, :, :sq],
            dvh.reshape(1, kv, g, skp, 32).sum(dim=2).to(vp.dtype)[:, :, :sq])
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_flash_attention_wrapper_refuses_what_the_kernels_do_not_take():
    q, k = torch.zeros(1, 4, 64, 32), torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError, match=r"q \[B,H,Sq,D\]"):
        fa_kernel.flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="H % KV == 0"):
        fa_kernel.flash_attention(q, torch.zeros(1, 3, 64, 32),
                                  torch.zeros(1, 3, 64, 32))
    with pytest.raises(ValueError, match="Sq % bq == 0"):
        fa_kernel.flash_attention(q, k, k, bq=48, bk=32)
    with pytest.raises(ValueError, match="sk_orig"):
        fa_kernel.flash_attention(q, k, k, bq=32, bk=32, sk_orig=65)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.flash_attention(q.double(), k.double(), k.double(), bq=32,
                                  bk=32)
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention(q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), k, k, bq=32, bk=32)
    lse = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="lse fp32"):
        fa_kernel.flash_attention_bwd(q, k, k, q, lse.double(), lse, bq=32,
                                      bk=32)
    with pytest.raises(ValueError, match="do like q"):
        fa_kernel.flash_attention_bwd(q, k, k, q.bfloat16(), lse, lse,
                                      bq=32, bk=32)
    # what only the CUDA kernels refuse: an uncompiled head dim
    with pytest.raises(ValueError, match="no flash-attention kernel for head"):
        fa_kernel._check_kernel(torch.zeros(1, 1, 1, 48))
    for d in fa_kernel.HEAD_DIMS:
        fa_kernel._check_kernel(torch.zeros(1, 1, 1, d))
    # gemma3-1b's head dim opts in to more than 48 KB and fits the card:
    # the forward's 128 own query rows and two stages of 16 keys and values,
    # rows of 260 floats
    assert fa_kernel.smem_bytes("fwd", 256) == 4 * 260 * (128 + 4 * 16)
    assert 48 * 1024 < fa_kernel.smem_bytes("fwd", 256) <= fa_kernel.SMEM_LIMIT
    # the backward at D = 256: 64 own rows and two stages of 16 streamed
    # rows, rows of 260 floats, and for dk/dv two stages of lse and delta
    assert fa_kernel.smem_bytes("dkv", 256) == \
        4 * 260 * (2 * 64 + 4 * 16) + 4 * 2 * 2 * 16
    assert fa_kernel.smem_bytes("dq", 256, 2) == 2 * 264 * (2 * 64 + 4 * 16)
    # the op pads, so a ragged Sq and Sk at any bq, bk reach the wrapper
    # aligned; the JAX bq rule keeps bq = Sq when Sq divides evenly
    out = fa_ops.attention(torch.ones(1, 4, 40, 32), torch.ones(1, 2, 40, 32),
                           torch.ones(1, 2, 40, 32), bq=256, bk=48)
    torch.testing.assert_close(out, torch.ones(1, 4, 40, 32))


def test_cudnn_fp32_holds_one_thread_at_a_time():
    """The flag is process-wide: a second thread waits for the first's
    block, so neither restores TF32 under the other's call."""
    prev = torch.backends.cudnn.allow_tf32
    inside, release = threading.Event(), threading.Event()
    seen = []

    def first():
        with cudnn_fp32():
            inside.set()
            release.wait(5)
            seen.append(("first", torch.backends.cudnn.allow_tf32))

    def second():
        inside.wait(5)
        with cudnn_fp32():
            seen.append(("second", torch.backends.cudnn.allow_tf32))

    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    try:
        torch.backends.cudnn.allow_tf32 = True
        for t in threads:
            t.start()
        assert inside.wait(5)
        time.sleep(0.05)
        assert seen == []
        release.set()
        for t in threads:
            t.join(5)
        assert seen == [("first", False), ("second", False)]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        release.set()
        torch.backends.cudnn.allow_tf32 = prev


def test_cudnn_fp32_pins_tf32_off_and_restores():
    prev = torch.backends.cudnn.allow_tf32
    try:
        for outer in (True, False):
            torch.backends.cudnn.allow_tf32 = outer
            with cudnn_fp32():
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is outer
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("kernel", ["matmul", "matvec", "conv2d", "maxpool",
                                    "blur", "flash_attention"])
def test_abstract_params_errors_match(kernel):
    """Same shape hooks, same ValueError on a bad operand, in both
    packages."""
    jops, tops, bad, good, kw = {
        "flash_attention": (jfa_ops, fa_ops, ((2, 8, 4),) * 3,
                            ((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)),
                            {}),
        "matmul": (jmm_ops, mm_ops, ((4, 5), (6, 3)), ((4, 5), (5, 3)), {}),
        "matvec": (jmv_ops, mv_ops, ((4, 5), (6,)), ((4, 5), (5,)), {}),
        "conv2d": (jmc_ops, mc_ops, ((4, 5, 6), (3, 3)), ((9, 7), (3, 3)),
                   {}),
        "maxpool": (jmp_ops, mp_ops, ((4, 5, 6),), ((9, 7),),
                    {"r": 3, "s": 2}),
        "blur": (jbl_ops, bl_ops, ((4,),), ((9, 7),), {}),
    }[kernel]
    avals = [Aval(s, "float32") for s in bad]
    with pytest.raises(ValueError) as jerr:
        jops.abstract_params(*avals, **kw)
    with pytest.raises(ValueError) as terr:
        tops.abstract_params(*avals, **kw)
    assert str(terr.value) == str(jerr.value)
    ok = [Aval(s, "float32") for s in good]
    assert tops.abstract_params(*ok, **kw) == jops.abstract_params(*ok, **kw)
    assert tuple(tops.out_aval(*ok, **kw).shape) == \
        tuple(jops.out_aval(*ok, **kw).shape)


def test_backend_rule_and_device_resolution():
    cpu = torch.zeros(2)
    assert on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError, match="no kernel for device meta"):
        on_cuda(torch.zeros(2, device="meta"))
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        # entry points never drift to the CPU on their own
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a, b = torch.zeros(8, 4), torch.zeros(4, 6)
    with pytest.raises(ValueError, match="no matmul kernel for schedule"):
        mm_kernel.matmul(a, b, bm=64, bn=64, bk=64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mm_kernel.matmul(a.double(), b.double(), bm=32, bn=32, bk=32)
    with pytest.raises(ValueError, match="contiguous"):
        mm_kernel.matmul(a, torch.zeros(6, 4).t(), bm=32, bn=32, bk=32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mv_kernel.matvec(a, torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="matvec needs"):
        mv_kernel.matvec(a, torch.zeros(5))
    # ops make operands contiguous before they reach the wrapper
    bt = torch.arange(24.0).reshape(6, 4).t()
    assert torch.equal(mm_ops.matmul(a + 1, bt, bm=32, bn=32, bk=32),
                       (a + 1) @ bt)
    p, w = torch.zeros(40, 30), torch.zeros(3, 3)
    with pytest.raises(ValueError, match="no conv2d kernel for tile"):
        mc_kernel.conv2d(p, w, bm=128, bn=128)
    with pytest.raises(ValueError, match="square taps"):
        mc_kernel.conv2d(p, torch.zeros(3, 2))
    with pytest.raises(ValueError, match="exceed the plane"):
        mc_kernel.conv2d(torch.zeros(2, 30), w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mc_kernel.conv2d(p, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        mc_kernel.conv2d(torch.zeros(30, 40).t(), w)
    # a halo that does not fit the shared-memory budget is refused, not
    # launched to read out of bounds
    with pytest.raises(ValueError, match="bytes of shared memory"):
        mc_kernel.conv2d(torch.zeros(100, 100), torch.zeros(81, 81))
    assert mc_kernel.smem_bytes(7, 32, 32) == 4 * (38 * 38 + 49)
    with pytest.raises(ValueError, match="no maxpool kernel for tile"):
        mp_kernel.maxpool(p, r=2, s=2, bm=16, bn=16)
    with pytest.raises(ValueError, match="maxpool needs a"):
        mp_kernel.maxpool(torch.zeros(4), r=2, s=2)
    with pytest.raises(ValueError, match="1 <= r <= min"):
        mp_kernel.maxpool(p, r=2, s=0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mp_kernel.maxpool(p.double(), r=2, s=2)
    with pytest.raises(ValueError, match="contiguous"):
        mp_kernel.maxpool(torch.zeros(30, 40).t(), r=2, s=2)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        mp_kernel.maxpool(torch.zeros(200, 200), r=2, s=4)
    assert mp_kernel.smem_bytes(5, 2, 32, 32) == 4 * 67 * 67
    with pytest.raises(ValueError, match="no blur kernel for tile"):
        bl_kernel.blur(p, bm=32, bn=32)
    with pytest.raises(ValueError, match="m >= 3, n >= 3"):
        bl_kernel.blur(torch.zeros(2, 30))
    with pytest.raises(ValueError, match="m >= 3, n >= 3"):
        bl_kernel.blur(torch.zeros(30))
    with pytest.raises(ValueError, match="m >= 1, n >= 3"):
        bl_kernel.blur_h(torch.zeros(30, 2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bl_kernel.blur(p.double())
    with pytest.raises(ValueError, match="contiguous"):
        bl_kernel.blur(torch.zeros(30, 40).t(), separable=True)
    with pytest.raises(ValueError, match="index range"):
        bl_kernel.blur_v(torch.empty(16 * 65535 + 3, 3), bm=16, bn=16)
    # the 128 tile's fp32 window, above 48 KB, is within what a block may
    # opt in to
    assert bl_kernel.smem_bytes(128, 128, (3, 3)) == 4 * 130 * 130
    assert bl_kernel.smem_bytes(128, 128, (1, 3)) == 4 * 128 * 130
    assert bl_kernel.smem_bytes(128, 128, (3, 3)) <= bl_kernel.SMEM_LIMIT
    assert torch.equal(mp_ops.maxpool(torch.zeros(30, 40).t(), r=2, s=2),
                       torch.zeros(20, 15))


# the main path's products (m, n, k) -> (s, blocks) of the 128 tile on 132
# SMs with one block an SM: 32, 16 and 9 output tiles filled out along k
MAIN_SPLITS = {(256, 2048, 1024): (4, 128), (256, 1024, 2048): (8, 128),
               (384, 384, 384): (8, 72), (512, 1024, 512): (4, 128),
               (512, 512, 1024): (8, 128)}


@pytest.mark.parametrize("shape", list(MAIN_SPLITS))
def test_split_k_fills_the_card_at_the_main_path_shapes(shape):
    m, n, k = shape
    s, blocks = MAIN_SPLITS[shape]
    assert mm_kernel.split_k(m, n, k, 128, 128, 32, 132) == s
    assert -(-m // 128) * -(-n // 128) * s == blocks
    # the 32 tile has at least 144 tiles there: it fills the card by count
    assert mm_kernel.split_k(m, n, k, 32, 32, 32, 132) == 1


def _k_ranges(k, s):
    chunk = mm_kernel.k_chunk(k, s)
    return [(r * chunk, min(k, (r + 1) * chunk)) for r in range(s)]


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_split_k_keeps_every_k_range_and_one_wave(sms):
    rng = np.random.RandomState(sms)
    shapes = [(1, 1, 1), (64, 96, 120), (100, 70, 130), (33, 257, 65),
              (128, 128, 40), (128, 128, 33), (4096, 4096, 64)]
    shapes += [tuple(int(v) for v in rng.randint(1, 3000, size=3))
               for _ in range(200)]
    for m, n, k in shapes:
        for bm, bn, bk in mm_kernel.SCHEDULES:
            s = mm_kernel.split_k(m, n, k, bm, bn, bk, sms)
            assert s in mm_kernel.SPLITS
            tiles = -(-m // bm) * -(-n // bn)
            if tiles >= sms or k <= bk:
                assert s == 1
            ranges = _k_ranges(k, s)
            # every block has k to sum, the ranges tile [0, k) in order,
            # and each starts on the kernel's 16-byte A alignment
            assert all(lo < hi for lo, hi in ranges), (m, n, k, s)
            assert ranges[0][0] == 0 and ranges[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(lo % mm_kernel.SPLIT_ALIGN == 0 for lo, _ in ranges)
            assert s == 1 or tiles * s <= sms


def test_split_k_reads_the_cards_cluster_slots():
    # an H100's occupancy for the 128 tile: clusters of 4 or 8 blocks sit
    # in one GPC each and reach 120 of its 132 SMs
    slots = {1: 132, 2: 132, 4: 120, 8: 120}
    got = {shape: mm_kernel.split_k(*shape, 128, 128, 32, 132, slots)
           for shape in MAIN_SPLITS}
    assert got == {(256, 2048, 1024): 2, (256, 1024, 2048): 4,
                   (384, 384, 384): 8, (512, 1024, 512): 2,
                   (512, 512, 1024): 4}
    # three blocks of the 32 tile share an SM, but a grid of at least as
    # many tiles as SMs is not split; fewer tiles are
    slots32 = {1: 396, 2: 396, 4: 372, 8: 360}
    assert mm_kernel.split_k(256, 1024, 2048, 32, 32, 32, 132, slots32) == 1
    assert mm_kernel.split_k(128, 512, 512, 32, 32, 32, 132, slots32) == 4


def test_schedules_and_signatures_agree_with_the_registry(monkeypatch):
    from repro_torch.runtime import default_registry

    seen = []

    def spy(a, b, *, bm, bn, bk):
        seen.append((bm, bn, bk))
        return mm_kernel.plain(a, b)

    monkeypatch.setattr(mm_kernel, "matmul", spy)
    a, b = torch.ones(4, 3), torch.ones(3, 5)
    rk = default_registry(include=["matmul"]).get("matmul")
    for v in rk.variants:
        v.call((a, b), {"m": 4, "n": 5, "k": 3})
    hand = [v.name for v in rk.variants if v.name.startswith("pallas_")]
    assert hand == [f"pallas_{bm}" for bm, _, _ in mm_kernel.SCHEDULES]
    assert seen == list(mm_kernel.SCHEDULES)
    # repro_matmul(a, b, c, m | n << 32, k, dtype | tile << 8 | split << 16
    # | device << 24, stream) and repro_matvec(a, x, y, m | k << 32, dtype |
    # device << 8, stream): pointers and the stream as c_void_p, the packed
    # counts as 64 and 32 bits
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert mm_kernel._SIGNATURES == {
        "repro_matmul": [ptr] * 3 + [i64, i32, i32, ptr]}
    assert mv_kernel._SIGNATURES == {
        "repro_matvec": [ptr] * 3 + [i64, i32, ptr]}
    assert mm_kernel._ENTRY.argtypes == mm_kernel._SIGNATURES["repro_matmul"]
    assert mv_kernel._ENTRY.argtypes == mv_kernel._SIGNATURES["repro_matvec"]


def test_backward_operands_reach_the_kernels_on_16_bytes():
    """The backward kernels copy rows by 16-byte cp.async: an operand whose
    storage starts off 16 bytes goes to them as an aligned copy, an
    aligned one as it is."""
    x = torch.arange(64.0).view(1, 1, 2, 32)
    assert fa_kernel._aligned(x) is x
    off = x.new_empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
    assert off.data_ptr() % 16 and off.is_contiguous()
    moved = fa_kernel._aligned(off)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, x)


def test_backward_tiles_agree_with_the_cuda_source():
    """The wrapper's table of the backward tiles (which ``smem_bytes`` and
    the refusals read) is the one ``csrc/flash_attention.cu`` compiles:
    BwdCfg's warps, split and streamed rows per head dim; every tile fits
    the card, and at D <= 128 a block's warps or those of the blocks an SM
    holds by shared memory reach 8."""
    import re
    from repro_torch.kernels import build

    src = (build.CSRC / "flash_attention.cu").read_text()
    found = {}
    for d, body in re.findall(r"struct BwdCfg<(\d+)> \{(.*?)\};", src, re.S):
        nums = dict(re.findall(r"(\w+) = (\d+)", body))
        found[int(d)] = {k: (int(nums[f"{p}_WARPS"]), int(nums[f"{p}_SPLIT"]),
                             int(nums[f"{p}_STREAM"]))
                         for k, p in (("dq", "DQ"), ("dkv", "DKV"))}
    assert found == fa_kernel.BWD_TILES
    assert sorted(found) == list(fa_kernel.HEAD_DIMS)
    for d in fa_kernel.HEAD_DIMS:
        for kernel in ("dq", "dkv"):
            tile = fa_kernel.bwd_tiles(kernel, d)
            need = fa_kernel.smem_bytes(kernel, d)
            assert need <= fa_kernel.SMEM_LIMIT
            if d <= 128:
                blocks = min(fa_kernel.SMEM_LIMIT // need, 2048 //
                             tile["threads"])
                assert blocks * tile["warps"] >= 8
            assert tile["own"] % 16 == 0 and tile["stream"] % 8 == 0


def test_forward_tiles_agree_with_the_cuda_source():
    """The wrapper's table of the forward's tiles (which ``smem_bytes`` and
    the refusals read) is the one ``csrc/flash_attention.cu`` compiles:
    FwdCfg's warps, split and streamed rows per head dim; every tile fits
    the card, a block owns at least 64 query rows (the kernels' grid
    admits 65535 blocks of them along a sequence), and at D = 256 two
    warps share 16 rows, so that each holds half of O."""
    import re

    src = (build.CSRC / "flash_attention.cu").read_text()
    found = {int(d): tuple(int(x) for x in body) for d, *body in re.findall(
        r"struct FwdCfg<(\d+)> \{\s*static constexpr int WARPS = (\d+), "
        r"SPLIT = (\d+), STREAM = (\d+);\s*\};", src)}
    assert found == fa_kernel.FWD_TILES
    assert sorted(found) == list(fa_kernel.HEAD_DIMS)
    assert "kFwdTile" not in src
    for d in fa_kernel.HEAD_DIMS:
        tile = fa_kernel.fwd_tiles(d)
        for itemsize in (4, 2):
            need = fa_kernel.smem_bytes("fwd", d, itemsize)
            assert need <= fa_kernel.SMEM_LIMIT
            assert need == itemsize * (d + 16 // itemsize) * (
                tile["own"] + 4 * tile["stream"])
        assert tile["own"] >= 64 and tile["stream"] % 8 == 0
        assert (d // tile["split"]) % 8 == 0
    assert fa_kernel.fwd_tiles(256)["split"] == 2


def test_lean_launch_path_takes_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(40, 24).astype(np.float32))
    x = torch.from_numpy(rng.randn(24).astype(np.float32))
    b = torch.from_numpy(rng.randn(24, 16).astype(np.float32))
    before = (mv_kernel.LAUNCHES, mm_kernel.LAUNCHES,
              mv_kernel._ENTRY.fn, mm_kernel._ENTRY.fn)
    assert torch.equal(mv_kernel.matvec(a, x), mv_kernel.plain(a, x))
    for bm, bn, bk in mm_kernel.SCHEDULES:
        assert torch.equal(mm_kernel.matmul(a, b, bm=bm, bn=bn, bk=bk),
                           mm_kernel.plain(a, b))
    # nothing launched, nothing built or bound for CPU tensors
    assert (mv_kernel.LAUNCHES, mm_kernel.LAUNCHES, mv_kernel._ENTRY.fn,
            mm_kernel._ENTRY.fn) == before
    assert cuda_index(a, x) == -1
    meta = torch.zeros(24, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        mv_kernel.matvec(a, meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mm_kernel.matmul(torch.zeros(4, 3, device="meta"),
                         torch.zeros(3, 2, device="meta"), bm=32, bn=32,
                         bk=32)
    with pytest.raises(ValueError, match="index range"):
        mv_kernel._check(torch.empty(2 ** 31, 0), torch.empty(0))


def test_ops_matvec_passes_ready_operands_without_a_copy(monkeypatch):
    seen = []
    monkeypatch.setattr(mv_kernel, "matvec",
                        lambda a, x: seen.append((a, x)) or mv_kernel.plain(
                            a, x))
    a, x = torch.randn(6, 5), torch.randn(5)
    mv_ops.matvec(a, x)
    assert seen[-1][0] is a and seen[-1][1] is x
    # a mistyped x is cast once, a strided a made contiguous
    mv_ops.matvec(a.bfloat16(), x)
    assert seen[-1][1].dtype == torch.bfloat16
    at = torch.randn(5, 6).t()
    mv_ops.matvec(at, x)
    assert seen[-1][0].is_contiguous() and seen[-1][1] is x


def test_build_is_content_keyed_and_failures_raise(monkeypatch, tmp_path):
    assert build.library_path("matmul") == build.library_path("matmul")
    assert build.library_path("matmul").name.startswith("libmatmul-")
    assert build.library_path("matmul") != build.library_path("matvec")
    assert set(build.SOURCES) == {"matmul", "matvec", "conv2d", "maxpool",
                                  "blur", "flash_attention"}
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    # a compiler that fails makes build() raise, never return quietly
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed for matmul.cu"):
        build.build(["matmul"])
    assert not list(tmp_path.glob("*.so"))


# --------------------------------------------------------------------------
# the window kernels (blur, maxpool): the workloads' planes, the launch
# geometry the wrappers choose, and the lean launch path
# --------------------------------------------------------------------------

WORK_BLUR = [(1024, 1024), (384, 384)]          # image_pipeline, mixed_dag
WORK_POOL = [(1020, 1020), (384, 384)]          # the same, at r = s = 2


@pytest.mark.parametrize("m,n", WORK_BLUR)
@pytest.mark.parametrize("separable", [False, True])
def test_blur_wrappers_match_jax_at_the_workload_planes(m, n, separable):
    """The blur wrappers on CPU tensors at the workloads' planes, drawn as
    the workloads draw them: against the JAX oracle and the JAX op's plain
    path within 1e-5, and each pass against the Pallas bodies bit for
    bit."""
    rng = np.random.RandomState(m + separable)
    x = (rng.rand(m, n) - 0.5).astype(np.float32)
    ja, ta = jnp.asarray(x), torch.from_numpy(x)
    out = bl_kernel.blur(ta, separable=separable)
    assert tuple(out.shape) == (m - 2, n - 2)
    for want in (jbl_ref.blur(ja), jbl_ops.blur(ja, use_kernel=False)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(_pallas_blur_bodies(ja, separable)))
    if separable:
        h = bl_kernel.blur_h(ta, bm=16, bn=16)
        on = n - 2
        jh = ((ja[:, 0:on] + ja[:, 1:on + 1] + ja[:, 2:on + 2])
              * (1.0 / 3.0))
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        assert torch.equal(bl_kernel.blur_v(h, bm=16, bn=16), out)


@pytest.mark.parametrize("m,n", WORK_POOL)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_wrapper_equals_jax_at_the_workload_planes(m, n, dtype):
    rng = np.random.RandomState(m)
    ja, ta = _pair(rng, (m, n), dtype)
    want = np.float32(jmp_ref.maxpool(ja, r=2, s=2))
    np.testing.assert_array_equal(
        np.float32(jmp_ops.maxpool(ja, r=2, s=2, use_kernel=False)), want)
    for bm, bn in mp_kernel.SCHEDULES:
        out = mp_kernel.maxpool(ta, r=2, s=2, bm=bm, bn=bn)
        assert tuple(out.shape) == (m // 2, n // 2)
        np.testing.assert_array_equal(out.float().numpy(), want)


# (taps, input plane) of each blur entry at the workloads' planes: the v
# pass reads the h pass's [m, n-2]
BLUR_PASSES = {"blur_direct": (3, 3), "blur_h": (1, 3), "blur_v": (3, 1)}


def _blur_inputs():
    for m, n in WORK_BLUR:
        for name, taps in BLUR_PASSES.items():
            yield name, taps, (m, n - 2) if name == "blur_v" else (m, n)


@pytest.mark.parametrize("tile,pool_tile", [(128, 32), (16, 8)])
def test_window_geometry_fills_the_card_on_the_vector_path(tile, pool_tile):
    """fp32 at every workload plane, through allocator-aligned buffers:
    the vector path, 16-byte loads where the input rows allow them (8 for
    the v pass over h's 4,088-byte rows), stores as wide as the output rows
    lie (h's rows take 8 bytes), and at least the FILL_BLOCKS of the rule
    (several blocks for each of an H100's 132 SMs)."""
    from repro_torch.kernels import FILL_BLOCKS, Window

    assert FILL_BLOCKS >= 132
    for name, taps, (m, n) in _blur_inputs():
        geo = bl_kernel.geometry(taps, m, n, 4, tile)
        on = n - taps[1] + 1
        assert geo.load_bytes == (16 if n % 4 == 0 else 8), (name, m, n)
        assert geo.store_bytes == (16 if on % 4 == 0 else 8), (name, m, n)
        # strips shortened until the grid fills the card, or to one row
        assert geo.blocks >= 132, (name, m, n, geo)
        assert geo.blocks >= FILL_BLOCKS or geo.rows == 1, (name, m, n, geo)
        assert (geo.threads, geo.rows) <= bl_kernel.VECTOR[tile]
    for m, n in WORK_POOL:
        geo = mp_kernel.geometry(m, n, 2, 2, 4, pool_tile)
        assert (geo.load_bytes, geo.store_bytes) == (16, 8)
        assert geo.blocks >= 132, (m, n, geo)
        assert geo.blocks >= FILL_BLOCKS or geo.rows == 1, (m, n, geo)
    # conv2d at the image workload's [1022,1022] (rows of 4,088 bytes: 8-byte
    # packets) and at a plane whose rows take 16, at its tile of the same
    # size class
    conv_tile = {128: 32, 16: 16}[tile]
    for m, n, load in ((1022, 1022, 8), (1024, 1024, 16)):
        for r in mc_kernel.VECTOR_TAPS:
            geo = mc_kernel.geometry(m, n, r, 4, conv_tile)
            on = n - r + 1
            assert geo.load_bytes == load, (m, n, r)
            assert geo.store_bytes == min(load, 16 if on % 4 == 0 else
                                          8 if on % 2 == 0 else 4)
            assert geo.blocks >= FILL_BLOCKS or geo.rows == 1, (m, n, r, geo)
            assert (geo.threads, geo.rows) <= mc_kernel.VECTOR[conv_tile]
    # the two tiles stay two schedules: at the image plane they launch
    # differently shaped blocks
    assert bl_kernel.geometry((3, 3), 1024, 1024, 4, 128) != \
        bl_kernel.geometry((3, 3), 1024, 1024, 4, 16)
    assert mc_kernel.geometry(1022, 1022, 3, 4, 32) != \
        mc_kernel.geometry(1022, 1022, 3, 4, 16)
    assert mp_kernel.geometry(1020, 1020, 2, 2, 4, 32) != \
        mp_kernel.geometry(1020, 1020, 2, 2, 4, 8)
    assert Window(16, 8, 128, 2, 0).config(1, 128) == \
        1 | 16 << 8 | 8 << 16 | 2 << 24 | 4 << 32 | 128 << 40


@pytest.mark.parametrize("kernel", ["blur", "maxpool", "conv2d"])
def test_window_geometry_takes_the_staged_path_off_alignment(kernel):
    """A base 4 bytes off 16 (``a_low = 4``), rows whose width is off 8
    bytes, for maxpool every window but r = s = 2, and for conv2d every r
    the vector path does not compile, take the staged path: one block per
    output tile, as before."""
    if kernel == "conv2d":
        for m, n, r in [(1022, 1022, 3), (1022, 1022, 7), (100, 90, 5)]:
            for tile in (32, 16):
                geo = mc_kernel.geometry(m, n, r, 4, tile, a_low=4)
                om, on = m - r + 1, n - r + 1
                assert geo == (0, 0, 0, 0, -(-om // tile) * -(-on // tile))
                # odd widths, and bf16 rows of 1,022 elements (4 bytes)
                assert mc_kernel.geometry(m, n + 1, r, 4, tile).load_bytes == 0
                assert mc_kernel.geometry(m, n, r, 2, tile).load_bytes == 0
        for r in (1, 2, 4, 6, 9):
            assert mc_kernel.geometry(1024, 1024, r, 4, 32).load_bytes == 0
        assert mc_kernel.geometry(1024, 1024, 9, 4, 32).blocks == 32 * 32
        # a misaligned output alone narrows the stores, not the path
        geo = mc_kernel.geometry(1024, 1024, 3, 4, 32, out_low=4)
        assert (geo.load_bytes, geo.store_bytes) == (16, 4)
    elif kernel == "blur":
        for taps in BLUR_PASSES.values():
            assert bl_kernel.geometry(taps, 1024, 1024, 4, 128,
                                      a_low=4).load_bytes == 0
            assert bl_kernel.geometry(taps, 51, 201, 4, 16).load_bytes == 0
            # bf16 rows of 1,022 elements lie on 4 bytes only
            assert bl_kernel.geometry(taps, 64, 1022, 2, 16).load_bytes == 0
        staged = bl_kernel.geometry((3, 3), 1024, 1024, 4, 128, a_low=4)
        assert staged.blocks == 8 * 8
        # a misaligned output alone narrows the stores, not the path
        geo = bl_kernel.geometry((3, 3), 1024, 1024, 4, 128, out_low=4)
        assert (geo.load_bytes, geo.store_bytes) == (16, 4)
    else:
        for m, n, r, s in [(100, 90, 3, 2), (65, 43, 5, 1), (32, 32, 4, 2)]:
            for tile in (32, 8):
                geo = mp_kernel.geometry(m, n, r, s, 4, tile)
                om, on = (m - r) // s + 1, (n - r) // s + 1
                assert geo.load_bytes == 0
                assert geo.blocks == -(-om // tile) * -(-on // tile)
        assert mp_kernel.geometry(1020, 1020, 2, 2, 4, 32,
                                  a_low=4).load_bytes == 0
        assert mp_kernel.geometry(101, 90, 2, 2, 4, 32).load_bytes == 8
        assert mp_kernel.geometry(64, 1022, 2, 2, 2, 32).load_bytes == 0


def test_window_config_agrees_with_the_cuda_source():
    """``Window.config``'s byte fields are the ones ``repro::Config``
    (csrc/window.cuh) decodes, and the rows the wrappers ask for are the
    ones ``with_rows`` compiles."""
    import re
    from repro_torch.kernels import Window

    src = (build.CSRC / "window.cuh").read_text()
    body = re.search(r"struct Config \{(.*?)\};", src, re.S).group(1)
    shifts = {name: int(shift or 0) for name, shift in re.findall(
        r"(\w+)\(\s*(?:32 \* )?static_cast<int>\(\(?c(?: >> (\d+)\))?", body)}
    assert shifts == {"dtype": 0, "load_bytes": 8, "store_bytes": 16,
                      "rows": 24, "threads": 32, "tile": 40, "device": 48}
    cfg = Window(8, 4, 64, 2, 0).config(1, 16) | 3 << 48
    assert [cfg >> shifts[k] & 0xff for k in shifts] == [1, 8, 4, 2, 2, 16,
                                                         3]
    compiled = {int(r) for r in re.findall(r"case (\d+): return launch", src)}
    for table in (bl_kernel.VECTOR, mp_kernel.VECTOR, mc_kernel.VECTOR):
        for threads, rows in table.values():
            assert rows in compiled and threads % 32 == 0 and threads <= 256
    # conv2d's vector path compiles the tap counts the wrapper sends it, and
    # its C entry takes the packed shape, r and config
    conv = (build.CSRC / "conv2d.cu").read_text()
    taps = re.search(r"int with_taps\(.*?\n\}", conv, re.S).group(0)
    assert tuple(int(r) for r in re.findall(r"case (\d+):", taps)) == \
        mc_kernel.VECTOR_TAPS
    assert "long long shape, int r, long long config" in conv
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert mc_kernel._ENTRY.argtypes == [ptr] * 3 + [i64, i32, i64, ptr]


def test_lean_window_launch_path_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the blur, maxpool and conv2d wrappers return their
    plain versions and launch, build and bind nothing; a tensor on another
    device is refused as the backend rule refuses it."""
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(40, 36).astype(np.float32))
    before = (dict(bl_kernel.LAUNCHES), mp_kernel.LAUNCHES,
              mp_kernel._ENTRY.fn,
              {k: e.fn for k, e in bl_kernel._ENTRIES.items()},
              mc_kernel.LAUNCHES, mc_kernel._ENTRY.fn)
    # conv2d on both of its paths' tap counts, fp32 and bf16: the plain
    # version, which is the JAX oracle's arithmetic
    for r in (3, 4, 7):
        w = torch.from_numpy(rng.randn(r, r).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            for bm, bn in mc_kernel.SCHEDULES:
                assert torch.equal(
                    mc_kernel.conv2d(a.to(dtype), w.to(dtype), bm=bm, bn=bn),
                    mc_kernel.plain(a.to(dtype), w.to(dtype)))
        np.testing.assert_allclose(
            mc_kernel.conv2d(a, w).numpy(),
            np.asarray(jmc_ref.conv2d(jnp.asarray(a.numpy()),
                                      jnp.asarray(w.numpy()))),
            rtol=1e-6, atol=1e-6)
    for bm, bn in bl_kernel.SCHEDULES:
        assert torch.equal(bl_kernel.blur_direct(a, bm=bm, bn=bn),
                           bl_kernel.plain(a))
        assert torch.equal(bl_kernel.blur_h(a, bm=bm, bn=bn),
                           bl_kernel.plain_h(a))
        assert torch.equal(bl_kernel.blur_v(a, bm=bm, bn=bn),
                           bl_kernel.plain_v(a))
    for bm, bn in mp_kernel.SCHEDULES:
        assert torch.equal(mp_kernel.maxpool(a, r=2, s=2, bm=bm, bn=bn),
                           mp_kernel.plain(a, r=2, s=2))
    assert (dict(bl_kernel.LAUNCHES), mp_kernel.LAUNCHES,
            mp_kernel._ENTRY.fn,
            {k: e.fn for k, e in bl_kernel._ENTRIES.items()},
            mc_kernel.LAUNCHES, mc_kernel._ENTRY.fn) == before
    meta = torch.zeros(40, 36, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bl_kernel.blur(meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mc_kernel.conv2d(meta, torch.zeros(3, 3, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        mc_kernel.conv2d(a, torch.zeros(3, 3, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mp_kernel.maxpool(meta, r=2, s=2)
    # the refusals come before the device is looked at
    with pytest.raises(ValueError, match="no blur kernel for tile"):
        bl_kernel.blur_h(meta, bm=64, bn=64)
    with pytest.raises(ValueError, match="maxpool needs a"):
        mp_kernel.maxpool(torch.zeros(4, device="meta"), r=2, s=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """On a card: each kernel at each schedule against its plain version,
    counting launches (run by python3 -m pytest -m cuda on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    td, tol = DTYPES[dtype][1], DTYPES[dtype][2]
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = mm_kernel.LAUNCHES
    for m, n, k in [(100, 70, 130), (33, 257, 65), (256, 1024, 512)]:
        a = torch.randn(m, k, generator=gen, device="cuda").to(td)
        b = torch.randn(k, n, generator=gen, device="cuda").to(td)
        for bm, bn, bk in mm_kernel.SCHEDULES:
            got = mm_kernel.matmul(a, b, bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), mm_kernel.plain(a, b).float(),
                                       rtol=tol, atol=tol)
    # the cluster split along k: on an H100 these take cluster sizes 8, 4,
    # 2 and 1 at the 128 tile, k below s * bk at (64, 96, 120), and the
    # narrow copy path at n = 36 in bf16 and at an a off 16 bytes; drawn as
    # the workloads draw (uniform, the contraction operand over sqrt(k)),
    # which keeps fp32 order differences at k = 1000 inside 1e-4
    cluster = [(128, 256, 1000), (384, 1280, 520), (512, 1536, 200),
               (1024, 1280, 64), (64, 96, 120), (96, 36, 264),
               (256, 512, 300)]
    for m, n, k in cluster:
        a = torch.rand(m, k, generator=gen, device="cuda") - 0.5
        b = (torch.rand(k, n, generator=gen, device="cuda") - 0.5) / k ** 0.5
        a, b = a.to(td), b.to(td)
        if (m, n, k) == (256, 512, 300):
            a = a.new_empty(m * k + 1)[1:].view(m, k).copy_(a)
        want = mm_kernel.plain(a, b).float()
        for bm, bn, bk in mm_kernel.SCHEDULES:
            got = mm_kernel.matmul(a, b, bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert mm_kernel.LAUNCHES == before + (3 + len(cluster)) * len(
        mm_kernel.SCHEDULES)
    # mixed_dag's products at large, drawn and chained as the workload does:
    # held relative to the output's magnitude, which the join takes to 1e5
    n = 384
    x, y, *ws = (torch.rand(n, n, generator=gen, device="cuda") - 0.5
                 for _ in range(8))
    root = mm_kernel.plain(x, y)
    pairs = [(x, y)] + [(root, w / n ** 0.5) for w in ws]
    join, *branches = (mm_kernel.plain(root, w) for _, w in pairs[1:])
    for br in branches:
        pairs.append((join, br))
        join = mm_kernel.plain(join, br)
    for a, b in pairs:
        a, b = a.to(td), b.to(td)
        want = mm_kernel.plain(a, b).float()
        scale = max(1.0, want.abs().max().item())
        for bm, bn, bk in mm_kernel.SCHEDULES:
            got = mm_kernel.matmul(a, b, bm=bm, bn=bn, bk=bk)
            torch.testing.assert_close(got.float(), want, rtol=tol,
                                       atol=tol * scale)
    before = mv_kernel.LAUNCHES
    for m, k in [(257, 513), (1, 5), (1024, 1024)]:
        a = torch.randn(m, k, generator=gen, device="cuda").to(td)
        x = torch.randn(k, generator=gen, device="cuda").to(td)
        got = mv_kernel.matvec(a, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), mv_kernel.plain(a, x).float(),
                                   rtol=tol, atol=tol)
        # a fixed order of sums: a second launch equals the first
        assert torch.equal(mv_kernel.matvec(a, x), got)
    assert mv_kernel.LAUNCHES == before + 6
    before = mc_kernel.LAUNCHES
    paths = set()
    calls = 0
    # the vector path (r = 3, 5, 7 on rows on 8 or 16 bytes) and the staged
    # one (other r, a base 4 bytes off, rows off 8 bytes)
    for m, n, r in [(100, 90, 5), (41, 77, 7), (1022, 1022, 3),
                    (1022, 1022, 5), (1022, 1022, 7), (1024, 1024, 3),
                    (64, 64, 4), (51, 201, 3)]:
        a = torch.randn(m, n, generator=gen, device="cuda").to(td)
        w = torch.randn(r, r, generator=gen, device="cuda").to(td)
        for plane in (a, _off4(a)):
            want = mc_kernel.plain(plane, w)
            for bm, bn in mc_kernel.SCHEDULES:
                geo = mc_kernel.geometry(m, n, r, plane.element_size(), bm,
                                         plane.data_ptr() & 15)
                vector = r in mc_kernel.VECTOR_TAPS and \
                    plane.data_ptr() % 8 == 0 and \
                    n * plane.element_size() % 8 == 0
                assert (geo.load_bytes > 0) == vector
                paths.add(vector)
                got = mc_kernel.conv2d(plane, w, bm=bm, bn=bn)
                torch.cuda.synchronize()
                # the plain version's tap order and roundings: equal bit
                # for bit
                torch.testing.assert_close(got, want, rtol=0, atol=0)
                calls += 1
    assert paths == {True, False}
    assert mc_kernel.LAUNCHES == before + calls
    before = mp_kernel.LAUNCHES
    for m, n, r, s in [(100, 90, 3, 2), (65, 43, 5, 1), (1020, 1020, 2, 2)]:
        a = torch.randn(m, n, generator=gen, device="cuda").to(td)
        a[m // 2, n // 3] = float("nan")
        for bm, bn in mp_kernel.SCHEDULES:
            got = mp_kernel.maxpool(a, r=r, s=s, bm=bm, bn=bn)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, mp_kernel.plain(a, r=r, s=s),
                                       rtol=0, atol=0, equal_nan=True)
    assert mp_kernel.LAUNCHES == before + 3 * len(mp_kernel.SCHEDULES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_kernels_match_plain(dtype):
    """On a card: the four flash-attention kernels against their plain
    versions at every compiled head dim, GQA, the three masks, a ragged
    Sq with sk_orig, a D = 128 shape whose backward tiles are all wholly
    visible (no mask evaluated) and a D = 256 one whose keys end in a
    sk_orig tail inside a tile, and an operand off 16 bytes; each kernel
    launched twice and held equal bit for bit, counting each entry point's
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    td = DTYPES[dtype][1]
    tol = 1e-4 if dtype == "float32" else 3e-2
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = dict(fa_kernel.LAUNCHES)
    cases = [(2, 8, 2, 128, 32, True, 0, 100), (2, 4, 4, 128, 32, False, 0, 0),
             (2, 6, 1, 128, 32, True, 16, 100), (1, 8, 1, 256, 64, True, 0, 0),
             (1, 8, 2, 192, 128, True, 0, 150),
             (1, 4, 1, 320, 256, True, 64, 300),
             (1, 8, 2, 512, 128, False, 0, 0),
             (1, 4, 2, 512, 256, True, 0, 437)]
    for b, h, kv, s, d, causal, window, sk_orig in cases:
        q, k, v, do = (torch.randn(b, n, s, d, generator=gen, device="cuda")
                       .mul(0.5).to(td) for n in (h, kv, kv, h))
        pkw = {"causal": causal, "window": window, "sk_orig": sk_orig}
        kw = dict(pkw, bq=32, bk=32)
        want_o, want_lse = fa_kernel.plain_fwd(q, k, v, **pkw)
        out = fa_kernel.flash_attention(q, k, v, **kw)
        o, lse = fa_kernel.flash_attention_fwd(q, k, v, **kw)
        # each forward launched twice gives the same bits
        assert torch.equal(fa_kernel.flash_attention(q, k, v, **kw), out)
        o2, lse2 = fa_kernel.flash_attention_fwd(q, k, v, **kw)
        assert torch.equal(o2, o) and torch.equal(lse2, lse)
        torch.cuda.synchronize()
        for got in (out, o):
            torch.testing.assert_close(got.float(), want_o.float(), rtol=tol,
                                       atol=tol)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
        delta = (do.float() * want_o.float()).sum(-1)
        if s == 192:          # k off 16 bytes: the wrapper copies it
            k = k.new_empty(k.numel() + 1)[1:].view(k.shape).copy_(k)
            assert k.data_ptr() % 16
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
    n = len(cases)
    assert {e: fa_kernel.LAUNCHES[e] - before[e] for e in before} == \
        {"flash_attention": 2 * n, "flash_attention_fwd": 2 * n,
         "flash_attention_bwd_dq": 2 * n, "flash_attention_bwd_dkv": 2 * n}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_blur_kernels_match_plain(dtype):
    """On a card: the blur kernels, both tiles, fused and separable, equal
    their plain version bit for bit at the JAX tests' shapes and the
    workloads' planes, counting each entry point's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    td = DTYPES[dtype][1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = dict(bl_kernel.LAUNCHES)
    shapes = [(66, 66), (128, 100), (51, 200), (1024, 1024), (384, 384)]
    for m, n in shapes:
        a = torch.randn(m, n, generator=gen, device="cuda").to(td)
        for separable in (False, True):
            for bm, bn in bl_kernel.SCHEDULES:
                got = bl_kernel.blur(a, bm=bm, bn=bn, separable=separable)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, bl_kernel.plain(a, separable=separable), rtol=0,
                    atol=0)
    n = len(shapes) * len(bl_kernel.SCHEDULES)
    assert {e: bl_kernel.LAUNCHES[e] - before[e] for e in before} == \
        {"blur_direct": n, "blur_h": n, "blur_v": n}


def _off4(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose base lies 4 bytes past an aligned
    buffer."""
    per = 4 // t.element_size()
    return t.new_empty(t.numel() + per)[per:].view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_window_kernels_match_plain_on_both_paths(dtype):
    """On a card: each blur entry and maxpool, both tiles, equal their
    plain versions bit for bit on the vector path (the workloads' planes,
    the JAX tests' ragged shapes) and on the staged path (the same planes
    4 bytes off alignment, an odd width, maxpool's other windows), a NaN
    planted in every maxpool plane; the geometry takes the path the
    alignment allows, and each entry point counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    td = DTYPES[dtype][1]
    gen = torch.Generator(device="cuda").manual_seed(1)
    before = (dict(bl_kernel.LAUNCHES), mp_kernel.LAUNCHES)
    passes = {"blur_direct": (bl_kernel.blur_direct, bl_kernel.plain),
              "blur_h": (bl_kernel.blur_h, bl_kernel.plain_h),
              "blur_v": (bl_kernel.blur_v, bl_kernel.plain_v)}
    paths = set()
    calls = 0
    for m, n in [(1024, 1024), (384, 384), (1024, 1022), (66, 66),
                 (51, 201)]:
        a = torch.randn(m, n, generator=gen, device="cuda").to(td)
        for plane in (a, _off4(a)):
            for name, (fn, plain) in passes.items():
                want = plain(plane)
                for bm, bn in bl_kernel.SCHEDULES:
                    geo = bl_kernel.geometry(
                        BLUR_PASSES[name], m, n, plane.element_size(), bm,
                        plane.data_ptr() & 15)
                    vector = plane.data_ptr() % 8 == 0 and \
                        n * plane.element_size() % 8 == 0
                    assert (geo.load_bytes > 0) == vector
                    paths.add(vector)
                    got = fn(plane, bm=bm, bn=bn)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, rtol=0, atol=0)
                    calls += 1
    assert paths == {True, False}
    n_each = calls // len(passes)
    assert {e: bl_kernel.LAUNCHES[e] - before[0][e] for e in passes} == \
        dict.fromkeys(passes, n_each)
    calls = 0
    for m, n, r, s in [(1020, 1020, 2, 2), (384, 384, 2, 2), (101, 90, 2, 2),
                       (100, 90, 3, 2), (65, 43, 5, 1), (32, 32, 4, 2)]:
        a = torch.randn(m, n, generator=gen, device="cuda").to(td)
        a[m // 2, n // 3] = float("nan")
        for plane in (a, _off4(a)):
            want = mp_kernel.plain(plane, r=r, s=s)
            for bm, bn in mp_kernel.SCHEDULES:
                geo = mp_kernel.geometry(m, n, r, s, plane.element_size(), bm,
                                         plane.data_ptr() & 15)
                assert (geo.load_bytes > 0) == (
                    r == s == 2 and plane.data_ptr() % 8 == 0
                    and n * plane.element_size() % 8 == 0)
                got = mp_kernel.maxpool(plane, r=r, s=s, bm=bm, bn=bn)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=0, atol=0,
                                           equal_nan=True)
                calls += 1
    assert mp_kernel.LAUNCHES == before[1] + calls
