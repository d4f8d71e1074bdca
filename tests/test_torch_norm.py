"""The port's norms (``models.layers.rmsnorm``/``layernorm``: one autograd
node over chunks of rows) against the JAX package's and against the plain
composition they replace, kept here as ``_plain_*``.

Both kinds and both ``impl``s, in fp32 and bf16, on numpy-drawn inputs
of 5 x 37 rows (185: not a multiple of the test's chunk of 8 rows):

* the forward against the JAX package's ``rmsnorm``/``layernorm``: fp32
  within 1e-6 of the largest magnitude, bf16 within one bf16 ulp of each
  element;
* the forward against the plain composition: to the bit;
* the gradients of x, scale and bias against autograd through the plain
  composition: fp32 within 1e-6 of each gradient's largest magnitude;
  bf16 (where the composition rounds its intermediates to bf16 and the
  Function computes in fp32) each within 2**-7 of the largest magnitude
  of the composition's gradient taken in fp64;
* the fp32 gradients against ``jax.grad`` of the reference: within 1e-5;
* on fake tensors at deepseek-67b's per-rank ``prefill_32k`` shape
  [2, 32768, 8192] bf16 under ``launch.dryrun.OpCounter``: no fp32
  storage larger than one chunk (``ROW_CHUNK_BYTES``) is made, without a
  gradient and with one (forward and backward), where the plain
  composition makes fp32 storages of the rows' full size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import layers as jlayers
from repro_torch.launch import dryrun
from repro_torch.models import layers

KINDS = ("rmsnorm", "layernorm")
IMPLS = ("f32", "bf16_apply")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SHAPE = (5, 37, 96)
TEST_CHUNK_ROWS = 8
FWD_JAX_F32 = 1e-6
GRAD_F32 = 1e-6
GRAD_JAX = 1e-5
GRAD_BF16 = 2.0 ** -7
PREFILL = (2, 32768, 8192)       # deepseek-67b prefill_32k, a rank


@pytest.fixture(autouse=True)
def _small_chunk(monkeypatch):
    """A chunk of 8 rows of the test's width, so 185 rows take 24
    chunks, the last of 1 row."""
    monkeypatch.setattr(layers, "ROW_CHUNK_BYTES",
                        TEST_CHUNK_ROWS * SHAPE[-1] * 4)


def _plain_rmsnorm(params, x, eps=1e-6, impl="f32"):
    dtype = x.dtype
    if impl == "bf16_apply":
        var = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(dtype)
        return x * inv * params["scale"].to(dtype)
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


def _mean_var(x):
    mu = x.mean(dim=-1, keepdim=True)
    return mu, (x - mu).square().mean(dim=-1, keepdim=True)


def _plain_layernorm(params, x, eps=1e-5, impl="f32"):
    dtype = x.dtype
    if impl == "bf16_apply":
        mu, var = _mean_var(x.float())
        inv = torch.rsqrt(var + eps).to(dtype)
        return ((x - mu.to(dtype)) * inv * params["scale"].to(dtype)
                + params["bias"].to(dtype))
    x = x.float()
    mu, var = _mean_var(x)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"] + params["bias"]).to(dtype)


PLAIN = {"rmsnorm": _plain_rmsnorm, "layernorm": _plain_layernorm}


def _inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    d = SHAPE[-1]
    x = (rng.standard_normal(SHAPE) * 2 + 0.5).astype(np.float32)
    params = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    if kind == "layernorm":
        params["bias"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal(SHAPE).astype(np.float32)
    return x, params, dy


def _run(fn, x, params, dy, dtype, impl):
    """(y, dx, {name: dparam}) of ``fn`` on copies of the inputs, x in
    ``dtype`` (params in fp32, or fp64 with an fp64 x)."""
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    tx = torch.tensor(x).to(dtype).requires_grad_()
    tp = {k: torch.tensor(v).to(pdt).requires_grad_()
          for k, v in params.items()}
    y = fn(tp, tx, impl=impl)
    y.backward(torch.tensor(dy).to(y.dtype))
    return y.detach(), tx.grad, {k: v.grad for k, v in tp.items()}


def _rel(got, want):
    got, want = (np.asarray(t.detach().double() if isinstance(
        t, torch.Tensor) else t, dtype=np.float64) for t in (got, want))
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_norm_forward_against_jax(kind, impl, dtype):
    x, params, _ = _inputs(kind)
    tdt, jdt = DTYPES[dtype]
    want = np.asarray(getattr(jlayers, kind)(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x).astype(jdt), impl=impl).astype(jnp.float32),
        dtype=np.float64)
    with torch.no_grad():
        got = getattr(layers, kind)(
            {k: torch.tensor(v) for k, v in params.items()},
            torch.tensor(x).to(tdt), impl=impl).double().numpy()
    if dtype == "float32":
        assert _rel(got, want) <= FWD_JAX_F32
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_norm_forward_equals_plain_composition(kind, impl, dtype, grad):
    """To the bit, with and without a gradient (the Function's forward
    and the direct path without one), over chunks of 8 rows."""
    x, params, _ = _inputs(kind, seed=1)
    tdt = DTYPES[dtype][0]
    tx = torch.tensor(x).to(tdt)
    tp = {k: torch.tensor(v).requires_grad_(grad) for k, v in params.items()}
    with torch.set_grad_enabled(grad):
        got = getattr(layers, kind)(tp, tx, impl=impl)
        want = PLAIN[kind](tp, tx, impl=impl)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert got.requires_grad == grad


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_norm_grads_against_plain_composition(kind, impl, dtype):
    x, params, dy = _inputs(kind, seed=2)
    tdt = DTYPES[dtype][0]
    y, dx, dp = _run(getattr(layers, kind), x, params, dy, tdt, impl)
    assert dx.dtype == tdt and all(g.dtype == torch.float32
                                   for g in dp.values())
    if dtype == "float32":
        _, want_dx, want_dp = _run(PLAIN[kind], x, params, dy, tdt, impl)
        bound = GRAD_F32
    else:
        # the composition in fp64 from the same bf16 input
        xb = torch.tensor(x).to(tdt).double().numpy()
        _, want_dx, want_dp = _run(PLAIN[kind], xb, params, dy,
                                   torch.float64, impl)
        bound = GRAD_BF16
    assert _rel(dx, want_dx) <= bound
    for k in dp:
        assert _rel(dp[k], want_dp[k]) <= bound, k


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_norm_grads_against_jax(kind, impl):
    x, params, dy = _inputs(kind, seed=3)
    fn = getattr(jlayers, kind)

    def loss(p, xx):
        return jnp.sum(fn(p, xx, impl=impl) * jnp.asarray(dy))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_dp, want_dx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    _, dx, dp = _run(getattr(layers, kind), x, params, dy, torch.float32,
                     impl)
    assert _rel(dx, want_dx) <= GRAD_JAX
    for k in dp:
        assert _rel(dp[k], want_dp[k]) <= GRAD_JAX, k


class _Fp32Storages(dryrun.OpCounter):
    """An ``OpCounter`` that keeps the largest fp32 storage any op made."""

    def __init__(self):
        super().__init__()
        self.largest_f32 = 0

    def track(self, tensors) -> None:
        for t in dryrun._tensors(tensors):
            if t.dtype == torch.float32:
                self.largest_f32 = max(self.largest_f32,
                                       t.untyped_storage().nbytes())
        super().track(tensors)


def _largest_f32(fn, kind, impl, grad):
    with FakeTensorMode():
        x = torch.empty(PREFILL, dtype=torch.bfloat16).requires_grad_(grad)
        d = PREFILL[-1]
        params = {"scale": torch.ones(d).requires_grad_(grad)}
        if kind == "layernorm":
            params["bias"] = torch.zeros(d).requires_grad_(grad)
        counter = _Fp32Storages()
        with counter, torch.set_grad_enabled(grad):
            y = fn(params, x, impl=impl)
            if grad:
                y.backward(torch.ones_like(y))
    return counter.largest_f32


@pytest.mark.parametrize("grad", [False, True], ids=["prefill", "train"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_norm_fp32_storages_at_most_a_chunk(monkeypatch, kind, impl, grad):
    monkeypatch.setattr(layers, "ROW_CHUNK_BYTES", 64 << 20)
    largest = _largest_f32(getattr(layers, kind), kind, impl, grad)
    assert 0 < largest <= layers.ROW_CHUNK_BYTES, largest
    # the plain composition's fp32 [rows, d] buffers
    plain = _largest_f32(PLAIN[kind], kind, impl, grad)
    assert plain == PREFILL[0] * PREFILL[1] * PREFILL[-1] * 4, plain


def test_row_chunks_cover_the_rows(monkeypatch):
    monkeypatch.setattr(layers, "ROW_CHUNK_BYTES", 3 * 4 * 10)
    assert layers.row_chunks(7, 10) == [(0, 3), (3, 6), (6, 7)]
    assert layers.row_chunks(0, 10) == [(0, 0)]
    assert layers.row_chunks(2, 1000) == [(0, 1), (1, 2)]
