"""repro_torch kernels: the port's matmul/matvec ops against the JAX
package's Pallas kernels (interpret mode) and its ref oracles, on the same
numpy-drawn inputs; the backend rule; the build's failure modes; and, on a
card, the CUDA kernels against their plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import ops as jmm_ops, ref as jmm_ref
from repro.kernels.matvec import ops as jmv_ops, ref as jmv_ref
from repro_torch.kernels import Aval, build, on_cuda, resolve_device
from repro_torch.kernels.matmul import matmul as mm_kernel, ops as mm_ops
from repro_torch.kernels.matvec import matvec as mv_kernel, ops as mv_ops

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


@pytest.mark.parametrize("kernel", ["matmul", "matvec"])
def test_abstract_params_errors_match(kernel):
    """Same shape hooks, same contraction-dim ValueError, in both packages."""
    jops, tops, bad, good = {
        "matmul": (jmm_ops, mm_ops, ((4, 5), (6, 3)), ((4, 5), (5, 3))),
        "matvec": (jmv_ops, mv_ops, ((4, 5), (6,)), ((4, 5), (5,))),
    }[kernel]
    avals = [Aval(s, "float32") for s in bad]
    with pytest.raises(ValueError) as jerr:
        jops.abstract_params(*avals)
    with pytest.raises(ValueError) as terr:
        tops.abstract_params(*avals)
    assert str(terr.value) == str(jerr.value)
    ok = [Aval(s, "float32") for s in good]
    assert tops.abstract_params(*ok) == jops.abstract_params(*ok)
    assert tuple(tops.out_aval(*ok).shape) == tuple(jops.out_aval(*ok).shape)


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


def test_build_is_content_keyed_and_failures_raise(monkeypatch, tmp_path):
    assert build.library_path("matmul") == build.library_path("matmul")
    assert build.library_path("matmul").name.startswith("libmatmul-")
    assert build.library_path("matmul") != build.library_path("matvec")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    # a compiler that fails makes build() raise, never return quietly
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed for matmul.cu"):
        build.build(["matmul"])
    assert not list(tmp_path.glob("*.so"))


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
    assert mm_kernel.LAUNCHES == before + 3 * len(mm_kernel.SCHEDULES)
    before = mv_kernel.LAUNCHES
    for m, k in [(257, 513), (1, 5), (1024, 1024)]:
        a = torch.randn(m, k, generator=gen, device="cuda").to(td)
        x = torch.randn(k, generator=gen, device="cuda").to(td)
        got = mv_kernel.matvec(a, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), mv_kernel.plain(a, x).float(),
                                   rtol=tol, atol=tol)
    assert mv_kernel.LAUNCHES == before + 3
