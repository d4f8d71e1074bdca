"""repro_torch kernels: the port's matmul/matvec ops against the JAX
package's Pallas kernels (interpret mode) and its ref oracles, and its
conv2d/maxpool/blur ops against the JAX ref oracles and jnp paths (the
Pallas conv2d, maxpool and blur kernels need ``pl.load``, which jax 0.9.0
lacks), on the same numpy-drawn inputs; the backend rule; the build's
failure modes; and, on a card, the CUDA kernels against their plain
versions."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.blur import ops as jbl_ops, ref as jbl_ref
from repro.kernels.conv2d import ops as jmc_ops, ref as jmc_ref
from repro.kernels.matmul import ops as jmm_ops, ref as jmm_ref
from repro.kernels.matvec import ops as jmv_ops, ref as jmv_ref
from repro.kernels.maxpool import ops as jmp_ops, ref as jmp_ref
from repro_torch.kernels import Aval, build, cudnn_fp32, on_cuda, \
    resolve_device
from repro_torch.kernels.blur import ops as bl_ops, ref as bl_ref
from repro_torch.kernels.conv2d import conv2d as mc_kernel, ops as mc_ops
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
    rng = np.random.RandomState(1)
    ja, ta = _pair(rng, (40, 30), "float32")
    np.testing.assert_allclose(bl_ops.blur(ta, use_kernel=False).numpy(),
                               np.asarray(jbl_ops.blur(ja, use_kernel=False)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(bl_ref.blur(ta).numpy(),
                                  bl_ops.blur(ta, use_kernel=False).numpy())
    with pytest.raises(NotImplementedError, match="Queue 2 item 5"):
        bl_ops.blur(ta)
    assert list(bl_ops.HOST_SCHEDULES) == list(jbl_ops.HOST_SCHEDULES)


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
                                    "blur"])
def test_abstract_params_errors_match(kernel):
    """Same shape hooks, same ValueError on a bad operand, in both
    packages."""
    jops, tops, bad, good, kw = {
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
    assert torch.equal(mp_ops.maxpool(torch.zeros(30, 40).t(), r=2, s=2),
                       torch.zeros(20, 15))


def test_build_is_content_keyed_and_failures_raise(monkeypatch, tmp_path):
    assert build.library_path("matmul") == build.library_path("matmul")
    assert build.library_path("matmul").name.startswith("libmatmul-")
    assert build.library_path("matmul") != build.library_path("matvec")
    assert set(build.SOURCES) == {"matmul", "matvec", "conv2d", "maxpool"}
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
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
    assert mv_kernel.LAUNCHES == before + 3
    before = mc_kernel.LAUNCHES
    for m, n, r in [(100, 90, 5), (41, 77, 7), (1022, 1022, 3)]:
        a = torch.randn(m, n, generator=gen, device="cuda").to(td)
        w = torch.randn(r, r, generator=gen, device="cuda").to(td)
        for bm, bn in mc_kernel.SCHEDULES:
            got = mc_kernel.conv2d(a, w, bm=bm, bn=bn)
            torch.cuda.synchronize()
            # the plain version's tap order and roundings: equal bit for bit
            torch.testing.assert_close(got, mc_kernel.plain(a, w), rtol=0,
                                       atol=0)
    assert mc_kernel.LAUNCHES == before + 3 * len(mc_kernel.SCHEDULES)
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
