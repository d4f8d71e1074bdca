#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build   — compiles every hand-written kernel from ``src/repro_torch/csrc``
   (matmul, matvec, conv2d, maxpool) with ``nvcc``, one process per source,
   all at once, and prints the time and the compiler's register and
   shared-memory report.
3. kernels — each kernel at each schedule, fp32 and bf16, against its plain
   PyTorch version on the card, over the ragged shape grid of the JAX
   package's kernel tests and the workloads' shapes: matmul and matvec at
   1e-4 (fp32) and 2e-2 (bf16), relative to the output's largest magnitude
   above 1 for ``mixed_dag``'s chained products; conv2d and maxpool
   exactly (a maxpool NaN case included); then the five blur host
   schedules against the plain blur at 1e-5.
4. main path — two paths, each over a fresh tuning cache with the card's
   fingerprint and its own dispatcher over the port's registry, the launch
   counters zeroed just before each and read just after.  Slice 1: eager
   ``ops.matmul``/``ops.matvec`` on cold shapes (every variant measured,
   each model fitted), then the ``large`` ``mlp_block`` and
   ``decode_microbatch`` workloads traced, compiled (sequential) and run.
   Slice 2: eager ``ops.matmul`` (``mixed_dag``'s shape among them),
   ``ops.conv2d``, ``ops.maxpool`` and ``ops.blur`` on cold shapes, then
   ``large`` ``image_pipeline`` and ``mixed_dag``.  Every output is held
   against its workload's reference within 1e-5 (relative to the output's
   largest magnitude where that exceeds 1), and every hand kernel a path
   runs must have launched in it.  cuDNN's TF32 default is left as PyTorch
   sets it: the port pins fp32 itself.
5. times   — each kernel at the workloads' shapes, timed with CUDA events
   over operand sets that together exceed the 50 MB L2 cache (the workloads
   read each operand once), beside its plain version, the one PyTorch call
   that computes the same function (``library_ms``) and its bound from the
   card's data sheet; the blur schedules' times once, for information.

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

FP32_TOL = 1e-4       # the JAX package's kernel-test tolerance for fp32
BF16_TOL = 2e-2       # and for bf16 (rounding of the bf16 result)
PARITY_TOL = 1e-5     # the workload suite's end-to-end budget

# (m, n, k) of C[m,n] = A[m,k] @ B[k,n]; (m, k) of y = A[m,k] @ x[k]
RAGGED_MM = [(64, 64, 64), (100, 70, 130), (33, 257, 65), (1, 1, 1),
             (128, 1, 128)]
RAGGED_MV = [(64, 64), (100, 70), (257, 513), (1, 5)]
WORK_MM = [(256, 2048, 1024), (256, 1024, 2048)]     # mlp_block large
WORK_MV = [(1024, 1024)]                               # decode_microbatch large
DAG_N, DAG_WIDTH = 384, 6                              # mixed_dag large
WORK_MM_DAG = [(DAG_N, DAG_N, DAG_N)]
# eager warm-up shapes in the paper's Table 2 range, the workloads' included
WARM_MM = WORK_MM + [(128, 512, 512), (512, 1024, 256), (64, 256, 1024),
                     (1024, 1024, 1024), (384, 640, 768), (32, 64, 128)]
WARM_MV = WORK_MV + [(512, 1024), (1024, 512), (256, 256), (768, 384),
                     (128, 1024), (2048, 1024)]
# (m, n, r) of a [m,n] (x) w [r,r]; (m, n, r, s) of an r x r pool at stride s
RAGGED_MC = [(64, 64, 3), (100, 90, 5), (41, 77, 7)]
RAGGED_MP = [(64, 64, 2, 2), (100, 90, 3, 2), (65, 43, 5, 1), (32, 32, 4, 2)]
WORK_MC = [(1022, 1022, 3)]                            # image_pipeline large
WORK_MP = [(1020, 1020, 2, 2), (384, 384, 2, 2)]       # image, mixed_dag
WORK_BLUR = [(1024, 1024), (384, 384)]                 # image, mixed_dag
# eager warm-up shapes in the paper's ranges (core/features.py mc_sample,
# mp_sample, blur_sample), the workloads' included; 2 variants x 7 shapes
# exceed min_rows_to_fit = 12, as do 5 blur variants x 4 shapes
WARM_MC = WORK_MC + [(512, 512, 3), (256, 768, 5), (1000, 300, 7),
                     (128, 128, 3), (700, 900, 5), (64, 1024, 3)]
WARM_MP = WORK_MP + [(512, 512, 3, 2), (1000, 700, 2, 1), (256, 256, 4, 2),
                     (800, 600, 5, 1), (100, 900, 3, 2)]
WARM_BLUR = WORK_BLUR + [(512, 1536), (2048, 256)]
# the slice-2 path's own matmul cold shapes: 3 variants x 5 shapes exceed
# min_rows_to_fit
WARM_MM_DAG = WORK_MM_DAG + [(128, 512, 512), (384, 640, 768), (32, 64, 128),
                             (512, 1024, 256)]

# fp32 FLOP/s outside the tensor cores and device-memory bytes/s, from
# NVIDIA's data sheets, by a fragment of the name nvidia-smi reports
# (first match wins: the plain "H100" is the SXM part)
CARD_PEAKS = (("H100 PCIe", 51e12, 2.0e12), ("H100 NVL", 60e12, 3.9e12),
              ("H100", 67e12, 3.35e12), ("H200", 67e12, 4.8e12))
L2_BYTES = 50 * 2 ** 20


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> tuple:
    for fragment, flops, bandwidth in CARD_PEAKS:
        if fragment in name:
            return flops, bandwidth
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def phase_build(build) -> None:
    t0 = time.perf_counter()
    built = build.build()
    wall = time.perf_counter() - t0
    for name, (seconds, report) in built.items():
        print(f"build: {name}.cu {seconds:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {len(built)} libraries in {wall:.2f} s wall "
          f"({'all cached' if not built else 'parallel nvcc'})")


def _operands(shapes, workload: bool, device, gen) -> tuple:
    """Standard-normal operands for the ragged grid (as the JAX package's
    kernel tests draw them); for the workloads' shapes, the values the main
    path feeds the kernel: uniform in [-0.5, 0.5), the contraction operand
    scaled by 1/sqrt(k) (``workloads.library._weight``).  At k=2048 two fp32
    summation orders of standard-normal products already differ by more
    than 1e-4 in absolute terms, while the workloads keep every value O(1)
    precisely so that fp32 parity holds."""
    if not workload:
        return tuple(torch.randn(*s, generator=gen, device=device)
                     for s in shapes)
    lhs, rhs = (torch.rand(*s, generator=gen, device=device) - 0.5
                for s in shapes)
    return lhs, rhs / rhs.shape[0] ** 0.5


def _dag_products(plain, device, gen) -> list:
    """The (lhs, rhs) of each of ``mixed_dag``'s matmuls at ``large``,
    drawn as the workload draws them (a, b uniform in [-0.5, 0.5), the
    weights scaled by 1/sqrt(n)) and chained through the plain version in
    fp32: the root a @ b, the branches root @ w, then the join chain."""
    a, b, *ws = (torch.rand(DAG_N, DAG_N, generator=gen, device=device)
                 - 0.5 for _ in range(2 + DAG_WIDTH))
    ws = [w / DAG_N ** 0.5 for w in ws]
    root = plain(a, b)
    pairs = [(a, b)] + [(root, w) for w in ws]
    join, *branches = (plain(root, w) for w in ws)
    for br in branches:
        pairs.append((join, br))
        join = plain(join, br)
    return pairs


def _check_mm_mv(mm, mv, device, gen, report, worst) -> None:
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).removeprefix("torch.")
        for m, n, k in RAGGED_MM + WORK_MM:
            a, b = (t.to(dtype) for t in _operands(
                [(m, k), (k, n)], (m, n, k) in WORK_MM, device, gen))
            want = mm.plain(a, b).float()
            for bm, bn, bk in mm.SCHEDULES:
                got = mm.matmul(a, b, bm=bm, bn=bn, bk=bk)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                torch.testing.assert_close(
                    got.float(), want, rtol=tol, atol=tol,
                    msg=lambda s: f"matmul tile {bm} {dtype} {(m, n, k)}: {s}")
                key = (f"matmul_t{bm}", dname)
                report[key] = max(report.get(key, 0.0), err)
                if dtype == torch.float32 and (m, n, k) in WORK_MM:
                    worst["matmul"] = max(worst["matmul"], err)
        for m, k in RAGGED_MV + WORK_MV:
            # y = A x with A the contraction operand: x first, A scaled
            x, a_t = _operands([(k,), (k, m)], (m, k) in WORK_MV, device,
                               gen)
            a = a_t.t().contiguous().to(dtype)
            x = x.to(dtype)
            want = mv.plain(a, x).float()
            got = mv.matvec(a, x)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            torch.testing.assert_close(
                got.float(), want, rtol=tol, atol=tol,
                msg=lambda s: f"matvec {dtype} {(m, k)}: {s}")
            key = ("matvec", dname)
            report[key] = max(report.get(key, 0.0), err)
            if dtype == torch.float32 and (m, k) in WORK_MV:
                worst["matvec"] = max(worst["matvec"], err)
        # mixed_dag's products: absolute error over the output's largest
        # magnitude above 1 (the join's operands reach about 1e5)
        for lhs, rhs in _dag_products(mm.plain, device, gen):
            a, b = lhs.to(dtype), rhs.to(dtype)
            want = mm.plain(a, b).float()
            scale = max(1.0, want.abs().max().item())
            for bm, bn, bk in mm.SCHEDULES:
                got = mm.matmul(a, b, bm=bm, bn=bn, bk=bk)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got.float(), want, rtol=tol, atol=tol * scale,
                    msg=lambda s: f"matmul tile {bm} {dtype} mixed_dag "
                                  f"product, scale {scale:.3g}: {s}")
                err = (got.float() - want).abs().max().item() / scale
                key = (f"matmul_t{bm} mixed_dag relative", dname)
                report[key] = max(report.get(key, 0.0), err)


def _plane(shape, workload: bool, device, gen) -> torch.Tensor:
    """Standard-normal for the ragged grid; for the workloads' shapes,
    uniform in [-0.5, 0.5) as the workloads draw their planes and taps."""
    if workload:
        return torch.rand(*shape, generator=gen, device=device) - 0.5
    return torch.randn(*shape, generator=gen, device=device)


def _check_conv_pool(mc, mp, device, gen, report, worst) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        # the kernel rounds each product before the add, in the plain
        # version's tap order, and rounds the sum to bf16 as it does
        for m, n, r in RAGGED_MC + WORK_MC:
            work = (m, n, r) in WORK_MC
            a = _plane((m, n), work, device, gen).to(dtype)
            w = _plane((r, r), work, device, gen).to(dtype)
            want = mc.plain(a, w).float()
            for bm, bn in mc.SCHEDULES:
                got = mc.conv2d(a, w, bm=bm, bn=bn)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                torch.testing.assert_close(
                    got.float(), want, rtol=0, atol=0,
                    msg=lambda s: f"conv2d tile {bm} {dtype} {(m, n, r)}: {s}")
                key = (f"conv2d_t{bm}", dname)
                report[key] = max(report.get(key, 0.0), err)
                if dtype == torch.float32 and work:
                    worst["conv2d"] = max(worst["conv2d"], err)
        # the last case plants a NaN, which must win its windows as in
        # jnp.maximum and F.max_pool2d
        cases = [(shape, False) for shape in RAGGED_MP + WORK_MP] \
            + [((100, 90, 3, 2), True)]
        for (m, n, r, s), nan in cases:
            a = _plane((m, n), (m, n, r, s) in WORK_MP, device, gen).to(dtype)
            if nan:
                a[37, 41] = float("nan")
            want = mp.plain(a, r=r, s=s)
            for bm, bn in mp.SCHEDULES:
                got = mp.maxpool(a, r=r, s=s, bm=bm, bn=bn)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, rtol=0, atol=0, equal_nan=True,
                    msg=lambda x: f"maxpool tile {bm} {dtype} "
                                  f"{(m, n, r, s)}: {x}")
                err = (got.float() - want.float()).nan_to_num().abs().max()
                key = (f"maxpool_t{bm}", dname)
                report[key] = max(report.get(key, 0.0), err.item())
                if dtype == torch.float32 and (m, n, r, s) in WORK_MP:
                    worst["maxpool"] = max(worst["maxpool"], err.item())
            if nan and not torch.isnan(want).any():
                raise RuntimeError("maxpool NaN case: the plain version "
                                   "dropped the NaN")


def _check_blur(device, gen) -> None:
    """The five host schedules against the plain blur, as the workloads
    feed them (uniform planes), at the suite's 1e-5."""
    from repro_torch.kernels.blur import ops, ref
    for m, n in WORK_BLUR:
        a = _plane((m, n), True, device, gen)
        want = ref.blur(a)
        errs = {}
        for name, fn in ops.HOST_SCHEDULES.items():
            got = fn(a)
            torch.testing.assert_close(
                got, want, rtol=PARITY_TOL, atol=PARITY_TOL,
                msg=lambda x: f"blur {name} {(m, n)}: {x}")
            errs[name] = (got - want).abs().max().item()
        print(f"kernels: blur schedules at [{m},{n}] vs plain, max abs err: "
              + json.dumps(errs))


def phase_kernels(K, device) -> dict:
    """Every kernel at every schedule against its plain version; returns
    kernel -> worst abs error at the main path's shapes in fp32."""
    gen = torch.Generator(device=device).manual_seed(0)
    worst = {name: 0.0 for name in K}
    report = {}
    _check_mm_mv(K["matmul"], K["matvec"], device, gen, report, worst)
    _check_conv_pool(K["conv2d"], K["maxpool"], device, gen, report, worst)
    print("kernels: " + json.dumps(
        {f"{k}/{d}": e for (k, d), e in sorted(report.items())}))
    print(f"kernels: all within tolerance of their plain versions (conv2d "
          f"and maxpool exact, a NaN case included); launches while "
          f"checking: "
          + json.dumps({name: mod.LAUNCHES for name, mod in K.items()}))
    _check_blur(device, gen)
    return worst


def _warm_slice1(ops, device, gen) -> None:
    for m, n, k in WARM_MM:
        ops.matmul(torch.randn(m, k, generator=gen, device=device),
                   torch.randn(k, n, generator=gen, device=device))
    for m, k in WARM_MV:
        ops.matvec(torch.randn(m, k, generator=gen, device=device),
                   torch.randn(k, generator=gen, device=device))


def _warm_slice2(ops, device, gen) -> None:
    for m, n, k in WARM_MM_DAG:
        ops.matmul(torch.randn(m, k, generator=gen, device=device),
                   torch.randn(k, n, generator=gen, device=device))
    for m, n, r in WARM_MC:
        ops.conv2d(torch.randn(m, n, generator=gen, device=device),
                   torch.randn(r, r, generator=gen, device=device))
    for m, n, r, s in WARM_MP:
        ops.maxpool(torch.randn(m, n, generator=gen, device=device), r=r, s=s)
    for m, n in WARM_BLUR:
        ops.blur(torch.randn(m, n, generator=gen, device=device))


# (label, hand kernels that must launch, models that must be fitted, eager
# warm-up, workloads driven at ``large``)
PATHS = (
    ("slice 1", ("matmul", "matvec"), ("matmul", "matvec"), _warm_slice1,
     ("mlp_block", "decode_microbatch")),
    ("slice 2", ("matmul", "conv2d", "maxpool"),
     ("matmul", "conv2d", "maxpool", "blur"), _warm_slice2,
     ("image_pipeline", "mixed_dag")),
)


def _check_outputs(name, outs, refs) -> float:
    """Each output within PARITY_TOL of its reference: absolute for
    outputs of magnitude up to 1, relative to the output's largest
    magnitude above that.  ``mixed_dag``'s join of six chained 384-deep
    products reaches about 1.8e5, where two correct fp32 summation orders
    already differ by far more than 1e-5 absolute."""
    if len(outs) != len(refs):
        raise RuntimeError(f"{name}: {len(outs)} outputs, {len(refs)} "
                           "references")
    err = 0.0
    for o, r in zip(outs, refs):
        if not torch.isfinite(o).all():
            raise RuntimeError(f"{name}: non-finite output")
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(o, r, rtol=PARITY_TOL,
                                   atol=PARITY_TOL * scale)
        err = max(err, (o - r).abs().max().item() / scale)
    return err


def _device_busy_s(fn) -> float:
    """Seconds the card spends in kernels during one call of ``fn``, from
    the profiler's CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6


def _run_workload(name, disp, device) -> None:
    """Trace, compile and run the ``large`` preset twice (the first call
    carries one-off costs such as library plans for new shapes), check
    both runs' outputs, and print the second run's breakdown and the
    card's busy share over a third, profiled run."""
    from repro_torch.workloads import get_workload

    built = get_workload(name).build("large", registry=disp.registry,
                                     device=device)
    compiled = built.program.compile(devices=disp, bindings=built.bindings)
    refs = built.reference()
    walls = []
    for _ in range(2):
        before = len(disp.selections)
        t0 = time.perf_counter()
        outs = compiled()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        outs = outs if isinstance(outs, tuple) else (outs,)
        err = _check_outputs(name, outs, refs)
    sels = list(disp.selections)[before:]
    chosen = [f"{t.name}={s.chosen}/{s.mode}/{s.kernel_s * 1e6:.0f}us"
              for t, s in zip(compiled.order, sels)]
    decide = sum(s.overhead_s for s in sels)
    execute = sum(s.kernel_s for s in sels)
    busy = _device_busy_s(compiled)
    print(f"main: {name} large: {len(compiled.order)} nodes, "
          f"predicted makespan {compiled.makespan * 1e3:.3f} ms, "
          f"first run {walls[0] * 1e3:.3f} ms, second run "
          f"{walls[1] * 1e3:.3f} ms (dispatch decisions "
          f"{decide * 1e3:.3f} ms, variant calls to synchronise "
          f"{execute * 1e3:.3f} ms; card busy {busy * 1e3:.3f} ms in a "
          f"profiled run, {100 * busy / walls[1]:.1f}% of the second "
          f"run), max abs err vs reference over max(1, |ref|) {err:.3g} "
          f"(budget {PARITY_TOL})")
    print(f"main: {name} second run, node=variant/mode/call to synchronise: "
          f"{' '.join(chosen)}")


def phase_main_path(K, device) -> dict:
    """Each path through its own dispatcher over a fresh cache; returns
    path label -> kernel -> launches in that path's run."""
    from repro_torch.api import ops, use_dispatcher
    from repro_torch.runtime import (Dispatcher, TuningCache,
                                     current_fingerprint, default_registry)

    gen = torch.Generator(device=device).manual_seed(1)
    by_path = {}
    with tempfile.TemporaryDirectory() as root:
        fp = current_fingerprint("cuda")
        print(f"main: fingerprint {fp.key}")
        for label, hand, fitted, warm, workloads in PATHS:
            cache_dir = str(Path(root) / label.replace(" ", "_"))
            disp = Dispatcher(default_registry(), TuningCache(cache_dir, fp))
            for mod in K.values():
                mod.LAUNCHES = 0
            t0 = time.perf_counter()
            with use_dispatcher(disp):
                warm(ops, device, gen)
            print(f"main: {label} eager warm-up "
                  f"{time.perf_counter() - t0:.2f} s, {disp.n_measured} "
                  f"measured, {disp.n_gated} gated, {disp.n_predicted} "
                  f"predicted")
            for s in list(disp.selections):
                if s.measured_s:
                    times = ", ".join(f"{v} {t * 1e6:.1f} us"
                                      for v, t in s.measured_s.items())
                    print(f"main: {s.mode} {s.kernel} {s.params}: {times}")
            for kernel in fitted:
                entry = disp.cache.entry(kernel)
                if entry.model is None:
                    raise RuntimeError(f"no model fitted for {kernel}")
                print(f"main: {kernel} model fitted on {entry.n_rows} rows, "
                      f"fit MAPE {entry.fit_mape:.1f}%")
            for name in workloads:
                _run_workload(name, disp, device)
            counts = {name: mod.LAUNCHES for name, mod in K.items()}
            print(f"main: {label} hand-kernel launches: {counts}")
            for kernel in hand:
                if counts[kernel] <= 0:
                    raise RuntimeError(f"{kernel}: the {label} path never "
                                       "launched its hand kernel")
            by_path[label] = counts
    return by_path


def _time_ms(fn, operand_sets, reps: int = 3) -> float:
    """Milliseconds per call, CUDA events over ``reps`` sweeps of
    ``operand_sets`` after one warm sweep."""
    for ops_ in operand_sets:
        fn(*ops_)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for ops_ in operand_sets:
            fn(*ops_)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(operand_sets))


def _operand_sets(shapes, nbytes, device, gen) -> list:
    """Enough distinct operand sets to exceed the L2 cache together."""
    count = max(2, -(-2 * L2_BYTES // nbytes))
    return [tuple(torch.randn(*s, generator=gen, device=device)
                  for s in shapes) for _ in range(count)]


def _best(fns, sets) -> dict:
    """Each function timed twice, in turns; the lower of the two."""
    times = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            times[name].append(_time_ms(fn, sets))
    return {name: min(t) for name, t in times.items()}


def _device_ms(fn, sets):
    """Milliseconds per call that the card spends in kernels, from the
    profiler over one sweep — the call's time without the host's launch
    cost.  None when the profiler records no device activity."""
    busy = _device_busy_s(lambda: [fn(*ops_) for ops_ in sets])
    return busy * 1e3 / len(sets) if busy > 0 else None


def _fmt_us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def _measure(label, fns, sets, flops, nbytes, card) -> dict:
    """Time each function (events and device time) and print one line
    with the bound of the work: the larger of operations over the fp32
    peak and bytes (each input read once, the output written once) over
    the memory rate."""
    flops_peak, bandwidth = card_peaks(card)
    t = _best(fns, sets)
    dev = {name: _device_ms(fn, sets) for name, fn in fns.items()}
    bound_by = "operations" if flops / flops_peak >= nbytes / bandwidth \
        else "bytes"
    bound = max(flops / flops_peak, nbytes / bandwidth) * 1e3
    print(f"times: {label}: " + ", ".join(
        f"{v} {ms * 1e3:.1f} us (device {_fmt_us(dev[v])})"
        for v, ms in t.items())
        + f"; bound {bound * 1e3:.2f} us ({bound_by}); {card}")
    return {"ms": t, "device_ms": dev, "bound_ms": bound,
            "bound_by": bound_by}


def _record(name, schedule, shape, res, worst, by_path) -> dict:
    """One kernel's record; ``launches`` sums the paths' runs, and
    ``launches_by_path`` gives each path's own count."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": {"matmul": "src/repro/kernels/matmul/matmul.py:17",
                         "matvec": "src/repro/kernels/matvec/matvec.py:16",
                         "conv2d": "src/repro/kernels/conv2d/conv2d.py:19",
                         "maxpool": "src/repro/kernels/maxpool/maxpool.py:15",
                         }[name],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": worst[name],
            "ms": res["ms"][schedule], "plain_ms": res["ms"]["plain"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["ms"]["library"],
            "device_ms": res["device_ms"][schedule],
            "schedule": schedule, "shape": list(shape), "dtype": "float32"}


def _times_mm_mv(mm, mv, device, gen, card, worst, by_path) -> list:
    records = []
    for idx, (m, n, k) in enumerate(WORK_MM + WORK_MM_DAG):
        nbytes = 4 * (m * k + k * n + m * n)
        fns = {f"pallas_{bm}": (lambda a, b, _s=(bm, bn, bk):
                                mm.matmul(a, b, bm=_s[0], bn=_s[1], bk=_s[2]))
               for bm, bn, bk in mm.SCHEDULES}
        fns.update(plain=mm.plain, library=torch.matmul)
        res = _measure(f"matmul fp32 [{m},{k}]x[{k},{n}]", fns,
                       _operand_sets([(m, k), (k, n)], nbytes, device, gen),
                       2.0 * m * n * k, nbytes, card)
        if idx == 0:
            best = min((v for v in fns if v.startswith("pallas")),
                       key=res["ms"].get)
            records.append(_record("matmul", best, (m, n, k), res, worst,
                                   by_path))
    for m, k in WORK_MV:
        nbytes = 4 * (m * k + k + m)
        res = _measure(f"matvec fp32 [{m},{k}]x[{k}]",
                       {"pallas_128": mv.matvec, "plain": mv.plain,
                        "library": torch.mv},
                       _operand_sets([(m, k), (k,)], nbytes, device, gen),
                       2.0 * m * k, nbytes, card)
        records.append(_record("matvec", "pallas_128", (m, k), res, worst,
                               by_path))
    return records


def _times_conv_pool(mc, mp, device, gen, card, worst, by_path) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import cudnn_fp32

    records = []
    for m, n, r in WORK_MC:
        om, on = m - r + 1, n - r + 1
        nbytes = 4 * (m * n + r * r + om * on)
        fns = {f"pallas_{bm}": (lambda a, w, _b=bm: mc.conv2d(a, w, bm=_b,
                                                              bn=_b))
               for bm, _ in mc.SCHEDULES}
        fns.update(plain=mc.plain, library=lambda a, w: F.conv2d(
            a[None, None], w[None, None])[0, 0])
        with cudnn_fp32():            # the library call in full fp32
            res = _measure(f"conv2d fp32 [{m},{n}] r={r}", fns,
                           _operand_sets([(m, n), (r, r)], nbytes, device,
                                         gen),
                           2.0 * om * on * r * r, nbytes, card)
        records.append(_record("conv2d", "pallas_32", (m, n, r), res, worst,
                               by_path))
    for idx, (m, n, r, s) in enumerate(WORK_MP):
        om, on = (m - r) // s + 1, (n - r) // s + 1
        nbytes = 4 * (m * n + om * on)
        fns = {f"pallas_{bm}": (lambda a, _b=bm: mp.maxpool(
                   a, r=r, s=s, bm=_b, bn=_b)) for bm, _ in mp.SCHEDULES}
        fns.update(plain=lambda a: mp.plain(a, r=r, s=s),
                   library=lambda a: F.max_pool2d(a[None, None], r, s)[0, 0])
        res = _measure(f"maxpool fp32 [{m},{n}] r={r} s={s}", fns,
                       _operand_sets([(m, n)], nbytes, device, gen),
                       float(om * on * r * r), nbytes, card)
        if idx == 0:
            records.append(_record("maxpool", "pallas_32", (m, n, r, s), res,
                                   worst, by_path))
    return records


def _times_blur(device, gen) -> None:
    """The host schedules' times, for information (they are PyTorch's own
    kernels, not the port's)."""
    from repro_torch.kernels.blur import ops

    for m, n in WORK_BLUR:
        sets = _operand_sets([(m, n)], 4 * m * n, device, gen)
        t = _best(ops.HOST_SCHEDULES, sets)
        print(f"times: blur schedules fp32 [{m},{n}]: " + ", ".join(
            f"{v} {ms * 1e3:.1f} us" for v, ms in t.items()))


def phase_times(K, device, card: str, worst: dict, by_path: dict) -> list:
    gen = torch.Generator(device=device).manual_seed(2)
    records = _times_mm_mv(K["matmul"], K["matvec"], device, gen, card,
                           worst, by_path)
    records += _times_conv_pool(K["conv2d"], K["maxpool"], device, gen, card,
                                worst, by_path)
    _times_blur(device, gen)
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.conv2d import conv2d as mc
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.matvec import matvec as mv
    from repro_torch.kernels.maxpool import maxpool as mp

    # TF32 stays at PyTorch's defaults (off for matmul, on for cuDNN): the
    # port pins fp32 around its own cuDNN calls
    K = {"matmul": mm, "matvec": mv, "conv2d": mc, "maxpool": mp}
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    line = card_line()
    name = torch.cuda.get_device_name(0)
    print(line)                  # the card's name and power limit
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    phase_build(build)
    worst = phase_kernels(K, device)
    by_path = phase_main_path(K, device)
    records = phase_times(K, device, name, worst, by_path)
    print(line)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
