#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build   — compiles every hand-written kernel from ``src/repro_torch/csrc``
   with ``nvcc`` (one process per source, all at once) and prints the time
   and the compiler's register/shared-memory report.
3. kernels — each kernel at each schedule, fp32 and bf16, against its plain
   PyTorch version on the card: the ragged shape grid of the JAX package's
   kernel tests and the workloads' shapes, at 1e-4 (fp32) and 2e-2 (bf16).
4. main path — a fresh tuning cache with the card's fingerprint and a
   dispatcher over the port's registry; eager ``ops.matmul``/``ops.matvec``
   on cold shapes (every variant measured, each model fitted), then the
   ``large`` ``mlp_block`` and ``decode_microbatch`` workloads traced,
   compiled (sequential) and run, each output held against the workload's
   reference at 1e-5.  Launch counters are zeroed just before this phase
   and every hand kernel must have launched in it.
5. times   — each kernel at the workloads' shapes, timed with CUDA events
   over operand sets that together exceed the 50 MB L2 cache (the workloads
   read each weight once), beside its plain version, the one PyTorch call
   that computes the same function (``library_ms``) and its bound from the
   card's data sheet.

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
# eager warm-up shapes in the paper's Table 2 range, the workloads' included
WARM_MM = WORK_MM + [(128, 512, 512), (512, 1024, 256), (64, 256, 1024),
                     (1024, 1024, 1024), (384, 640, 768), (32, 64, 128)]
WARM_MV = WORK_MV + [(512, 1024), (1024, 512), (256, 256), (768, 384),
                     (128, 1024), (2048, 1024)]

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


def phase_kernels(mm, mv, device) -> dict:
    """Every kernel at every schedule against its plain version; returns
    kernel -> worst abs error at the main path's shapes in fp32."""
    gen = torch.Generator(device=device).manual_seed(0)
    worst = {"matmul": 0.0, "matvec": 0.0}
    report = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
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
                key = (f"matmul_t{bm}", str(dtype).removeprefix("torch."))
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
            key = ("matvec", str(dtype).removeprefix("torch."))
            report[key] = max(report.get(key, 0.0), err)
            if dtype == torch.float32 and (m, k) in WORK_MV:
                worst["matvec"] = max(worst["matvec"], err)
    print("kernels: " + json.dumps(
        {f"{k}/{d}": e for (k, d), e in sorted(report.items())}))
    print(f"kernels: all within {FP32_TOL} (fp32) and {BF16_TOL} (bf16) of "
          f"their plain versions; launches while checking: matmul "
          f"{mm.LAUNCHES}, matvec {mv.LAUNCHES}")
    return worst


def phase_main_path(mm, mv, device) -> dict:
    from repro_torch.api import ops, use_dispatcher
    from repro_torch.runtime import (Dispatcher, TuningCache,
                                     current_fingerprint, default_registry)
    from repro_torch.workloads import get_workload

    gen = torch.Generator(device=device).manual_seed(1)
    with tempfile.TemporaryDirectory() as root:
        fp = current_fingerprint("cuda")
        disp = Dispatcher(default_registry(), TuningCache(root, fp))
        print(f"main: fingerprint {fp.key}")
        mm.LAUNCHES = 0
        mv.LAUNCHES = 0
        t0 = time.perf_counter()
        with use_dispatcher(disp):
            for m, n, k in WARM_MM:
                ops.matmul(torch.randn(m, k, generator=gen, device=device),
                           torch.randn(k, n, generator=gen, device=device))
            for m, k in WARM_MV:
                ops.matvec(torch.randn(m, k, generator=gen, device=device),
                           torch.randn(k, generator=gen, device=device))
        print(f"main: eager warm-up {time.perf_counter() - t0:.2f} s, "
              f"{disp.n_measured} measured, {disp.n_gated} gated, "
              f"{disp.n_predicted} predicted")
        for s in disp.selections:
            if s.measured_s:
                times = ", ".join(f"{v} {t * 1e6:.1f} us"
                                  for v, t in s.measured_s.items())
                print(f"main: {s.mode} {s.kernel} {s.params}: {times}")
        for kernel in ("matmul", "matvec"):
            entry = disp.cache.entry(kernel)
            if entry.model is None:
                raise RuntimeError(f"no model fitted for {kernel}")
            print(f"main: {kernel} model fitted on {entry.n_rows} rows, "
                  f"fit MAPE {entry.fit_mape:.1f}%")

        for name in ("mlp_block", "decode_microbatch"):
            built = get_workload(name).build("large", registry=disp.registry,
                                             device=device)
            compiled = built.program.compile(devices=disp,
                                             bindings=built.bindings)
            before = len(disp.selections)
            t0 = time.perf_counter()
            outs = compiled()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            outs = outs if isinstance(outs, tuple) else (outs,)
            refs = built.reference()
            if len(outs) != len(refs):
                raise RuntimeError(f"{name}: {len(outs)} outputs, "
                                   f"{len(refs)} references")
            err = 0.0
            for o, r in zip(outs, refs):
                if not torch.isfinite(o).all():
                    raise RuntimeError(f"{name}: non-finite output")
                torch.testing.assert_close(o, r, rtol=PARITY_TOL,
                                           atol=PARITY_TOL)
                err = max(err, (o - r).abs().max().item())
            sels = list(disp.selections)[before:]
            chosen = [f"{t.name}={s.chosen}/{s.mode}"
                      for t, s in zip(compiled.order, sels)]
            decide = sum(s.overhead_s for s in sels)
            execute = sum(s.kernel_s for s in sels)
            print(f"main: {name} large: {len(compiled.order)} nodes, "
                  f"predicted makespan {compiled.makespan * 1e3:.3f} ms, "
                  f"run {wall * 1e3:.3f} ms (dispatch decisions "
                  f"{decide * 1e3:.3f} ms, variant calls to synchronise "
                  f"{execute * 1e3:.3f} ms), max abs err vs reference "
                  f"{err:.3g} (budget {PARITY_TOL})")
            print(f"main: {name} variants: {' '.join(chosen)}")
    launches = {"matmul": mm.LAUNCHES, "matvec": mv.LAUNCHES}
    print(f"main: hand-kernel launches on the main path: {launches}")
    for kernel, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{kernel}: the main path never launched "
                               "its hand kernel")
    return launches


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
    profiler's CUDA kernel events over one sweep — the call's time without
    the host's launch cost.  None when the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ops_ in sets:
            fn(*ops_)
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / len(sets) if us > 0 else None


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


def _record(name, schedule, shape, res, worst, launches) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": {"matmul": "src/repro/kernels/matmul/matmul.py:17",
                         "matvec": "src/repro/kernels/matvec/matvec.py:16"
                         }[name],
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": res["ms"][schedule], "plain_ms": res["ms"]["plain"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["ms"]["library"],
            "device_ms": res["device_ms"][schedule],
            "schedule": schedule, "shape": list(shape), "dtype": "float32"}


def phase_times(mm, mv, device, card: str, worst: dict,
                launches: dict) -> list:
    gen = torch.Generator(device=device).manual_seed(2)
    records = []
    for idx, (m, n, k) in enumerate(WORK_MM):
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
                                   launches))
    for m, k in WORK_MV:
        nbytes = 4 * (m * k + k + m)
        res = _measure(f"matvec fp32 [{m},{k}]x[{k}]",
                       {"pallas_128": mv.matvec, "plain": mv.plain,
                        "library": torch.mv},
                       _operand_sets([(m, k), (k,)], nbytes, device, gen),
                       2.0 * m * k, nbytes, card)
        records.append(_record("matvec", "pallas_128", (m, k), res, worst,
                               launches))
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.matvec import matvec as mv

    # the library path and every reference run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    line = card_line()
    name = torch.cuda.get_device_name(0)
    print(line)                  # the card's name and power limit
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    phase_build(build)
    worst = phase_kernels(mm, mv, device)
    launches = phase_main_path(mm, mv, device)
    records = phase_times(mm, mv, device, name, worst, launches)
    print(line)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
