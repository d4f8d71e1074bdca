#!/usr/bin/env python3
"""Build the matmul and matvec kernels and check them once on one NVIDIA card.

Run from the root of a checkout::

    python3 tools/matmul_probe.py

A short first call for a new or changed ``csrc/matmul.cu`` or
``csrc/matvec.cu``: it builds both libraries (printing ``ptxas``'s
register, shared-memory and spill report), prints each kernel's largest
error against its plain version at the main path's shapes and at shapes
that take every cluster size along k and the narrow (misaligned) copy
path, fp32 and bf16, checks that two matvec launches agree bit for bit,
and times each kernel beside ``torch.matmul`` / ``torch.mv`` (CUDA events
over 20 calls after a warm one, and the profiler's device time).
``chip_smoke.py`` holds the same kernels to tolerances and times them
properly; this script fails only if a build or launch fails, or a result
leaves its tolerance (1e-4 fp32, 2e-2 bf16).
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

MM = [(256, 2048, 1024), (256, 1024, 2048), (384, 384, 384),
      (512, 1024, 512), (512, 512, 1024),
      # cluster sizes 8/4/2/1 at the 128 tile, k below s * bk, narrow paths
      (128, 256, 1000), (384, 1280, 520), (512, 1536, 200), (1024, 1280, 64),
      (64, 96, 120), (100, 70, 130), (33, 257, 65), (96, 36, 264), (1, 1, 1)]
MV = [(1024, 1024), (257, 513), (1, 5), (100, 70), (128, 1024),
      (512, 1024), (64, 20000)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def event_us(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n * 1e3


def device_us(fn, n: int = 10) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / n


def operands(shapes, gen):
    """Uniform in [-0.5, 0.5), the contraction operand scaled by 1/sqrt(k),
    as the workloads draw them."""
    lhs, rhs = (torch.rand(*s, generator=gen, device="cuda") - 0.5
                for s in shapes)
    return lhs, rhs / max(1, rhs.shape[0]) ** 0.5


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.matvec import matvec as mv

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    for name, (_, report) in build.build(["matmul", "matvec"]).items():
        print(f"build {name}")
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print("  ", line.strip())
    print(f"build {time.perf_counter() - t0:.1f} s")
    sms = mm.sm_count(0)
    for dtype in TOL:
        for bm, _, _ in mm.SCHEDULES:
            print(f"cluster slots {dtype} tile {bm}: "
                  f"{mm.cluster_slots(0, dtype, bm)} ({sms} SMs)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    for dtype, tol in TOL.items():
        for m, n, k in MM:
            a, b = (t.to(dtype) for t in operands([(m, k), (k, n)], gen))
            want = mm.plain(a, b).float()
            errs = []
            for bm, bn, bk in mm.SCHEDULES:
                got = mm.matmul(a, b, bm=bm, bn=bn, bk=bk)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                s = mm._split(0, dtype, m, n, k, bm, bn, bk)
                errs.append(f"t{bm} s={s} {err:.3g}")
                if not torch.allclose(got.float(), want, rtol=tol, atol=tol):
                    bad.append(("matmul", bm, dtype, (m, n, k), err))
            print(f"matmul {dtype} {(m, n, k)}: " + ", ".join(errs))
        # a base pointer off 16 bytes takes the narrow path
        src, b = (t.to(dtype) for t in operands([(256, 300), (300, 512)],
                                                  gen))
        a = src.new_empty(256 * 300 + 1)[1:].view(256, 300).copy_(src)
        want = mm.plain(a, b).float()
        for bm, bn, bk in mm.SCHEDULES:
            got = mm.matmul(a, b, bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            print(f"matmul {dtype} misaligned a t{bm}: {err:.3g}")
            if not torch.allclose(got.float(), want, rtol=tol, atol=tol):
                bad.append(("matmul misaligned", bm, dtype, err))
        for m, k in MV:
            x, a_t = operands([(k,), (k, m)], gen)
            a, x = a_t.t().contiguous().to(dtype), x.to(dtype)
            want = mv.plain(a, x).float()
            got, again = mv.matvec(a, x), mv.matvec(a, x)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            same = torch.equal(got, again)
            print(f"matvec {dtype} {(m, k)}: {err:.3g}, deterministic {same}")
            if not same or not torch.allclose(got.float(), want, rtol=tol,
                                              atol=tol):
                bad.append(("matvec", dtype, (m, k), err, same))
    print(f"launches: matmul {mm.LAUNCHES}, matvec {mv.LAUNCHES}")
    for m, n, k in MM[:5]:
        a, b = operands([(m, k), (k, n)], gen)
        fns = {f"t{bm}": (lambda _s=(bm, bn, bk): mm.matmul(
            a, b, bm=_s[0], bn=_s[1], bk=_s[2])) for bm, bn, bk in
            mm.SCHEDULES}
        fns["torch.matmul"] = lambda: torch.matmul(a, b)
        print(f"time matmul fp32 {(m, n, k)}: " + ", ".join(
            f"{v} {event_us(f):.1f} us (device {device_us(f):.1f})"
            for v, f in fns.items()))
    a, x = operands([(1024, 1024), (1024,)], gen)
    for _ in range(2):
        print("time matvec fp32 (1024, 1024): " + ", ".join(
            f"{v} {event_us(f, 200):.2f} us (device {device_us(f):.2f})"
            for v, f in (("kernel", lambda: mv.matvec(a, x)),
                         ("torch.mv", lambda: torch.mv(a, x)))))
    if bad:
        print("FAILED: " + repr(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
