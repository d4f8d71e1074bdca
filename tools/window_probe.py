#!/usr/bin/env python3
"""Build the window kernels (blur, maxpool, conv2d), check them and sweep
their launch geometry on one NVIDIA card; then the lane contention probe.

Run from the root of a checkout::

    python3 tools/window_probe.py [conv2d]

A short call for a changed ``csrc/blur.cu``, ``csrc/maxpool.cu``,
``csrc/conv2d.cu`` or ``csrc/window.cuh``: it builds the three libraries
(printing ``ptxas``'s register and spill report), holds every blur entry,
the maxpool kernel and conv2d at both tiles, fp32 and bf16, to its plain
version bit for bit at the workloads' planes, the JAX tests' ragged shapes
and a plane whose base lies 4 bytes past an aligned buffer (the staged
path), with a NaN case for maxpool and conv2d at r = 3, 5, 7 (the vector
path) and 4 (staged); then it times each entry at the workloads' planes
(the profiler's device time per call over operand sets past the 50 MB L2)
for every block width and rows a thread walks of the vector path, beside
the wrappers' own geometry and the library call (``F.avg_pool2d``,
``F.max_pool2d``, ``F.conv2d`` with TF32 off), and the wrappers' event time
per call; conv2d at [1022,1022] for each compiled r.  Last,
``chip_smoke.contention_probe`` over two freshly warmed dispatchers (the
card's and the host's) and the time of one dispatcher-sized model fit with
the default intra-op threads and with one.  With the argument ``conv2d``
only conv2d is built, checked and swept.  Exits 1 if any check fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
L2_BYTES = 50 * 2 ** 20
BLUR = [(1024, 1024), (384, 384), (66, 66), (128, 100), (51, 200),
        (1024, 1022), (7, 9)]
POOL = [(1020, 1020, 2, 2), (384, 384, 2, 2), (64, 64, 2, 2), (66, 34, 2, 2),
        (101, 90, 2, 2), (100, 90, 3, 2), (65, 43, 5, 1), (32, 32, 4, 2)]
CONV = [(1022, 1022, 3), (1022, 1022, 5), (1022, 1022, 7), (64, 64, 3),
        (100, 90, 5), (41, 77, 7), (64, 64, 4), (51, 201, 3), (1024, 1022, 3),
        (7, 9, 7)]
THREADS = (32, 64, 128, 256)
ROWS = (1, 2, 4)


def device_us(fn, sets) -> float:
    """Device time per call over one sweep of ``sets``, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in sets:
            fn(*s)
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / len(sets)


def event_us(fn, sets, reps: int = 3) -> float:
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for s in sets:
            fn(*s)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * len(sets))


def planes(shape, nbytes, gen) -> list:
    count = max(2, -(-2 * L2_BYTES // nbytes))
    return [(torch.rand(*shape, generator=gen, device="cuda") - 0.5,)
            for _ in range(count)]


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose base lies 4 bytes past an aligned one."""
    per = 4 // t.element_size()
    return t.new_empty(t.numel() + per)[per:].view(t.shape).copy_(t)


def check(bk, mp, gen) -> list:
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, n in BLUR:
            a = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
            for plane in (a, misaligned(a)):
                for name, fn, want in (
                        ("blur_direct", bk.blur_direct, bk.plain(plane)),
                        ("blur_h", bk.blur_h, bk.plain_h(plane)),
                        ("blur_v", bk.blur_v, bk.plain_v(plane))):
                    for bm, bn in bk.SCHEDULES:
                        got = fn(plane, bm=bm, bn=bn)
                        torch.cuda.synchronize()
                        geo = bk.geometry(bk._TAPS[name], m, n,
                                          plane.element_size(), bm,
                                          plane.data_ptr() & 15,
                                          got.data_ptr() & 15)
                        if not torch.equal(got, want):
                            err = (got.float() - want.float()).abs().max()
                            bad.append((name, bm, str(dtype), (m, n),
                                        plane.data_ptr() & 15, geo,
                                        err.item()))
            print(f"blur {dtype} {(m, n)} checked")
        for m, n, r, s in POOL:
            a = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
            a[m // 2, n // 3] = float("nan")
            for plane in (a, misaligned(a)):
                want = mp.plain(plane, r=r, s=s)
                for bm, bn in mp.SCHEDULES:
                    got = mp.maxpool(plane, r=r, s=s, bm=bm, bn=bn)
                    torch.cuda.synchronize()
                    same = torch.equal(got.isnan(), want.isnan()) and \
                        torch.equal(got.nan_to_num(), want.nan_to_num())
                    if not same:
                        bad.append(("maxpool", bm, str(dtype), (m, n, r, s),
                                    plane.data_ptr() & 15,
                                    mp.geometry(m, n, r, s,
                                                plane.element_size(), bm,
                                                plane.data_ptr() & 15,
                                                got.data_ptr() & 15)))
            print(f"maxpool {dtype} {(m, n, r, s)} checked")
    return bad


def sweep_blur(bk, gen, card) -> None:
    from repro_torch.kernels import Window, store_bytes

    for m, n in ((1024, 1024), (384, 384)):
        sets = planes((m, n), 8 * m * n, gen)
        hsets = [(bk.blur_h(a),) for (a,) in sets]
        for name, lib, taps, inputs in (
                ("blur_direct", (3, 3), (3, 3), sets),
                ("blur_h", (1, 3), (1, 3), sets),
                ("blur_v", (3, 1), (3, 1), hsets)):
            mi, ni = inputs[0][0].shape
            om, on = mi - taps[0] + 1, ni - taps[1] + 1
            entry = bk._ENTRIES[name]
            fn = entry.fn or entry.bind()
            geo = bk.geometry(taps, mi, ni, 4, 128)
            outs = [a.new_empty((om, on)) for (a,) in inputs]
            times = {}
            for threads in THREADS:
                for rows in ROWS:
                    cfg = Window(geo.load_bytes, store_bytes(
                        0, on * 4, geo.load_bytes), threads, rows,
                        0).config(0, 128)
                    it = iter(outs * 4)

                    def call(a, _c=cfg, _it=it):
                        code = fn(a.data_ptr(), next(_it).data_ptr(),
                                  mi | ni << 32, _c,
                                  torch.cuda.current_stream().cuda_stream)
                        if code:
                            entry.fail(code)
                    times[f"{threads}x{rows}"] = round(device_us(
                        call, inputs), 2)
            own = {f"t{bm}": (bk.geometry(taps, mi, ni, 4, bm),
                              device_us(lambda a, _b=bm: getattr(bk, name)(
                                  a, bm=_b, bn=_b), inputs))
                   for bm, _ in bk.SCHEDULES}
            pool = lambda a: F.avg_pool2d(a[None, None], lib, stride=1)[0, 0]
            lib_us = device_us(pool, inputs)
            ev = {k: round(event_us(f, inputs), 2) for k, f in (
                ("t128", lambda a: getattr(bk, name)(a)),
                ("library", pool))}
            nbytes = 4 * (mi * ni + om * on)
            print(f"sweep {name} fp32 [{mi},{ni}] device us by "
                  f"threads x rows: {json.dumps(times)}; wrappers "
                  + json.dumps({k: [list(g), round(t, 2)]
                                for k, (g, t) in own.items()})
                  + f"; library {lib_us:.2f} us; events {json.dumps(ev)}; "
                  f"bound {nbytes / 3.35e12 * 1e6:.2f} us; {card}")
        del sets, hsets
        torch.cuda.empty_cache()


def sweep_pool(mp, gen, card) -> None:
    from repro_torch.kernels import Window, store_bytes

    for m, n in ((1020, 1020), (384, 384)):
        om, on = m // 2, n // 2
        sets = planes((m, n), 4 * (m * n + om * on), gen)
        fn = mp._ENTRY.fn or mp._ENTRY.bind()
        geo = mp.geometry(m, n, 2, 2, 4, 32)
        outs = [a.new_empty((om, on)) for (a,) in sets]
        times = {}
        for threads in THREADS:
            for rows in ROWS:
                cfg = Window(geo.load_bytes, store_bytes(
                    0, on * 4, geo.load_bytes // 2), threads, rows,
                    0).config(0, 32)
                it = iter(outs * 4)

                def call(a, _c=cfg, _it=it):
                    code = fn(a.data_ptr(), next(_it).data_ptr(),
                              m | n << 32, 2 | 2 << 16, _c,
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        mp._ENTRY.fail(code)
                times[f"{threads}x{rows}"] = round(device_us(call, sets), 2)
        own = {f"t{bm}": (mp.geometry(m, n, 2, 2, 4, bm), device_us(
            lambda a, _b=bm: mp.maxpool(a, r=2, s=2, bm=_b, bn=_b), sets))
            for bm, _ in mp.SCHEDULES}
        pool = lambda a: F.max_pool2d(a[None, None], 2, 2)[0, 0]
        lib_us = device_us(pool, sets)
        ev = {k: round(event_us(f, sets), 2) for k, f in (
            ("t32", lambda a: mp.maxpool(a, r=2, s=2)), ("library", pool))}
        nbytes = 4 * (m * n + om * on)
        print(f"sweep maxpool fp32 [{m},{n}] r=s=2 device us by threads x "
              f"rows: {json.dumps(times)}; wrappers "
              + json.dumps({k: [list(g), round(t, 2)]
                            for k, (g, t) in own.items()})
              + f"; library {lib_us:.2f} us; events {json.dumps(ev)}; bound "
              f"{nbytes / 3.35e12 * 1e6:.2f} us; {card}")
        del sets
        torch.cuda.empty_cache()


def check_conv(mc, gen) -> list:
    """conv2d, both tiles, fp32 and bf16, on CONV's planes and their copies
    4 bytes off alignment, against its plain version bit for bit."""
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, r in CONV:
            a = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
            w = torch.randn(r, r, generator=gen, device="cuda").to(dtype)
            for plane in (a, misaligned(a)):
                want = mc.plain(plane, w)
                for bm, bn in mc.SCHEDULES:
                    got = mc.conv2d(plane, w, bm=bm, bn=bn)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        bad.append(("conv2d", bm, str(dtype), (m, n, r),
                                    plane.data_ptr() & 15,
                                    mc.geometry(m, n, r, plane.element_size(),
                                                bm, plane.data_ptr() & 15,
                                                got.data_ptr() & 15),
                                    (got.float() - want.float()).abs().max()
                                    .item()))
            print(f"conv2d {dtype} {(m, n, r)} checked")
    return bad


def sweep_conv(mc, gen, card) -> None:
    from repro_torch.kernels import Window, cudnn_fp32, store_bytes

    m = n = 1022
    for r in mc.VECTOR_TAPS:
        om, on = m - r + 1, n - r + 1
        nbytes = 4 * (m * n + r * r + om * on)
        sets = [(a, torch.rand(r, r, generator=gen, device="cuda") - 0.5)
                for (a,) in planes((m, n), nbytes, gen)]
        fn = mc._ENTRY.fn or mc._ENTRY.bind()
        geo = mc.geometry(m, n, r, 4, 32)
        outs = [a.new_empty((om, on)) for a, _ in sets]
        times = {}
        for threads in THREADS:
            for rows in ROWS:
                cfg = Window(geo.load_bytes, store_bytes(
                    0, on * 4, geo.load_bytes), threads, rows,
                    0).config(0, 32)
                it = iter(outs * 4)

                def call(a, w, _c=cfg, _it=it):
                    code = fn(a.data_ptr(), w.data_ptr(),
                              next(_it).data_ptr(), m | n << 32, r, _c,
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        mc._ENTRY.fail(code)
                times[f"{threads}x{rows}"] = round(device_us(call, sets), 2)
        own = {f"t{bm}": (mc.geometry(m, n, r, 4, bm), device_us(
            lambda a, w, _b=bm: mc.conv2d(a, w, bm=_b, bn=_b), sets))
            for bm, _ in mc.SCHEDULES}

        def lib(a, w):
            return F.conv2d(a[None, None], w[None, None])[0, 0]
        with cudnn_fp32():
            lib_us = device_us(lib, sets)
            ev = {k: round(event_us(f, sets), 2) for k, f in (
                ("t32", mc.conv2d), ("library", lib))}
        best = min(times.values())
        print(f"sweep conv2d fp32 [{m},{n}] r={r} device us by threads x "
              f"rows: {json.dumps(times)}; wrappers "
              + json.dumps({k: [list(g), round(t, 2)]
                            for k, (g, t) in own.items()})
              + f"; library (TF32 off) {lib_us:.2f} us; events "
              f"{json.dumps(ev)}; bound {nbytes / 3.35e12 * 1e6:.2f} us, "
              f"t32 at {100 * nbytes / 3.35e12 * 1e6 / own['t32'][1]:.1f}% "
              f"of the peak rate, the sweep's best {best} us; {card}")
        del sets
        torch.cuda.empty_cache()


def fit_seconds() -> dict:
    """One fit of the dispatcher's model size (6000 epochs, 40 rows) on a
    fresh thread with the default intra-op threads and with one."""
    from repro_torch.core.nnc import MLPModel, lightweight_dims

    rng = np.random.RandomState(0)
    X = rng.rand(40, 6).astype(np.float32) * 100
    y = (X[:, 0] * X[:, 1] + 1).astype(np.float32)
    default = torch.get_num_threads()
    out = {}
    for threads in (default, 1, default, 1):
        box = []

        def fit(_t=threads):
            torch.set_num_threads(_t)
            t0 = time.perf_counter()
            MLPModel(lightweight_dims(6, 75, 1), epochs=6000).fit(X, y)
            box.append(time.perf_counter() - t0)
        t = threading.Thread(target=fit)
        t.start()
        t.join()
        torch.set_num_threads(default)
        out.setdefault(threads, []).append(round(box[0], 3))
    return out


def contention(device) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.api import ops, use_dispatcher
    from repro_torch.runtime import (Dispatcher, TuningCache,
                                     current_fingerprint, default_registry)

    with tempfile.TemporaryDirectory() as root:
        disps = {}
        for name in ("cuda:0", "cpu"):
            disp = Dispatcher(default_registry(), TuningCache(
                f"{root}/{name.replace(':', '')}",
                current_fingerprint("cuda" if name != "cpu" else "cpu")))
            dev = torch.device(name)
            gen = torch.Generator(device=dev).manual_seed(3)
            with use_dispatcher(disp):
                for m, n, k in chip_smoke.WARM_MM_DAG:
                    ops.matmul(torch.randn(m, k, generator=gen, device=dev),
                               torch.randn(k, n, generator=gen, device=dev))
            disps[name] = disp
        chip_smoke._print_contention(disps["cuda:0"], disps["cpu"], device)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.blur import blur as bk
    from repro_torch.kernels.conv2d import conv2d as mc
    from repro_torch.kernels.maxpool import maxpool as mp

    only_conv = sys.argv[1:] == ["conv2d"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    names = ["conv2d"] if only_conv else ["blur", "maxpool", "conv2d"]
    for name, (_, report) in build.build(names).items():
        print(f"build {name}")
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print("  ", line.strip())
    print(f"build {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = [] if only_conv else check(bk, mp, gen)
    bad += check_conv(mc, gen)
    for b in bad:
        print("MISMATCH", b)
    print(f"launches: blur {bk.LAUNCHES}, maxpool {mp.LAUNCHES}, conv2d "
          f"{mc.LAUNCHES}")
    if not only_conv:
        sweep_blur(bk, gen, card)
        sweep_pool(mp, gen, card)
    sweep_conv(mc, gen, card)
    if not only_conv:
        print(f"fit seconds by intra-op threads (fresh thread each): "
              f"{fit_seconds()}")
        contention(torch.device("cuda", 0))
    print(card)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
