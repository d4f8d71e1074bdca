"""Executor overlap benchmark: sequential bridge vs async executor.

Fan-out/fan-in diamond DAGs (one root matmul feeding K independent branch
matmuls that join in a final matmul) on two simulated devices with
simulated compute time and a simulated inter-device link.  Reports, per
fan-out width: the sequential bridge's wall time (no overlap — the lower
bound a single-stream runtime pays), the async executor's wall time
(branches overlap across devices, transfers overlap with compute on their
link lanes), and the comm-aware EFT's *predicted* makespan — so the CSV
shows in one row whether the executor delivers the schedule's promise.

    PYTHONPATH=src python -m repro_torch.paper.executor_overlap [--quick]

The port of ``benchmarks/executor_overlap.py``.  Writes
``results/torch/executor_overlap.csv``, the same rows as
``results/torch/executor_overlap.json`` (the structured form
``repro_torch.bench.fold_external`` merges into the unified ``bench.json``
schema), and the widest diamond's Chrome trace to
``results/torch/executor_overlap_trace.json`` (open in chrome://tracing or
Perfetto).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
import torch

N = 192                         # square matmul size: ~14ms/node at 1e9 F/s
WIDTHS = (2, 4, 8)
QUICK_WIDTHS = (2, 4)


def _diamond(reg, rng, width: int):
    """Root -> K independent branches -> join, all NxN matmuls; every node
    (interior ones included) is an output via ``mark_output``."""
    from repro_torch.api import ops, trace

    arrs = [torch.as_tensor(rng.rand(N, N), dtype=torch.float32)
            for _ in range(2 + width)]
    with trace(registry=reg) as tb:
        root = ops.matmul(arrs[0], arrs[1])
        branches = [ops.matmul(root, w) for w in arrs[2:]]
        joins = []
        join = branches[0]
        for b in branches[1:]:
            join = ops.matmul(join, b)
            joins.append(join)
        tb.mark_output(root, *branches, *joins)
    return tb.program, dict(tb.bindings)


def run(quick: bool = False,
        out_csv: str = "results/torch/executor_overlap.csv",
        out_json: str = "results/torch/executor_overlap.json",
        out_trace: str = "results/torch/executor_overlap_trace.json",
        root: str = "results/torch/fake_devices") -> list:
    from repro_torch.exec import CommModel
    from repro_torch.runtime import (TuningCache, current_fingerprint,
                                     default_registry)
    from repro_torch.runtime.simdev import SimLink, fake_matmul_device

    reg = default_registry(include=["matmul"])
    devices = {
        "d0": fake_matmul_device(root, "ovl-d0", 1.0e9, reg,
                                 simulate_time=True),
        "d1": fake_matmul_device(root, "ovl-d1", 0.9e9, reg,
                                 simulate_time=True),
    }
    link = SimLink(latency_s=5e-4, bytes_per_s=2e9)
    # the simulated link's model lives under the host's fingerprint, as in
    # the JAX package (whose default fingerprint is the host's)
    comm = CommModel(TuningCache(root=os.path.join(root, "comm"),
                                 fingerprint=current_fingerprint("cpu")))
    link.measure_into(comm, [("d0", "d1"), ("d1", "d0")])

    rng = np.random.RandomState(0)
    rows = []
    last_trace = None
    for width in (QUICK_WIDTHS if quick else WIDTHS):
        prog, bindings = _diamond(reg, rng, width)
        compiled = prog.compile(devices=devices, bindings=bindings,
                                executor="async", comm=comm,
                                transfer=link.transfer)
        try:
            compiled(_executor="sequential")  # warmup outside the clock
            t0 = time.perf_counter()
            seq = compiled(_executor="sequential")
            seq_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            asy = compiled(_executor="async")
            async_wall = time.perf_counter() - t0
        finally:
            compiled.close()                  # the async lanes' threads
        last_trace = compiled.last_trace
        for s, a in zip(seq, asy):
            if not torch.equal(s, a):
                raise RuntimeError("async output diverged from the "
                                   "sequential reference")
        rows.append({
            "branches": width,
            "nodes": len(prog.nodes),
            "transfers": len(compiled.transfers),
            "sequential_wall_s": seq_wall,
            "async_wall_s": async_wall,
            "predicted_makespan_s": compiled.makespan,
            "overlap_speedup": seq_wall / async_wall,
        })

    os.makedirs(os.path.dirname(out_csv), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    with open(out_json, "w") as f:
        json.dump({"quick": quick, "rows": rows,
                   "best_overlap_speedup":
                       max(r["overlap_speedup"] for r in rows)}, f, indent=1)
    if last_trace is not None:
        last_trace.save_chrome(out_trace)
    return rows


def summarize(rows: list) -> list:
    lines = ["== executor overlap: sequential bridge vs async (2 sim "
             "devices + link) =="]
    lines.append(f"{'branches':>8s} {'seq_wall':>10s} {'async_wall':>10s} "
                 f"{'predicted':>10s} {'speedup':>8s} {'xfers':>6s}")
    for r in rows:
        lines.append(f"{r['branches']:8d} {r['sequential_wall_s']:9.3f}s "
                     f"{r['async_wall_s']:9.3f}s "
                     f"{r['predicted_makespan_s']:9.3f}s "
                     f"{r['overlap_speedup']:7.2f}x {r['transfers']:6d}")
    best = max(r["overlap_speedup"] for r in rows)
    lines.append(f"executor_overlap_best_speedup,{best:.3f},"
                 "async_wall_vs_sequential_wall")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    for line in summarize(run(quick=args.quick)):
        print(line)
