"""Runtime dispatch: steady-state overhead + selection quality vs oracle.

Cold-fills a tuning cache on the blur variant axis, then measures

- dispatch overhead at steady state (decision time as a share of wall
  time; acceptance target <5%), and
- selection quality: predicted-best execution time vs the oracle (every
  variant exhaustively measured, each call synchronised) and vs the static
  default schedule.

The port of ``benchmarks/runtime_overhead.py``: the planes lie on
``device`` (the card unless the caller asks for the CPU), and the tuning
cache is keyed by that device's fingerprint.

    PYTHONPATH=src python -m repro_torch.paper.runtime_overhead [--quick]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

SHAPES = [(384, 384), (512, 512), (768, 512), (768, 768),
          (1024, 768), (1024, 1024), (1536, 1024), (2048, 1024)]
QUICK_SHAPES = [(384, 384), (512, 512), (768, 768), (1024, 1024)]


def run(quick: bool = False,
        out_path: str = "results/torch/runtime_overhead.json",
        cache_root: str = "results/tunecache", device="cuda") -> dict:
    from repro_torch.kernels import resolve_device
    from repro_torch.perfdata.measure import time_callable
    from repro_torch.runtime import (Dispatcher, DispatchPolicy, TuningCache,
                                     current_fingerprint, default_registry)
    from repro_torch.runtime.dispatch import synchronize

    device = resolve_device(device)
    shapes = QUICK_SHAPES if quick else SHAPES
    reps = 10 if quick else 25
    reg = default_registry(include=["blur"])
    d = Dispatcher(
        registry=reg, cache=TuningCache(root=cache_root,
                                        fingerprint=current_fingerprint(device)),
        policy=DispatchPolicy(min_rows_to_fit=len(shapes) * 5,
                              fit_epochs=3000 if quick else 6000))

    rng = np.random.RandomState(0)
    arrays = {s: torch.as_tensor(rng.rand(*s), dtype=torch.float32,
                                 device=device) for s in shapes}

    # cold pass: measured dispatch fills the cache
    for a in arrays.values():
        d.dispatch("blur", a)
    if d._entry("blur").model is None:
        d.fit("blur")

    # steady state: one warm-up pass (fills the decision memo), then time
    for a in arrays.values():
        d.dispatch("blur", a)
    d.reset_stats()
    for _ in range(reps):
        for a in arrays.values():
            d.dispatch("blur", a)
    stats = d.stats()

    # oracle: measure EVERY variant per shape; compare the predicted choice
    rk = reg.get("blur")
    cases = {}
    for (m, n), a in arrays.items():
        params = {"m": m, "n": n}
        times = {v.name: time_callable(
            lambda: synchronize(v.call((a,), params)),
            min_window=2e-3) for v in rk.variants}
        chosen = d.predict_times("blur", params)
        pick = min(chosen, key=chosen.get)
        best = min(times, key=times.get)
        cases[f"{m}x{n}"] = {
            "chosen": pick, "best": best,
            "chosen_time": times[pick], "best_time": times[best],
            "regret_vs_oracle": times[pick] / times[best],
            "speedup_vs_default": times["direct"] / times[pick],
        }

    out = {
        "quick": quick,
        "fingerprint": d.cache.fingerprint.to_json(),
        "steady_overhead_s": stats["steady_overhead_s"],
        "steady_overhead_pct": stats["steady_overhead_pct"],
        "dispatches": stats["dispatches"],
        "cases": cases,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def summarize(results: dict) -> list:
    lines = ["== runtime dispatch: overhead + selection vs oracle =="]
    lines.append(f"steady-state overhead: "
                 f"{results['steady_overhead_s']*1e6:.0f}us/dispatch = "
                 f"{results['steady_overhead_pct']:.2f}% of wall time "
                 f"(target <5%)")
    lines.append(f"{'size':12s} {'chosen':12s} {'best':12s} "
                 f"{'regret':>7s} {'vs_default':>10s}")
    for size, c in results["cases"].items():
        lines.append(f"{size:12s} {c['chosen']:12s} {c['best']:12s} "
                     f"{c['regret_vs_oracle']:7.2f} "
                     f"{c['speedup_vs_default']:10.2f}")
    regrets = [c["regret_vs_oracle"] for c in results["cases"].values()]
    lines.append(f"mean regret vs oracle: {float(np.mean(regrets)):.2f}x")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    for line in summarize(run(quick=args.quick, device=args.device)):
        print(line)
