"""Fig 4: Blur schedule selection — NN+C-predicted-best vs default vs true
best, on REAL measured runtimes of genuinely different blur schedules: the
port of ``benchmarks/variant_selection.py``, whose five jnp schedules are
the torch ops of ``kernels.blur.ops.HOST_SCHEDULES`` here, run on
``device`` (the card unless the caller asks for the CPU)."""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.core.features import blur_complexity
from repro_torch.core.nnc import MLPModel, lightweight_dims, mape
from repro_torch.core.selection import VariantSelector, evaluate_selection
from repro_torch.kernels.blur.ops import (HOST_SCHEDULES, SCHEDULE_FEATURES,
                                          host_blur_time)
from repro_torch.runtime.fingerprint import current_fingerprint

TRAIN_SIZES = [(256, 256), (256, 1024), (512, 512), (768, 512), (1024, 256),
               (1024, 1024), (1536, 768), (512, 2048)]
TEST_SIZES = [(384, 384), (768, 768), (1280, 1280), (2048, 1024),
              (2048, 2048)]
EPOCHS = 25000


def _features(m, n, sched):
    return [m, n, *SCHEDULE_FEATURES[sched], blur_complexity({"m": m, "n": n})]


def run(out_path: str = "results/torch/variant_selection.json",
        device="cuda") -> dict:
    """Fig. 4 on ``device``.  A document at ``out_path`` is reused only
    when the same device (by fingerprint) wrote it; else it is measured
    anew and overwritten."""
    fingerprint = current_fingerprint(device).key
    if os.path.exists(out_path):
        with open(out_path) as f:
            doc = json.load(f)
        if doc.get("device") == fingerprint:
            return doc
    rng = np.random.RandomState(0)
    X, y = [], []
    for (m, n) in TRAIN_SIZES:
        for sched in HOST_SCHEDULES:
            t = host_blur_time(sched, m, n, rng, device=device)
            X.append(_features(m, n, sched))
            y.append(t)
    X, y = np.asarray(X), np.asarray(y)
    model = MLPModel(lightweight_dims(X.shape[1], 75, 1), epochs=EPOCHS)
    model.fit(X, y)
    train_mape = mape(y, model.predict(X))
    sel = VariantSelector(model)

    rows = {}
    schedules = list(HOST_SCHEDULES)
    for (m, n) in TEST_SIZES:
        cands = np.asarray([_features(m, n, s) for s in schedules])
        truth = np.asarray([host_blur_time(s, m, n, rng, device=device)
                            for s in schedules])
        # "autoscheduler" default: the direct fused schedule
        res = evaluate_selection(sel, cands, truth,
                                 default_idx=schedules.index("direct"))
        res["chosen"] = schedules[res["chosen_idx"]]
        res["best"] = schedules[res["best_idx"]]
        res["times"] = dict(zip(schedules, truth.tolist()))
        rows[f"{m}x{n}"] = res
        print(f"[variant] {m}x{n}: chose {res['chosen']} "
              f"(best {res['best']}), speedup vs default "
              f"{res['speedup_vs_default']:.2f}x, regret {res['regret_vs_best']:.2f}x")
    out = {"train_mape": train_mape, "cases": rows, "device": fingerprint}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def summarize(results: dict) -> list[str]:
    lines = ["== Fig 4: Blur schedule selection (measured host runtimes) =="]
    lines.append(f"predictor train MAPE: {results['train_mape']:.1f}%")
    lines.append(f"{'size':12s} {'chosen':12s} {'best':12s} "
                 f"{'speedup_vs_default':>19s} {'regret':>7s}")
    for size, r in results["cases"].items():
        lines.append(f"{size:12s} {r['chosen']:12s} {r['best']:12s} "
                     f"{r['speedup_vs_default']:19.2f} {r['regret_vs_best']:7.2f}")
    sp = [r["speedup_vs_default"] for r in results["cases"].values()]
    lines.append(f"max speedup over default schedule: {max(sp):.2f}x "
                 f"(paper reports up to 1.5x over Halide autoscheduler)")
    return lines
