"""Appendix: the paper's §4.2 "other kernels evaluated, omitted for
brevity" — dense factorizations (Cholesky, QR) through the same protocol.
Host rows are REAL wall-clock (LAPACK vs blocked / modified-Gram-Schmidt
variants); two simulated-device rows per kernel for portability.  The
port of ``benchmarks/omitted_kernels.py``."""
from __future__ import annotations

import json
import os

from repro_torch.core.nnc import make_model, mae, mape, slice_features
from repro_torch.perfdata.datasets import extra_combos, generate, train_test_split

METHODS = ("nnc", "nn", "cons", "lr", "nlr")


def run(epochs: int = 20000,
        out_path: str = "results/torch/omitted_kernels.json") -> dict:
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    for combo in extra_combos():
        if combo.key in results:
            continue
        X, y, _ = generate(combo, n=500, seed=0)
        (trX, trY), (teX, teY) = train_test_split(X, y)
        row = {}
        for method in METHODS:
            model, uses_c = make_model(method, X.shape[1], epochs=epochs)
            model.fit(slice_features(trX, uses_c), trY)
            pred = model.predict(slice_features(teX, uses_c))
            row[method] = {"mae": mae(teY, pred), "mape": mape(teY, pred)}
        results[combo.key] = row
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[omitted] {combo.key:24s} "
              + " ".join(f"{m}:{row[m]['mape']:.0f}%" for m in METHODS))
    return results


def summarize(results: dict) -> list[str]:
    lines = ["== Appendix: omitted kernels (Cholesky / QR) MAPE % =="]
    lines.append(f"{'combo':24s}" + "".join(f"{m:>8s}" for m in METHODS))
    for key, row in sorted(results.items()):
        lines.append(f"{key:24s}" + "".join(
            f"{row[m]['mape']:8.1f}" for m in METHODS))
    wins = sum(1 for r in results.values()
               if r["nnc"]["mae"] <= r["nn"]["mae"])
    lines.append(f"NN+C beats NN (MAE) on {wins}/{len(results)} omitted-kernel combos")
    return lines
