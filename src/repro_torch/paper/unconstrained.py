"""Table 9 / Fig 3: lightweight (<75 params, 250 rows) vs unconstrained
(64x32 hidden, 2500 rows) NN+C — accuracy gain vs size/time cost.  The
port of ``benchmarks/unconstrained.py``, over the same simulated combos."""
from __future__ import annotations

import json
import os
import time

from repro_torch.core.nnc import make_model, mae, mape, slice_features
from repro_torch.perfdata.datasets import Combo, generate, train_test_split

CASES = [
    Combo("mm", "eigen", "i5", True), Combo("mm", "cuda_shared", "tesla", True),
    Combo("mv", "eigen", "i7", True), Combo("mv", "cuda_global", "quadro", True),
    Combo("mc", "boost", "xeon", True), Combo("mc", "cuda_global", "tesla", True),
    Combo("mp", "eigen", "xeon", True), Combo("mp", "cuda_shared", "quadro", True),
]


def run(epochs: int = 20000, out_path: str = "results/torch/unconstrained.json") -> dict:
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    for combo in CASES:
        if combo.key in results:
            continue
        mm_cpu = combo.kernel == "mm" and combo.is_cpu
        row = {}
        for tag, unc, n in (("light", False, 500), ("unconstrained", True, 5000)):
            X, y, _ = generate(combo, n=n, seed=0)
            (trX, trY), (teX, teY) = train_test_split(X, y, n_train=n // 2)
            t0 = time.time()
            model, uses_c = make_model("nnc", X.shape[1], mm_cpu=mm_cpu,
                                       unconstrained=unc, epochs=epochs)
            model.fit(slice_features(trX, uses_c), trY)
            pred = model.predict(slice_features(teX, uses_c))
            row[tag] = {"mae": mae(teY, pred), "mape": mape(teY, pred),
                        "n_params": model.n_params,
                        "train_s": round(time.time() - t0, 2)}
        row["size_increase"] = row["unconstrained"]["n_params"] / row["light"]["n_params"]
        row["time_increase"] = max(row["unconstrained"]["train_s"], 1e-3) / \
            max(row["light"]["train_s"], 1e-3)
        results[combo.key] = row
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[unconstrained] {combo.key:28s} light mae={row['light']['mae']:.3e} "
              f"-> unc mae={row['unconstrained']['mae']:.3e} "
              f"(size x{row['size_increase']:.1f}, time x{row['time_increase']:.1f})")
    return results


def summarize(results: dict) -> list[str]:
    lines = ["== Table 9 / Fig 3: lightweight vs unconstrained NN+C =="]
    lines.append(f"{'combo':28s} {'light MAE':>11s} {'unc MAE':>11s} "
                 f"{'sizex':>6s} {'timex':>6s}")
    for key, row in sorted(results.items()):
        lines.append(f"{key:28s} {row['light']['mae']:11.3e} "
                     f"{row['unconstrained']['mae']:11.3e} "
                     f"{row['size_increase']:6.1f} {row['time_increase']:6.1f}")
    return lines
