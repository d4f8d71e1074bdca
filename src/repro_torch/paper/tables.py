"""Tables 4-8: MAE per kernel-variant-hardware combo, aggregated MAPE.

Runs the paper's exact protocol over the 40-combo portability matrix
(simulated devices), the measured host-anchor combos and, on a card, the
9 measured card combos (``datasets.card_combos``): 500 instances, 250
train / 250 test, five methods.  The port of ``benchmarks/paper_tables.py``.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from repro_torch.core.nnc import make_model, mae, mape, slice_features
from repro_torch.kernels import resolve_device
from repro_torch.perfdata.datasets import (CARD, Combo, card_combos,
                                           card_stamp, generate, host_combos,
                                           paper_combos, train_test_split)

METHODS = ("nnc", "nn", "cons", "lr", "nlr")


def run_combo(combo: Combo, epochs: int, seed: int = 0,
              cache_dir: str = "results/perfdata") -> dict:
    X, y, names = generate(combo, n=500, seed=seed, cache_dir=cache_dir)
    (trX, trY), (teX, teY) = train_test_split(X, y)
    mm_cpu = combo.kernel == "mm" and combo.is_cpu
    out = {}
    for method in METHODS:
        t0 = time.time()
        model, uses_c = make_model(method, X.shape[1], mm_cpu=mm_cpu,
                                   epochs=epochs, seed=seed)
        model.fit(slice_features(trX, uses_c), trY)
        pred = model.predict(slice_features(teX, uses_c))
        out[method] = {
            "mae": mae(teY, pred),
            "mape": mape(teY, pred),
            "n_params": getattr(model, "n_params", 0),
            "train_s": round(time.time() - t0, 2),
        }
    return out


def run(epochs: int = 20000, include_host: bool = True,
        out_path: str = "results/torch/paper_tables.json",
        combos: list | None = None, device="cuda") -> dict:
    """``combos=None`` runs the paper's combos, the host combos with
    ``include_host`` and, when ``device`` is a card, the card combos."""
    todo = combos if combos is not None else list(paper_combos())
    if include_host and combos is None:
        todo += host_combos()
    if combos is None and resolve_device(device).type == "cuda":
        todo += card_combos(device)
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    for combo in todo:
        # a card combo's row is reused only from the same card and build
        stamp = card_stamp(combo)
        if combo.key in results and results[combo.key].get("stamp") == stamp:
            continue
        t0 = time.time()
        row = results[combo.key] = run_combo(combo, epochs)
        if stamp:
            row["stamp"] = stamp
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        best = min(METHODS, key=lambda m: row[m]["mae"])
        print(f"[tables] {combo.key:28s} ({time.time()-t0:5.1f}s) "
              + " ".join(f"{m}:{row[m]['mae']:.2e}" for m in METHODS)
              + f"  best={best}")
    return results


def is_card(key: str) -> bool:
    return key.split("|")[2] == CARD


def _wins(rows: dict, what: str) -> str:
    wins = sum(1 for row in rows.values()
               if row["nnc"]["mae"] <= row["nn"]["mae"])
    return (f"\nNN+C beats NN (MAE) on {wins}/{len(rows)} {what}; "
            f"overall MAPE nnc="
            f"{np.mean([r['nnc']['mape'] for r in rows.values()]):.1f}% "
            f"nn={np.mean([r['nn']['mape'] for r in rows.values()]):.1f}%")


def summarize(results: dict) -> list[str]:
    """Table 4-7 style rows (MAE) + Table 8 aggregation (MAPE).  The card
    combos have a Table 8 row of their own, ``CARD``, and a win line of
    their own, so the other rows are the JAX package's over its combos."""
    lines = []
    kernels = sorted({k.split("|")[0] for k in results})
    lines.append("== Tables 4-7: MAE (seconds) per combo ==")
    for kernel in kernels:
        lines.append(f"-- {kernel.upper()} --")
        header = f"{'combo':28s}" + "".join(f"{m:>12s}" for m in METHODS)
        lines.append(header)
        for key in sorted(k for k in results if k.startswith(kernel + "|")):
            row = results[key]
            lines.append(f"{key:28s}" + "".join(
                f"{row[m]['mae']:12.3e}" for m in METHODS))
    lines.append("")
    lines.append("== Table 8: aggregated MAPE (%) ==")
    groups: dict[str, dict[str, list]] = {}
    for key, row in results.items():
        kernel, _, device = key.split("|")
        if device == CARD:
            names = ("CARD",)
        else:
            hw = "GPU" if device in ("tesla", "quadro") else "CPU"
            names = (kernel.upper(), hw)
        for g in names:
            groups.setdefault(g, {})
            for m in METHODS:
                groups[g].setdefault(m, []).append(row[m]["mape"])
    header = f"{'group':10s}" + "".join(f"{m:>10s}" for m in METHODS)
    lines.append(header)
    for g in sorted(groups):
        lines.append(f"{g:10s}" + "".join(
            f"{np.mean(groups[g][m]):10.1f}" for m in METHODS))
    # win-rate of NN+C vs NN (the paper's headline ordering)
    ref = {k: r for k, r in results.items() if not is_card(k)}
    card = {k: r for k, r in results.items() if is_card(k)}
    if ref:
        lines.append(_wins(ref, "combos"))
    if card:
        lines.append(_wins(card, "card combos"))
    return lines
