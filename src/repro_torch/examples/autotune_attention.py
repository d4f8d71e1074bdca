"""Beyond-paper: NN+C autotunes the framework's own attention schedule —
the port of ``examples/autotune_attention.py``, on the device (the card
unless ``--device cpu``).

The variant axis is the chunked attention's tile schedule (q_chunk,
k_chunk); runtimes are measured wall times of ``attend_chunked`` on the
device.  The lightweight predictor (<75 weights) picks a schedule for an
unseen shape; its regret against exhaustive search is reported — the
paper's Fig 4 methodology pointed at the framework's own kernels.  The
result goes to ``results/torch/autotune_attention.json``.

    PYTHONPATH=src python -m repro_torch.examples.autotune_attention [--device cpu]
"""
import argparse
import json
import os

import numpy as np

from repro_torch.autotune.tuner import AttentionTuner, measure_schedule
from repro_torch.kernels import resolve_device

TRAIN_SHAPES = [(1, 2, 512, 64), (1, 4, 512, 64), (2, 2, 1024, 64),
                (1, 2, 2048, 64), (1, 8, 1024, 32)]
TEST_SHAPE = (1, 4, 2048, 64)
SCHEDULES = [(q, k) for q in (128, 256, 512) for k in (256, 512, 1024)]
DEFAULT = (256, 1024)               # the framework's static default
OUT = "results/torch/autotune_attention.json"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "autotune_attention")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    tuner = AttentionTuner()
    print(f"collecting measured schedule timings (train shapes) on "
          f"{device}...")
    X, y = tuner.collect(TRAIN_SHAPES, schedules=SCHEDULES, device=device)
    tuner.fit(X, y)
    print(f"predictor: {tuner.model.n_params} params")

    b, h, s, d = TEST_SHAPE
    chosen = tuner.best_schedule(b, h, s, d, schedules=SCHEDULES)
    rng = np.random.RandomState(1)
    truth = {sc: measure_schedule(b, h, s, d, *sc, rng=rng, device=device)
             for sc in SCHEDULES}
    best = min(truth, key=truth.get)
    print(f"\ntest shape {TEST_SHAPE}:")
    for sc, t in sorted(truth.items(), key=lambda kv: kv[1]):
        mark = " <== chosen" if sc == chosen else (
            " (true best)" if sc == best else "")
        print(f"  qc={sc[0]:4d} kc={sc[1]:5d}: {t*1e3:7.1f}ms{mark}")
    regret = truth[chosen] / truth[best]
    speedup = truth[DEFAULT] / truth[chosen]
    print(f"chosen {chosen}: regret vs best {regret:.2f}x, speedup vs "
          f"default {speedup:.2f}x")
    result = {"chosen": list(chosen), "best": list(best), "regret": regret,
              "speedup_vs_default": speedup, "n_params": tuner.model.n_params,
              "truth_s": {f"{q}x{k}": t for (q, k), t in truth.items()}}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
