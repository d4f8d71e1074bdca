"""Serving-style example: a stream of image-processing requests scheduled
across heterogeneous (simulated) devices with NN+C-predicted runtimes —
the port of ``examples/serve_blur_pipeline.py``.

Each device's NN+C model is fitted on its combo's simulated dataset (the
JAX package's, bit for bit); the requests are the reference's draws; the
earliest-finish-time scheduler places them.  The schedule goes to
``results/torch/serve_blur_pipeline.json``.

    PYTHONPATH=src python -m repro_torch.examples.serve_blur_pipeline
"""
import json
import os

import numpy as np

from repro_torch.core.features import feature_vector
from repro_torch.core.nnc import make_model, slice_features
from repro_torch.core.scheduler import KernelTask, makespan, schedule
from repro_torch.perfdata.datasets import Combo, generate, train_test_split

DEVICES = {
    "cpu0": Combo("mc", "eigen", "xeon", True),
    "gpu0": Combo("mc", "cuda_shared", "tesla", True),
    "gpu1": Combo("mc", "cuda_global", "quadro", True),
}
EPOCHS = 12000
OUT = "results/torch/serve_blur_pipeline.json"


def requests(rng) -> list:
    """A batch of convolution requests of wildly different sizes."""
    tasks = []
    for i in range(12):
        m_dim = int(rng.choice([128, 256, 512, 1024]))
        tasks.append(KernelTask(
            f"req{i:02d}", "mc",
            {"m": m_dim, "n": m_dim, "r": int(rng.choice([3, 5, 7])),
             "d": 1.0}))
    return tasks


def fit_predictor(devices=None, epochs=None):
    """predict(task, device) from one NN+C model per device."""
    models = {}
    for dev, combo in (devices or DEVICES).items():
        X, y, _ = generate(combo, n=500, seed=0)
        (trX, trY), _ = train_test_split(X, y)
        m, uses_c = make_model("nnc", X.shape[1],
                               epochs=epochs or EPOCHS)
        m.fit(slice_features(trX, uses_c), trY)
        models[dev] = (m, uses_c, combo.is_cpu)

    def predict(task, device):
        m, uses_c, is_cpu = models[device]
        x = feature_vector("mc", task.params,
                           n_threads=32 if is_cpu else None)
        return float(m.predict(slice_features(x[None], uses_c))[0])

    return predict


def main(argv=None) -> dict:
    rng = np.random.RandomState(0)
    predict = fit_predictor()
    tasks = requests(rng)
    assignments = schedule(tasks, predict, list(DEVICES))
    per_dev = {}
    for name, a in sorted(assignments.items(), key=lambda kv: kv[1].start):
        per_dev.setdefault(a.device, []).append(name)
        print(f"{name} -> {a.device:5s} [{a.start*1e3:8.2f}, "
              f"{a.finish*1e3:8.2f}] ms")
    print(f"makespan {makespan(assignments)*1e3:.2f}ms; "
          f"load: " + ", ".join(f"{d}:{len(v)}" for d, v in per_dev.items()))
    # naive single-device baseline for contrast
    single = {}
    for dev in DEVICES:
        single[dev] = sum(predict(t_, dev) for t_ in tasks)
        print(f"  all-on-{dev}: {single[dev]*1e3:.2f}ms")
    result = {"schedule": {n: [a.device, a.start, a.finish]
                           for n, a in assignments.items()},
              "makespan_s": makespan(assignments), "single_s": single}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
