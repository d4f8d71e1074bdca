"""The paper's §1 motivating example, end to end, through
``repro_torch.api``: the port of ``examples/schedule_dag.py``.

Two independent matmuls, a CPU-class and a GPU-class simulated device
(``sim-cpu`` and ``sim-gpu``: the names ``cpu`` and ``cuda`` are the
port's real devices): the small one must take the CPU so the GPU is free
for the big one — a decision only
*absolute time* predictions enable.  The user-facing code is just trace ->
compile: the tracer derives params from shapes, each simulated device's
tuning cache predicts absolute times, and the earliest-finish-time
scheduler does the rest.  The placement goes to
``results/torch/schedule_dag.json``.

    PYTHONPATH=src python -m repro_torch.examples.schedule_dag
"""
import json
import os

import numpy as np
import torch

from repro_torch.api import ops, trace
from repro_torch.core.scheduler import KernelTask
from repro_torch.runtime import default_registry
from repro_torch.runtime.simdev import fake_matmul_device

ROOT = "results/torch/fake_devices"
OUT = "results/torch/schedule_dag.json"


def main(argv=None) -> dict:
    reg = default_registry(include=["matmul"])
    devices = {"sim-cpu": fake_matmul_device(ROOT, "cpu-xeon", 1e9, reg),
               "sim-gpu": fake_matmul_device(ROOT, "gpu-tesla", 1e11, reg)}

    rng = np.random.RandomState(0)
    small_a, small_b, big_a, big_b = (
        torch.from_numpy(rng.rand(*shape).astype(np.float32))
        for shape in ((100, 100), (100, 100), (1024, 1024), (1024, 1024)))

    with trace(registry=reg) as tb:
        small = ops.matmul(small_a, small_b)
        big = ops.matmul(big_a, big_b)
    compiled = tb.compile(devices=devices)

    gantt = compiled.gantt()
    for row in gantt:
        print(f"{row['task']:10s} -> {row['device']}  "
              f"[{row['start_s']*1e3:8.3f}ms, {row['finish_s']*1e3:8.3f}ms]")
    print(f"makespan: {compiled.makespan*1e3:.3f}ms")

    # per-kernel winners alone would send BOTH matmuls to the GPU
    t = {(n, d): disp.predict_time("matmul", reg.params_of("matmul", a, b))
         for n, (a, b) in [("small", (small_a, small_b)),
                           ("big", (big_a, big_b))]
         for d, disp in devices.items()}
    print(f"(per-kernel, the small matmul is also faster on the GPU: "
          f"{t[('small', 'sim-gpu')]*1e3:.3f}ms vs cpu "
          f"{t[('small', 'sim-cpu')]*1e3:.3f}ms — but the schedule keeps the "
          f"GPU free for the big one)")

    out_small, out_big = compiled()
    ref = small_a @ small_b
    assert float((out_small - ref).abs().max()) < 1e-2
    assert compiled.device_of(small.name) == "sim-cpu"
    assert compiled.device_of(big.name) == "sim-gpu"

    # the traced program lowers to the tasks a hand-built DAG has (the
    # reference compares whole KernelTasks, whose out_bytes and input_deps
    # a traced task carries and a hand-built one lacks: its assert fails)
    task, want = tb.program.to_kernel_tasks()[0], KernelTask(
        small.name, "matmul", {"m": 100, "n": 100, "k": 100})
    assert (task.name, task.kernel, task.params) == (want.name, want.kernel,
                                                     want.params)
    result = {"placement": {small.name: compiled.device_of(small.name),
                            big.name: compiled.device_of(big.name)},
              "gantt": gantt, "makespan_s": compiled.makespan}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
