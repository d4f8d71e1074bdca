"""Author -> export -> re-import -> compile -> run: the portability loop,
the port of ``examples/program_compile.py``.

A workload DAG is traced once and saved as pure data (shapes, kernels,
params, value flow — no tensors, no weights), in the JAX package's
schema.  A different process — here, a different hardware setup: two
simulated devices with their own fingerprinted tuning caches — loads the
JSON, re-validates it against its live registry, and compiles it under
*its* predicted times.  Writes the exported program JSON and the
predicted-schedule Gantt CSV under ``results/torch/``.

    PYTHONPATH=src python -m repro_torch.examples.program_compile
"""
import json
import os

import numpy as np
import torch

from repro_torch.api import Program, ops, save_gantt_csv, trace
from repro_torch.runtime import default_registry
from repro_torch.runtime.simdev import fake_matmul_device

ROOT = "results/torch/fake_devices"
PROGRAM_JSON = "results/torch/program.json"
GANTT_CSV = "results/torch/schedule_gantt.csv"


def author(reg) -> Program:
    """A chained workload: two independent matmuls feeding a third."""
    rng = np.random.RandomState(0)

    def draw(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32))

    with trace(registry=reg) as tb:
        left = ops.matmul(draw(100, 100), draw(100, 100))
        right = ops.matmul(draw(1024, 100), draw(100, 100))
        ops.matmul(right, left)
    return tb.program


def main(argv=None) -> dict:
    os.makedirs(os.path.dirname(PROGRAM_JSON), exist_ok=True)
    reg = default_registry(include=["matmul"])

    program = author(reg)
    program.save(PROGRAM_JSON)
    size = os.path.getsize(PROGRAM_JSON)
    print(f"exported {len(program.nodes)}-node program -> {PROGRAM_JSON} "
          f"({size} bytes)")

    # ...elsewhere, under different hardware: load, re-validate, compile
    devices = {"sim-cpu": fake_matmul_device(ROOT, "cpu-xeon", 1e9, reg),
               "sim-gpu": fake_matmul_device(ROOT, "gpu-tesla", 1e11, reg)}
    loaded = Program.load(PROGRAM_JSON, registry=reg)
    assert loaded == program
    compiled = loaded.compile(devices=devices)

    save_gantt_csv(compiled, GANTT_CSV)
    print(f"schedule ({compiled.makespan*1e3:.3f}ms makespan) -> {GANTT_CSV}")
    for row in compiled.gantt():
        print(f"  {row['task']:10s} {row['device']:7s} "
              f"[{row['start_s']*1e3:8.3f}ms, {row['finish_s']*1e3:8.3f}ms]")

    # the loaded program carries no data: bind fresh inputs and execute
    rng = np.random.RandomState(1)
    arrays = [torch.from_numpy(rng.rand(*spec.shape).astype(spec.dtype))
              for spec in loaded.inputs]
    out = compiled(*arrays)
    ref = (arrays[2] @ arrays[3]) @ (arrays[0] @ arrays[1])
    err = float((out - ref).abs().max() / ref.abs().max())
    print(f"executed: out {tuple(out.shape)}, max rel err {err:.2e}")
    assert err < 1e-5
    with open(PROGRAM_JSON) as f:
        assert json.load(f)["schema"] == 1
    return {"program": PROGRAM_JSON, "gantt": compiled.gantt(), "err": err}


if __name__ == "__main__":
    main()
