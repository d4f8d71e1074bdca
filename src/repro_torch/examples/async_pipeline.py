"""Asynchronous multi-device execution of a traced pipeline: the port of
``examples/async_pipeline.py``.

The full ``repro_torch.exec`` story in one script: two simulated devices
(their tuning caches predict — and, via ``simulate_time``, *take* — honest
absolute times), a simulated inter-device link measured into a
``CommModel`` as tuning-cache pseudo-kernels, a traced fan-out/fan-in DAG
compiled with comm-aware EFT, and the same schedule executed twice — once
through the sequential bridge, once through the dependency-driven async
executor.  Prints the predicted and measured timelines and writes the
async run's Chrome trace to ``results/torch/exec_trace.json``.

    PYTHONPATH=src python -m repro_torch.examples.async_pipeline
"""
import os
import time

import numpy as np
import torch

from repro_torch.api import ops, trace
from repro_torch.exec import CommModel
from repro_torch.runtime import Fingerprint, TuningCache, default_registry
from repro_torch.runtime.simdev import SimLink, fake_matmul_device

ROOT = "results/torch/fake_devices"
TRACE_JSON = "results/torch/exec_trace.json"
N = 192
# the link's cache is keyed by a simulated fingerprint, not the host's
COMM_FP = Fingerprint("sim", "pipe-link", 1, 1, ("float32",))


def main(argv=None) -> dict:
    os.makedirs(os.path.dirname(TRACE_JSON), exist_ok=True)
    reg = default_registry(include=["matmul"])
    devices = {
        "sim-cpu": fake_matmul_device(ROOT, "pipe-cpu", 1.0e9, reg,
                                  simulate_time=True),
        "sim-gpu": fake_matmul_device(ROOT, "pipe-gpu", 0.9e9, reg,
                                  simulate_time=True),
    }
    link = SimLink(latency_s=5e-4, bytes_per_s=2e9)
    comm = CommModel(TuningCache(root=os.path.join(ROOT, "comm"),
                                 fingerprint=COMM_FP))
    link.measure_into(comm, [("sim-cpu", "sim-gpu"), ("sim-gpu", "sim-cpu")])
    print("link model (measured into the tuning cache as pseudo-kernels):")
    for nbytes in (1 << 14, 1 << 20):
        print(f"  {nbytes:>8d} B: predicted "
              f"{comm.predict('sim-cpu', 'sim-gpu', nbytes)*1e3:.3f}ms, "
              f"true {link.seconds(nbytes)*1e3:.3f}ms")

    rng = np.random.RandomState(0)
    arrs = [torch.from_numpy(rng.rand(N, N).astype(np.float32))
            for _ in range(6)]
    with trace(registry=reg) as tb:
        root = ops.matmul(arrs[0], arrs[1])
        b0 = ops.matmul(root, arrs[2])       # four independent branches —
        b1 = ops.matmul(root, arrs[3])       # the async executor overlaps
        b2 = ops.matmul(root, arrs[4])       # them across the two devices
        b3 = ops.matmul(root, arrs[5])
        ops.matmul(ops.matmul(b0, b1), ops.matmul(b2, b3))

    compiled = tb.compile(devices=devices, executor="async", comm=comm,
                          transfer=link.transfer)
    print(f"\npredicted schedule ({compiled.makespan*1e3:.1f}ms makespan, "
          f"{len(compiled.transfers)} transfers):")
    for row in compiled.gantt():
        print(f"  {row['task']:10s} {row['device']:7s} "
              f"[{row['start_s']*1e3:7.1f}ms, {row['finish_s']*1e3:7.1f}ms]")
    for t in compiled.transfers:
        print(f"  {t.name} ({t.nbytes} B on lane {t.lane})")

    compiled(_executor="sequential")         # warm-up outside the clocks
    t0 = time.perf_counter()
    out_seq = compiled(_executor="sequential")
    seq_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_async = compiled(_executor="async")
    async_wall = time.perf_counter() - t0

    assert torch.equal(out_seq, out_async), \
        "async must match the sequential reference bit-for-bit"
    compiled.last_trace.save_chrome(TRACE_JSON)
    compiled.close()

    print(f"\nsequential bridge: {seq_wall*1e3:7.1f}ms  (sum of nodes, "
          "no overlap)")
    print(f"async executor:    {async_wall*1e3:7.1f}ms  (predicted "
          f"{compiled.makespan*1e3:.1f}ms)")
    print(f"overlap speedup:   {seq_wall/async_wall:7.2f}x, outputs "
          "bit-identical")
    print(f"chrome trace -> {TRACE_JSON}")
    print("\nmeasured timeline (async):")
    print(compiled.last_trace.to_gantt_csv())
    return {"makespan_s": compiled.makespan, "seq_wall_s": seq_wall,
            "async_wall_s": async_wall, "gantt": compiled.gantt()}


if __name__ == "__main__":
    main()
