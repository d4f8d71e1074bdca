#!/usr/bin/env python3
"""Time the one-device compiled runs of a checkout on one NVIDIA card.

Run from the root of a checkout::

    python3 tools/one_device_walls.py [ROOT]

ROOT (default: this checkout) holds ``chip_smoke.py`` and
``src/repro_torch``; the script imports both from there, builds that
checkout's kernels into its own build directory, and for each one-device
path of its ``chip_smoke.PATHS`` (slices 1-3), over a fresh cache and
dispatcher, runs the path's eager warm-up, then traces each workload at
``large``, compiles it (sequential) and runs it RUNS times.  It prints
each workload's walls, their median past the first run (the run that
carries one-off costs) and the variants its last run dispatched, on the
card named beside them.  To compare two commits on one card, unpack one
into a git-ignored directory of the other and run both from one command,
in turns (A, B, B, A): host-bound walls move from one machine to the next
more than between two commits.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

RUNS = 9


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parents[1]).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke
    from repro_torch.api import ops, use_dispatcher
    from repro_torch.kernels import build
    from repro_torch.runtime import (Dispatcher, TuningCache,
                                     current_fingerprint, default_registry)
    from repro_torch.workloads import get_workload

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    build.build()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(1)
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        fp = current_fingerprint("cuda")
        for label, _, _, warm, workloads, _ in chip_smoke.PATHS:
            disp = Dispatcher(default_registry(), TuningCache(
                str(Path(tmp) / label.replace(" ", "_")), fp))
            with use_dispatcher(disp):
                warm(ops, device, gen)
            for name in workloads:
                built = get_workload(name).build(
                    "large", registry=disp.registry, device=device)
                compiled = built.program.compile(devices=disp,
                                                 bindings=built.bindings)
                runs = []
                for _ in range(RUNS):
                    t0 = time.perf_counter()
                    compiled()
                    torch.cuda.synchronize()
                    runs.append(time.perf_counter() - t0)
                last = list(disp.selections)[-len(compiled.order):]
                walls[name] = {
                    "runs_ms": [round(w * 1e3, 3) for w in runs],
                    "median_ms": round(statistics.median(runs[1:]) * 1e3, 3),
                    "picks": sorted({f"{s.kernel}={s.chosen}" for s in last})}
    print(f"one-device walls of {root}: {json.dumps(walls)}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
