#!/usr/bin/env python3
"""Run parts of ``chip_smoke.py`` alone on one NVIDIA card: the
flash-attention kernels against their plain versions, the models phase
and the train phase's gradient gates.

Run from the root of a checkout::

    python3 tools/model_gates_probe.py [kernels] [models] [gates]

With no argument it runs all three, in that order, after building the
flash-attention library: ``kernels`` is ``_check_flash_attention`` (the
JAX tests' grid, ``FA_SHAPES`` and ``FA_EDGES`` in fp32 and bf16, each
kernel's largest error printed by case), ``models`` is ``phase_models``
(every model of ``MODELS``: its gates, timing and planted faults) and
``gates`` is ``_train_gates`` (the value-and-grad gates of
``TRAIN_GATES``).  Each part prints its seconds, on the card named at the
top.  It takes about two minutes on an H100, the build included.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

PARTS = ("kernels", "models", "gates")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    parts = sys.argv[1:] or list(PARTS)
    if any(p not in PARTS for p in parts):
        print(f"parts: {' '.join(PARTS)}", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["flash_attention"])
    print(f"probe: build {time.perf_counter() - t0:.1f} s", flush=True)
    K = cs._kernels()
    fa = K["flash_attention"]
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = cs.card_line()
    print(line)
    for part in parts:
        t = time.perf_counter()
        if part == "kernels":
            gen = torch.Generator(device=device).manual_seed(0)
            report, worst = {}, dict.fromkeys(cs.launch_counts(K), 0.0)
            cs._check_flash_attention(fa, device, gen, report, worst)
            print("probe kernels: " + json.dumps(
                {f"{k}/{d}": e for (k, d), e in sorted(report.items())}))
        elif part == "models":
            cs.phase_models(K, device, line)
        else:
            cs._train_gates(device, line, fa)
        print(f"probe: {part} {time.perf_counter() - t:.1f} s; {line}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
