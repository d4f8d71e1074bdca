#!/usr/bin/env python3
"""Time a checkout's training step and its data-parallel step on one
NVIDIA card.

Run from the root of a checkout::

    python3 tools/train_step_walls.py [ROOT]

ROOT (default: this checkout) holds ``chip_smoke.py`` and
``src/repro_torch``; the script imports both from there and builds that
checkout's flash-attention kernels into its own build directory.  It
then runs three parts of ``chip_smoke``'s training and dist phases on
TRAIN_ARCH at TRAIN_BATCH x TRAIN_SEQ: the plain launcher
(``_train_launcher``: its warm step, tokens/s and peak device memory),
the profiled step
(``_train_profile``: the host's wall, the card's busy share and the
kernels a step launches) and (4a) (``_dist_dp_nccl``: the same launcher
under ``--data-parallel`` on a world of one over NCCL).  During (4a)
every ``collectives.reduce_sum_`` call is timed by CUDA events; a step's
all-reduce time is the sum of its calls.  It prints one JSON line, on
the card named beside it.  To compare two commits on one card, unpack
one into a git-ignored directory of the other and run both from one
command, in turns (A, B, B, A): host-bound walls move from one machine
to the next more than between two commits.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parents[1]).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.dist import collectives
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    build.build(["flash_attention"])
    K = cs._kernels()
    fa = K["flash_attention"]
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = cs.card_line()
    launcher = cs._train_launcher(fa, device, card)
    torch.cuda.empty_cache()
    step = cs._train_profile(build_model(get_arch(cs.TRAIN_ARCH)), device,
                             fa, card)
    torch.cuda.empty_cache()

    spans = []
    reduce = collectives.reduce_sum_

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        reduce(*args, **kwargs)
        end.record()
        spans.append((start, end))

    collectives.reduce_sum_ = timed
    try:
        dp = cs._dist_dp_nccl(K, device, card, launcher)
    finally:
        collectives.reduce_sum_ = reduce
    torch.cuda.synchronize()
    calls = len(spans) // cs.TRAIN_STEPS
    if not calls or calls * cs.TRAIN_STEPS != len(spans):
        raise RuntimeError(f"{len(spans)} reduce_sum_ calls over "
                           f"{cs.TRAIN_STEPS} steps")
    ms = [s.elapsed_time(e) for s, e in spans]
    per_step = [sum(ms[i:i + calls]) for i in range(0, len(ms), calls)]
    print(json.dumps({
        "root": str(root),
        "plain_step_ms": launcher["step_ms"],
        "plain_peak_bytes": launcher["peak_bytes"],
        "profiled_host_step_ms": step["host_step_ms"],
        "busy_ms": step["busy_ms"], "busy_share": step["busy_share"],
        "kernels_a_step": step["launches"],
        "dp_step_ms": dp["dp_nccl_step_ms"],
        "dp_reduce_calls_a_step": calls,
        "dp_allreduce_ms_a_step": statistics.median(per_step),
        "dp_allreduce_ms_steps": per_step,
        "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
