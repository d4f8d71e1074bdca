#!/usr/bin/env python3
"""Which ``torch.distributed`` transports work for ranks that share one
NVIDIA card.

Run from the root of a checkout::

    python3 tools/dist_probe.py

Starts two ranks on ``cuda:0`` (child processes of this script, a
``file://`` rendezvous, a group timeout of 30 s, each child killed at 60 s)
once per case and prints, beside the card's name and power limit, whether
each collective completed, and the error it raised if not:

  * NCCL: an all-reduce and a send/receive of CUDA tensors;
  * gloo: an all-reduce and a send/receive of CUDA tensors, and the same
    of CPU tensors.

The port's ranks that share a card use gloo with their CUDA tensors staged
through host memory (``repro_torch.dist.compat``); this probe records why.
"""
from __future__ import annotations

import datetime
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

CASES = (("nccl", "cuda"), ("gloo", "cuda"), ("gloo", "cpu"))
CHILD_TIMEOUT_S = 60


def _try(fn) -> str:
    try:
        fn()
        return "ok"
    except Exception as exc:      # the probe's answer is the error itself
        return f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"


def child(rank: int, backend: str, where: str, url: str) -> int:
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    device = torch.device("cuda", 0) if where == "cuda" else "cpu"
    out = {}

    def all_reduce():
        t = torch.full((1024,), float(rank + 1), device=device)
        dist.all_reduce(t)
        if t[0].item() != 3.0:
            raise RuntimeError(f"all-reduce gave {t[0].item()}")

    def send_recv():
        t = torch.full((1024,), float(rank), device=device)
        r = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, 1 - rank),
               dist.P2POp(dist.irecv, r, 1 - rank)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if r[0].item() != float(1 - rank):
            raise RuntimeError(f"received {r[0].item()}")

    out["all_reduce"] = _try(all_reduce)
    out["send_recv"] = _try(send_recv)
    print("PROBE " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--child"]:
        rank, backend, where, url = sys.argv[2:6]
        return child(int(rank), backend, where, url)
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    for backend, where in CASES:
        with tempfile.TemporaryDirectory() as tmp:
            url = f"file://{tmp}/rendezvous"
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--child",
                 str(r), backend, where, url], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for r in range(2)]
            results = []
            for p in procs:
                try:
                    out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, err = p.communicate()
                    results.append(f"timed out after {CHILD_TIMEOUT_S} s")
                    continue
                line = next((ln for ln in out.splitlines()
                             if ln.startswith("PROBE ")), None)
                results.append(line[6:] if line else
                               f"exit {p.returncode}: "
                               f"{err.strip().splitlines()[-1:]}")
        print(f"dist_probe: {backend} with {where} tensors, 2 ranks on "
              f"cuda:0: {results} ({time.perf_counter() - t0:.1f} s); "
              f"{card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
