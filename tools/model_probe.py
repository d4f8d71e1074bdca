#!/usr/bin/env python3
"""Where a model step's time goes on one NVIDIA card.

Run from the root of a checkout::

    python3 tools/model_probe.py [ARCH] [LAYERS]

(default gemma3-1b with all its layers).  Builds the flash-attention
kernel, initialises the model's fp32 parameters from a seeded
``torch.Generator`` on ``cuda:0`` and, in fp32 and in the config's bf16
compute, prefills two 2048-token prompts into a cache of 2048 + STEPS
and decodes STEPS greedy tokens.  It prints the decode steps' wall and
tokens/s, the card's busy time in the steps by the profiler, and the ten
operators that take the most host time and the most device time in one
profiled step, each line beside the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

STEPS = 32
BATCH, PROMPT = 2, 2048


def _decode(model, params, cache, tok, start, steps):
    for t in range(steps):
        lg, cache = model.decode_step(params, cache, tok, start + t)
        tok = lg[:, -1].argmax(-1, keepdim=True)
    return tok


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    arch = sys.argv[1] if len(sys.argv) > 1 else "gemma3-1b"
    cfg = get_arch(arch)
    if len(sys.argv) > 2:
        cfg = dataclasses.replace(cfg, n_layers=int(sys.argv[2]))
    build.build(["flash_attention"])
    device = torch.device("cuda", 0)
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=device)
    for dtype in ("float32", "bfloat16"):
        model = build_model(dataclasses.replace(cfg, compute_dtype=dtype))
        label = f"{arch} ({cfg.n_layers} layers) {dtype}"
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": prompts},
                                          max_seq=PROMPT + STEPS + 1,
                                          cache_dtype=getattr(torch, dtype))
            tok = logits[:, -1].argmax(-1, keepdim=True)
            del logits
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok = _decode(model, params, cache, tok, PROMPT, STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _decode(model, params, cache, tok, PROMPT + STEPS, 1)
                torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events) / 1e3
        print(f"probe: {label}: {STEPS} decode steps of B={BATCH} in "
              f"{wall * 1e3:.1f} ms = {wall * 1e3 / STEPS:.2f} ms a step, "
              f"{BATCH * STEPS / wall:.1f} tokens/s; the profiled step: "
              f"card busy {busy:.2f} ms; {card}")
        for key, name in (("self_cpu_time_total", "host"),
                          ("self_device_time_total", "device")):
            top = sorted(events, key=lambda e: getattr(e, key),
                         reverse=True)[:10]
            print(f"probe: {label}: top {name} time in one step: " + "; ".join(
                f"{e.key} {getattr(e, key) / 1e3:.3f} ms x{e.count}"
                for e in top) + f"; {card}")
        del cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
