#!/usr/bin/env python3
"""Build the flash-attention kernels and check them once on one NVIDIA card.

Run from the root of a checkout::

    python3 tools/flash_attention_probe.py

A short first call for a new or changed ``csrc/flash_attention.cu``: it
builds the library (printing ``ptxas``'s register and spill report), then
at attention_block's q/k/v and at one attention layer each of yi-9b and
gemma3-1b (4096 tokens, B=1; fp32, bq = bk = 256) prints each kernel's
largest error against its plain version (the backward's relative to the
gradient's largest magnitude above 1), the forward's in bf16, and each
kernel's time per call by CUDA events over three calls after one warm
call.  ``chip_smoke.py`` holds the same kernels to tolerances and times
them properly; this script only fails if a build or launch does.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

SHAPES = {"attention_block": (4, 8, 8, 512, 32, True, 0),
          "yi-9b": (1, 32, 4, 4096, 128, True, 0),
          "gemma3-1b": (1, 4, 1, 4096, 256, True, 512)}


def event_ms(fn, n: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    for _, (_, report) in build.build(["flash_attention"]).items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print("  ", line.strip())
    print(f"build {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, h, kv, s, d, causal, window) in SHAPES.items():
        q, k = (torch.randn(b, n, s, d, generator=gen, device="cuda") * 0.5
                for n in (h, kv))
        v, do = (torch.randn(b, n, s, d, generator=gen, device="cuda")
                 for n in (kv, h))
        kw = {"causal": causal, "window": window, "bq": 256, "bk": 256}
        pkw = {"causal": causal, "window": window}
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        want_o, want_lse = fa.plain_fwd(q, k, v, **pkw)
        out = fa.flash_attention(q, k, v, **kw)
        print(label, "fwd err", (o - want_o).abs().max().item(),
              (lse - want_lse).abs().max().item(), "no-lse err",
              (out - want_o).abs().max().item())
        delta = (do * want_o).sum(-1)
        grads = fa.flash_attention_bwd(q, k, v, do, want_lse, delta, **kw)
        wants = fa.plain_bwd(q, k, v, do, want_lse, delta, **pkw)
        print(label, "bwd err", [
            ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
            for g, w in zip(grads, wants)])
        print(label, "ms fwd", event_ms(lambda: fa.flash_attention_fwd(
            q, k, v, **kw)), "dq", event_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, want_lse, delta, **kw)), "dkv",
            event_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, want_lse, delta, **kw)))
        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        ob, _ = fa.flash_attention_fwd(qb, kb, vb, **kw)
        wb, _ = fa.plain_fwd(qb, kb, vb, **pkw)
        print(label, "bf16 fwd err",
              (ob.float() - wb.float()).abs().max().item())
        del q, k, v, do, grads, wants
        torch.cuda.empty_cache()
    print(fa.LAUNCHES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
