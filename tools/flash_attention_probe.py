#!/usr/bin/env python3
"""Build the flash-attention kernels and check them once on one NVIDIA card.

Run from the root of a checkout::

    python3 tools/flash_attention_probe.py

A short first call for a new or changed ``csrc/flash_attention.cu``: it
builds the library (printing ``ptxas``'s register and spill report, and
the backward sweeps' tiles and warps per block by head dim), then at
attention_block's q/k/v and at one attention layer each of yi-9b and
gemma3-1b (4096 tokens, B=1; bq = bk = 256), and at two shapes whose tiles
the masks leave whole (S=512 non-causal, D=128) or ragged (a sk_orig tail
at D=256), prints each kernel's largest error against its plain version
(the backward's relative to the gradient's largest magnitude above 1) in
fp32 and bf16, whether two launches of each backward kernel agree bit for
bit, and at the three layers each kernel's time per call by CUDA events
over three calls after one warm call.  ``chip_smoke.py`` holds the same
kernels to tolerances and times them properly; this script only fails if
a build or launch does.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

# label: (B, H, KV, S, D, causal, window, sk_orig, timed)
SHAPES = {"attention_block": (4, 8, 8, 512, 32, True, 0, 0, True),
          "yi-9b": (1, 32, 4, 4096, 128, True, 0, 0, True),
          "gemma3-1b": (1, 4, 1, 4096, 256, True, 512, 0, True),
          "whole tiles": (1, 8, 2, 512, 128, False, 0, 0, False),
          "sk_orig tail": (1, 4, 2, 512, 256, True, 0, 437, False)}


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


def rel_errs(gots, wants) -> list:
    return [((g.float() - w.float()).abs().max()
             / max(1.0, w.float().abs().max().item())).item()
            for g, w in zip(gots, wants)]


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
    for d in fa.HEAD_DIMS:
        print(f"backward tiles at D={d}: " + "; ".join(
            f"{kernel} {fa.bwd_tiles(kernel, d)}, shared memory "
            f"{fa.smem_bytes(kernel, d, 4)} B fp32, "
            f"{fa.smem_bytes(kernel, d, 2)} B bf16"
            for kernel in ("dq", "dkv")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, h, kv, s, d, causal, window, sk_orig,
                timed) in SHAPES.items():
        q, k = (torch.randn(b, n, s, d, generator=gen, device="cuda") * 0.5
                for n in (h, kv))
        v, do = (torch.randn(b, n, s, d, generator=gen, device="cuda")
                 for n in (kv, h))
        pkw = {"causal": causal, "window": window, "sk_orig": sk_orig}
        kw = dict(pkw, bq=256 if s % 256 == 0 else 32, bk=256
                  if s % 256 == 0 else 32)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        want_o, want_lse = fa.plain_fwd(q, k, v, **pkw)
        out = fa.flash_attention(q, k, v, **kw)
        print(label, "fwd err", (o - want_o).abs().max().item(),
              (lse - want_lse).abs().max().item(), "no-lse err",
              (out - want_o).abs().max().item())
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype) for t in (q, k, v, do)]
            wo, wl = fa.plain_fwd(*args[:3], **pkw)
            delta = (args[3].float() * wo.float()).sum(-1)
            grads = fa.flash_attention_bwd(*args, wl, delta, **kw)
            again = fa.flash_attention_bwd(*args, wl, delta, **kw)
            wants = fa.plain_bwd(*args, wl, delta, **pkw)
            same = all(torch.equal(a, b_) for a, b_ in zip(grads, again))
            print(label, dtype, "bwd err dq, dk, dv", rel_errs(grads, wants),
                  "two launches equal:", same)
            del grads, again, wants
        if timed:
            delta = (do * want_o).sum(-1)
            print(label, "ms fwd", event_ms(lambda: fa.flash_attention_fwd(
                q, k, v, **kw)), "dq", event_ms(
                    lambda: fa.flash_attention_bwd_dq(
                        q, k, v, do, want_lse, delta, **kw)), "dkv",
                event_ms(lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, do, want_lse, delta, **kw)))
        del q, k, v, do
        torch.cuda.empty_cache()
    print(fa.LAUNCHES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
