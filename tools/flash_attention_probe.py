#!/usr/bin/env python3
"""Build the flash-attention kernels and check them once on one NVIDIA card;
then sweep the forward's tile table.

Run from the root of a checkout::

    python3 tools/flash_attention_probe.py [--no-sweep]

A short first call for a new or changed ``csrc/flash_attention.cu``: it
builds the library (printing ``ptxas``'s register and spill report per
kernel, and the sweeps' tiles and warps per block by head dim), then at
attention_block's q/k/v and at one attention layer each of yi-9b and
gemma3-1b (4096 tokens, B=1; bq = bk = 256), and at two shapes whose tiles
the masks leave whole (S=512 non-causal, D=128) or ragged (a sk_orig tail
at D=256), prints each kernel's largest error against its plain version
(the backward's relative to the gradient's largest magnitude above 1) in
fp32 and bf16, whether two launches of each kernel agree bit for bit, and
at the three layers each kernel's time per call by CUDA events over three
calls after one warm call.

The sweep (left out with ``--no-sweep``) builds copies of the source whose
forward tile table (``FwdCfg``: warps, warps sharing 16 rows, streamed
rows) takes each of ``FWD_CANDIDATES``' columns, one library per column,
all compiled at once, and times each forward at the three layers and a
D=64 one (the profiler's device time per call over operand sets past the
50 MB L2), fp32, beside the compiled table.  ``chip_smoke.py`` holds the
same kernels to tolerances and times them properly; this script only
fails if a build or launch does.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
L2_BYTES = 50 * 2 ** 20

# label: (B, H, KV, S, D, causal, window, sk_orig, timed)
SHAPES = {"attention_block": (4, 8, 8, 512, 32, True, 0, 0, True),
          "yi-9b": (1, 32, 4, 4096, 128, True, 0, 0, True),
          "gemma3-1b": (1, 4, 1, 4096, 256, True, 512, 0, True),
          "whole tiles": (1, 8, 2, 512, 128, False, 0, 0, False),
          "sk_orig tail": (1, 4, 2, 512, 256, True, 0, 437, False)}
# the forward sweep's layers: the three above and one at D = 64
SWEEP = {"attention_block": (4, 8, 8, 512, 32, True, 0),
         "D=64 layer": (1, 16, 4, 4096, 64, True, 0),
         "yi-9b": (1, 32, 4, 4096, 128, True, 0),
         "gemma3-1b": (1, 4, 1, 4096, 256, True, 512)}
# (warps, split, streamed rows) of the forward by head dim: column i of
# every row makes variant i
FWD_CANDIDATES = {32: [(4, 1, 64), (8, 2, 64), (8, 2, 32), (16, 2, 64)],
                  64: [(8, 1, 32), (4, 1, 32), (8, 2, 32), (8, 1, 64)],
                  128: [(8, 1, 64), (4, 1, 32), (8, 2, 64), (16, 2, 32)],
                  256: [(16, 2, 16), (8, 2, 32), (16, 2, 8), (8, 2, 24)]}


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


def device_us(fn, sets) -> float:
    """Device time per call over one sweep of ``sets``, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for args in sets:
            fn(*args)
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / len(sets)


def report_ptxas(report: str, only: str = "") -> None:
    """Each kernel's registers and spills, by its (mangled) name; only the
    kernels whose name holds ``only``."""
    name = None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = found.group(1)
        elif ("registers" in line or "spill" in line) and name \
                and only in name:
            print(f"   {name}: {line.strip()}")


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

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    for _, (_, report) in build.build(["flash_attention"]).items():
        report_ptxas(report)
    print(f"build {time.perf_counter() - t0:.1f} s")
    for d in fa.HEAD_DIMS:
        print(f"tiles at D={d}: fwd {fa.fwd_tiles(d)}, shared memory "
              f"{fa.smem_bytes('fwd', d, 4)} B fp32, "
              f"{fa.smem_bytes('fwd', d, 2)} B bf16; " + "; ".join(
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
        o2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
        same = torch.equal(o, o2) and torch.equal(lse, lse2) and \
            torch.equal(out, fa.flash_attention(q, k, v, **kw))
        print(label, "fwd err", (o - want_o).abs().max().item(),
              (lse - want_lse).abs().max().item(), "no-lse err",
              (out - want_o).abs().max().item(), "two launches equal:", same)
        ob, _ = fa.flash_attention_fwd(q.bfloat16(), k.bfloat16(),
                                       v.bfloat16(), **kw)
        wb, _ = fa.plain_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), **pkw)
        print(label, "bf16 fwd err", (ob.float() - wb.float()).abs().max()
              .item())
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
    if "--no-sweep" not in sys.argv:
        sweep_forward(build, card)
    return 0


def _variant_source(src: str, column: int) -> str:
    """The source with FwdCfg's row for each head dim set to column
    ``column`` of FWD_CANDIDATES."""
    def row(found):
        w, sp, st = FWD_CANDIDATES[int(found.group(1))][column]
        return (f"struct FwdCfg<{found.group(1)}> {{\n  static constexpr int "
                f"WARPS = {w}, SPLIT = {sp}, STREAM = {st};\n}};")
    out, n = re.subn(r"struct FwdCfg<(\d+)> \{.*?\};", row, src, flags=re.S)
    assert n == len(FWD_CANDIDATES), n
    return out


def sweep_forward(build, card: str) -> None:
    """Time the forward of every FwdCfg variant at SWEEP's layers."""
    columns = len(next(iter(FWD_CANDIDATES.values())))
    src = (build.CSRC / "flash_attention.cu").read_text()
    root = ROOT / "build" / "fwd_sweep"
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for col in range(columns):
        d = root / f"v{col}"
        d.mkdir(parents=True)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "flash_attention.cu").write_text(_variant_source(src, col))
        lib = d / "libfa.so"
        procs.append((col, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(d / "flash_attention.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    entries = {}
    for col, lib, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode:
            print(f"variant {col}: build failed\n{report}")
            continue
        print(f"variant {col}: " + ", ".join(
            f"D={d} {FWD_CANDIDATES[d][col]}" for d in FWD_CANDIDATES))
        report_ptxas(report, only="fa_fwd")
        dll = ctypes.CDLL(str(lib))
        fn = dll.repro_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[col] = fn
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, (b, h, kv, s, d, causal, window) in SWEEP.items():
        count = max(2, -(-2 * L2_BYTES // (8 * (b * h + b * kv) * s * d)))
        sets = []
        for _ in range(count):
            q = torch.randn(b, h, s, d, generator=gen, device="cuda") * 0.5
            k = torch.randn(b, kv, s, d, generator=gen, device="cuda") * 0.5
            v = torch.randn(b, kv, s, d, generator=gen, device="cuda")
            sets.append((q, k, v, torch.empty_like(q),
                         torch.empty(b, h, s, device="cuda")))
        want = None
        times = {}
        for col, fn in entries.items():
            def call(q, k, v, o, lse, _fn=fn):
                code = _fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(), b, h, kv, s, s, d,
                           s, int(causal), window, 0,
                           torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"variant {col}: CUDA error {code}")
            times[str(FWD_CANDIDATES[d][col])] = round(device_us(call, sets),
                                                       2)
            call(*sets[0])
            torch.cuda.synchronize()
            if want is None:
                want = sets[0][3].clone()
            err = (sets[0][3] - want).abs().max().item()
            if err > 1e-4:
                print(f"variant {col} at {label}: differs from variant 0 "
                      f"by {err}")
        print(f"sweep fwd fp32 {label} B={b} H={h} KV={kv} S={s} D={d}: "
              f"device us by (warps, split, stream): {times}; compiled "
              f"{fa_table(d)}; {card}")
        del sets
        torch.cuda.empty_cache()


def fa_table(d: int):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    return fa.FWD_TILES[d]


if __name__ == "__main__":
    sys.exit(main())
