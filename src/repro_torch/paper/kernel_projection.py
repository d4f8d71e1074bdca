"""The hand attention kernels' projection for the memory term: the port of
``benchmarks/kernel_projection.py``.

The plain attention path (``models.attention.attend_chunked``, what a
dry-run cell's step runs) materialises its score tiles in device memory;
the hand flash-attention kernels (``kernels/flash_attention``) keep them
on chip, and memory sees only q/k/v/out (plus the backward's reads and
dq/dk/dv).  The plain path's traffic comes from the dry-run's op counter
(``launch.dryrun.trace``: each op's inputs plus outputs) over
``attend_chunked`` forward and forward+backward at a rank's shape in bf16
on fake tensors, where the reference lowers and analyses HLO.  The kernel
boundary bytes are then substituted, with the reference's arithmetic:

  adjusted_mem = mem - layers * (T_plain_attn - T_kernel_attn) / HBM_BW

``HBM_BW`` is ``launch.roofline``'s (the H100 SXM data sheet's).  The cells
are the dry-run document's (``arch|shape|mesh`` and, from ``dryrun
--variant``, ``arch|shape|mesh|variant``), where the reference reads a
``results/hillclimb.json`` nothing in the repo writes.  On a card,
``kernel_times`` measures the hand kernels at the same shape by CUDA events
(the lse-writing forward, dq, dk/dv), printed beside each projection.

    PYTHONPATH=src python -m repro_torch.paper.kernel_projection [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.launch import dryrun
from repro_torch.launch.roofline import HBM_BW
from repro_torch.models.attention import attend_chunked

# projected key -> (the dry-run cell it adjusts, the per-rank attention
# shape): the reference's three cases and gemma3-1b's plain train_4k cell
CASES = {
    # deepseek train: B=256/16, H=64/16, S=4096, d=128, KV=8/16->1(rep/2)
    "deepseek-67b|train_4k|pod16x16|pallas": (
        "deepseek-67b|train_4k|pod16x16",
        dict(b_loc=16, h_loc=4, s=4096, d=128, kv_loc=1, layers=95)),
    # qwen3 train on top of moeshard
    "qwen3-moe-235b-a22b|train_4k|pod16x16|moeshard+pallas": (
        "qwen3-moe-235b-a22b|train_4k|pod16x16|moeshard",
        dict(b_loc=16, h_loc=4, s=4096, d=128, kv_loc=1, layers=94)),
    # gemma3 on top of localattn+sp: per-device q seq 4096/16, full heads
    "gemma3-1b|train_4k|pod16x16|localattn+sp+pallas": (
        "gemma3-1b|train_4k|pod16x16|localattn+sp",
        dict(b_loc=16, h_loc=4, s=256, d=256, kv_loc=1, layers=26,
             window=512)),
    # gemma3 as the dry-run's plain cell holds it: B=256/16, every head
    "gemma3-1b|train_4k|pod16x16|pallas": (
        "gemma3-1b|train_4k|pod16x16",
        dict(b_loc=16, h_loc=4, s=4096, d=256, kv_loc=1, layers=26,
             window=512)),
}


def attention_traffic(b, h, s, d, *, k_chunk=1024, q_chunk=512,
                      window=0) -> tuple[float, float]:
    """(fwd bytes, fwd+bwd bytes) of the plain path at one rank's shape, by
    the dry-run's op counter over bf16 fake tensors."""
    q = torch.empty((b, s, h, d), dtype=torch.bfloat16, device="meta")

    def fwd(q, k, v):
        return attend_chunked(q, k, v, causal=True, window=window,
                              k_chunk=k_chunk, q_chunk=q_chunk)

    def grad(q, k, v):
        leaves = [t.requires_grad_() for t in (q, k, v)]
        loss = (fwd(*leaves).to(torch.float32) ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    with torch.no_grad():
        t_f = dryrun.trace(fwd, (q, q, q))[0].totals.hbm_bytes
    t_fb = dryrun.trace(grad, (q, q, q))[0].totals.hbm_bytes
    return t_f, t_fb


def kernel_boundary_traffic(b, h, s, d, kv_heads=None) -> tuple[float, float]:
    """(fwd, fwd+bwd) bytes the hand kernels move through device memory."""
    kv = kv_heads or h
    qb = b * s * h * d * 2
    kvb = 2 * b * s * kv * d * 2
    ob = qb
    fwd = qb + kvb + ob
    # bwd: read q,k,v,o,do + write dq,dk,dv (the backward recomputes on chip)
    bwd = (qb * 2 + kvb + ob) + (qb + kvb)
    return fwd, fwd + bwd


def project_cell(cell: dict, *, b_loc, h_loc, s, d, kv_loc, layers,
                 attn_passes=3.0, window=0, k_chunk=1024) -> dict:
    """attn_passes: 2 fwd (remat) + 1 bwd worth of traffic ~ fwd + fwd+bwd."""
    t_f, t_fb = attention_traffic(b_loc, h_loc, s, d, window=window,
                                  k_chunk=k_chunk)
    k_f, k_fb = kernel_boundary_traffic(b_loc, h_loc, s, d, kv_loc)
    # per layer: one fwd (live) + one fwd (remat) + one bwd
    plain_total = layers * (t_f + t_fb)
    kern_total = layers * (k_f + k_fb)
    saved = plain_total - kern_total
    adj = dict(cell)
    adj["memory_s"] = cell["memory_s"] - saved / HBM_BW
    adj["per_device_bytes"] = cell["per_device_bytes"] - saved
    adj["attn_hlo_bytes"] = plain_total
    adj["attn_kernel_bytes"] = kern_total
    terms = {"compute": adj["compute_s"], "memory": adj["memory_s"],
             "collective": adj["collective_s"]}
    adj["bottleneck"] = max(terms, key=terms.get)
    return adj


def kernel_times(b, h, s, d, kv, *, window=0, device="cuda",
                 reps: int = 3) -> dict:
    """Milliseconds a call of each hand kernel takes at one rank's shape in
    bf16 (CUDA events over ``reps`` calls after a warm one): the
    lse-writing forward, dq and dk/dv.  The kernels run on a card only."""
    from repro_torch.kernels import resolve_device
    from repro_torch.kernels.flash_attention import flash_attention as fa

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("kernel_times: the hand kernels run on a card")
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, h, s, d, generator=gen, device=device) * 0.5
    k = torch.randn(b, kv, s, d, generator=gen, device=device) * 0.5
    v, do = (torch.randn(b, n, s, d, generator=gen, device=device)
             for n in (kv, h))
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    kw = {"causal": True, "window": window}
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(dim=-1)
    calls = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(
                 q, k, v, **kw),
             "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
                 q, k, v, do, lse, delta, **kw),
             "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
                 q, k, v, do, lse, delta, **kw)}
    out = {}
    for name, call in calls.items():
        call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / reps
    return out


def project(doc: dict, cases: dict = CASES, device=None) -> dict:
    """Each case whose cell the dry-run document holds, projected (and, on
    a card, the hand kernels timed at its shape); prints one line each."""
    out = {}
    for key, (cell_key, kw) in cases.items():
        cell = doc.get(cell_key)
        if not cell or not cell.get("ok") or cell.get("skipped"):
            arch, shape, mesh, *variant = cell_key.split("|")
            print(f"[kernels] {key}: no dry-run cell {cell_key} — run "
                  f"`python -m repro_torch.launch.dryrun --arch {arch} "
                  f"--shape {shape}{' --multi-pod' if mesh != 'pod16x16' else ''}"
                  f"{' --variant ' + variant[0] if variant else ''}`")
            continue
        adj = project_cell(cell, **kw)
        line = (f"[kernels] {key}: memory {cell['memory_s']:.1f}s -> "
                f"{adj['memory_s']:.1f}s (attn plain "
                f"{adj['attn_hlo_bytes']/1e9:.0f}GB -> kernel "
                f"{adj['attn_kernel_bytes']/1e9:.0f}GB); bottleneck "
                f"{adj['bottleneck']}")
        if device is not None:
            ms = kernel_times(kw["b_loc"], kw["h_loc"], kw["s"], kw["d"],
                              kw["kv_loc"], window=kw.get("window", 0),
                              device=device)
            adj["kernel_ms"] = ms
            per_layer = sum(ms.values()) + ms["flash_attention_fwd"]
            adj["kernel_s"] = kw["layers"] * per_layer / 1e3
            line += (f"; measured a layer: " + ", ".join(
                f"{n.removeprefix('flash_attention_')} {t:.3f} ms"
                for n, t in ms.items())
                + f", x{kw['layers']} layers (fwd twice) "
                f"{adj['kernel_s']:.3f}s against the projected kernel "
                f"bytes' {adj['attn_kernel_bytes'] / HBM_BW:.3f}s")
        print(line)
        out[key] = adj
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.paper.kernel_projection")
    ap.add_argument("--dryrun", default="results/torch/dryrun.json")
    ap.add_argument("--out", default="results/torch/kernel_projection.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) also times the hand kernels; "
                         "cpu projects only")
    args = ap.parse_args(argv)
    from repro_torch.kernels import resolve_device

    device = resolve_device(args.device)
    with open(args.dryrun) as f:
        doc = json.load(f)
    out = project(doc, device=device if device.type == "cuda" else None)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
