"""``python -m repro_torch.bench serve``: the serving-engine arrival-trace
scenario, the port of ``repro.bench.serve_trace``.

Drives seeded arrival traces (Poisson steady load + mixed short/long
bursts) through ``repro_torch.serve.ServeEngine`` on a reduced transformer and
compares FIFO vs cost-aware (SJF) admission.  The protocol mirrors how a
deployment would warm up:

1. a FIFO warmup run records real split ``prefill_step``/``decode_step``
   rows into a scratch tuning cache,
2. ``fit_cost_entries`` fits both entries (deterministic ``LinearModel``),
3. each (trace x policy) combination runs on a *fresh* engine over the
   shared fitted cache with its own ``repro_torch.obs.Telemetry``.

Every reported number comes out of the telemetry document — TTFT and
per-token latency from the ``serve.ttft_s``/``serve.token_latency_s``
histograms, goodput from the ``serve.goodput_tok_s`` gauge series —
never from engine-private state, so the bench measures exactly what a
monitoring stack would see.

The headline claim is ``sjf_beats_fifo_bursty``: on the bursty trace SJF
must improve p99 *or* mean TTFT over FIFO (with one long job per burst
the p99 often IS the long job, which SJF deliberately delays — the mean
is the theory-backed win).  ``run_serve`` merges the section into an
existing ``results/bench.json`` (schema 4) and always writes
``results/bench_serve.json`` + ``results/telemetry_serve.json``.

The engines run on ``device`` (the card unless the caller asks for the
CPU) over a tuning cache under that device's fingerprint; the weights come
from ``torch.Generator().manual_seed(0)`` (the reference's ``PRNGKey(0)``
gives others), the traces from ``seed`` as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch.bench.schema import (BENCH_SCHEMA_VERSION, load_bench,
                                      validate_bench)
from repro_torch.configs import ARCHS
from repro_torch.core.nnc import LinearModel
from repro_torch.kernels import resolve_device
from repro_torch.models import build_model
from repro_torch.obs.telemetry import Telemetry
from repro_torch.runtime.cache import TuningCache
from repro_torch.runtime.fingerprint import current_fingerprint
from repro_torch.serve import ServeEngine, fit_cost_entries
from repro_torch.serve.policy import _decode_entry, _prefill_entry
from repro_torch.serve.request import bursty_trace, poisson_trace

ARCH = "yi-9b"          # reduced() preset: 2 layers, d_model 64
MAX_SLOTS = 2
POLICIES = ("fifo", "sjf")


def _hist(summary: dict, name: str) -> dict:
    h = summary.get("histograms", {}).get(name, {})
    return {"p50": float(h.get("p50", 0.0)),
            "p99": float(h.get("p99", 0.0)),
            "mean": float(h.get("mean", 0.0)),
            "count": int(h.get("count", 0))}


def _goodput(tel: Telemetry) -> float:
    pts = tel.series("serve.goodput_tok_s")
    return float(pts[-1][1]) if pts else 0.0


def _traces(quick: bool, seed: int) -> dict:
    """(arrival-process name, fresh-request factory) per trace.  Factories,
    not lists: requests are mutated by a run, so each engine/policy gets a
    fresh copy of the *same* seeded trace."""
    n_poisson = 8 if quick else 20
    n_bursts = 2 if quick else 4
    return {
        "poisson": ("poisson", lambda: poisson_trace(
            n_poisson, seed=seed + 1, rate=0.4)),
        "bursty": ("burst", lambda: bursty_trace(
            n_bursts, seed=seed + 2, burst_gap=16)),
    }


def run_serve(quick: bool = False, *, results_dir: str = "results",
              seed: int = 0, cache_root: str = None,
              device="cuda") -> dict:
    device = resolve_device(device)
    cfg = dataclasses.replace(ARCHS[ARCH].reduced(),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device=device)
    max_seq = 96 if quick else 160
    cache_root = cache_root or tempfile.mkdtemp(prefix="serve_tunecache_")
    cache = TuningCache(root=cache_root,
                        fingerprint=current_fingerprint(device))

    # 1-2. warmup records split rows (and absorbs the jit compiles, which
    # must not contaminate the measured traces), then a deterministic fit
    warm = ServeEngine(model, cache, params=params, max_slots=MAX_SLOTS,
                       max_seq=max_seq, admission="fifo")
    warm.run_trace(poisson_trace(6 if quick else 12, seed=seed, rate=0.5))
    fit_cost_entries(cache, model_factory=LinearModel, save=False)

    # 3. trace x policy grid, fresh engine + telemetry per cell
    section = {
        "size": "quick" if quick else "full",
        "model": ARCH, "max_slots": MAX_SLOTS, "max_seq": max_seq,
        "cost_model": {
            "prefill_mape_pct": float(_prefill_entry(cache).fit_mape),
            "decode_mape_pct": float(_decode_entry(cache).fit_mape)},
        "traces": {},
    }
    tel_saved = None
    for tname, (arrival, mk_trace) in _traces(quick, seed).items():
        entry = {"arrival": arrival, "n_requests": len(mk_trace()),
                 "policies": {}}
        for policy in POLICIES:
            tel = Telemetry()
            eng = ServeEngine(model, cache, params=params,
                              max_slots=MAX_SLOTS, max_seq=max_seq,
                              admission=policy, telemetry=tel,
                              record_rows=False)
            stats = eng.run_trace(mk_trace())
            s = tel.summary()
            entry["policies"][policy] = {
                "ttft_s": _hist(s, "serve.ttft_s"),
                "token_latency_s": _hist(s, "serve.token_latency_s"),
                "goodput_tok_s": _goodput(tel),
                "completed": int(stats["completed"]),
                "rejected": int(stats["rejected"]),
                "engine_steps": int(stats["engine_steps"]),
                "occupancy": float(stats["occupancy"]),
                "admission_fallback": bool(stats["admission_fallback"]),
            }
            if tname == "bursty" and policy == "sjf":
                tel_saved = tel
        section["traces"][tname] = entry

    fifo = section["traces"]["bursty"]["policies"]["fifo"]["ttft_s"]
    sjf = section["traces"]["bursty"]["policies"]["sjf"]["ttft_s"]
    section["sjf_beats_fifo_bursty"] = bool(
        sjf["p99"] < fifo["p99"] or sjf["mean"] < fifo["mean"])

    os.makedirs(results_dir, exist_ok=True)
    if tel_saved is not None:
        tel_path = os.path.join(results_dir, "telemetry_serve.json")
        tel_saved.save(tel_path)
        section["telemetry_path"] = tel_path
    return section


def _atomic_write(doc: dict, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def write_serve(section: dict, *, out_path: str = "results/bench.json",
                results_dir: str = "results", quick: bool = False) -> str:
    """Merge the serve section into ``out_path`` when a bench document
    exists there (bumping to schema 4), and always write the standalone
    ``bench_serve.json`` next to it.  Returns the path written."""
    standalone = os.path.join(results_dir, "bench_serve.json")
    os.makedirs(results_dir, exist_ok=True)
    _atomic_write({"schema": BENCH_SCHEMA_VERSION, "quick": quick,
                   "generated_unix": time.time(), "serve": section},
                  standalone)
    if os.path.exists(out_path):
        doc = load_bench(out_path)
        doc["serve"] = section
        doc["schema"] = max(int(doc["schema"]), BENCH_SCHEMA_VERSION)
        validate_bench(doc)
        _atomic_write(doc, out_path)
        return out_path
    return standalone


def summarize_serve(section: dict) -> list:
    lines = [f"serve [{section['size']}] model={section['model']} "
             f"slots={section['max_slots']} "
             f"(prefill fit {section['cost_model']['prefill_mape_pct']:.0f}% "
             f"/ decode fit {section['cost_model']['decode_mape_pct']:.0f}% "
             "MAPE)"]
    for tname, t in section["traces"].items():
        for policy, r in t["policies"].items():
            tt = r["ttft_s"]
            lines.append(
                f"  {tname:<8} {policy:<4} ttft p50={tt['p50'] * 1e3:7.2f}ms "
                f"p99={tt['p99'] * 1e3:7.2f}ms mean={tt['mean'] * 1e3:7.2f}ms "
                f"goodput={r['goodput_tok_s']:8.1f} tok/s "
                f"done={r['completed']}")
    verdict = "yes" if section["sjf_beats_fifo_bursty"] else "NO"
    lines.append(f"  SJF beats FIFO on bursty (p99 or mean TTFT): {verdict}")
    return lines
