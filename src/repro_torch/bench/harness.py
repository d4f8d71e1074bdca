"""The paper-table benchmark harness over ``repro_torch.workloads``, the
port of ``repro.bench.harness``.

For every workload x device config this measures, end to end through the
full stack (trace -> comm-aware EFT schedule -> buffer planning ->
sequential/async execution):

(a) whole-program wall time under predicted-best variant dispatch vs the
    registry-default (first) variant and the predicted-worst variant —
    the paper's "variant selection over whole pipelines" claim, reported
    as per-workload speedups plus a per-config geomean,
(b) per-kernel prediction MAPE over the tuned grid (the Table 4-8 analog,
    computed from the same persisted cache state dispatch predicts with),
(c) overhead fractions: variant-decision time as a share of wall, and the
    wall share not explained by the modelled schedule (executor cost).

Three configs, two of them real:

- ``cuda`` (the default) and ``cpu`` — one real dispatcher on ``cuda:0``
  or on the host, grid *measured* through the black-box protocol
  (``runtime.seeding.measure_from_programs``) on that device, then
  executed sequentially over workloads whose inputs lie there.  Honest
  numerics + honest MAPE; speedups here are whatever the model's ranking
  actually buys on that device.  The JAX package's one real config,
  ``cpu``, is the host JAX runs on; here the real device is the card, and
  ``cpu`` runs only when asked for (as the tests do).  ``cuda`` without a
  card raises: it never falls back to the host.
- ``simdev2`` — two simulated devices with deterministically *seeded*
  caches (``seed_from_programs``: known per-variant skews, winner never
  variant 0) and a simulated link; dispatch sleeps the pinned variant's
  predicted time and skips real kernel execution, so wall times measure
  scheduling/overlap fidelity reproducibly.  Predicted-best beating worst
  here is a structural invariant the acceptance gate checks.

``run_bench`` writes a schema-versioned ``results/bench.json`` (see
``bench.schema``, the JAX package's format) with sibling benchmark
artifacts folded in, and ``summarize`` renders the human table.
"""
from __future__ import annotations

import csv
import json
import os
import time

import numpy as np
import torch

from repro_torch.bench.pinned import MODES, PinnedDispatcher
from repro_torch.bench.schema import BENCH_SCHEMA_VERSION, validate_bench
from repro_torch.core.nnc import mape
from repro_torch.kernels import resolve_device
from repro_torch.runtime import (Dispatcher, Fingerprint, TuningCache,
                                 current_fingerprint, measure_from_programs,
                                 seed_from_programs)
from repro_torch.workloads import get_workload, suite_registry, workload_names

SIM_DEVICES = (("d0", 4.0e7), ("d1", 3.0e7))   # name -> sustained flops/s
# slow enough that per-node predicted times (the sleeps realizing the
# schedule) are milliseconds — executor/thread bookkeeping stays a small
# fraction of wall, so mode ratios reflect the schedule, not the runtime
SIM_AMPLITUDE = 1.0            # worst variant is 2x the best on sim devices
DEFAULT_CONFIGS = ("cuda", "simdev2")


def _geomean(xs) -> float:
    xs = [max(float(x), 1e-12) for x in xs]
    return float(np.exp(np.mean(np.log(xs)))) if xs else 0.0


# --------------------------------------------------------------------------
# device configs
# --------------------------------------------------------------------------

def _real_config(root, registry, programs, quick: bool, device) -> dict:
    """One measured dispatcher on ``device``, its cache under
    ``root/<device type>`` keyed by that device's fingerprint."""
    device = resolve_device(device)
    cache = TuningCache(root=os.path.join(root, device.type),
                        fingerprint=current_fingerprint(device))
    tuner = Dispatcher(registry=registry, cache=cache)
    # always the paper's NN+C model here: the closed-form baseline misranks
    # variants whose times differ by orders of magnitude across shapes
    measure_from_programs(
        tuner, programs, device=device, min_window=1e-3 if quick else 2e-3,
        fit_epochs=2000 if quick else 6000, best_of=2 if quick else 3,
        reset=True)
    maps = {m: {"local": PinnedDispatcher(registry=registry, cache=cache,
                                          mode=m)} for m in MODES}
    return {"kind": "real", "executor": "sequential", "comm": None,
            "transfer": None, "mode_maps": maps, "caches": {"local": cache}}


def _sim_config(root, registry, programs, quick: bool, device) -> dict:
    """Two seeded simulated devices; their values lie on ``device``, the
    host."""
    from repro_torch.exec import CommModel
    from repro_torch.runtime.simdev import SimLink

    caches = {}
    for name, speed in SIM_DEVICES:
        fp = Fingerprint("sim", f"bench-{name}", 1, 1, ("float32",))
        cache = TuningCache(root=os.path.join(root, "sim"), fingerprint=fp)
        seed_from_programs(Dispatcher(registry=registry, cache=cache),
                           programs, speed, amplitude=SIM_AMPLITUDE,
                           reset=True)
        caches[name] = cache
    link = SimLink(latency_s=2e-4, bytes_per_s=2e9)
    comm = CommModel(TuningCache(root=os.path.join(root, "sim-comm"),
                                 fingerprint=current_fingerprint("cpu")))
    link.measure_into(comm, [(a, b) for a in caches for b in caches
                             if a != b])
    maps = {m: {name: PinnedDispatcher(registry=registry, cache=cache,
                                       mode=m, simulate_time=True,
                                       execute=False)
                for name, cache in caches.items()} for m in MODES}
    return {"kind": "sim", "executor": "async", "comm": comm,
            "transfer": link.transfer, "mode_maps": maps, "caches": caches}


# config name -> (builder, the device its workloads' inputs lie on)
_CONFIG_BUILDERS = {"cuda": (_real_config, "cuda:0"),
                    "cpu": (_real_config, "cpu"),
                    "simdev2": (_sim_config, "cpu")}


def _device_mape(cache: TuningCache) -> dict:
    """Per-kernel model MAPE over the cache's tuned grid (all rows)."""
    out = {}
    for kernel in cache.kernels():
        entry = cache.entry(kernel)
        if entry.model is None or entry.n_rows == 0:
            continue
        out[kernel] = {
            "mape_pct": float(mape(entry.y, entry.predict(entry.X))),
            "n_rows": int(entry.n_rows)}
    return out


# --------------------------------------------------------------------------
# per-workload measurement
# --------------------------------------------------------------------------

def _attribution_of(trace):
    """Compact critical-path attribution of one executed trace (schema-5
    ``attribution`` block), or None when the trace can't be analyzed."""
    from repro_torch.obs.explain import analyze_trace, summarize_attribution
    try:
        if trace is None or not trace.events:
            return None
        doc = summarize_attribution(analyze_trace(trace))
        return doc if doc["buckets"] else None
    except Exception:
        return None    # attribution is best-effort decoration on bench.json


def _run_workload(name: str, built, cfg: dict, reps: int) -> dict:
    from repro_torch.obs import Telemetry

    if cfg["kind"] == "real":
        # real runs are sub-millisecond and noisy; extra reps are nearly
        # free and min-of-k needs the k (sim runs sleep out the schedule —
        # stable by construction, and each rep costs real wall time)
        reps = reps * 3
    prog = built.program
    walls, makespans, compiled = {}, {}, {}
    n_transfers = 0
    overhead = {"dispatch_frac": 0.0, "executor_frac": 0.0}
    telemetry_section = None
    try:
        for mode in MODES:
            c = prog.compile(devices=cfg["mode_maps"][mode],
                             bindings=built.bindings,
                             executor=cfg["executor"], comm=cfg["comm"],
                             transfer=cfg["transfer"])
            makespans[mode] = float(c.makespan)
            compiled[mode] = c
            if mode == "best":
                n_transfers = len(c.transfers)
            c()                      # warmup: library plans, decision memos
        for mode in MODES:           # all modes warm before any clock runs
            devmap = cfg["mode_maps"][mode]
            for d in devmap.values():
                d.reset_counters()
            if mode == "best":
                # the steady-state legs run *with* telemetry attached, so
                # the reported walls/overheads are the instrumented numbers.
                # Attached post-warmup: one-off first-call costs never
                # enter the residuals
                tel = Telemetry(run_id=f"{name}:{cfg['kind']}:best")
                for d in devmap.values():
                    d.telemetry = tel
            rep_walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                compiled[mode]()
                rep_walls.append(time.perf_counter() - t0)
            walls[mode] = float(min(rep_walls))
            if mode == "best":
                for d in devmap.values():   # mode_maps are shared across
                    d.telemetry = None      # workloads: scope the run here
                s = tel.summary()
                telemetry_section = {
                    "decisions": s["decisions"], "overhead": s["overhead"],
                    "drift": s["drift"], "drift_flags": s["drift_flags"]}
                total = sum(rep_walls)
                decision = sum(d.decision_s for d in devmap.values())
                overhead["dispatch_frac"] = decision / max(total, 1e-12)
                if cfg["kind"] == "sim":
                    # sleeps realize the schedule: anything past the
                    # predicted makespan is executor/transfer bookkeeping
                    unexplained = 1.0 - makespans[mode] / max(walls[mode],
                                                              1e-12)
                else:
                    kernel_s = sum(d.kernel_s for d in devmap.values()) \
                        / reps
                    unexplained = 1.0 - kernel_s / max(total / reps, 1e-12)
                overhead["executor_frac"] = max(0.0, float(unexplained))
        attribution = _attribution_of(compiled["best"].last_trace)
    finally:
        for c in compiled.values():     # stop the lane workers
            c.close()
    mapes = {}
    for cache in cfg["caches"].values():
        for kernel, m in _device_mape(cache).items():
            if kernel in built.kernels_used:
                mapes.setdefault(kernel, []).append(m["mape_pct"])
    return {
        "n_transfers": n_transfers,
        "wall_s": walls,
        "predicted_makespan_s": makespans,
        "speedup_vs_default": walls["default"] / max(walls["best"], 1e-12),
        "speedup_vs_worst": walls["worst"] / max(walls["best"], 1e-12),
        "overhead": overhead,
        "mape": {k: float(np.mean(v)) for k, v in sorted(mapes.items())},
        "telemetry": telemetry_section,
        # why the best-mode run took as long as it did: the critical-path
        # attribution of its last executed trace (None on trace-less runs)
        "attribution": attribution,
    }


# --------------------------------------------------------------------------
# the adaptive scenario: mis-seeded predictions, steal + feedback recovery
# --------------------------------------------------------------------------

ADAPTIVE_TRUE_FLOPS = 1.0e7        # both devices' actual sustained rate
ADAPTIVE_CLAIMED = {"d0": 1.0e8,   # what d0's tuning cache *claims*: 10x
                    "d1": 1.0e7}   # the truth, so the EFT piles every node
#   onto d0 (d1's cache is honest).  The static replay pays that mistake
#   as d1 idle time.  The adaptive run starts with the same lie — early
#   decisions see an implausibly light d0 backlog and stay put — but
#   every completed node feeds its actual duration back, refits pull d0's
#   model toward the truth, the live load ledger reprices d0's backlog,
#   and ready tasks start stealing to the idle (honestly-priced) d1


def run_adaptive(quick: bool = False, results_dir: str = "results",
                 device_root: str = None, workloads=None, size: str = None,
                 trace_name: str = "exec_trace_adaptive.json") -> dict:
    """The mis-seeded adaptive-vs-static scenario (schema-2 ``adaptive``
    section).  Two simulated devices with *equal true speed* but wildly
    skewed seeded predictions run each workload three ways:

    - ``static``   — the async executor replaying the mis-predicted EFT
      schedule verbatim (fresh mis-seeded caches, no feedback),
    - ``adaptive`` — the same mis-seeded start, but with runtime
      re-dispatch (``StealPolicy``) and online feedback (closed-form
      ``LinearModel`` refits, cheap enough to run inline),
    - ``replan``   — recompiled *after* the adaptive run, so the EFT plans
      over the corrected models: the across-runs payoff of the feedback.

    All dispatchers sleep the TRUE time regardless of what they predict
    (``SkewedSimDispatcher``), so wall clock measures schedule quality;
    the simulated devices' values are host tensors.  Each adaptive rep
    runs under a fresh ``repro_torch.obs.Telemetry``; the last rep's
    Chrome trace — task slices merged with telemetry counter tracks and
    steal/refit instants on one clock — is written to
    ``results_dir/trace_name``, with the raw telemetry saved next to it
    (``telemetry_path``) for ``python -m repro_torch.obs report``.
    """
    from repro_torch.core.nnc import LinearModel
    from repro_torch.exec import CommModel, StealPolicy, Topology
    from repro_torch.obs import Telemetry
    from repro_torch.runtime.online import OnlineConfig
    from repro_torch.runtime.simdev import (SimFabric, SimLink,
                                            SkewedSimDispatcher, true_time_at)

    names = list(workloads) if workloads \
        else ["decode_microbatch", "mixed_dag"]
    size = size or ("small" if quick else "medium")
    device_root = device_root or os.path.join(results_dir, "bench_devices")

    registry = suite_registry(names)
    built = {name: get_workload(name).build(size=size, registry=registry,
                                            device="cpu")
             for name in names}
    programs = [b.program for b in built.values()]

    link = SimLink(latency_s=2e-4, bytes_per_s=2e9)
    topology = Topology.shared_bus(sorted(ADAPTIVE_CLAIMED))
    fabric = SimFabric(topology, link)
    comm = CommModel(TuningCache(root=os.path.join(device_root,
                                                   "adaptive-comm"),
                                 fingerprint=current_fingerprint("cpu")))
    link.measure_into(comm, [(a, b) for a in ADAPTIVE_CLAIMED
                             for b in ADAPTIVE_CLAIMED if a != b])

    def fresh_devices(tag: str) -> dict:
        """Mis-seeded caches + true-time dispatchers, fresh per scenario
        leg so feedback from one leg never flatters another."""
        true_time = true_time_at(registry, ADAPTIVE_TRUE_FLOPS)
        out = {}
        for name, claimed in ADAPTIVE_CLAIMED.items():
            fp = Fingerprint("sim", f"adaptive-{tag}-{name}", 1, 1,
                             ("float32",))
            cache = TuningCache(root=os.path.join(device_root, "adaptive"),
                                fingerprint=fp)
            seed_from_programs(Dispatcher(registry=registry, cache=cache),
                               programs, claimed, amplitude=SIM_AMPLITUDE,
                               reset=True)
            out[name] = SkewedSimDispatcher(registry=registry, cache=cache,
                                            true_time=true_time)
        return out

    # closed-form refits are microseconds, so refit on every observation
    # and fit over a short trailing window — the appended truth outweighs
    # the mis-seeded rows within a handful of nodes
    online = OnlineConfig(refit_every=1, budget_rows=2,
                          model_factory=LinearModel, save=False)
    section = {"devices": {n: {"claimed_flops_per_s": c,
                               "true_flops_per_s": ADAPTIVE_TRUE_FLOPS}
                           for n, c in ADAPTIVE_CLAIMED.items()},
               "workloads": {}, "size": size}
    last_trace = last_tel = None
    reps = 2                       # min-of-k per leg: sleeps realize the
    #   schedule deterministically, reps only shave host-noise outliers
    for name, b in built.items():
        common = dict(bindings=b.bindings, comm=comm,
                      transfer=fabric.transfer, topology=topology)
        c_static = b.program.compile(devices=fresh_devices(f"{name}-s"),
                                     executor="async", **common)
        walls = []
        for _ in range(reps):      # the static replay never refits, so
            t0 = time.perf_counter()   # repeated runs replay identically
            out_static = c_static()
            walls.append(time.perf_counter() - t0)
        c_static.close()
        wall_static = min(walls)

        # the adaptive leg mutates its models as it runs — every rep gets
        # a fresh mis-seeded start so each measures THE mis-seeded run
        walls, n_steals, refits = [], 0, 0
        for r in range(reps):
            # one Telemetry per rep so its points share the rep's trace
            # epoch; the last rep's pair (trace + telemetry) is saved
            tel = Telemetry(run_id=f"adaptive:{name}")
            c_adapt = b.program.compile(
                devices=fresh_devices(f"{name}-a{r}"), executor="adaptive",
                steal=StealPolicy(), online=online, telemetry=tel, **common)
            if r == 0:             # the bit-exact sequential reference
                out_ref = c_adapt(_executor="sequential")
            t0 = time.perf_counter()
            out_adapt = c_adapt()
            walls.append(time.perf_counter() - t0)
            c_adapt.close()
            last_trace = c_adapt.last_trace
            last_tel = tel
            n_steals = len(last_trace.steals())
            refits = sum(sum(rr.refits.values())
                         for rr in c_adapt.refiners.values())
        wall_adapt = min(walls)
        # scope the saved telemetry to the adaptive run: the replan leg
        # reuses these dispatchers and must not keep reporting into it
        for d in c_adapt.dispatchers.values():
            d.telemetry = None

        # recompile over the feedback-corrected caches: the EFT now plans
        # with (approximately) true per-device times
        c_replan = b.program.compile(devices=c_adapt.dispatchers,
                                     executor="async", **common)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            c_replan()
            walls.append(time.perf_counter() - t0)
        c_replan.close()
        wall_replan = min(walls)

        def _tup(v):
            return v if isinstance(v, tuple) else (v,)
        bit_exact = all(torch.equal(a, r)
                        for a, r in zip(_tup(out_adapt), _tup(out_ref))) \
            and all(torch.equal(a, r)
                    for a, r in zip(_tup(out_static), _tup(out_ref)))
        section["workloads"][name] = {
            "static_wall_s": float(wall_static),
            "adaptive_wall_s": float(wall_adapt),
            "replan_wall_s": float(wall_replan),
            "speedup_vs_static": wall_static / max(wall_adapt, 1e-12),
            "replan_speedup_vs_static": wall_static / max(wall_replan,
                                                          1e-12),
            "n_steals": int(n_steals),
            "refits": int(refits),
            "bit_exact": bool(bit_exact),
        }

    section["geomean_speedup_vs_static"] = _geomean(
        [w["speedup_vs_static"] for w in section["workloads"].values()])
    if last_trace is not None:
        os.makedirs(results_dir, exist_ok=True)
        trace_path = os.path.join(results_dir, trace_name)
        with open(trace_path, "w") as f:
            # one merged timeline: task slices plus the run's counter
            # tracks (queue depth, live MAPE) and steal/refit instants
            json.dump(last_trace.to_chrome(telemetry=last_tel), f, indent=1)
        section["trace_path"] = trace_path
        tel_path = os.path.join(
            results_dir, trace_name.replace("exec_trace", "telemetry")
            if "exec_trace" in trace_name else "telemetry_adaptive.json")
        last_tel.save(tel_path)
        section["telemetry_path"] = tel_path
        att = _attribution_of(last_trace)
        if att is not None:
            section["attribution"] = att
    return section


# --------------------------------------------------------------------------
# external artifact folding (the unified-schema satellite)
# --------------------------------------------------------------------------

def fold_external(results_dir: str) -> dict:
    """Fold sibling benchmark artifacts into the unified document when
    they exist: ``runtime_overhead.json`` (dispatch overhead + oracle
    regret), ``executor_overlap.json``/``.csv`` (async-vs-sequential
    speedups), and the ``paper_tables.json`` per-combo MAPE aggregate."""
    ext = {}
    p = os.path.join(results_dir, "runtime_overhead.json")
    if os.path.exists(p):
        with open(p) as f:
            ro = json.load(f)
        cases = ro.get("cases", {})
        regrets = [c["regret_vs_oracle"] for c in cases.values()]
        ext["runtime_overhead"] = {
            "steady_overhead_pct": ro.get("steady_overhead_pct"),
            "dispatches": ro.get("dispatches"),
            "mean_regret_vs_oracle":
                float(np.mean(regrets)) if regrets else None,
            "cases": len(cases)}
    p = os.path.join(results_dir, "executor_overlap.json")
    rows = None
    if os.path.exists(p):
        with open(p) as f:
            rows = json.load(f).get("rows")
    else:
        p = os.path.join(results_dir, "executor_overlap.csv")
        if os.path.exists(p):
            with open(p, newline="") as f:
                rows = [{k: float(v) for k, v in r.items()}
                        for r in csv.DictReader(f)]
    if rows:
        ext["executor_overlap"] = {
            "rows": rows,
            "best_overlap_speedup":
                max(r["overlap_speedup"] for r in rows)}
    p = os.path.join(results_dir, "paper_tables.json")
    if os.path.exists(p):
        with open(p) as f:
            tables = json.load(f)
        if tables:
            ext["paper_tables"] = {
                "combos": len(tables),
                "nnc_mean_mape_pct": float(np.mean(
                    [r["nnc"]["mape"] for r in tables.values()])),
                "nn_mean_mape_pct": float(np.mean(
                    [r["nn"]["mape"] for r in tables.values()]))}
    return ext


# --------------------------------------------------------------------------
# the entry point
# --------------------------------------------------------------------------

def run_bench(quick: bool = False, out_path: str = "results/bench.json",
              results_dir: str = "results", device_root: str = None,
              workloads=None, size: str = None, reps: int = None,
              configs=DEFAULT_CONFIGS, adaptive: bool = None) -> dict:
    names = list(workloads) if workloads else workload_names()
    size = size or ("small" if quick else "medium")
    reps = reps or (3 if quick else 5)
    device_root = device_root or os.path.join(results_dir, "bench_devices")
    unknown = [c for c in configs if c not in _CONFIG_BUILDERS]
    if unknown:
        raise ValueError(f"unknown configs {unknown}; "
                         f"available: {sorted(_CONFIG_BUILDERS)}")

    registry = suite_registry(names)
    # the workloads once per config device, so every config's bindings lie
    # where it runs; the seeds are the JAX package's, so is the Program JSON
    built: dict = {}
    for c in configs:
        device = _CONFIG_BUILDERS[c][1]
        if device not in built:
            built[device] = {
                name: get_workload(name).build(size=size, registry=registry,
                                               device=device)
                for name in names}

    cfgs = {}
    for c in configs:
        builder, device = _CONFIG_BUILDERS[c]
        programs = [b.program for b in built[device].values()]
        cfgs[c] = builder(device_root, registry, programs, quick, device)

    workload_results = {}
    for name in names:
        any_built = next(iter(built.values()))[name]
        workload_results[name] = {
            "size": size,
            "kernels": sorted(any_built.kernels_used),
            "n_nodes": any_built.n_nodes,
            "configs": {c: _run_workload(
                name, built[_CONFIG_BUILDERS[c][1]][name], cfg, reps)
                for c, cfg in cfgs.items()},
        }

    geomean = {}
    for c in cfgs:
        rows = [w["configs"][c] for w in workload_results.values()]
        geomean[c] = {
            "speedup_vs_default": _geomean(
                [r["speedup_vs_default"] for r in rows]),
            "speedup_vs_worst": _geomean(
                [r["speedup_vs_worst"] for r in rows])}

    # the host's fingerprint is the real device's; a run of simulated
    # configs only ran on the host
    real = [_CONFIG_BUILDERS[c][1] for c, cfg in cfgs.items()
            if cfg["kind"] == "real"]
    doc = {
        "schema": BENCH_SCHEMA_VERSION,
        "quick": bool(quick),
        "generated_unix": float(time.time()),
        "host_fingerprint": current_fingerprint(
            real[0] if real else "cpu").to_json(),
        "configs": {c: {"kind": cfg["kind"], "executor": cfg["executor"],
                        "devices": sorted(cfg["caches"]),
                        "device_mape": {d: _device_mape(cache)
                                        for d, cache
                                        in cfg["caches"].items()}}
                    for c, cfg in cfgs.items()},
        "workloads": workload_results,
        "geomean": geomean,
        "external": fold_external(results_dir),
    }
    if adaptive or (adaptive is None and "simdev2" in configs):
        doc["adaptive"] = run_adaptive(quick=quick, results_dir=results_dir,
                                       device_root=device_root, size=size)
    validate_bench(doc)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, out_path)
    return doc


def summarize(doc: dict) -> list:
    """Human-readable summary table of a bench document."""
    lines = [f"== repro_torch.bench: {len(doc['workloads'])} workloads, "
             f"configs {', '.join(sorted(doc['configs']))} "
             f"({'quick' if doc['quick'] else 'full'}) =="]
    for cfg in sorted(doc["configs"]):
        meta = doc["configs"][cfg]
        lines.append(f"-- {cfg} ({meta['kind']}, {meta['executor']}, "
                     f"devices: {','.join(meta['devices'])}) --")
        lines.append(f"{'workload':20s} {'nodes':>5s} {'xfers':>5s} "
                     f"{'best_ms':>9s} {'default':>8s} {'worst':>8s} "
                     f"{'vs_def':>7s} {'vs_worst':>8s} {'mape%':>7s} "
                     f"{'disp%':>6s}")
        for name in sorted(doc["workloads"]):
            w = doc["workloads"][name]
            r = w["configs"].get(cfg)
            if r is None:
                continue
            mapes = list(r["mape"].values())
            lines.append(
                f"{name:20s} {w['n_nodes']:5d} {r['n_transfers']:5d} "
                f"{r['wall_s']['best'] * 1e3:9.2f} "
                f"{r['wall_s']['default'] * 1e3:8.2f} "
                f"{r['wall_s']['worst'] * 1e3:8.2f} "
                f"{r['speedup_vs_default']:6.2f}x "
                f"{r['speedup_vs_worst']:7.2f}x "
                f"{float(np.mean(mapes)):7.1f} "
                f"{100 * r['overhead']['dispatch_frac']:6.2f}")
        g = doc["geomean"][cfg]
        lines.append(f"{'geomean':20s} {'':5s} {'':5s} {'':9s} {'':8s} "
                     f"{'':8s} {g['speedup_vs_default']:6.2f}x "
                     f"{g['speedup_vs_worst']:7.2f}x")
        flags = sorted({f"{name}:{k}"
                        for name, w in doc["workloads"].items()
                        for k in ((w["configs"].get(cfg) or {})
                                  .get("telemetry") or {})
                        .get("drift_flags", ())})
        if flags:
            lines.append(f"drift flags ({cfg}): {', '.join(flags)}")
    ad = doc.get("adaptive")
    if ad:
        lines.append("-- adaptive (mis-seeded steal + feedback vs static "
                     "replay) --")
        lines.append(f"{'workload':20s} {'static_ms':>10s} {'adapt_ms':>9s} "
                     f"{'replan_ms':>10s} {'speedup':>8s} {'steals':>6s} "
                     f"{'refits':>6s} {'exact':>5s}")
        for name in sorted(ad["workloads"]):
            w = ad["workloads"][name]
            lines.append(
                f"{name:20s} {w['static_wall_s'] * 1e3:10.1f} "
                f"{w['adaptive_wall_s'] * 1e3:9.1f} "
                f"{w['replan_wall_s'] * 1e3:10.1f} "
                f"{w['speedup_vs_static']:7.2f}x "
                f"{w['n_steals']:6d} {w['refits']:6d} "
                f"{'yes' if w['bit_exact'] else 'NO':>5s}")
        lines.append(f"{'geomean':20s} {'':10s} {'':9s} {'':10s} "
                     f"{ad['geomean_speedup_vs_static']:7.2f}x")
    ext = doc.get("external", {})
    ro = ext.get("runtime_overhead")
    # fields may be None when the folded artifact was partial/degenerate
    if ro and isinstance(ro.get("steady_overhead_pct"), (int, float)):
        regret = ro.get("mean_regret_vs_oracle")
        lines.append(
            f"external: runtime dispatch overhead "
            f"{ro['steady_overhead_pct']:.2f}%"
            + (f" (regret {regret:.2f}x)"
               if isinstance(regret, (int, float)) else ""))
    if ext.get("executor_overlap"):
        lines.append(f"external: best executor overlap speedup "
                     f"{ext['executor_overlap']['best_overlap_speedup']:.2f}x")
    if ext.get("paper_tables"):
        pt = ext["paper_tables"]
        lines.append(f"external: paper tables nnc MAPE "
                     f"{pt['nnc_mean_mape_pct']:.1f}% over "
                     f"{pt['combos']} combos")
    return lines
