"""Causal critical-path analysis and makespan attribution, the port of
``repro.obs.explain``.

``analyze_trace`` reconstructs the dependency DAG of one execution from
its ``exec.ExecutionTrace`` (every event carries ``deps`` + ``meta``
since the lowering attaches them) and answers *why* the run took as long
as it did:

- **realized critical path** — walk backward from the last-ending task
  along each task's *binding* dependency (the dep that finished last).
  Each chain link owns the segment ``[ready, end]`` where ``ready`` is
  its binding dep's finish; segments are contiguous and disjoint, so
  their lengths sum to the makespan *exactly* — the attribution is a
  partition, not an estimate.
- **makespan buckets** — each segment splits into run time (bucketed
  ``compute.<kernel>`` or ``transfer.<lane>``) and wait time, with the
  wait further split into ``queue.<lane>`` (the lane was busy running
  other tasks) and ``overhead.dispatch``/``overhead.steal`` (nothing ran:
  executor bookkeeping, thread wakeups, steal re-homing latency).
- **per-task slack** — classic CPM backward pass over dataflow *and*
  lane-succession edges: how much later a task could have finished
  without moving the makespan.
- **predicted critical path** — the same walk over the frozen EFT
  schedule's predicted finishes (``meta.predicted_finish_s``), diffed
  against the realized chain (which tasks entered/left the critical
  path) — the "did mispredictions change the schedule's shape" signal.
- **misprediction attribution** — for every critical-chain task with a
  prediction, the signed seconds its error cost (``actual - predicted``,
  wall units), grouped by (kernel, shape-bucket) and ranked.  Each group
  carries the planned device's fit-time MAPE band, so a drift flag
  cross-references to schedule damage in seconds.

``analyze_chrome`` runs the same analysis on a *saved* Chrome trace
(``ExecutionTrace.from_chrome`` round-trips deps/meta), so explain works
on CI artifacts long after the run.  ``waterfalls_from_telemetry``
renders the serve-engine side: per-request TTFT decomposed into queue
wait / prefill execution / decode execution / scheduling overhead from
the ``request.arrival:<rid>`` / ``admission:<rid>`` / per-step
``serve.step`` spans ``serve.engine`` records.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

EXPLAIN_SCHEMA_VERSION = 1
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class TaskRecord:
    """One analyzed task span (seconds on the trace clock)."""
    name: str
    kind: str                   # "compute" | "transfer"
    lane: str
    begin_s: float
    end_s: float
    deps: tuple = ()
    meta: Optional[dict] = None
    note: str = ""

    @property
    def dur_s(self) -> float:
        return self.end_s - self.begin_s


# --------------------------------------------------------------------------
# interval helpers (closed-open [a, b) intervals in seconds)
# --------------------------------------------------------------------------

def _merge(intervals: Sequence[tuple]) -> list:
    out: list = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(intervals: Sequence[tuple]) -> float:
    return sum(b - a for a, b in intervals)


def _overlap(a0: float, a1: float, merged: Sequence[tuple]) -> float:
    """Length of [a0, a1) covered by the merged interval list."""
    return sum(max(0.0, min(a1, b1) - max(a0, b0)) for b0, b1 in merged)


def _subtract(intervals: list, holes: list) -> list:
    """Merged ``intervals`` minus merged ``holes``."""
    out = []
    for a, b in intervals:
        cur = a
        for h0, h1 in holes:
            if h1 <= cur or h0 >= b:
                continue
            if h0 > cur:
                out.append((cur, h0))
            cur = max(cur, h1)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


# --------------------------------------------------------------------------
# record extraction
# --------------------------------------------------------------------------

def records_from_trace(trace) -> tuple:
    """``(records, epoch, n_steals)`` from a live ``ExecutionTrace``."""
    records = [TaskRecord(e.name, e.kind, e.device, e.begin_s, e.end_s,
                          tuple(e.deps), dict(e.meta) if e.meta else None,
                          e.note)
               for e in trace.by_start() if e.kind in ("compute",
                                                       "transfer")]
    n_steals = sum(1 for e in trace.events if e.kind == "steal")
    return records, trace.t0, n_steals


def analyze_trace(trace) -> dict:
    records, epoch, n_steals = records_from_trace(trace)
    return analyze(records, epoch=epoch, n_steals=n_steals)


def analyze_chrome(doc: dict) -> dict:
    """Analyze a saved Chrome trace document (``to_chrome`` output)."""
    from repro_torch.exec.trace import ExecutionTrace
    return analyze_trace(ExecutionTrace.from_chrome(doc))


# --------------------------------------------------------------------------
# the analysis
# --------------------------------------------------------------------------

def _toposort(records: list, by_name: dict, succ: dict) -> list:
    """Topological order over the successor edges (Kahn)."""
    indeg = {r.name: 0 for r in records}
    for n, ss in succ.items():
        for s in ss:
            indeg[s] += 1
    ready = deque(sorted(n for n, d in indeg.items() if d == 0))
    out = []
    while ready:
        n = ready.popleft()
        out.append(n)
        for s in succ[n]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if len(out) != len(records):        # cycle (corrupt trace): fall back
        return [r.name for r in sorted(records,
                                       key=lambda r: (r.begin_s, r.name))]
    return out


def _critical_chain(records: list, by_name: dict, t0: float) -> list:
    """``[(record, segment_start), ...]`` in start order.  Segment i runs
    from the binding dep's finish (or ``t0`` for the chain head) to the
    task's finish; consecutive segments share endpoints, so segment
    lengths partition ``[t0, makespan_end]`` exactly."""
    chain = []
    cur = max(records, key=lambda r: (r.end_s, r.name))
    seen: set = set()
    while cur is not None and cur.name not in seen:
        seen.add(cur.name)
        deps = [by_name[d] for d in cur.deps if d in by_name]
        binding = max(deps, key=lambda r: (r.end_s, r.name)) \
            if deps else None
        chain.append((cur, binding.end_s if binding is not None else t0))
        cur = binding
    chain.reverse()
    return chain


def _slack(records: list, by_name: dict, succ_data: dict,
           end_t: float) -> dict:
    """Backward CPM pass.  Successor edges are dataflow (dep -> consumer)
    plus lane succession (a lane runs one task at a time, so a task also
    blocks the next task on its lane) — without the resource edges, tasks
    that delay others purely by occupying a lane would show phantom
    slack."""
    succ = {r.name: list(succ_data[r.name]) for r in records}
    by_lane: dict = {}
    for r in sorted(records, key=lambda r: (r.begin_s, r.name)):
        by_lane.setdefault(r.lane, []).append(r)
    for evs in by_lane.values():
        for a, b in zip(evs, evs[1:]):
            succ[a.name].append(b.name)
    order = _toposort(records, by_name, succ)
    lf: dict = {}
    for name in reversed(order):
        ss = succ[name]
        if not ss:
            lf[name] = end_t
        else:
            lf[name] = min(lf[s] - by_name[s].dur_s for s in ss)
    return {n: max(0.0, lf[n] - by_name[n].end_s) for n in lf}


def _wait_split(rec: TaskRecord, seg_start: float,
                lane_busy: dict) -> tuple:
    """``(queue_s, overhead_s)`` for the chain segment's wait interval
    ``[seg_start, begin)``: queue is the part during which the task's
    lane was busy running *other* tasks, overhead the remainder
    (dispatch/steal bookkeeping, idle thread wakeup)."""
    w0, w1 = seg_start, min(rec.begin_s, rec.end_s)
    if w1 <= w0:
        return 0.0, 0.0
    busy = [(a, b) for a, b, name in lane_busy.get(rec.lane, ())
            if name != rec.name]
    queue = _overlap(w0, w1, _merge([(a, b) for a, b in busy]))
    return queue, max(0.0, (w1 - w0) - queue)


def _predicted_chain(records: list, by_name: dict) -> Optional[dict]:
    """The EFT schedule's own critical path, walked over
    ``meta.predicted_finish_s`` (model units).  Transfers without
    predicted timelines are hopped through to their producers, so the
    path is over compute nodes — comparable with the realized chain's
    compute subset."""
    def p_finish(r) -> Optional[float]:
        m = r.meta or {}
        v = m.get("predicted_finish_s")
        return float(v) if isinstance(v, (int, float)) else None

    comp = [r for r in records
            if r.kind == "compute" and p_finish(r) is not None]
    if not comp:
        return None

    def pred_deps(r) -> list:
        out = []
        for d in r.deps:
            rd = by_name.get(d)
            if rd is None:
                continue
            if rd.kind == "transfer":
                out += [by_name[x] for x in rd.deps if x in by_name]
            else:
                out.append(rd)
        return [x for x in out
                if x.kind == "compute" and p_finish(x) is not None]

    cur = max(comp, key=lambda r: (p_finish(r), r.name))
    predicted_end = p_finish(cur)
    path, seen = [], set()
    while cur is not None and cur.name not in seen:
        seen.add(cur.name)
        path.append(cur.name)
        ds = pred_deps(cur)
        cur = max(ds, key=lambda r: (p_finish(r), r.name)) if ds else None
    path.reverse()
    return {"path": path, "makespan_model_s": predicted_end}


def _mispredictions(chain: list) -> list:
    """Signed makespan-seconds each (kernel, shape-bucket) pair's
    prediction error cost along the realized critical chain, ranked
    worst first.  Positive cost = the work ran slower than the schedule
    believed (it stretched the makespan); negative = faster."""
    groups: dict = {}
    for rec, _seg in chain:
        m = rec.meta or {}
        pred = m.get("predicted_s")
        if not isinstance(pred, (int, float)):
            continue
        key = (m.get("kernel", rec.name), m.get("shape_bucket", ""))
        g = groups.setdefault(key, {
            "kernel": key[0], "shape_bucket": key[1],
            "cost_s": 0.0, "predicted_s": 0.0, "actual_s": 0.0,
            "n_tasks": 0, "lanes": set(),
            "fit_band_pct": m.get("fit_band_pct")})
        g["cost_s"] += rec.dur_s - float(pred)
        g["predicted_s"] += float(pred)
        g["actual_s"] += rec.dur_s
        g["n_tasks"] += 1
        g["lanes"].add(rec.lane)
    out = []
    for g in groups.values():
        g["lanes"] = sorted(g["lanes"])
        g["ape_pct"] = 100.0 * abs(g["actual_s"] - g["predicted_s"]) \
            / max(g["predicted_s"], _EPS)
        band = g.get("fit_band_pct")
        g["exceeds_fit_band"] = bool(
            isinstance(band, (int, float)) and g["ape_pct"] > band)
        out.append(g)
    out.sort(key=lambda g: (-g["cost_s"], g["kernel"], g["shape_bucket"]))
    return out


def lane_utilization(records: list, t0: float, end_t: float) -> dict:
    """Per-lane busy/wait/idle decomposition of ``[t0, end_t]``: busy is
    time the lane ran tasks; wait is lane-idle time during which at least
    one task that eventually ran on the lane was already ready (deps
    resolved) — a dispatch gap; idle is starvation (no runnable work)."""
    span = max(end_t - t0, _EPS)
    by_name = {r.name: r for r in records}
    out: dict = {}
    by_lane: dict = {}
    for r in records:
        by_lane.setdefault(r.lane, []).append(r)
    for lane, evs in sorted(by_lane.items()):
        busy_iv = _merge([(r.begin_s, r.end_s) for r in evs])
        busy = _length(busy_iv)
        pend = []
        for r in evs:
            ds = [by_name[d].end_s for d in r.deps if d in by_name]
            ready = max(ds) if ds else t0
            if r.begin_s > ready:
                pend.append((max(t0, ready), r.begin_s))
        wait = _length(_subtract(_merge(pend), busy_iv))
        idle = max(0.0, span - busy - wait)
        out[lane] = {"busy_s": busy, "busy_frac": busy / span,
                     "wait_frac": wait / span, "idle_frac": idle / span,
                     "n_tasks": len(evs)}
    return out


def analyze(records: list, epoch: Optional[float] = None,
            n_steals: int = 0) -> dict:
    """The attribution document for one run (see module docstring).  All
    reported times are seconds relative to the run epoch."""
    records = [r for r in records if r.kind in ("compute", "transfer")]
    if not records:
        return {"explain_schema": EXPLAIN_SCHEMA_VERSION, "empty": True,
                "makespan_s": 0.0, "n_tasks": 0, "n_steals": int(n_steals),
                "buckets": {}, "critical_path": [], "mispredictions": [],
                "lanes": {}, "slack_s": {}, "predicted": None,
                "divergence": None, "bucket_total_s": 0.0,
                "residual_frac": 0.0, "top_bottleneck": None}
    by_name: dict = {}
    for r in records:
        by_name.setdefault(r.name, r)
    t0 = min(r.begin_s for r in records) if epoch is None else float(epoch)
    end_t = max(r.end_s for r in records)
    makespan = end_t - t0

    succ = {r.name: [] for r in records}
    for r in records:
        for d in r.deps:
            if d in by_name:
                succ[d].append(r.name)

    lane_busy: dict = {}
    for r in records:
        lane_busy.setdefault(r.lane, []).append(
            (r.begin_s, r.end_s, r.name))

    chain = _critical_chain(records, by_name, t0)
    buckets: dict = {}
    path_rows = []
    for rec, seg_start in chain:
        queue_s, overhead_s = _wait_split(rec, seg_start, lane_busy)
        run_s = rec.end_s - max(rec.begin_s, seg_start)
        if rec.kind == "transfer":
            run_bucket = f"transfer.{rec.lane}"
        else:
            run_bucket = \
                f"compute.{(rec.meta or {}).get('kernel', rec.name)}"
        oh_bucket = "overhead.steal" if rec.note.startswith("stolen:") \
            else "overhead.dispatch"
        for bucket, v in ((run_bucket, run_s),
                          (f"queue.{rec.lane}", queue_s),
                          (oh_bucket, overhead_s)):
            if v > 0.0:
                buckets[bucket] = buckets.get(bucket, 0.0) + v
        path_rows.append({
            "task": rec.name, "kind": rec.kind, "lane": rec.lane,
            "ready_s": seg_start - t0, "start_s": rec.begin_s - t0,
            "end_s": rec.end_s - t0, "run_s": run_s,
            "queue_s": queue_s, "overhead_s": overhead_s,
            "bucket": run_bucket,
            "stolen": rec.note.startswith("stolen:")})

    buckets = dict(sorted(buckets.items(), key=lambda kv: -kv[1]))
    total = sum(buckets.values())
    predicted = _predicted_chain(records, by_name)
    divergence = None
    if predicted is not None:
        realized = [row["task"] for row in path_rows
                    if row["kind"] == "compute"]
        divergence = {
            "entered": sorted(set(realized) - set(predicted["path"])),
            "left": sorted(set(predicted["path"]) - set(realized))}
    return {
        "explain_schema": EXPLAIN_SCHEMA_VERSION,
        "makespan_s": makespan,
        "n_tasks": len(records),
        "n_steals": int(n_steals),
        "critical_path": path_rows,
        "buckets": buckets,
        "bucket_total_s": total,
        "residual_frac": abs(makespan - total) / max(makespan, _EPS),
        "top_bottleneck": next(iter(buckets), None),
        "slack_s": _slack(records, by_name, succ, end_t),
        "lanes": lane_utilization(records, t0, end_t),
        "predicted": predicted,
        "divergence": divergence,
        "mispredictions": _mispredictions(chain),
    }


def summarize_attribution(doc: dict) -> dict:
    """The compact ``attribution`` block folded into bench.json
    (schema 5): bucket totals, the dominant bucket, and the worst-ranked
    misprediction with its fit-band cross-reference."""
    top = (doc.get("mispredictions") or [None])[0]
    if top is not None:
        top = {k: top[k] for k in ("kernel", "shape_bucket", "cost_s",
                                   "ape_pct", "fit_band_pct",
                                   "exceeds_fit_band", "lanes")}
    return {
        "makespan_s": float(doc.get("makespan_s", 0.0)),
        "residual_frac": float(doc.get("residual_frac", 0.0)),
        "buckets": {k: float(v)
                    for k, v in (doc.get("buckets") or {}).items()},
        "top_bottleneck": doc.get("top_bottleneck"),
        "critical_path_len": len(doc.get("critical_path") or ()),
        "n_steals": int(doc.get("n_steals", 0)),
        "top_misprediction": top,
    }


# --------------------------------------------------------------------------
# serve waterfalls (from a saved/live obs.Telemetry document)
# --------------------------------------------------------------------------

def _rid_of(event: dict) -> Optional[int]:
    rid = (event.get("args") or {}).get("rid")
    if rid is not None:
        return int(rid)
    name = event.get("name", "")
    if ":" in name:
        try:
            return int(name.rsplit(":", 1)[1])
        except ValueError:
            return None
    return None


def waterfalls_from_telemetry(doc: dict) -> dict:
    """Per-request TTFT waterfalls from a telemetry document recorded by
    ``serve.ServeEngine``: for each request with an arrival and a first
    token, TTFT decomposes into queue wait (arrival -> admission),
    prefill/decode execution (the request's share of ``serve.step`` spans
    inside [admission, first token], split by the per-slot phase each
    span recorded), and scheduling overhead (the window not covered by
    any step the request was active in).  ``residual_s`` is whatever the
    decomposition failed to attribute — the < 5% honesty check."""
    epoch = float(doc.get("epoch", 0.0))
    arrival: dict = {}
    admit: dict = {}
    first: dict = {}
    done: dict = {}
    done_args: dict = {}
    steps = []
    for e in doc.get("events", ()):
        name, cat = e.get("name", ""), e.get("cat")
        if cat == "serve.step":
            steps.append(e)
            continue
        rid = _rid_of(e)
        if rid is None:
            continue
        if name.startswith("request.arrival:"):
            arrival[rid] = float(e["t0"])
        elif cat == "admission":
            admit[rid] = float(e["t0"])
        elif name.startswith("first_token:"):
            first[rid] = float(e["t0"])
        elif name.startswith("request.done:"):
            done[rid] = float(e["t0"])
            done_args[rid] = dict(e.get("args") or {})

    requests: dict = {}
    for rid in sorted(arrival):
        if rid not in first or rid not in admit:
            continue
        t_arr, t_adm, t_first = arrival[rid], admit[rid], first[rid]
        ttft = t_first - t_arr
        queue = max(0.0, t_adm - t_arr)
        prefill = decode = covered = 0.0
        for s in steps:
            mine = [x for x in (s.get("args") or {}).get("requests", ())
                    if x.get("rid") == rid]
            if not mine:
                continue
            ov = max(0.0, min(float(s["t1"]), t_first)
                     - max(float(s["t0"]), t_adm))
            if ov <= 0.0:
                continue
            covered += ov
            if mine[0].get("phase") == "prefill":
                prefill += ov
            else:
                decode += ov
        sched = max(0.0, (t_first - t_adm) - covered)
        residual = ttft - queue - prefill - decode - sched
        row = {"arrival_s": t_arr - epoch, "ttft_s": ttft,
               "queue_wait_s": queue, "prefill_s": prefill,
               "decode_s": decode, "sched_overhead_s": sched,
               "residual_s": residual,
               "residual_frac": abs(residual) / max(ttft, _EPS)}
        if rid in done:
            row["total_s"] = done[rid] - t_arr
            tokens = done_args[rid].get("tokens")
            if isinstance(tokens, (int, float)):
                row["tokens"] = int(tokens)
        requests[rid] = row
    fracs = [r["residual_frac"] for r in requests.values()]
    return {"explain_schema": EXPLAIN_SCHEMA_VERSION,
            "run_id": doc.get("run_id"),
            "n_requests": len(requests),
            "max_residual_frac": max(fracs) if fracs else 0.0,
            "requests": requests}


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------

def format_explain(doc: dict, path: str = "") -> list:
    """Human-readable rendering of an ``analyze`` document."""
    head = "== explain" + (f": {path}" if path else "") + " =="
    if doc.get("empty"):
        return [head, "(empty trace)"]
    lines = [head,
             f"makespan {doc['makespan_s'] * 1e3:.2f} ms over "
             f"{doc['n_tasks']} tasks ({doc['n_steals']} steals); "
             f"attribution residual "
             f"{100 * doc['residual_frac']:.3f}%"]
    lines.append(f"top bottleneck: {doc['top_bottleneck']}")
    lines.append(f"{'bucket':30s} {'seconds':>10s} {'share':>7s}")
    for bucket, v in doc["buckets"].items():
        lines.append(f"{bucket:30s} {v:10.5f} "
                     f"{100 * v / max(doc['makespan_s'], _EPS):6.1f}%")
    lines.append(f"-- critical path ({len(doc['critical_path'])} links) --")
    lines.append(f"{'task':24s} {'lane':12s} {'ready':>8s} {'start':>8s} "
                 f"{'end':>8s} {'queue':>7s} {'ovh':>7s}")
    for row in doc["critical_path"]:
        lines.append(
            f"{row['task']:24s} {row['lane']:12s} "
            f"{row['ready_s'] * 1e3:8.2f} {row['start_s'] * 1e3:8.2f} "
            f"{row['end_s'] * 1e3:8.2f} {row['queue_s'] * 1e3:7.2f} "
            f"{row['overhead_s'] * 1e3:7.2f}"
            + ("  [stolen]" if row.get("stolen") else ""))
    div = doc.get("divergence")
    if div is not None:
        lines.append(
            "vs predicted path: "
            + (f"entered {', '.join(div['entered'])}; "
               if div["entered"] else "")
            + (f"left {', '.join(div['left'])}"
               if div["left"] else "")
            or "vs predicted path: identical")
        if not div["entered"] and not div["left"]:
            lines[-1] = "vs predicted path: identical"
    mis = doc.get("mispredictions") or ()
    if mis:
        lines.append("-- misprediction attribution (critical chain) --")
        lines.append(f"{'kernel':20s} {'bucket':18s} {'cost_ms':>8s} "
                     f"{'ape%':>7s} {'band%':>7s} {'lanes'}")
        for g in mis:
            band = g.get("fit_band_pct")
            lines.append(
                f"{g['kernel']:20s} {str(g['shape_bucket'])[:18]:18s} "
                f"{g['cost_s'] * 1e3:8.2f} {g['ape_pct']:7.1f} "
                + (f"{band:7.1f}" if isinstance(band, (int, float))
                   else f"{'-':>7s}")
                + f" {','.join(g['lanes'])}"
                + ("  [EXCEEDS BAND]" if g["exceeds_fit_band"] else ""))
    lines += format_lanes(doc.get("lanes") or {})
    return lines


def format_lanes(lanes: dict) -> list:
    if not lanes:
        return []
    lines = [f"{'lane':16s} {'tasks':>5s} {'busy%':>6s} {'wait%':>6s} "
             f"{'idle%':>6s}"]
    for lane, u in sorted(lanes.items()):
        lines.append(f"{lane:16s} {u['n_tasks']:5d} "
                     f"{100 * u['busy_frac']:6.1f} "
                     f"{100 * u['wait_frac']:6.1f} "
                     f"{100 * u['idle_frac']:6.1f}")
    return lines


def format_waterfalls(doc: dict, path: str = "") -> list:
    head = "== serve waterfalls" + (f": {path}" if path else "") + " =="
    lines = [head,
             f"{doc['n_requests']} requests; max TTFT residual "
             f"{100 * doc['max_residual_frac']:.2f}%"]
    if not doc["requests"]:
        return lines
    lines.append(f"{'rid':>4s} {'arrive':>8s} {'ttft':>8s} {'queue':>8s} "
                 f"{'prefill':>8s} {'decode':>8s} {'sched':>8s} "
                 f"{'resid%':>7s}")
    for rid, r in sorted(doc["requests"].items()):
        lines.append(
            f"{rid:4d} {r['arrival_s'] * 1e3:8.2f} "
            f"{r['ttft_s'] * 1e3:8.2f} {r['queue_wait_s'] * 1e3:8.2f} "
            f"{r['prefill_s'] * 1e3:8.2f} {r['decode_s'] * 1e3:8.2f} "
            f"{r['sched_overhead_s'] * 1e3:8.2f} "
            f"{100 * r['residual_frac']:7.2f}")
    return lines
