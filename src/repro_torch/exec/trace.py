"""Per-task begin/end/device execution trace, the port of
``repro.exec.trace``.

Every executor run (async *and* the sequential bridge) records one
``TraceEvent`` per task — compute nodes and explicit transfer tasks alike —
with wall-clock begin/end and the lane that ran it.  The adaptive executor
additionally records zero-duration ``"steal"`` events (one per runtime
re-dispatch, ``note`` = ``planned->actual``) and annotates stolen compute
events and their inline input moves, so a trace answers *why* a task ran
somewhere other than its planned device.  The trace exports to two
formats: Chrome ``trace_event`` JSON (open in ``chrome://tracing`` or
Perfetto; one row per device/link/bus lane, steals as instant events, so
compute/transfer overlap is visible at a glance) and a Gantt CSV shaped
like the predicted-schedule CSV ``api.export.gantt_csv`` emits
(task/device/start/finish line up; column 2 is the event *kind* here vs
the kernel name there), so predicted and actual timelines sit side by
side.

All timestamps are raw clock values (``time.perf_counter`` by default)
normalized at export against one *run epoch*: the executor captures
``set_epoch(clock())`` once at run start, so the Chrome trace, the Gantt
CSV, and any ``obs.Telemetry`` recorded during the same run share
a single time base instead of each export re-deriving its own zero from
whichever event happened to start first.  ``to_chrome(telemetry=...)``
merges that telemetry in: gauge series become Chrome counter tracks
("C" events — queue depths, rolling MAPE) and telemetry span/instant
events land on a dedicated ``telemetry`` thread row, all on the shared
clock next to the task slices.

Each event also carries its *causality*: ``deps`` (the names of the
tasks it waited on) and ``meta`` (free-form schedule context — kernel,
shape bucket, predicted seconds — attached by ``api.compile_``).  The
Chrome export embeds both in ``args`` and additionally emits flow events
("s"/"f" arrow pairs) along every dependency edge, so Perfetto draws the
critical chain instead of just lanes; ``from_chrome`` rebuilds a trace
from a saved document, which is how ``obs.explain`` analyzes traces long
after the run that produced them.  The document has the JAX package's
format, so each package's ``from_chrome`` reads the other's.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    name: str
    kind: str                   # "compute" | "transfer" | "steal"
    device: str                 # device name, "src->dst" link or "bus:" lane
    begin_s: float
    end_s: float
    note: str = ""              # steal annotation ("planned->actual", ...)
    deps: tuple = ()            # names of the tasks this one waited on
    meta: Optional[dict] = None  # schedule context (kernel, shape bucket,
    #   predicted seconds, ...) — attached by the lowering, read by
    #   obs.explain

    @property
    def dur_s(self) -> float:
        return self.end_s - self.begin_s


class ExecutionTrace:
    """Thread-safe accumulator of ``TraceEvent``s for one execution."""

    def __init__(self, epoch: Optional[float] = None):
        self.events: list = []
        self.epoch = epoch          # run time-base; None: derive from events
        self._lock = threading.Lock()

    def set_epoch(self, t: float) -> None:
        """Pin the run's time base (first caller wins — the executor calls
        this once at run start, before any event is recorded, so every
        export and merged telemetry stream shares one zero)."""
        if self.epoch is None:
            self.epoch = float(t)

    def record(self, name: str, kind: str, device: str,
               begin_s: float, end_s: float, note: str = "",
               deps: tuple = (), meta: Optional[dict] = None) -> None:
        with self._lock:
            self.events.append(TraceEvent(name, kind, device,
                                          begin_s, end_s, note,
                                          tuple(deps), meta))

    # -- summaries -----------------------------------------------------------
    @property
    def t0(self) -> float:
        if self.epoch is not None:
            return self.epoch
        return min(e.begin_s for e in self.events) if self.events else 0.0

    @property
    def wall_s(self) -> float:
        """End-to-end wall time spanned by the recorded events."""
        if not self.events:
            return 0.0
        return max(e.end_s for e in self.events) - self.t0

    def devices(self) -> list:
        return sorted({e.device for e in self.events})

    def busy_s(self, device: str) -> float:
        """Total busy seconds of one lane (no overlap within a lane: each
        worker runs one task at a time)."""
        return sum(e.dur_s for e in self.events if e.device == device)

    def by_start(self) -> list:
        return sorted(self.events, key=lambda e: (e.begin_s, e.name))

    def steals(self) -> list:
        """The runtime re-dispatch events, in steal order."""
        return [e for e in self.by_start() if e.kind == "steal"]

    # -- exports -------------------------------------------------------------
    def to_chrome(self, telemetry=None) -> dict:
        """Chrome ``trace_event`` document: one "X" (complete) event per
        task, one tid per lane (named via metadata events), timestamps in
        microseconds relative to the run epoch (or the first begin when no
        epoch was pinned).

        ``telemetry`` (an ``obs.Telemetry`` recorded on the same
        clock) folds in: every gauge series becomes a counter track ("C"
        events — queue depth, rolling MAPE render as graphs above the
        lanes) and telemetry instants/spans land on one extra
        ``telemetry`` thread row (refits, gate rejections next to the
        steal instants and task slices they explain).

        Task events embed ``deps``/``meta`` in ``args`` and every
        dependency edge additionally emits one flow-event pair ("s" at
        the producer's end, "f" with ``bp:"e"`` at the consumer's begin),
        so Perfetto renders the causal arrows and ``from_chrome`` can
        rebuild the full dependency DAG from the saved file."""
        t0 = self.t0
        lanes = {d: i for i, d in enumerate(self.devices())}
        events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                   "cat": "__metadata", "args": {"name": d}}
                  for d, tid in lanes.items()]
        spans = {}                      # first span recorded per task name
        for e in self.by_start():
            if e.kind != "steal":
                spans.setdefault(e.name, e)
        flow_id = 0
        for e in self.by_start():
            if e.kind == "steal":
                # re-dispatch decisions are instants, not spans
                ev = {"name": e.name, "cat": "steal", "ph": "i", "s": "t",
                      "pid": 0, "tid": lanes[e.device],
                      "ts": (e.begin_s - t0) * 1e6}
            else:
                ev = {"name": e.name, "cat": e.kind, "ph": "X",
                      "pid": 0, "tid": lanes[e.device],
                      "ts": (e.begin_s - t0) * 1e6,
                      "dur": e.dur_s * 1e6}
            args: dict = {}
            if e.note:
                args["note"] = e.note
            if e.deps:
                args["deps"] = list(e.deps)
            if e.meta:
                args["meta"] = dict(e.meta)
            if args:
                ev["args"] = args
            events.append(ev)
            if e.kind == "steal":
                continue
            for d in e.deps:
                src = spans.get(d)
                if src is None:
                    continue
                flow_id += 1
                events.append({"name": "dep", "cat": "flow", "ph": "s",
                               "id": flow_id, "pid": 0,
                               "tid": lanes[src.device],
                               "ts": (src.end_s - t0) * 1e6})
                events.append({"name": "dep", "cat": "flow", "ph": "f",
                               "bp": "e", "id": flow_id, "pid": 0,
                               "tid": lanes[e.device],
                               "ts": (e.begin_s - t0) * 1e6})
        if telemetry is not None:
            events += self._telemetry_events(telemetry, t0, len(lanes))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    @classmethod
    def from_chrome(cls, doc: dict) -> "ExecutionTrace":
        """Rebuild a trace from a saved Chrome document (epoch 0, times in
        seconds relative to the original run epoch).  Task spans, steal
        instants, deps, and meta round-trip; telemetry counter tracks and
        instants merged by ``to_chrome(telemetry=...)`` are skipped —
        they are not task events."""
        tid_names = {}
        for ev in doc.get("traceEvents", ()):
            if ev.get("ph") == "M" and ev.get("name") == "thread_name":
                tid_names[ev.get("tid")] = \
                    (ev.get("args") or {}).get("name", str(ev.get("tid")))
        tr = cls(epoch=0.0)
        for ev in doc.get("traceEvents", ()):
            ph, cat = ev.get("ph"), ev.get("cat")
            lane = tid_names.get(ev.get("tid"), str(ev.get("tid")))
            args = ev.get("args") or {}
            if ph == "X" and cat in ("compute", "transfer"):
                b = float(ev["ts"]) / 1e6
                tr.record(ev["name"], cat, lane, b,
                          b + float(ev.get("dur", 0.0)) / 1e6,
                          note=args.get("note", ""),
                          deps=tuple(args.get("deps", ())),
                          meta=dict(args["meta"])
                          if args.get("meta") else None)
            elif ph == "i" and cat == "steal":
                t = float(ev["ts"]) / 1e6
                tr.record(ev["name"], "steal", lane, t, t,
                          note=args.get("note", ""))
        return tr

    @staticmethod
    def _telemetry_events(telemetry, t0: float, tid: int) -> list:
        events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                   "cat": "__metadata", "args": {"name": "telemetry"}}]
        for name in telemetry.series_names():
            for t, v in telemetry.series(name):
                events.append({"name": name, "ph": "C", "pid": 0,
                               "ts": (t - t0) * 1e6,
                               "args": {"value": v}})
        for e in telemetry.events():
            if e["ph"] == "instant":
                ev = {"name": e["name"], "cat": e["cat"], "ph": "i",
                      "s": "t", "pid": 0, "tid": tid,
                      "ts": (e["t0"] - t0) * 1e6}
            else:
                ev = {"name": e["name"], "cat": e["cat"], "ph": "X",
                      "pid": 0, "tid": tid, "ts": (e["t0"] - t0) * 1e6,
                      "dur": (e["t1"] - e["t0"]) * 1e6}
            if e.get("args"):
                ev["args"] = dict(e["args"])
            events.append(ev)
        return events

    def to_gantt_csv(self) -> str:
        """Measured-timeline CSV (task,kind,device,start_s,finish_s) —
        aligned with the predicted-schedule Gantt except that column 2 is
        the event kind, not the kernel name."""
        t0 = self.t0
        lines = ["task,kind,device,start_s,finish_s"]
        for e in self.by_start():
            lines.append(f"{e.name},{e.kind},{e.device},"
                         f"{e.begin_s - t0:.9f},{e.end_s - t0:.9f}")
        return "\n".join(lines) + "\n"

    def save_chrome(self, path: str, telemetry=None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(telemetry=telemetry), f, indent=1)

    def save_gantt_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_gantt_csv())
