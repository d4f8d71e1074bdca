"""Run-scoped telemetry: metrics, structured events, and drift, one clock,
the port of ``repro.obs.telemetry``.

One ``Telemetry`` instance is *the* observability surface for one run
(a bench scenario, a serving process, a test): every layer that makes a
decision — dispatch, online refit, the executor, program execution —
reports into it instead of keeping ad-hoc counters.  Three primitives:

- **metrics** — monotonic ``count()`` counters, ``gauge()`` time-series
  (each point timestamped on the shared clock, so gauges render as
  Chrome-trace counter tracks), and ``observe()`` histograms (running
  count/sum/min/max plus a bounded window of recent samples for
  percentiles — the p50/p99 latency surface the serving engine needs);
- **events** — ``span()`` (begin/end) and ``instant()`` records with a
  category and free-form args, on the same clock as executor trace
  slices, so steals/refits/gate rejections line up with task timelines;
- **drift** — ``residual()`` feeds the rolling predicted-vs-actual
  monitor (``obs.drift.DriftMonitor``) and mirrors each kernel's live
  MAPE into a gauge series, flagging kernels whose live error leaves the
  fit-time band.

All timestamps are raw ``clock()`` values (default ``time.perf_counter``)
with the construction-time value kept as ``epoch`` — the same convention
``exec.ExecutionTrace`` uses, so telemetry and execution traces merge
onto one timeline without re-basing.

``NULL_TELEMETRY`` is the near-zero-cost default: every method is a
no-op, so instrumented code paths run unconditionally without branching
on ``None`` at each site (call sites on the hottest paths still guard —
a guarded ``None`` is one pointer test).  ``Telemetry.save``/``load``
round-trip the full state as JSON; ``summarize_doc`` renders the summary
from either a live instance or a loaded file.  The document is the JAX
package's, key for key: a file either package saves, the other loads and
summarizes alike.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.obs.drift import DriftConfig, DriftMonitor

OBS_SCHEMA_VERSION = 1

# bounded-state defaults: a long-running process must not grow telemetry
# without bound (same rule as the dispatcher's Selection log)
MAX_HIST_SAMPLES = 4096
MAX_SERIES_POINTS = 4096
MAX_EVENTS = 65536


class _Histogram:
    __slots__ = ("count", "sum", "min", "max", "samples")

    def __init__(self, max_samples: int = MAX_HIST_SAMPLES):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: deque = deque(maxlen=max_samples)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max
        self.samples.append(v)

    def to_json(self) -> dict:
        return {"count": int(self.count), "sum": float(self.sum),
                "min": float(self.min), "max": float(self.max),
                "samples": [float(s) for s in self.samples]}


class Telemetry:
    """Thread-safe run-scoped metric/event/drift accumulator."""

    enabled = True

    def __init__(self, run_id: str = "run",
                 clock: Callable[[], float] = time.perf_counter,
                 drift: Optional[DriftConfig] = None):
        self.run_id = run_id
        self.clock = clock
        self.epoch = float(clock())
        self.drift = DriftMonitor(drift)
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._series: dict = {}          # name -> deque of (t, value)
        self._hists: dict = {}           # name -> _Histogram
        self._events: deque = deque(maxlen=MAX_EVENTS)

    # -- metrics -------------------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float,
              t: Optional[float] = None) -> None:
        """Append one timestamped point to ``name``'s series (the Chrome
        counter-track primitive: queue depths, rolling MAPE, ...)."""
        t = self.clock() if t is None else t
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = deque(maxlen=MAX_SERIES_POINTS)
            s.append((float(t), float(value)))

    def observe(self, name: str, value: float) -> None:
        """Record one sample into ``name``'s histogram."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram()
            h.observe(value)

    # -- events --------------------------------------------------------------
    def instant(self, name: str, cat: str = "event", **args) -> None:
        t = self.clock()
        with self._lock:
            self._events.append({"name": name, "cat": cat, "ph": "instant",
                                 "t0": t, "t1": t, "args": args})

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", **args):
        t0 = self.clock()
        try:
            yield
        finally:
            t1 = self.clock()
            with self._lock:
                self._events.append({"name": name, "cat": cat, "ph": "span",
                                     "t0": t0, "t1": t1, "args": args})

    def event(self, name: str, t0: float, t1: float,
              cat: str = "span", **args) -> None:
        """Record a span with explicit begin/end — for callers that only
        know the args *after* the work finished (``span()`` captures its
        args at entry), e.g. the serve engine's per-step request list."""
        with self._lock:
            self._events.append({"name": name, "cat": cat, "ph": "span",
                                 "t0": float(t0), "t1": float(t1),
                                 "args": args})

    # -- drift ---------------------------------------------------------------
    def residual(self, kernel: str, predicted_s: float, actual_s: float,
                 fit_band_pct: Optional[float] = None) -> None:
        """One predicted-vs-actual residual for ``kernel``; updates the
        drift monitor and mirrors its rolling MAPE into a gauge series
        (so drift renders as a counter track next to the run's tasks)."""
        t = self.clock()
        with self._lock:
            self.drift.observe(kernel, predicted_s, actual_s, fit_band_pct)
            name = f"drift.live_mape.{kernel}"
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = deque(maxlen=MAX_SERIES_POINTS)
            s.append((float(t), float(self.drift.live_mape(kernel))))

    # -- reading -------------------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def events(self, cat: Optional[str] = None) -> list:
        with self._lock:
            evs = list(self._events)
        return [e for e in evs if cat is None or e["cat"] == cat]

    def series(self, name: str) -> list:
        with self._lock:
            return list(self._series.get(name, ()))

    def series_names(self) -> list:
        with self._lock:
            return sorted(self._series)

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> dict:
        with self._lock:
            return {
                "obs_schema": OBS_SCHEMA_VERSION,
                "run_id": self.run_id,
                "epoch": self.epoch,
                "counters": dict(self._counters),
                "series": {n: [[t, v] for t, v in s]
                           for n, s in self._series.items()},
                "histograms": {n: h.to_json()
                               for n, h in self._hists.items()},
                "events": list(self._events),
                "drift": self.drift.to_json(),
            }

    def save(self, path: str) -> None:
        """Atomic write (temp file + ``os.replace``): a reader that races a
        mid-run save sees either the previous complete document or the new
        one, never a truncated file ``load`` would exit-2 on."""
        doc = self.to_json()
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> dict:
        """Load a saved telemetry document (validated schema gate)."""
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) \
                or doc.get("obs_schema") != OBS_SCHEMA_VERSION:
            raise ValueError(
                f"{path}: not a telemetry file (expected obs_schema="
                f"{OBS_SCHEMA_VERSION}, got {doc.get('obs_schema')!r})")
        return doc

    def summary(self) -> dict:
        return summarize_doc(self.to_json())


class NullTelemetry(Telemetry):
    """The no-op default: accepts every call, records nothing."""

    enabled = False

    def __init__(self):                      # noqa: D401 — no state at all
        self.run_id = "null"
        self.epoch = 0.0
        self.drift = DriftMonitor()

    def count(self, name, n=1):
        pass

    def gauge(self, name, value, t=None):
        pass

    def observe(self, name, value):
        pass

    def instant(self, name, cat="event", **args):
        pass

    @contextlib.contextmanager
    def span(self, name, cat="span", **args):
        yield

    def event(self, name, t0, t1, cat="span", **args):
        pass

    def residual(self, kernel, predicted_s, actual_s, fit_band_pct=None):
        pass

    def counters(self):
        return {}

    def events(self, cat=None):
        return []

    def series(self, name):
        return []

    def series_names(self):
        return []

    def to_json(self):
        return {"obs_schema": OBS_SCHEMA_VERSION, "run_id": "null",
                "epoch": 0.0, "counters": {}, "series": {},
                "histograms": {}, "events": [], "drift": {}}


NULL_TELEMETRY = NullTelemetry()


def as_telemetry(tel: Optional[Telemetry]) -> Telemetry:
    """None-tolerant coercion: ``None`` becomes the shared no-op."""
    return tel if tel is not None else NULL_TELEMETRY


# --------------------------------------------------------------------------
# summaries (pure functions over the JSON document, so the report CLI and
# live instances render identically)
# --------------------------------------------------------------------------

def _hist_stats(h: dict) -> dict:
    out = {"count": int(h.get("count", 0)), "sum": float(h.get("sum", 0.0))}
    if out["count"]:
        out["mean"] = out["sum"] / out["count"]
        out["min"] = float(h["min"])
        out["max"] = float(h["max"])
        samples = np.asarray(h.get("samples", ()), dtype=float)
        if samples.size:
            for p in (50, 90, 99):
                out[f"p{p}"] = float(np.percentile(samples, p))
    return out


# decision-counter names folded into the summary's ``decisions`` block —
# the counts the bench document and the drift check care about
_DECISION_COUNTERS = (
    "dispatch.predicted", "dispatch.memo_hit", "dispatch.measured",
    "dispatch.gated", "dispatch.default", "dispatch.pinned",
    "gate.accept", "gate.reject", "exec.steals", "online.refits",
)


def summarize_doc(doc: dict) -> dict:
    """Render the standing summary from a telemetry JSON document."""
    counters = dict(doc.get("counters", {}))
    hists = {n: _hist_stats(h)
             for n, h in sorted(doc.get("histograms", {}).items())}
    drift = DriftMonitor.from_json(doc.get("drift", {}))
    events = list(doc.get("events", ()))

    # dispatch overhead as a share of dispatch + kernel wall time — the
    # <5% acceptance number, computed from the recorded histograms
    decision_s = doc.get("histograms", {}).get("dispatch.overhead_s", {})
    decision_sum = float(decision_s.get("sum", 0.0))
    kernel_sum = sum(float(h.get("sum", 0.0))
                     for n, h in doc.get("histograms", {}).items()
                     if n.startswith("kernel."))
    overhead = {}
    if decision_sum or kernel_sum:
        overhead["dispatch_frac"] = \
            decision_sum / max(decision_sum + kernel_sum, 1e-12)

    event_counts: dict = {}
    for e in events:
        event_counts[e.get("cat", "event")] = \
            event_counts.get(e.get("cat", "event"), 0) + 1

    return {
        "run_id": doc.get("run_id"),
        "counters": dict(sorted(counters.items())),
        "decisions": {k: int(counters[k]) for k in _DECISION_COUNTERS
                      if k in counters},
        "histograms": hists,
        "overhead": overhead,
        "events": event_counts,
        "series": sorted(doc.get("series", {})),
        "drift": drift.status(),
        "drift_flags": drift.flags(),
    }
