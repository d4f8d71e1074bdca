"""Predictor-driven kernel dispatch (the paper's §6 closed at run time).

``Dispatcher.dispatch(kernel, *args)`` ranks every registered variant with the cached
NN+C model and executes only the predicted-best.  On a cold cache (no
fitted model) it *measures* a bounded candidate set through the black-box
timing protocol of ``perfdata.measure.time_callable``, records the rows,
and persists them; once enough rows accumulate the lightweight model is
fitted and subsequent dispatches are pure prediction (<75-weight numpy
forward, microseconds).  On an unseen shape bucket the confidence gate
trusts the model only when the predicted variant spread clears the model's
own error band; near-ties get their top-2 candidates measured instead (see
``DispatchPolicy.confidence_gate``).

Variants run on the device of the tensors they are given.  A CUDA launch
returns before the kernel ends, so every timed call synchronises the
output's device before the clock is read: the cold path and ``kernel_s``
time kernels, not launches.

With ``policy.online=True`` every dispatch also records the *actual* wall
time of the chosen variant and hands it to the ``OnlineRefiner``, which
refits incrementally and tracks rolling MAPE (see ``online.py``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.perfdata.measure import time_callable
from repro_torch.runtime.cache import TuningCache, shape_bucket
from repro_torch.runtime.online import OnlineConfig, OnlineRefiner
from repro_torch.runtime.registry import KernelRegistry, default_registry


def synchronize(out):
    """Return ``out`` once the device that computes it is done."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


@dataclasses.dataclass
class DispatchPolicy:
    measure_on_cold: bool = True    # cold cache: measure (True) or default
    max_measure_candidates: int = 8  # bound on the cold-path candidate set
    min_window: float = 2e-3        # per-candidate timing window (seconds)
    min_rows_to_fit: int = 12       # fit the model once this many rows exist
    fit_epochs: int = 6000
    # measure-when-uncertain: on an *unseen* shape bucket the model's argmin
    # is trusted only when the predicted top-2 spread exceeds the model's own
    # error band (rolling MAPE when online, else the fit-time MAPE); inside
    # the band the top candidates are measured instead (the rows also buy
    # bucket coverage).  confidence_gate=False restores blind trust.
    confidence_gate: bool = True
    gate_candidates: int = 2        # how many top candidates the gate times
    default_error_band: float = 0.25  # relative band when no MAPE exists yet
    online: bool = False            # record actual times + refit
    refit_every: int = 24           # online: refit after k new rows
    refit_epochs: int = 2000
    selection_log: int = 1024       # bound on the kept Selection records


@dataclasses.dataclass
class Selection:
    """Record of one dispatch decision (kept for stats/benchmarks)."""
    kernel: str
    params: dict
    bucket: tuple
    mode: str                       # predicted | measured | gated | default
    chosen: str
    predicted_s: Optional[dict]     # variant -> predicted seconds
    measured_s: Optional[dict]      # variant -> measured seconds (cold path)
    overhead_s: float               # decision cost (predict/measure + bookkeeping)
    kernel_s: float                 # wall time of the executed variant


class Dispatcher:
    def __init__(self, registry: Optional[KernelRegistry] = None,
                 cache: Optional[TuningCache] = None,
                 policy: Optional[DispatchPolicy] = None,
                 telemetry=None):
        self.registry = registry or default_registry()
        self.cache = cache or TuningCache()
        self.policy = policy or DispatchPolicy()
        self.refiner = OnlineRefiner(self.cache, OnlineConfig(
            refit_every=self.policy.refit_every,
            refit_epochs=self.policy.refit_epochs)) \
            if self.policy.online else None
        # run-scoped observability (repro_torch.obs.Telemetry); None costs
        # one pointer test per dispatch.  The setter mirrors it into the
        # refiner so refit events land in the same stream, also when it is
        # attached after construction (after a warm-up, say)
        self.telemetry = telemetry
        self.n_predicted = 0
        self.n_measured = 0
        self.n_gated = 0
        self.n_default = 0
        # bounded: a long-running process must not leak a Selection per
        # dispatch
        self.selections: deque = deque(maxlen=self.policy.selection_log)
        # per-exact-shape decision memo: a warm dispatch of a seen shape is
        # a dict hit, not a model forward.  Entries carry the cache entry's
        # fit version and die on refit.
        self._decisions: dict[tuple, tuple] = {}
        self._predictions: dict[tuple, tuple] = {}  # the same, for
        #   predict_times: (fit version, variant -> seconds)
        self._entries: dict[str, object] = {}

    # -- helpers -------------------------------------------------------------
    @property
    def telemetry(self):
        return self._telemetry

    @telemetry.setter
    def telemetry(self, tel) -> None:
        self._telemetry = tel
        if self.refiner is not None:
            self.refiner.telemetry = tel

    def _entry(self, kernel: str):
        e = self._entries.get(kernel)
        if e is None:
            rk = self.registry.get(kernel)
            e = self.cache.entry(kernel, feature_names=rk.feature_names,
                                 variant_names=self.registry.variant_names(
                                     kernel))
            self._entries[kernel] = e
        return e

    def predict_times(self, kernel: str, params: dict) -> dict:
        """variant name -> predicted seconds (requires a fitted model).
        Kept per exact shape until the entry's next refit: the adaptive
        executor prices every ready task's devices and every queued task's
        backlog through here, so a repeat is a dict hit, not a model
        forward."""
        entry = self._entry(kernel)
        version = entry.version         # read first: a racing refit only
        key = (kernel, tuple(sorted(params.items())))   # makes this stale
        hit = self._predictions.get(key)
        if hit is not None and hit[0] == version:
            return dict(hit[1])
        rows = self.registry.feature_rows(kernel, params)
        pred = entry.predict(rows)
        out = dict(zip(self.registry.variant_names(kernel), pred.tolist()))
        self._predictions[key] = (version, out)
        return dict(out)

    def predict_time(self, kernel: str, params: dict) -> float:
        """Predicted runtime of the best variant — the scheduler's
        per-device time callable (core.scheduler.predictor_from_runtime)."""
        return min(self.predict_times(kernel, params).values())

    def fit(self, kernel: str, **kw) -> None:
        """Explicit (re)fit + persist, e.g. at the end of a warm-up sweep."""
        entry = self._entry(kernel)
        entry.fit(epochs=kw.pop("epochs", self.policy.fit_epochs), **kw)
        self.cache.save(kernel)

    # -- the dispatch path ---------------------------------------------------
    def dispatch(self, kernel: str, *args, **kwargs):
        t0 = time.perf_counter()
        tel = self._telemetry
        rk = self.registry.get(kernel)
        params = rk.params_of(*args, **kwargs)
        bucket = shape_bucket(params)
        entry = self._entry(kernel)

        predicted = measured = rows = None
        memo_hit = False
        if entry.model is not None:
            # the per-shape memo is checked before anything else: an earlier
            # decision for this exact shape (predicted OR gated-measured)
            # stands until the next refit bumps entry.version
            memo_key = (kernel, tuple(sorted(params.items())))
            hit = self._decisions.get(memo_key)
            if hit is not None and hit[0] == entry.version:
                _, idx, predicted = hit
                memo_hit = True
                mode = "predicted"
                self.n_predicted += 1
            else:
                rows = self.registry.feature_rows(kernel, params)
                pred = entry.predict(rows)
                predicted = dict(zip(entry.variant_names, pred.tolist()))
                order = np.argsort(pred)
                gate = self.policy.confidence_gate \
                    and bucket not in entry.buckets
                confident, spread, band = (True, None, None) if not gate \
                    else self._gate_eval(pred, order, kernel, entry)
                if confident:
                    idx = int(order[0])
                    mode = "predicted"
                    self.n_predicted += 1
                    if gate and tel is not None:
                        tel.count("gate.accept")
                        tel.count(f"gate.by_kernel.{kernel}.accept")
                else:
                    # unseen shape class + near-tie: measure the top-2
                    cand = [int(i)
                            for i in order[:self.policy.gate_candidates]]
                    idx, measured = self._measure(entry, rk, rows, args,
                                                  params, bucket,
                                                  candidates=cand)
                    mode = "gated"
                    self.n_gated += 1
                    if tel is not None:
                        tel.count("gate.reject")
                        tel.count(f"gate.by_kernel.{kernel}.reject")
                        tel.instant(f"gate:{kernel}", cat="gate",
                                    kernel=kernel, reason="near_tie",
                                    spread_pct=100.0 * spread,
                                    band_pct=100.0 * band,
                                    bucket=list(bucket))
                # memoize either way — a gated dispatch stores the *measured*
                # winner, so later calls of this shape reuse it instead of
                # re-trusting the argmin the gate just judged unconfident
                self._decisions[memo_key] = (entry.version, idx, predicted)
        elif self.policy.measure_on_cold:
            rows = self.registry.feature_rows(kernel, params)
            idx, measured = self._measure(entry, rk, rows, args, params,
                                          bucket)
            mode = "measured"
            self.n_measured += 1
        else:
            idx, mode = 0, "default"
            self.n_default += 1

        overhead = time.perf_counter() - t0
        chosen = rk.variants[idx]
        t1 = time.perf_counter()
        out = synchronize(chosen.call(args, params))
        kernel_s = time.perf_counter() - t1

        # online feedback — but never from a first warm execution of a new
        # shape, whose wall time may carry one-off costs (a kernel library's
        # first load, allocator growth) that would poison the refit window.
        # A memo hit means this exact shape already executed in-process; the
        # cold path warmed up inside _measure's timing protocol.
        if self.refiner is not None and (mode != "predicted" or memo_hit):
            if rows is None:        # decision-memo hit skipped building them
                rows = self.registry.feature_rows(kernel, params)
            self.refiner.observe(
                kernel, rows[idx], bucket, kernel_s,
                predicted_s=predicted[chosen.name] if predicted else None)
        if tel is not None:
            tel.count(f"dispatch.{mode}")
            # per-kernel decision mix, without touching the bounded
            # Selection log
            tel.count(f"dispatch.by_kernel.{kernel}.{mode}")
            if memo_hit:
                tel.count("dispatch.memo_hit")
            tel.observe("dispatch.overhead_s", overhead)
            tel.observe(f"kernel.{kernel}.s", kernel_s)
            # drift: predicted-vs-actual for executions whose wall time is
            # clean of one-off first-call costs (the refiner's rule)
            if predicted is not None and (mode != "predicted" or memo_hit):
                tel.residual(kernel, predicted[chosen.name], kernel_s,
                             fit_band_pct=entry.fit_mape)
        self.selections.append(Selection(
            kernel=kernel, params=params, bucket=bucket, mode=mode,
            chosen=chosen.name, predicted_s=predicted, measured_s=measured,
            overhead_s=overhead, kernel_s=kernel_s))
        return out

    __call__ = dispatch

    def _gate_eval(self, pred, order, kernel, entry) -> tuple:
        """``(confident, spread, band)``: is the predicted best separated
        from the runner-up by more than the model's error band?  Single-
        variant kernels are always confident (there is nothing to
        mis-rank)."""
        if len(pred) < 2:
            return True, 0.0, 0.0
        best, second = float(pred[order[0]]), float(pred[order[1]])
        spread = (second - best) / max(abs(best), 1e-12)
        band = self._error_band(kernel, entry)
        return spread > band, spread, band

    def _confident(self, pred, order, kernel, entry) -> bool:
        return self._gate_eval(pred, order, kernel, entry)[0]

    def _error_band(self, kernel, entry) -> float:
        """Relative model error: rolling MAPE when online observations
        exist, else the fit-time training MAPE, else the policy default."""
        if self.refiner is not None:
            m = self.refiner.rolling_mape(kernel)
            if np.isfinite(m):
                return m / 100.0
        if entry.fit_mape is not None:
            return entry.fit_mape / 100.0
        return self.policy.default_error_band

    def _measure(self, entry, rk, rows, args, params, bucket,
                 candidates: Optional[list] = None):
        """Cold/gated path: time a bounded candidate set, record the rows.

        ``candidates`` (variant indices) narrows the set — the confidence
        gate times only the predicted top-k instead of everything."""
        if candidates is None:
            candidates = list(range(min(len(rk.variants),
                                        self.policy.max_measure_candidates)))
        times = []
        for i in candidates:
            v = rk.variants[i]
            times.append(time_callable(
                lambda: synchronize(v.call(args, params)),
                min_window=self.policy.min_window))
        entry.add_rows(rows[candidates], times, bucket)
        if entry.model is None and entry.n_rows >= self.policy.min_rows_to_fit:
            entry.fit(epochs=self.policy.fit_epochs)
        self.cache.save(entry.kernel)
        measured = {rk.variants[i].name: t for i, t in zip(candidates, times)}
        return candidates[int(np.argmin(times))], measured

    # -- stats ---------------------------------------------------------------
    def reset_stats(self) -> None:
        """Clear counters/selection log (cache and decision memo survive) —
        call between phases so steady-state numbers aren't polluted by
        warm-up."""
        self.n_predicted = self.n_measured = self.n_gated = 0
        self.n_default = 0
        self.selections = deque(maxlen=self.policy.selection_log)

    def stats(self) -> dict:
        sel = list(self.selections)
        warm = [s for s in sel if s.mode == "predicted"]
        out = {"dispatches": len(sel), "predicted": self.n_predicted,
               "measured": self.n_measured, "gated": self.n_gated,
               "default": self.n_default}
        if warm:
            oh = float(np.sum([s.overhead_s for s in warm]))
            kt = float(np.sum([s.kernel_s for s in warm]))
            out["steady_overhead_s"] = oh / len(warm)
            # time-weighted: decision cost as a share of total wall time
            # spent in predicted dispatches (the <5% acceptance target)
            out["steady_overhead_pct"] = 100.0 * oh / max(oh + kt, 1e-12)
            out["steady_overhead_pct_per_call"] = 100.0 * float(
                np.mean([s.overhead_s / max(s.kernel_s + s.overhead_s, 1e-12)
                         for s in warm]))
        if self.refiner is not None:
            out["rolling_mape"] = {k: self.refiner.rolling_mape(k)
                                   for k in self.refiner.observed_kernels()}
        return out


# --------------------------------------------------------------------------
# Module-level convenience: one shared dispatcher per process
# --------------------------------------------------------------------------

_DEFAULT: Optional[Dispatcher] = None


def default_dispatcher(policy: Optional[DispatchPolicy] = None) -> Dispatcher:
    """The process-wide dispatcher (its cache keyed by the card's
    fingerprint).  Rebuilt only when ``policy`` actually changes — passing
    the same policy on every call keeps the live dispatcher (and its
    decision memo, stats, and online-refit counters)."""
    global _DEFAULT
    if _DEFAULT is None or (policy is not None
                            and policy != _DEFAULT.policy):
        _DEFAULT = Dispatcher(policy=policy)
    return _DEFAULT


def dispatch(kernel: str, *args,
             policy: Optional[DispatchPolicy] = None, **kwargs):
    """``dispatch("matmul", a, b)`` — predict-best execution through the
    process-wide dispatcher (created on first use)."""
    return default_dispatcher(policy).dispatch(kernel, *args, **kwargs)
