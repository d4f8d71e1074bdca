"""``ServeEngine``: the predictor-driven serving front door, the port of
``repro.serve.engine``.

The full stack in one loop: bounded arrival queue -> cost-aware admission
(shortest-predicted-job-first via the split ``prefill_step``/
``decode_step`` models in the tuning cache) -> iteration-level batch
assembly on the ``ContinuousBatcher`` slot machinery -> execution of a
compiled ``repro_torch.api`` program step on the ``repro_torch.exec``
executor.

Every engine iteration is one call of a one-node compiled program whose
single kernel, the ``serve_step`` pseudo-kernel, closes over the engine's
model step and mutable cache.  That buys the serving loop the whole
api/exec/obs stack for free: predicted-vs-realized makespan instants,
``kernel.serve_step.s`` histograms, dispatch decision counters, and
executor queue gauges all land in the same
``repro_torch.obs.Telemetry`` the engine's own TTFT/per-token histograms
report to.  The dispatcher
runs with ``measure_on_cold=False`` + ``confidence_gate=False`` — a serve
step mutates the KV cache, so it must execute exactly once per dispatch;
the cold-path timing protocol would replay it.

Telemetry contract (all through ``repro_torch.obs``, no engine-private
counters):

- histograms ``serve.ttft_s`` (submit -> first token) and
  ``serve.token_latency_s`` (inter-token gaps);
- gauges ``serve.queue_depth`` (on submit/admit) and
  ``serve.goodput_tok_s`` (end of ``run_trace``);
- counters ``serve.requests_completed``, ``serve.tokens_generated``,
  ``serve.requests_rejected``, ``serve.admission_fallback``;
- ``admission:<rid>`` instants (policy, predicted seconds, queue wait);
- per-request ``serve.request`` residuals (predicted vs actual service
  time) feeding the existing ``DriftMonitor``;
- a per-request trace-ID thread for ``repro_torch.obs.explain``:
  ``request.arrival:<rid>`` / ``first_token:<rid>`` /
  ``request.done:<rid>`` instants plus one ``serve.step`` span per engine
  iteration whose args list the (rid, slot, phase) of every active
  request — enough for ``explain`` to rebuild a TTFT waterfall (queue
  wait / prefill / decode / scheduling overhead) per request.

The engine runs where its ``params`` lie; with ``params=None`` it makes
them on ``device`` (the card unless the caller asks for the CPU) from
``torch.Generator().manual_seed(0)``, which gives other weights than the
reference's ``PRNGKey(0)``.  A step runs on the executor's lane worker
(``executor="async"``) with the engine's card and stream made current
there; the step's next tokens stay on the card until the dispatcher has
synchronised it, the one block of each engine iteration.

A cold cache is not an error: ``ColdCacheError`` from the cost model
demotes admission to FIFO with a ``serve.admission_fallback`` count, and
completed requests keep recording split rows so the cache warms up for
the next engine.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.api.compile_ import compile_program
from repro_torch.api.ops import TraceBuilder
from repro_torch.core.nnc import LinearModel
from repro_torch.kernels import Aval
from repro_torch.models import module
from repro_torch.obs.telemetry import as_telemetry
from repro_torch.runtime.cache import shape_bucket
from repro_torch.runtime.dispatch import Dispatcher, DispatchPolicy
from repro_torch.runtime.registry import (KernelRegistry, RegisteredKernel,
                                          Variant)
from repro_torch.serve.continuous import ContinuousBatcher
from repro_torch.serve.policy import (ADMISSION_POLICIES, ColdCacheError,
                                      record_decode_time,
                                      record_prefill_time,
                                      split_cost_model_from_cache)

SERVE_STEP_KERNEL = "serve_step"
SERVE_STEP_FEATURES = ("slots", "ctx")


class ServeEngine(ContinuousBatcher):
    """Continuous batcher + tuning-cache cost model + compiled execution.

    ``cache`` is a ``runtime.TuningCache``; ``telemetry`` is a
    ``repro_torch.obs.Telemetry`` threaded through the engine and its
    compiled step exactly like ``compile_program`` threads it (None ->
    no-op).  ``device`` is where ``params=None`` makes the weights.
    """

    def __init__(self, model, cache, *, params=None, max_slots: int = 4,
                 max_seq: int = 256, max_queue: int = 64,
                 admission: str = "sjf", telemetry=None,
                 stream_kv: bool = False, record_rows: bool = True,
                 executor: str = "async", device="cuda"):
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {admission!r}")
        self.telemetry = as_telemetry(telemetry)
        self.tuning_cache = cache
        self.max_queue = max_queue
        self.record_rows = record_rows
        self.requested_policy = admission
        self.policy_name = admission
        self._split_model = None
        try:
            self._split_model = split_cost_model_from_cache(cache)
        except ColdCacheError as e:
            if admission == "sjf":
                # the documented fallback: serve FIFO instead of making
                # callers pre-check the cache, and say so in telemetry
                self.policy_name = "fifo"
                self.telemetry.count("serve.admission_fallback")
                self.telemetry.instant("serve.admission_fallback",
                                       cat="serve", reason=str(e),
                                       kernels=list(e.kernels))
        cost_model = self._split_model if self.policy_name == "sjf" else None
        if params is None:
            params = model.init_params(torch.Generator().manual_seed(0),
                                       device=device)
        super().__init__(model, params, max_slots=max_slots,
                         max_seq=max_seq, cost_model=cost_model,
                         stream_kv=stream_kv)
        self.completed: list = []
        self.rejected: list = []
        self._step_reqs: list = []   # (rid, slot, phase) of the live step
        # KV/slot byte gauges for the memory ledger surface: the cache is
        # preallocated for max_slots, so totals are static per engine;
        # serve.kv_live_bytes tracks the occupied-slot share on
        # admit/release (the number a capacity-aware admission would gate
        # on).  KV leaves are the per-position k/v planes; everything else
        # in the cache tree is recurrent per-slot state.
        self.kv_cache_bytes, self.slot_bytes = self._cache_bytes()
        self.telemetry.gauge("serve.kv_cache_bytes", self.kv_cache_bytes)
        self.telemetry.gauge("serve.kv_slot_bytes", self.slot_bytes)
        self.telemetry.gauge("serve.kv_live_bytes", 0)
        self._compiled = self._compile_step(executor)

    # -- memory accounting ---------------------------------------------------
    def _cache_bytes(self) -> tuple:
        """``(total cache bytes, per-slot bytes)`` of the preallocated
        model cache tree (KV planes + recurrent state, all slot-major)."""
        total = sum(x.numel() * x.element_size()
                    for x in module.leaves(self.cache))
        return total, total // max(self.max_slots, 1)

    def _gauge_kv_live(self) -> None:
        active = sum(1 for s in self.slots if s is not None)
        self.telemetry.gauge("serve.kv_live_bytes",
                             active * self.slot_bytes)

    # -- predictions ---------------------------------------------------------
    def predict_ttft_s(self, prompt_len: int) -> Optional[float]:
        """Predicted prompt-consumption seconds (TTFT minus queue wait)."""
        if self._split_model is None:
            return None
        return self._split_model.prefill_seconds(prompt_len)

    def predict_request_s(self, prompt_len: int,
                          max_new: int) -> Optional[float]:
        if self._split_model is None:
            return None
        return self._split_model.request_seconds(prompt_len, max_new)

    # -- the compiled serve_step program -------------------------------------
    def _seed_serve_step_entry(self) -> None:
        """The compiled schedule needs a predicted time for ``serve_step``
        (a cold cache raises at compile, by contract).  serve_step is a
        prediction-only pseudo-kernel with one variant, so when no fitted
        model exists yet a weak analytic prior (time ~ slots*ctx) is
        fitted in memory; live ``kernel.serve_step.s`` histograms and
        makespan residuals then show how wrong it is."""
        entry = self.tuning_cache.entry(
            SERVE_STEP_KERNEL, feature_names=list(SERVE_STEP_FEATURES),
            variant_names=["engine"])
        if entry.model is not None:
            return
        rows, ys = [], []
        for s in (1, 2, 4, 8):
            for c in (64, 256, 1024):
                rows.append([float(s), float(c), float(s * c)])
                ys.append(1e-4 + 1e-8 * s * c)
        entry.add_rows(np.asarray(rows), ys,
                       shape_bucket({"slots": 0, "ctx": 0}))
        entry.fit(model=LinearModel())

    def _compile_step(self, executor: str):
        engine = self
        max_seq = self.max_seq

        def params_of(tokens, start):
            return {"slots": int(np.shape(tokens)[0]), "ctx": int(max_seq)}

        def out_aval(tokens, start):
            return Aval(tuple(tokens.shape), "int32")

        def call(args, params):
            # one model step over the engine's mutable cache from the
            # host's token and start arrays; the next tokens stay on the
            # device, where the dispatcher synchronises them
            tokens, start = args
            return engine._run_model(tokens, start)

        variant = Variant(
            SERVE_STEP_KERNEL, "engine", call,
            lambda p: [float(p["slots"]), float(p["ctx"])],
            lambda p: float(p["slots"]) * float(p["ctx"]))
        registry = KernelRegistry()
        registry.register(RegisteredKernel(
            SERVE_STEP_KERNEL, params_of, SERVE_STEP_FEATURES, (variant,),
            abstract_params=params_of, out_aval=out_aval))
        self._seed_serve_step_entry()
        # measure_on_cold/confidence_gate off: a serve step is stateful and
        # must run exactly once per dispatch (never the timing protocol)
        dispatcher = Dispatcher(
            registry, self.tuning_cache,
            DispatchPolicy(measure_on_cold=False, confidence_gate=False))
        tb = TraceBuilder(registry)
        tokens0 = np.zeros((self.max_slots, 1), np.int32)
        start0 = np.zeros((self.max_slots,), np.int32)
        tb.mark_output(tb.add(SERVE_STEP_KERNEL, (tokens0, start0), {}))
        return compile_program(
            tb.program, devices={"serve": dispatcher}, executor=executor,
            telemetry=self.telemetry)

    def _assemble(self, active: list) -> np.ndarray:
        # snapshot who rides this iteration (and in which phase) before
        # the base class consumes prompt state — the step span records it
        self._step_reqs = [
            {"rid": self.slots[i].rid, "slot": i,
             "phase": "prefill" if self.prompt_left[i] >= 1 else "decode"}
            for i in active]
        return super()._assemble(active)

    def _execute(self, tokens: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        out = self._compiled(tokens, self.start.copy()).cpu().numpy()
        self.telemetry.event(
            f"engine.step:{self.steps}", t0, time.perf_counter(),
            cat="serve.step", step=self.steps, requests=self._step_reqs)
        return out

    # -- queue + lifecycle hooks ---------------------------------------------
    def submit(self, req) -> bool:
        if len(self.queue) >= self.max_queue:
            req.rejected = True
            self.rejected.append(req)
            self.telemetry.count("serve.requests_rejected")
            return False
        if getattr(req, "submitted_s", None) is None:
            req.submitted_s = time.perf_counter()
        self.telemetry.instant(
            f"request.arrival:{req.rid}", cat="serve.request", rid=req.rid,
            prompt=len(req.prompt), max_new=req.max_new)
        if self._split_model is not None:
            req.predicted_s = self._split_model.request_seconds(
                len(req.prompt), req.max_new)
        super().submit(req)
        self.telemetry.gauge("serve.queue_depth", len(self.queue))
        return True

    def _on_admit(self, req, slot: int) -> None:
        now = time.perf_counter()
        req.admitted_s = now
        req.slot = slot
        submitted = getattr(req, "submitted_s", None)
        self.telemetry.gauge("serve.queue_depth", len(self.queue))
        self._gauge_kv_live()
        self.telemetry.instant(
            f"admission:{req.rid}", cat="admission", rid=req.rid,
            slot=slot, policy=self.policy_name,
            prompt=len(req.prompt), max_new=req.max_new,
            predicted_s=getattr(req, "predicted_s", None),
            queue_wait_s=None if submitted is None else now - submitted)

    def _on_token(self, req, slot: int, first: bool) -> None:
        now = time.perf_counter()
        if first:
            req.first_token_s = now
            self.telemetry.instant(f"first_token:{req.rid}",
                                   cat="serve.request", rid=req.rid)
            submitted = getattr(req, "submitted_s", None)
            if submitted is not None:
                self.telemetry.observe("serve.ttft_s", now - submitted)
        else:
            prev = getattr(req, "_last_token_s", None) \
                or getattr(req, "first_token_s", None)
            if prev is not None:
                self.telemetry.observe("serve.token_latency_s", now - prev)
        req._last_token_s = now
        self.telemetry.count("serve.tokens_generated")

    def _on_done(self, req, slot: int) -> None:
        now = time.perf_counter()
        req.finished_s = now
        self.completed.append(req)
        self.telemetry.instant(f"request.done:{req.rid}",
                               cat="serve.request", rid=req.rid,
                               tokens=len(req.generated))
        self.telemetry.count("serve.requests_completed")
        admitted = getattr(req, "admitted_s", None)
        predicted = getattr(req, "predicted_s", None)
        if admitted is not None and predicted is not None:
            band = self._split_model.fit_band_pct \
                if self._split_model is not None else None
            self.telemetry.residual("serve.request", predicted,
                                    now - admitted, fit_band_pct=band)
        if self.record_rows:
            self._record_split_rows(req, now)
        self._gauge_kv_live()

    def _record_split_rows(self, req, now: float) -> None:
        """Split the completed request's measured wall time into one
        prefill row (admission -> first token, the TTFT predictor's
        target) and one per-token decode row at the request's mean
        context."""
        admitted = getattr(req, "admitted_s", None)
        first = getattr(req, "first_token_s", None)
        if admitted is None or first is None:
            return
        record_prefill_time(self.tuning_cache, len(req.prompt),
                            len(req.prompt), max(first - admitted, 1e-9))
        new = len(req.generated)
        if new > 1:
            ctx_mid = len(req.prompt) + new // 2
            record_decode_time(self.tuning_cache, ctx_mid,
                               max((now - first) / (new - 1), 1e-9))

    # -- driving a trace ------------------------------------------------------
    def run_trace(self, requests, max_steps: int = 100000) -> dict:
        """Drive a step-indexed arrival trace (``request.poisson_trace`` /
        ``bursty_trace``) to completion: requests whose ``arrival_step``
        has come are submitted before each iteration; when the engine goes
        idle between bursts the step clock fast-forwards to the next
        arrival (and the drained cache region is reclaimed)."""
        pending = deque(sorted(
            requests, key=lambda r: (getattr(r, "arrival_step", 0), r.rid)))
        t0 = time.perf_counter()
        while True:
            while pending and \
                    getattr(pending[0], "arrival_step", 0) <= self.steps:
                self.submit(pending.popleft())
            if not self.step():
                if not pending:
                    break
                self.steps = max(self.steps,
                                 getattr(pending[0], "arrival_step", 0))
                if all(s is None for s in self.slots):
                    self.index = 0
                continue
            if self.steps >= max_steps:
                break
        wall = time.perf_counter() - t0
        tokens = sum(len(r.generated) for r in self.completed)
        self.telemetry.gauge("serve.goodput_tok_s",
                             tokens / max(wall, 1e-9))
        return self.stats(wall_s=wall)

    def stats(self, wall_s: Optional[float] = None) -> dict:
        out = {"engine_steps": self.steps,
               "occupancy": self.busy_slot_steps
               / max(self.steps * self.max_slots, 1),
               "completed": len(self.completed),
               "rejected": len(self.rejected),
               "tokens_generated": sum(len(r.generated)
                                       for r in self.completed),
               "policy": self.policy_name,
               "admission_fallback": self.policy_name
               != self.requested_policy}
        if wall_s is not None:
            out["wall_s"] = wall_s
            out["goodput_tok_s"] = out["tokens_generated"] \
                / max(wall_s, 1e-9)
        return out
