"""Evaluation-mode dispatchers: run a program under a *fixed* variant rule,
the port of ``repro.bench.pinned``.

The bench harness compares three whole-program execution modes:

- ``best``    — every node runs its predicted-fastest variant,
- ``default`` — every node runs variant 0 (the registry's first entry: the
  static schedule a predictor-less system would ship), and
- ``worst``   — every node runs its predicted-slowest variant (the floor
  the paper's up-to-1.7x Halide pipeline claim is measured against).

``PinnedDispatcher`` implements all three behind the normal ``Dispatcher``
surface, so ``Program.compile`` and every executor drive it unchanged.
``predict_time`` returns the *pinned* variant's prediction — the EFT
schedule (and its makespan) stays consistent with what the mode will
actually run.  With ``simulate_time`` each dispatch sleeps the pinned
variant's predicted seconds (the ``runtime.simdev`` convention), and with
``execute=False`` it returns zeros of the output aval, on the host,
instead of running the kernel — the pure scheduling/overlap simulation the
simdev bench config uses (numerics parity is the real configs' and the
workload tests' job).  A real run synchronises the card after each call,
as the dispatcher does, so ``kernel_s`` holds the kernel and not its
launch.
"""
from __future__ import annotations

import time

import torch

from repro_torch.api.program import norm_dtype
from repro_torch.runtime.dispatch import Dispatcher, synchronize

MODES = ("best", "default", "worst")


class PinnedDispatcher(Dispatcher):
    def __init__(self, *args, mode: str = "best",
                 simulate_time: bool = False, time_scale: float = 1.0,
                 execute: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.simulate_time = simulate_time
        self.time_scale = time_scale
        self.execute = execute
        self.decision_s = 0.0       # accumulated variant-choice overhead
        self.kernel_s = 0.0         # accumulated execution (or sleep) time
        self.n_calls = 0
        self._pin_memo: dict = {}

    def _choose(self, kernel: str, params: dict) -> tuple:
        """(variant index, predicted seconds) under the pinned rule —
        memoized per exact shape like the production decision memo."""
        key = (kernel, tuple(sorted(params.items())))
        hit = self._pin_memo.get(key)
        if hit is not None:
            return hit
        pred = self.predict_times(kernel, params)
        names = self.registry.variant_names(kernel)
        if self.mode == "best":
            name = min(pred, key=pred.get)
        elif self.mode == "worst":
            name = max(pred, key=pred.get)
        else:
            name = names[0]
        choice = (names.index(name), float(pred[name]))
        self._pin_memo[key] = choice
        return choice

    def predict_time(self, kernel: str, params: dict) -> float:
        return self._choose(kernel, params)[1]

    def dispatch(self, kernel: str, *args, **kwargs):
        t0 = time.perf_counter()
        rk = self.registry.get(kernel)
        params = rk.params_of(*args, **kwargs)
        idx, pred_s = self._choose(kernel, params)
        decision = time.perf_counter() - t0
        self.decision_s += decision
        self.n_calls += 1
        t1 = time.perf_counter()
        if self.simulate_time:
            time.sleep(pred_s * self.time_scale)
        if self.execute:
            out = synchronize(rk.variants[idx].call(args, params))
        else:
            aval = self.registry.out_aval(kernel, *args, **kwargs)
            out = torch.zeros(tuple(aval.shape),
                              dtype=getattr(torch, norm_dtype(aval.dtype)))
        kernel_s = time.perf_counter() - t1
        self.kernel_s += kernel_s
        tel = self._telemetry
        if tel is not None:
            tel.count("dispatch.pinned")
            tel.observe("dispatch.overhead_s", decision)
            tel.observe(f"kernel.{kernel}.s", kernel_s)
            if self.execute:
                # predicted-vs-actual only where the kernel really ran;
                # attach telemetry after warmup or the first call's one-off
                # costs (library plans, allocator growth) land in the
                # residual (the bench does)
                tel.residual(kernel, pred_s, kernel_s,
                             fit_band_pct=self._entry(kernel).fit_mape)
        return out

    __call__ = dispatch

    def reset_counters(self) -> None:
        self.decision_s = self.kernel_s = 0.0
        self.n_calls = 0
