"""Prediction-drift monitoring: live MAPE vs the fit-time error band, the
port of ``repro.obs.drift``.

The paper's claim is not just that the NN+C models are accurate at fit
time (~3% MAPE on the tuned grid) — it is that they *stay* accurate
enough to drive variant selection and placement.  ``DriftMonitor`` turns
that into a standing health signal (the "Learned Performance Model for
TPUs" framing: continuously score predicted-vs-actual residuals): every
executed dispatch reports the chosen variant's predicted and actual
seconds, the monitor keeps a rolling window of absolute percentage
errors per kernel, and a kernel is *flagged* once its live MAPE exceeds
``factor`` times its fit-time band (the training MAPE persisted in the
tuning cache) with at least ``min_obs`` observations — the point where
the gap between what the model believes and what the hardware does is no
longer explained by the model's own training error, i.e. the moment a
refit (or re-measure) is owed.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    window: int = 64            # rolling-APE window per kernel
    factor: float = 2.0         # flag when live MAPE > factor * fit band
    min_obs: int = 8            # observations before a flag can raise
    default_band_pct: float = 25.0   # band for kernels with no fit MAPE


class DriftMonitor:
    """Per-kernel rolling predicted-vs-actual residual tracker."""

    def __init__(self, config: Optional[DriftConfig] = None):
        self.config = config or DriftConfig()
        self._apes: dict = {}       # kernel -> deque of APEs (fractions)
        self._bands: dict = {}      # kernel -> fit-time MAPE (pct) or None
        self._counts: dict = {}     # kernel -> total observations

    def observe(self, kernel: str, predicted_s: float, actual_s: float,
                fit_band_pct: Optional[float] = None) -> float:
        """Record one residual; returns the absolute percentage error.

        ``fit_band_pct`` is the model's fit-time MAPE (the band live error
        is judged against); the last non-None value reported wins, so the
        band follows refits."""
        ape = abs(float(actual_s) - float(predicted_s)) \
            / max(abs(float(actual_s)), 1e-12)
        dq = self._apes.get(kernel)
        if dq is None:
            dq = self._apes[kernel] = deque(maxlen=self.config.window)
        dq.append(ape)
        self._counts[kernel] = self._counts.get(kernel, 0) + 1
        if fit_band_pct is not None:
            self._bands[kernel] = float(fit_band_pct)
        return 100.0 * ape

    # -- reading -------------------------------------------------------------
    def kernels(self) -> list:
        return sorted(self._apes)

    def live_mape(self, kernel: str) -> float:
        """Rolling-window MAPE (pct); NaN before the first observation."""
        dq = self._apes.get(kernel)
        if not dq:
            return float("nan")
        return 100.0 * sum(dq) / len(dq)

    def band(self, kernel: str) -> float:
        b = self._bands.get(kernel)
        return float(b) if b is not None else self.config.default_band_pct

    def flagged(self, kernel: str) -> bool:
        if self._counts.get(kernel, 0) < self.config.min_obs:
            return False
        return self.live_mape(kernel) > self.config.factor * self.band(kernel)

    def status(self) -> dict:
        """kernel -> {live_mape_pct, fit_band_pct, n, flagged}."""
        return {k: {"live_mape_pct": self.live_mape(k),
                    "fit_band_pct": self.band(k),
                    "n": int(self._counts.get(k, 0)),
                    "flagged": self.flagged(k)}
                for k in self.kernels()}

    def flags(self) -> list:
        return [k for k in self.kernels() if self.flagged(k)]

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> dict:
        return {"config": dataclasses.asdict(self.config),
                "kernels": {k: {"apes": [float(a) for a in self._apes[k]],
                                "fit_band_pct": self._bands.get(k),
                                "n": int(self._counts.get(k, 0))}
                            for k in self.kernels()}}

    @classmethod
    def from_json(cls, doc: dict) -> "DriftMonitor":
        mon = cls(DriftConfig(**doc.get("config", {})))
        for k, d in doc.get("kernels", {}).items():
            dq = deque(maxlen=mon.config.window)
            dq.extend(float(a) for a in d.get("apes", []))
            mon._apes[k] = dq
            if d.get("fit_band_pct") is not None:
                mon._bands[k] = float(d["fit_band_pct"])
            mon._counts[k] = int(d.get("n", len(dq)))
        return mon
