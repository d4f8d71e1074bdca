"""Online refinement: actual wall times feed back into the cached model.

Every dispatch (under ``DispatchPolicy(online=True)``) reports the chosen
variant's feature row and its *actual* wall time.  The refiner appends the
row to the cache entry and, once ``refit_every`` new rows accumulate,
refits the lightweight model — warm-started from the current weights and
bounded to the paper's <250-instance training budget, so a refit costs
about the same as the original fit and can run inline.

Rolling MAPE over the last ``window`` observations is the drift signal: a
workload or clock-speed shift shows up as a rising MAPE that the next
refit pulls back down.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Optional

import numpy as np

from repro_torch.core.nnc import mape
from repro_torch.runtime.cache import TRAIN_BUDGET_ROWS, TuningCache


@dataclasses.dataclass
class OnlineConfig:
    refit_every: int = 24          # new rows between refits
    window: int = 64               # rolling-MAPE window
    budget_rows: int = TRAIN_BUDGET_ROWS
    refit_epochs: int = 2000
    warm_start: bool = True
    model_factory: object = None   # e.g. nnc.LinearModel: refit with this
    #   closed-form model instead of the MLP — microseconds per refit, the
    #   right trade when refits run inline on an executor worker thread
    #   (the adaptive executor's mid-run feedback)
    save: bool = True              # persist the cache after each refit;
    #   False keeps refits purely in memory — file I/O on an executor
    #   worker's critical path would dwarf a closed-form refit


class OnlineRefiner:
    def __init__(self, cache: TuningCache,
                 config: Optional[OnlineConfig] = None, telemetry=None):
        self.cache = cache
        self.config = config or OnlineConfig()
        self.telemetry = telemetry      # obs.Telemetry or None: refit
        #   instants (with before/after model MAPE) + counters
        self._pending = defaultdict(int)       # rows since last refit
        self._apes = defaultdict(
            lambda: deque(maxlen=self.config.window))
        self.refits = defaultdict(int)
        self.refit_s = defaultdict(float)      # wall seconds in refits+saves

    def observe(self, kernel: str, feature_row: np.ndarray, bucket: tuple,
                actual_s: float, predicted_s: Optional[float] = None) -> None:
        """Record one executed dispatch; refit when enough rows accumulated.

        ``predicted_s`` is the model's estimate for the chosen variant (None
        on the cold/measured path, where there was no prediction to score).
        """
        entry = self.cache.entry(kernel)
        if predicted_s is not None:
            self._apes[kernel].append(
                abs(actual_s - predicted_s) / max(abs(actual_s), 1e-12))
        entry.add_rows(np.asarray(feature_row)[None, :], [actual_s], bucket)
        self._pending[kernel] += 1
        if self._pending[kernel] >= self.config.refit_every \
                and entry.n_rows >= 2:
            tel = self.telemetry
            # the before-MAPE model pass only runs when someone is watching
            before = self._model_mape(entry) if tel is not None else None
            t0 = time.perf_counter()
            if self.config.model_factory is not None:
                entry.fit(model=self.config.model_factory(),
                          budget_rows=self.config.budget_rows)
            else:
                entry.fit(epochs=self.config.refit_epochs,
                          warm_start=self.config.warm_start,
                          budget_rows=self.config.budget_rows)
            if self.config.save:
                self.cache.save(kernel)
            self._pending[kernel] = 0
            self.refits[kernel] += 1
            self.refit_s[kernel] += time.perf_counter() - t0
            if tel is not None:
                rolling = self.rolling_mape(kernel)
                tel.count("online.refits")
                tel.instant(f"refit:{kernel}", cat="refit", kernel=kernel,
                            before_mape_pct=before,
                            after_mape_pct=self._model_mape(entry),
                            rows=int(entry.n_rows),
                            rolling_mape_pct=float(rolling)
                            if np.isfinite(rolling) else None)

    @staticmethod
    def _model_mape(entry) -> Optional[float]:
        """Model MAPE over the entry's current rows (None when unfitted)."""
        if entry.model is None or entry.n_rows == 0:
            return None
        return float(mape(entry.y, entry.predict(entry.X)))

    def rolling_mape(self, kernel: str) -> float:
        """Mean absolute percentage error over the observation window
        (NaN until the first scored observation)."""
        apes = self._apes[kernel]
        if not apes:
            return float("nan")
        return 100.0 * float(np.mean(apes))

    def observed_kernels(self) -> list[str]:
        return sorted(self._apes)
