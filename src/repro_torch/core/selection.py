"""Variant selection (paper §6): argmin over NN+C-predicted runtimes.

Generalises the Halide-Blur demonstration: a *schedule space* (the variant
axis) is searched by predicting every candidate's runtime with the trained
lightweight model and executing only the predicted-best.  The port's copy
of the JAX package's ``core.selection``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VariantSelector:
    """Wraps a fitted regressor predicting time from [features..., c]."""

    model: object                       # has .predict(X)

    def select(self, candidates: np.ndarray) -> int:
        """candidates: [N, F] feature rows -> index of predicted-fastest."""
        pred = self.model.predict(candidates)
        return int(np.argmin(pred))

    def rank(self, candidates: np.ndarray) -> np.ndarray:
        return np.argsort(self.model.predict(candidates))


def evaluate_selection(selector: VariantSelector, candidates: np.ndarray,
                       true_times: np.ndarray,
                       default_idx: int = 0) -> dict:
    """Fig-4 style metrics: chosen vs true-best vs default ("autoscheduler")."""
    chosen = selector.select(candidates)
    best = int(np.argmin(true_times))
    return {
        "chosen_idx": chosen,
        "best_idx": best,
        "chosen_time": float(true_times[chosen]),
        "best_time": float(true_times[best]),
        "default_time": float(true_times[default_idx]),
        "speedup_vs_default": float(true_times[default_idx] / true_times[chosen]),
        "regret_vs_best": float(true_times[chosen] / true_times[best]),
    }
