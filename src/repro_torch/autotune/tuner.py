"""NN+C-driven schedule autotuning for the framework's own kernels: the
port of the JAX package's ``autotune/tuner.py``.

This is the paper's variant-selection loop closed over *our* variant axis:
a chunked-attention schedule (q_chunk, k_chunk) is a variant; the feature
vector is (B, H, S, D, q_chunk, k_chunk, c=attention FLOPs); the
lightweight NN+C model is trained on measured step times and then ranks
candidate schedules for unseen shapes.

The port times its own ``attend_chunked`` (torch ops, as the reference
times jnp ones) on the card by default; without one it raises unless the
caller asks for the CPU (``device="cpu"``).  Each call ends in a
``torch.cuda.synchronize`` where the reference blocks until ready, so the
times are host walls of a host-bound loop of small launches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.nnc import MLPModel, lightweight_dims
from repro_torch.core.selection import VariantSelector
from repro_torch.kernels import resolve_device
from repro_torch.models.attention import attend_chunked
# the registry owns the schedule axis (single source of truth); the tuner
# sweeps the full grid, dispatch ranks the curated subset
from repro_torch.runtime.registry import ATTENTION_SCHEDULE_GRID, attention_flops

SCHEDULES = list(ATTENTION_SCHEDULE_GRID)


def _features(b, h, s, d, qc, kc):
    return [b, h, s, d, qc, kc, attention_flops(b, h, s, d)]


def measure_schedule(b, h, s, d, qc, kc, reps: int = 2,
                     rng: Optional[np.random.RandomState] = None,
                     seed: Optional[int] = None, device=None) -> float:
    """Wall-time one (q_chunk, k_chunk) schedule: the best of ``reps``
    calls after one warm call, each synchronised.  ``device`` is the card
    unless the caller asks for the CPU.

    The noise source is explicit: pass ``rng`` (or ``seed``) to reproduce a
    measurement run; the default draws fresh OS entropy so *repeated* tuning
    runs see independent measurement noise."""
    device = resolve_device("cuda" if device is None else device)
    if rng is None:
        rng = np.random.RandomState(seed)
    q = torch.as_tensor(rng.randn(b, s, h, d) * 0.3, dtype=torch.float32,
                        device=device)
    k = torch.as_tensor(rng.randn(b, s, h, d) * 0.3, dtype=torch.float32,
                        device=device)
    v = torch.as_tensor(rng.randn(b, s, h, d), dtype=torch.float32,
                        device=device)

    def call():
        with torch.inference_mode():
            attend_chunked(q, k, v, causal=True, k_chunk=kc, q_chunk=qc)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


@dataclasses.dataclass
class AttentionTuner:
    model: Optional[MLPModel] = None

    def collect(self, shapes: Sequence[tuple], schedules=None,
                verbose: bool = False, seed: Optional[int] = None,
                device=None) -> tuple[np.ndarray, np.ndarray]:
        """Measure every (shape, schedule) pair on ``device`` (the card
        unless asked otherwise).  ``seed`` pins the input noise for
        reproducible collection; ``None`` (default) uses fresh entropy per
        run."""
        schedules = schedules or SCHEDULES
        rng = np.random.RandomState(seed)
        X, y = [], []
        for (b, h, s, d) in shapes:
            for (qc, kc) in schedules:
                t = measure_schedule(b, h, s, d, qc, kc, rng=rng,
                                     device=device)
                X.append(_features(b, h, s, d, qc, kc))
                y.append(t)
                if verbose:
                    print(f"  ({b},{h},{s},{d}) qc={qc} kc={kc}: {t*1e3:.1f}ms")
        return np.asarray(X), np.asarray(y)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "AttentionTuner":
        self.model = MLPModel(lightweight_dims(X.shape[1], 75, 1),
                              epochs=25000)
        self.model.fit(X, y)
        return self

    def best_schedule(self, b, h, s, d, schedules=None) -> tuple[int, int]:
        schedules = schedules or SCHEDULES
        cands = np.asarray([_features(b, h, s, d, qc, kc)
                            for qc, kc in schedules])
        idx = VariantSelector(self.model).select(cands)
        return schedules[idx]
