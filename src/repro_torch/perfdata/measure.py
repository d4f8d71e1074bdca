"""The black-box timing protocol shared by every measured row."""
from __future__ import annotations

import time
from typing import Callable


def time_callable(fn: Callable[[], object], min_window: float = 5e-3,
                  max_reps: int = 200) -> float:
    """Wall-clock seconds per call of ``fn`` — the repo-wide black-box
    timing protocol: one warmup call, then adaptive repetition until the
    measured window reaches ``min_window`` (amortizes timer resolution for
    microsecond kernels without penalizing millisecond ones).

    ``fn`` must return only when its work is done: a callable that
    launches CUDA work synchronises the device before returning (the
    runtime dispatcher wraps every variant so), or the window measures
    launches, not kernels.
    """
    fn()                                    # warmup
    reps = 1
    while True:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        if dt >= min_window or reps >= max_reps:
            return dt / reps
        reps = min(max_reps, max(reps * 2, int(reps * min_window / max(dt, 1e-9))))
