"""Deterministic tuning-cache seeding for reproducible tests and simulation.

Dispatchers whose caches hold *known* synthetic rows: per-variant times
derived from the analytic flop count at a stated device speed, skewed per
variant so the predicted-best, default (first), and predicted-worst
variants genuinely differ.  Seeding from the programs under test
guarantees every node's shape bucket is covered, so compiles never hit the
cold-cache error and never trigger the confidence gate's measurement path
— byte-identical predictions on every run, and the same as the JAX
package's for the same programs.
"""
from __future__ import annotations

import zlib

import numpy as np

from repro_torch.core.nnc import LinearModel
from repro_torch.runtime.cache import shape_bucket


def variant_skews(n_variants: int, kernel: str, amplitude: float = 1.0,
                  seed: int = 0) -> np.ndarray:
    """Per-variant synthetic slowdown factors in ``[1, 1+amplitude]``.

    Deterministic in (kernel, seed).  For multi-variant kernels the winner
    (factor 1.0) is never variant 0, so the *default/first* variant is
    always strictly slower than the predicted best, and the worst variant
    is ``1 + amplitude`` slower.
    """
    if n_variants <= 1:
        return np.ones(n_variants)
    w = 1 + (zlib.crc32(kernel.encode()) + seed) % (n_variants - 1)
    ranks = np.array([(i - w) % n_variants for i in range(n_variants)],
                     dtype=np.float64)
    return 1.0 + amplitude * ranks / (n_variants - 1)


def seed_from_programs(dispatcher, programs, flops_per_s: float,
                       amplitude: float = 1.0, seed: int = 0,
                       model_factory=LinearModel, reset: bool = False) -> list:
    """Fill ``dispatcher``'s cache with synthetic rows for every node of
    every program, fit each touched kernel entry, and persist.

    Times are ``flops / flops_per_s * variant_skews(...)`` — a device with
    the stated sustained flop rate whose variants differ by known factors.
    With ``reset`` each touched entry drops previously persisted rows
    first (a re-seeded grid replaces, never accumulates).  Returns the
    list of seeded kernel names.
    """
    reg = dispatcher.registry
    touched, seen = {}, set()
    for prog in programs:
        for node in prog.nodes:
            key = (node.kernel, tuple(sorted(node.params.items())))
            if key in seen:        # repeated shapes add no information and
                continue           # would crowd the bounded fit window
            seen.add(key)
            rk = reg.get(node.kernel)
            entry = dispatcher.cache.entry(
                node.kernel, feature_names=rk.feature_names,
                variant_names=reg.variant_names(node.kernel))
            if reset and node.kernel not in touched:
                entry.clear_rows()
            rows = reg.feature_rows(node.kernel, node.params)
            skews = variant_skews(len(rows), node.kernel, amplitude, seed)
            entry.add_rows(rows, rows[:, -1] / flops_per_s * skews,
                           shape_bucket(node.params))
            touched[node.kernel] = entry
    for entry in touched.values():
        entry.fit(model=model_factory())
    dispatcher.cache.save()
    return sorted(touched)
