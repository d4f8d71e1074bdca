"""Deterministic tuning-cache seeding for reproducible tests and simulation.

Dispatchers whose caches hold *known* synthetic rows: per-variant times
derived from the analytic flop count at a stated device speed, skewed per
variant so the predicted-best, default (first), and predicted-worst
variants genuinely differ.  Seeding from the programs under test
guarantees every node's shape bucket is covered, so compiles never hit the
cold-cache error and never trigger the confidence gate's measurement path
— byte-identical predictions on every run, and the same as the JAX
package's for the same programs.  ``measure_from_programs`` is the
measured sibling: it times every variant of every node on a real device.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.core.nnc import LinearModel
from repro_torch.kernels import resolve_device
from repro_torch.perfdata.measure import time_callable
from repro_torch.runtime.cache import shape_bucket
from repro_torch.runtime.dispatch import synchronize


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


def measure_from_programs(dispatcher, programs, device="cuda",
                          min_window: float = 2e-3, seed: int = 0,
                          model_factory=None, fit_epochs: int = 4000,
                          best_of: int = 3, reset: bool = False) -> list:
    """Tune ``dispatcher``'s cache by *measuring* every variant of every
    distinct (kernel, params) node across ``programs`` on ``device`` (the
    card unless ``device="cpu"``) — the real-hardware sibling of
    ``seed_from_programs`` and the bench harness's "tuned grid".

    Interior-node operands are synthesized from the program's avals (the
    black-box protocol only needs shapes, not live data), drawn with the
    JAX package's numpy calls in its order and then moved to ``device``,
    so both packages time the same operands.  Each variant is timed
    ``best_of`` times and the minimum kept — on a loaded host a single
    adaptive window is noisy enough to invert variant rankings; each
    timed call synchronises the card, so the window holds kernels, not
    launches.  With ``reset`` each touched entry drops previously
    persisted rows first: a fresh pass *replaces* the grid, because
    stacking two noisy measurement sets of the same rows makes the fit
    straddle both.  Each touched kernel entry is fitted
    (``model_factory()`` when given, else the production MLP at
    ``fit_epochs``) and persisted.  Returns the seeded kernel names.
    """
    from repro_torch.api.program import norm_dtype   # api imports runtime

    device = resolve_device(device)
    reg = dispatcher.registry
    rng = np.random.RandomState(seed)
    touched, seen = {}, set()
    for prog in programs:
        avals = {s.name: s.aval for s in prog.inputs}
        for node in prog.nodes:
            avals[node.name] = node.aval
            key = (node.kernel, tuple(sorted(node.params.items())))
            if key in seen:
                continue
            seen.add(key)
            rk = reg.get(node.kernel)
            entry = dispatcher.cache.entry(
                node.kernel, feature_names=rk.feature_names,
                variant_names=reg.variant_names(node.kernel))
            if reset and node.kernel not in touched:
                entry.clear_rows()
            args = tuple(
                torch.from_numpy(rng.rand(*avals[d].shape) - 0.5).to(
                    device=device,
                    dtype=getattr(torch, norm_dtype(avals[d].dtype)))
                for d in node.deps)
            rows = reg.feature_rows(node.kernel, node.params)
            times = []
            for v in rk.variants:
                times.append(min(
                    time_callable(
                        lambda v=v: synchronize(v.call(args, node.params)),
                        min_window=min_window)
                    for _ in range(max(1, best_of))))
            entry.add_rows(rows, times, shape_bucket(node.params))
            touched[node.kernel] = entry
    for entry in touched.values():
        if model_factory is not None:
            entry.fit(model=model_factory())
        else:
            entry.fit(epochs=fit_epochs)
    dispatcher.cache.save()
    return sorted(touched)
