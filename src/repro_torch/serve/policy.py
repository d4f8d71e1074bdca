"""Admission policy + split prefill/decode cost model for serving: the
port of ``repro.serve.policy``, the same functions over the port's
``runtime.cache.TuningCache`` (whose files either package loads).

The serving layer predicts two different things about a request and they
scale differently, so they are two pseudo-kernels in the tuning cache:

- ``prefill_step`` — time to consume the whole prompt (TTFT minus queue
  wait).  Features ``(prompt, ctx)``; c = prompt * ctx, the attention op
  count of prefilling ``prompt`` tokens against a ``ctx``-long region.
- ``decode_step`` — steady-state per-generated-token time.  Feature
  ``(ctx,)``; c = ctx, each decode step attending to an O(ctx) prefix.

Earlier revisions recorded one whole-request row under ``decode_step``
(features ``(prompt, new)``, c = (prompt+new)^2).  ``migrate_whole_request
_rows`` splits such rows proportionally to the analytic op counts —
prefill ops ~ prompt^2, decode ops ~ new*(2*prompt + new), which sum to
(prompt+new)^2, the old c — so a cache fitted before the split keeps its
training signal instead of going cold.

``split_cost_model_from_cache`` raises the typed ``ColdCacheError``
(a ``ValueError`` subclass, so old ``except ValueError`` callers keep
working); the engine catches it and falls back to FIFO admission with a
``serve.admission_fallback`` telemetry counter rather than requiring
callers to pre-check the cache.
"""
from __future__ import annotations

import numpy as np

from repro_torch.runtime.cache import shape_bucket

PREFILL_STEP_KERNEL = "prefill_step"
PREFILL_STEP_FEATURES = ("prompt", "ctx")
DECODE_STEP_KERNEL = "decode_step"
DECODE_STEP_FEATURES = ("ctx",)
# the pre-split layout, recognised (and migrated) but never written
_WHOLE_REQUEST_FEATURES = ("prompt", "new")
ADMISSION_POLICIES = ("fifo", "sjf")


class ColdCacheError(ValueError):
    """The tuning cache has no fitted model for a serving pseudo-kernel.

    Subclasses ``ValueError`` so pre-split callers that caught the bare
    ``ValueError`` keep working; carries ``kernels`` so the engine can say
    *which* entries need rows before SJF admission is possible.
    """

    def __init__(self, kernels):
        self.kernels = tuple(kernels)
        super().__init__(
            "tuning cache has no fitted model for "
            + ", ".join(repr(k) for k in self.kernels)
            + " — record serving times (record_prefill_time / "
            "record_decode_time) and fit the entries first")


def prefill_features(prompt_len: int, ctx: int) -> list:
    """[prompt, ctx, c] — prefilling ``prompt`` tokens each attending to an
    O(ctx) region costs ~ prompt*ctx attention ops."""
    return [float(prompt_len), float(ctx), float(prompt_len) * float(ctx)]


def decode_features(ctx: int) -> list:
    """[ctx, c] — one decode step attends to an O(ctx) prefix."""
    return [float(ctx), float(ctx)]


def _prefill_entry(cache):
    return cache.entry(PREFILL_STEP_KERNEL,
                       feature_names=list(PREFILL_STEP_FEATURES),
                       variant_names=["engine"])


def _decode_entry(cache):
    return cache.entry(DECODE_STEP_KERNEL,
                       feature_names=list(DECODE_STEP_FEATURES),
                       variant_names=["engine"])


def record_prefill_time(cache, prompt_len: int, ctx: int,
                        seconds: float) -> None:
    """Append one measured prompt-consumption (TTFT) row."""
    entry = _prefill_entry(cache)
    row = np.asarray([prefill_features(prompt_len, ctx)])
    entry.add_rows(row, [seconds],
                   shape_bucket({"prompt": prompt_len, "ctx": ctx}))


def record_decode_time(cache, ctx: int, seconds_per_token: float) -> None:
    """Append one measured steady-state per-token row at context ``ctx``."""
    entry = _decode_entry(cache)
    row = np.asarray([decode_features(ctx)])
    entry.add_rows(row, [seconds_per_token], shape_bucket({"ctx": ctx}))


def split_request_seconds(prompt_len: int, max_new: int, seconds: float):
    """Split a whole-request wall time into (prefill_s, per_token_s, ctx_mid).

    The split is proportional to the analytic op counts the old c used:
    prefill ~ prompt^2, decode ~ new*(2*prompt + new) (together exactly
    (prompt+new)^2).  ``ctx_mid = prompt + new/2`` is the mean context the
    decode steps ran at, so the per-token row lands on the right feature.
    """
    p, n = max(int(prompt_len), 1), max(int(max_new), 1)
    prefill_ops = float(p * p)
    decode_ops = float(n * (2 * p + n))
    prefill_s = seconds * prefill_ops / (prefill_ops + decode_ops)
    per_token_s = (seconds - prefill_s) / n
    ctx_mid = p + n // 2
    return prefill_s, per_token_s, ctx_mid


def record_request_time(cache, prompt_len: int, max_new: int,
                        seconds: float) -> None:
    """Back-compat shim: split one whole-request wall time into a prefill
    row and a per-token decode row (see ``split_request_seconds``)."""
    prefill_s, per_token_s, ctx_mid = split_request_seconds(
        prompt_len, max_new, seconds)
    record_prefill_time(cache, prompt_len, prompt_len, prefill_s)
    record_decode_time(cache, ctx_mid, per_token_s)


def migrate_whole_request_rows(cache) -> int:
    """Split pre-split whole-request ``decode_step`` rows into the new
    ``prefill_step``/``decode_step`` entries.  Returns the number of old
    rows migrated (0 when there is nothing old-layout to migrate).

    Must look at the *raw* on-disk entry: ``cache.entry`` with the new
    feature names would silently discard the stale layout before we could
    read its rows.
    """
    old = cache._entries.get(DECODE_STEP_KERNEL)
    if old is None:
        old = cache._load(DECODE_STEP_KERNEL)
    if old is None or \
            list(old.feature_names) != list(_WHOLE_REQUEST_FEATURES):
        return 0
    # drop the stale in-memory/on-disk layout before re-recording
    cache._entries.pop(DECODE_STEP_KERNEL, None)
    rows = [(int(round(x[0])), int(round(x[1])), float(t))
            for x, t in zip(np.asarray(old.X), np.asarray(old.y))]
    for prompt_len, max_new, seconds in rows:
        record_request_time(cache, prompt_len, max_new, seconds)
    if rows:
        cache.save()
    return len(rows)


class SplitCostModel:
    """Predicted request timing from the two fitted serving entries."""

    def __init__(self, prefill_entry, decode_entry):
        self._prefill = prefill_entry
        self._decode = decode_entry

    @property
    def fit_band_pct(self):
        """Worst fit-time MAPE of the two entries — the drift band a live
        whole-request residual is judged against."""
        bands = [e.fit_mape for e in (self._prefill, self._decode)
                 if e.fit_mape is not None]
        return max(bands) if bands else None

    def prefill_seconds(self, prompt_len: int, ctx: int = 0) -> float:
        ctx = ctx or prompt_len
        row = np.asarray([prefill_features(prompt_len, ctx)])
        return float(self._prefill.predict(row)[0])

    def decode_seconds_per_token(self, ctx: int) -> float:
        row = np.asarray([decode_features(ctx)])
        return float(self._decode.predict(row)[0])

    def request_seconds(self, prompt_len: int, max_new: int) -> float:
        """Predicted service time: full prefill + max_new decode steps at
        the request's mean context."""
        ctx_mid = prompt_len + max(int(max_new), 1) // 2
        return (self.prefill_seconds(prompt_len)
                + max_new * self.decode_seconds_per_token(ctx_mid))

    # calling the model directly keeps the pre-split
    # ``cost(prompt_len, max_new)`` callable contract alive
    __call__ = request_seconds


def split_cost_model_from_cache(cache) -> SplitCostModel:
    """Build the split admission cost model from a runtime ``TuningCache``.

    Migrates any pre-split whole-request rows first; raises
    ``ColdCacheError`` naming the unfitted entries when either model is
    missing (engines catch it and fall back to FIFO admission).
    """
    migrate_whole_request_rows(cache)
    prefill, decode = _prefill_entry(cache), _decode_entry(cache)
    cold = [e.kernel for e in (prefill, decode) if e.model is None]
    if cold:
        raise ColdCacheError(cold)
    return SplitCostModel(prefill, decode)


def cost_model_from_cache(cache):
    """Back-compat: ``cost(prompt_len, max_new) -> predicted seconds``.

    Now backed by the split prefill/decode entries; raises the typed
    ``ColdCacheError`` (still a ``ValueError``) when cold.
    """
    return split_cost_model_from_cache(cache)


def fit_cost_entries(cache, *, model_factory=None, epochs: int = 2000,
                     save: bool = True) -> SplitCostModel:
    """Fit both serving entries (migrating old rows first) and return the
    split model.  ``model_factory`` builds a fresh model per entry (e.g.
    ``LinearModel``); default is the lightweight MLP."""
    migrate_whole_request_rows(cache)
    for entry in (_prefill_entry(cache), _decode_entry(cache)):
        if entry.n_rows < 2:
            raise ColdCacheError([entry.kernel])
        entry.fit(model=model_factory() if model_factory else None,
                  epochs=epochs)
    if save:
        cache.save()
    return SplitCostModel(_prefill_entry(cache), _decode_entry(cache))


def fifo_order(requests) -> list:
    """Arrival order (stable no-op, spelled out for symmetry)."""
    return list(requests)


def sjf_order(requests, request_cost) -> list:
    """Shortest-predicted-job-first under ``request_cost(prompt_len,
    max_new)``; ties (and equal predictions) keep arrival order because
    ``sorted`` is stable."""
    return sorted(requests,
                  key=lambda r: request_cost(len(r.prompt), r.max_new))
