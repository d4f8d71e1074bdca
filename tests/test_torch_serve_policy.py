"""repro_torch.serve's traces and admission policy against the JAX
package's: the seeded arrival traces key for key, the split
prefill/decode cost model's predictions and SJF order on the same rows,
the whole-request row migration, and tuning caches that one package
writes and the other loads under one explicit fingerprint."""
import numpy as np
import pytest

from repro.core.nnc import LinearModel as JLinearModel
from repro.runtime import Fingerprint as JFingerprint
from repro.runtime import TuningCache as JTuningCache
from repro.serve import policy as jpolicy
from repro.serve import request as jrequest
from repro_torch.core.nnc import LinearModel
from repro_torch.runtime import Fingerprint, TuningCache
from repro_torch.serve import (ColdCacheError, bursty_trace,
                               cost_model_from_cache, fifo_order,
                               fit_cost_entries, migrate_whole_request_rows,
                               poisson_trace, record_decode_time,
                               record_prefill_time, record_request_time,
                               sjf_order, split_cost_model_from_cache)
from repro_torch.serve import policy
from repro_torch.serve.policy import DECODE_STEP_KERNEL, PREFILL_STEP_KERNEL
from repro_torch.serve.request import ServeRequest

REL = 1e-6                       # predictions, relative
SIM = ("sim", "serve-parity", 1, 1, ("float32",))
PREFILL_ROWS = [(p, p, 1e-4 * p * p) for p in (2, 4, 8, 16, 32)]
DECODE_ROWS = [(ctx, 1e-5 * ctx) for ctx in (4, 8, 16, 32, 64)]
SHAPES = [(2, 4), (4, 4), (8, 8), (16, 8), (32, 16), (24, 16), (3, 5)]


def _trace_key(reqs):
    return [(r.rid, tuple(r.prompt), r.max_new, r.arrival_step)
            for r in reqs]


def _caches(root):
    """(JAX cache, port cache) over one root under one fingerprint."""
    return (JTuningCache(root=str(root), fingerprint=JFingerprint(*SIM)),
            TuningCache(root=str(root), fingerprint=Fingerprint(*SIM)))


def _fill(pol, cache, noise=0.0, seed=0):
    rng = np.random.RandomState(seed)
    for p, ctx, t in PREFILL_ROWS:
        pol.record_prefill_time(cache, p, ctx, t * (1 + noise * rng.randn()))
    for ctx, t in DECODE_ROWS:
        pol.record_decode_time(cache, ctx, t * (1 + noise * rng.randn()))


def _preds(model) -> list:
    return [model.request_seconds(p, n) for p, n in SHAPES] \
        + [model.prefill_seconds(p) for p, _ in SHAPES] \
        + [model.decode_seconds_per_token(p + n) for p, n in SHAPES]


def _requests(module):
    return [module.ServeRequest(rid=i, prompt=[1] * p, max_new=n)
            for i, (p, n) in enumerate(SHAPES)]


# --------------------------------------------------------------------------
# arrival traces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"n": 8, "seed": 0}, {"n": 16, "seed": 3, "rate": 0.4},
    {"n": 8, "seed": 1, "rate": 0.5, "vocab": 262144},
    {"n": 5, "seed": 7, "prompt_lens": (3, 5, 9), "max_news": (2, 6)}],
    ids=["default", "rate0.4", "vocab262144", "menus"])
def test_poisson_trace_equals_jax(kw):
    kw = dict(kw)
    n = kw.pop("n")
    assert _trace_key(poisson_trace(n, **kw)) == \
        _trace_key(jrequest.poisson_trace(n, **kw))


@pytest.mark.parametrize("kw", [
    {"n_bursts": 2, "seed": 0}, {"n_bursts": 4, "seed": 2, "burst_gap": 16},
    {"n_bursts": 2, "seed": 2, "burst_gap": 16, "vocab": 262144},
    {"n_bursts": 3, "seed": 5, "shorts_per_burst": 2, "longs_per_burst": 2}],
    ids=["default", "gap16", "vocab262144", "two-longs"])
def test_bursty_trace_equals_jax(kw):
    assert _trace_key(bursty_trace(**kw)) == \
        _trace_key(jrequest.bursty_trace(**kw))


def test_trace_generators_deterministic():
    assert _trace_key(poisson_trace(8, seed=3)) == \
        _trace_key(poisson_trace(8, seed=3))
    assert _trace_key(poisson_trace(8, seed=3)) != \
        _trace_key(poisson_trace(8, seed=4))
    pois = poisson_trace(16, seed=1)
    assert all(a.arrival_step <= b.arrival_step
               for a, b in zip(pois, pois[1:]))
    burst = bursty_trace(2, seed=0, burst_gap=24)
    assert {r.arrival_step for r in burst} == {0, 24}
    for step in (0, 24):
        assert sorted(len(r.prompt) for r in burst
                      if r.arrival_step == step) == [2, 2, 2, 24]


def test_request_lifecycle_properties():
    r = ServeRequest(rid=0, prompt=[1, 2], max_new=3)
    assert r.ttft_s is None and r.queue_wait_s is None \
        and r.service_s is None
    r.submitted_s, r.admitted_s = 1.0, 1.5
    r.first_token_s, r.finished_s = 2.0, 4.0
    assert (r.ttft_s, r.queue_wait_s, r.service_s) == (1.0, 0.5, 2.5)


# --------------------------------------------------------------------------
# split cost model
# --------------------------------------------------------------------------

def test_cold_cache_error_is_typed(tmp_path):
    _, cache = _caches(tmp_path)
    with pytest.raises(ColdCacheError) as ei:
        cost_model_from_cache(cache)
    assert isinstance(ei.value, ValueError)
    assert set(ei.value.kernels) == {PREFILL_STEP_KERNEL, DECODE_STEP_KERNEL}
    record_prefill_time(cache, 4, 4, 1e-3)
    record_decode_time(cache, 8, 1e-4)
    with pytest.raises(ColdCacheError):
        split_cost_model_from_cache(cache)
    with pytest.raises(ColdCacheError):      # one row is not a fit
        fit_cost_entries(cache, model_factory=LinearModel, save=False)


@pytest.mark.parametrize("noise", [0.0, 0.2], ids=["exact", "noisy"])
def test_split_model_equals_jax(tmp_path, noise):
    jcache = JTuningCache(root=str(tmp_path / "j"),
                          fingerprint=JFingerprint(*SIM))
    cache = TuningCache(root=str(tmp_path / "p"),
                        fingerprint=Fingerprint(*SIM))
    _fill(jpolicy, jcache, noise, seed=7)
    _fill(policy, cache, noise, seed=7)
    jm = jpolicy.fit_cost_entries(jcache, model_factory=JLinearModel,
                                  save=False)
    m = fit_cost_entries(cache, model_factory=LinearModel, save=False)
    np.testing.assert_allclose(_preds(m), _preds(jm), rtol=REL)
    assert m.fit_band_pct == pytest.approx(jm.fit_band_pct, rel=REL)
    assert m(2, 4) == m.request_seconds(2, 4)
    assert [r.rid for r in sjf_order(_requests(jrequest), m)] == \
        [r.rid for r in jpolicy.sjf_order(_requests(jrequest), jm)]
    # prefill superlinear in prompt, decode linear in context, short
    # requests first
    assert m.prefill_seconds(2) < m.prefill_seconds(8) \
        < m.prefill_seconds(32)
    assert m.decode_seconds_per_token(4) < m.decode_seconds_per_token(32)
    assert m.request_seconds(2, 4) < m.request_seconds(8, 8) \
        < m.request_seconds(24, 16)


def test_split_fits_have_distinct_mape_bands(tmp_path):
    _, cache = _caches(tmp_path)
    _fill(policy, cache, noise=0.2, seed=7)
    fit_cost_entries(cache, model_factory=LinearModel, save=False)
    prefill = cache.entry(PREFILL_STEP_KERNEL)
    decode = cache.entry(DECODE_STEP_KERNEL)
    assert prefill.fit_mape != decode.fit_mape
    assert split_cost_model_from_cache(cache).fit_band_pct == \
        max(prefill.fit_mape, decode.fit_mape)


@pytest.mark.parametrize("shape", [(2, 4), (24, 16), (1, 1), (7, 0)],
                         ids=str)
def test_request_split_equals_jax(shape):
    p, n = shape
    assert policy.split_request_seconds(p, n, 0.37) == \
        jpolicy.split_request_seconds(p, n, 0.37)
    assert policy.prefill_features(p, 3 * p) == \
        jpolicy.prefill_features(p, 3 * p)
    assert policy.decode_features(p + n) == jpolicy.decode_features(p + n)


def test_fifo_order_is_arrival_order():
    reqs = _requests(jrequest)
    assert fifo_order(reqs) == reqs and fifo_order(reqs) is not reqs


# --------------------------------------------------------------------------
# whole-request row migration
# --------------------------------------------------------------------------

def _old_layout(cache):
    old = cache.entry(DECODE_STEP_KERNEL, feature_names=["prompt", "new"],
                      variant_names=["engine"])
    true_s = {}
    for p, n in SHAPES[:6]:
        t = 2e-5 * (p + n) ** 2
        true_s[(p, n)] = t
        old.add_rows(np.asarray([[float(p), float(n), float((p + n) ** 2)]]),
                     [t], bucket=(("new", n), ("prompt", p)))
    cache.save()
    return true_s


def test_whole_request_row_migration_roundtrip(tmp_path):
    _, cache = _caches(tmp_path)
    true_s = _old_layout(cache)
    _, fresh = _caches(tmp_path)
    assert migrate_whole_request_rows(fresh) == len(true_s)
    assert migrate_whole_request_rows(fresh) == 0
    assert fresh.entry(DECODE_STEP_KERNEL).feature_names == ["ctx"]
    m = fit_cost_entries(fresh, model_factory=LinearModel)
    for (p, n), t in true_s.items():
        assert abs(m.request_seconds(p, n) - t) / t < 0.5, (p, n)
    assert m.request_seconds(2, 4) < m.request_seconds(4, 4) \
        < m.request_seconds(16, 8) < m.request_seconds(24, 16)


def test_migration_equals_jax(tmp_path):
    """An old-layout cache the JAX package wrote migrates in the port to
    the rows the JAX package's migration gives."""
    jcache, _ = _caches(tmp_path / "j")
    _old_layout(jcache)
    jref, _ = _caches(tmp_path / "j")
    assert jpolicy.migrate_whole_request_rows(jref) == 6
    _, port = _caches(tmp_path / "p")
    _old_layout(port)
    _, port = _caches(tmp_path / "p")
    assert migrate_whole_request_rows(port) == 6
    for kernel in (PREFILL_STEP_KERNEL, DECODE_STEP_KERNEL):
        np.testing.assert_array_equal(port.entry(kernel).X,
                                      jref.entry(kernel).X)
        np.testing.assert_array_equal(port.entry(kernel).y,
                                      jref.entry(kernel).y)


def test_record_request_time_equals_jax(tmp_path):
    jcache, cache = (JTuningCache(root=str(tmp_path / "j"),
                                  fingerprint=JFingerprint(*SIM)),
                     TuningCache(root=str(tmp_path / "p"),
                                 fingerprint=Fingerprint(*SIM)))
    for p, n in SHAPES:
        jpolicy.record_request_time(jcache, p, n, 1e-3 * (p + n))
        record_request_time(cache, p, n, 1e-3 * (p + n))
    for kernel in (PREFILL_STEP_KERNEL, DECODE_STEP_KERNEL):
        np.testing.assert_array_equal(cache.entry(kernel).X,
                                      jcache.entry(kernel).X)
        np.testing.assert_array_equal(cache.entry(kernel).y,
                                      jcache.entry(kernel).y)


# --------------------------------------------------------------------------
# tuning caches across the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fitted_cache_loads_in_the_other_package(tmp_path, writer):
    """One package records and fits the serving entries and saves them;
    the other loads them under the same fingerprint and gives the same
    predictions and the same SJF order."""
    jcache, cache = _caches(tmp_path)
    if writer == "jax":
        _fill(jpolicy, jcache, noise=0.1, seed=3)
        written = jpolicy.fit_cost_entries(jcache, model_factory=JLinearModel)
    else:
        _fill(policy, cache, noise=0.1, seed=3)
        written = fit_cost_entries(cache, model_factory=LinearModel)
    jload, load = _caches(tmp_path)
    jm = jpolicy.split_cost_model_from_cache(jload)
    m = split_cost_model_from_cache(load)
    np.testing.assert_allclose(_preds(m), _preds(written), rtol=REL)
    np.testing.assert_allclose(_preds(jm), _preds(written), rtol=REL)
    order = [r.rid for r in sjf_order(_requests(jrequest), m)]
    assert order == [r.rid for r in jpolicy.sjf_order(_requests(jrequest),
                                                       jm)]
    assert order != list(range(len(SHAPES)))       # SJF actually reorders
