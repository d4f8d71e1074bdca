"""repro_torch.serve's ContinuousBatcher, ServeEngine and generate against
the JAX package's on the same weights: reduced yi-9b in fp32 with the JAX
package's ``init_params(PRNGKey(0))`` carried across by
``models.module.from_numpy``, ``max_slots=2``, ``max_seq=64``.  Tokens
equal token for token; each engine step's logits, replayed from the
inputs the port's engine gave its model, within 1e-4 of the largest logit
(the bound of the model parity tests).  Also: the engine against each request
run alone, the in-place recurrent slot reset (against a fresh engine and
the JAX package), ``stream_kv``, the bounded queue, the cold-cache FIFO
fallback, SJF admission, the telemetry contract, and temperature
sampling (seeded determinism and a chi-square test of the draws)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.runtime import TuningCache as JTuningCache
from repro.serve import ContinuousBatcher as JContinuousBatcher
from repro.serve import ServeEngine as JServeEngine
from repro.serve import decode as jdecode
from repro.serve import request as jrequest
from repro_torch import configs
from repro_torch.core.nnc import LinearModel
from repro_torch.models import build_model, module
from repro_torch.obs.telemetry import Telemetry
from repro_torch.runtime import TuningCache, current_fingerprint
from repro_torch.serve import request as prequest
from repro_torch.serve import (ContinuousBatcher, ServeEngine, bursty_trace,
                               fit_cost_entries, poisson_trace,
                               record_decode_time, record_prefill_time,
                               split_cost_model_from_cache)
from repro_torch.serve.continuous import _reset_slot
from repro_torch.serve.decode import ServeConfig, generate, sample
from repro_torch.serve.policy import DECODE_STEP_KERNEL, PREFILL_STEP_KERNEL
from repro_torch.serve.request import ServeRequest

REL = 1e-4                  # fp32 logits, relative to the largest logit
SLOTS, MAX_SEQ = 2, 64


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Torch ops on one intra-op thread, the count restored after (several
    test workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name, **overrides):
    """(JAX model, JAX params, port model, the same params as tensors)."""
    overrides.setdefault("compute_dtype", "float32")
    jcfg = dataclasses.replace(jconfigs.ARCHS[name].reduced(), **overrides)
    cfg = dataclasses.replace(configs.ARCHS[name].reduced(), **overrides)
    jm, m = jbuild(jcfg), build_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, m, module.from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


@pytest.fixture(scope="module")
def yi():
    return _pair("yi-9b")


def _cache(root) -> TuningCache:
    return TuningCache(root=str(root), fingerprint=current_fingerprint("cpu"))


def _generated(reqs) -> list:
    return [list(r.generated) for r in reqs]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


class _Recording(ServeEngine):
    """The port's engine, keeping the (tokens, index, start) each step gave
    its model."""

    def _run_model(self, tokens, start):
        self.inputs = getattr(self, "inputs", [])
        self.inputs.append((np.array(tokens), self.index, np.array(start)))
        return super()._run_model(tokens, start)


@pytest.fixture(scope="module")
def engine_runs(yi, tmp_path_factory):
    """The bursty trace through both packages' engines (FIFO) and the
    poisson trace through both packages' plain batchers."""
    jm, jp, m, p = yi
    root = tmp_path_factory.mktemp("engines")
    out = {}
    for name, eng in (("jax", JServeEngine(
            jm, JTuningCache(root=str(root / "j")), params=jp,
            max_slots=SLOTS, max_seq=MAX_SEQ, admission="fifo")),
                      ("port", _Recording(
            m, _cache(root / "p"), params=p, max_slots=SLOTS,
            max_seq=MAX_SEQ, admission="fifo"))):
        reqs = (jrequest if name == "jax" else prequest).bursty_trace(
            2, seed=2, burst_gap=16)
        stats = eng.run_trace(reqs)
        out[name] = (eng, reqs, stats)
    for name, cls, mod, mm, pp in (
            ("jax_batcher", JContinuousBatcher, jrequest, jm, jp),
            ("port_batcher", ContinuousBatcher, prequest, m, p)):
        reqs = mod.poisson_trace(6, seed=2)
        bat = cls(mm, pp, max_slots=SLOTS, max_seq=MAX_SEQ)
        for r in reqs:
            bat.submit(r)
        out[name] = (bat, reqs, bat.run())
    return out


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

def test_batcher_tokens_equal_jax(engine_runs):
    jbat, jreqs, jstats = engine_runs["jax_batcher"]
    bat, reqs, stats = engine_runs["port_batcher"]
    assert _generated(reqs) == _generated(jreqs)
    assert all(r.done and len(r.generated) == r.max_new for r in reqs)
    assert stats == jstats


def test_engine_tokens_and_stats_equal_jax(engine_runs):
    _, jreqs, jstats = engine_runs["jax"]
    _, reqs, stats = engine_runs["port"]
    assert stats["completed"] == len(reqs) == 8
    assert _generated(reqs) == _generated(jreqs)
    assert [r.slot for r in reqs] == [r.slot for r in jreqs]
    for key in ("engine_steps", "occupancy", "completed", "rejected",
                "tokens_generated", "policy", "admission_fallback"):
        assert stats[key] == jstats[key], key


def test_engine_step_logits_equal_jax(yi, engine_runs):
    """Replay every step the port's engine took, from its recorded model
    inputs, through both packages' decode_step over fresh caches: the
    logits agree within REL at every step and their argmax is the token
    batch the engine used."""
    jm, jp, m, p = yi
    eng, reqs, _ = engine_runs["port"]
    jstep = jax.jit(lambda c, t, i, s: jm.decode_step(jp, c, t, i, start=s))
    jcache = jm.init_cache(SLOTS, MAX_SEQ)
    cache = m.init_cache(SLOTS, MAX_SEQ, device="cpu")
    assert len(eng.inputs) == eng.steps
    worst = 0.0
    with torch.inference_mode():
        for tokens, index, start in eng.inputs:
            jl, jcache = jstep(jcache, jnp.asarray(tokens), jnp.int32(index),
                               jnp.asarray(start))
            lg, cache = m.decode_step(p, cache, torch.from_numpy(tokens),
                                      index, start=torch.from_numpy(start))
            worst = max(worst, _rel(lg.numpy(), jl))
            np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                          np.asarray(jnp.argmax(jl, -1)))
    assert worst <= REL, worst


def test_generate_equals_jax(yi):
    jm, jp, m, p = yi
    rng = np.random.RandomState(4)
    prompt = rng.randint(1, 256, (2, 12)).astype(np.int32)
    want = jdecode.generate(jm, jp, jnp.asarray(prompt), 6, 18)
    got = generate(m, p, torch.from_numpy(prompt), 6, 18)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, 18)
    with torch.inference_mode():
        lg, _ = m.prefill(p, {"tokens": torch.from_numpy(prompt)}, 18)
    assert _rel(lg.numpy(), jl) <= REL


def _dirty_then_fresh(mod, model, params, batcher):
    """(second tenant of a dirtied slot, the same request alone)."""
    eng = batcher(model, params, max_slots=1, max_seq=MAX_SEQ)
    first = mod.ServeRequest(rid=0, prompt=[9] * 6, max_new=6)
    eng.submit(first)
    eng.run()
    second = mod.ServeRequest(rid=1, prompt=[7, 3, 11, 5], max_new=5)
    eng.submit(second)
    eng.run()
    fresh = batcher(model, params, max_slots=1, max_seq=MAX_SEQ)
    alone = mod.ServeRequest(rid=2, prompt=[7, 3, 11, 5], max_new=5)
    fresh.submit(alone)
    fresh.run()
    return first, second, alone


def test_recurrent_slot_reset_matches_fresh_engine_and_jax():
    """xLSTM: a re-admitted slot behaves like a fresh engine (its mlstm and
    slstm state zeroed in place on admission), token for token with the
    JAX package."""
    jm, jp, m, p = _pair("xlstm-1.3b", layer_pattern=("mlstm", "slstm"),
                         n_layers=2)
    f, second, alone = _dirty_then_fresh(prequest, m, p, ContinuousBatcher)
    jf, jsecond, jalone = _dirty_then_fresh(jrequest, jm, jp,
                                            JContinuousBatcher)
    assert second.generated == alone.generated
    assert f.generated == jf.generated
    assert second.generated == jsecond.generated == jalone.generated


@pytest.mark.parametrize("name,over", [
    ("hymba-1.5b", {}),
    ("xlstm-1.3b", {"layer_pattern": ("mlstm", "slstm"), "n_layers": 3})],
    ids=["hybrid-scan", "xlstm-scan-tail"])
def test_reset_slot_zeroes_one_slots_recurrent_leaves(name, over):
    cfg = dataclasses.replace(configs.ARCHS[name].reduced(), **over)
    cache = build_model(cfg).init_cache(3, 16, device="cpu")
    for leaf in module.leaves(cache):
        leaf.fill_(1)
    assert _reset_slot(cache, 1) is cache
    seen = set()

    def walk(tree, axis, path=""):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, axis, f"{path}/{key}")
                continue
            seen.add((axis, key in ("k", "v")))
            rows = [leaf.select(axis, s) for s in range(3)]
            if key in ("k", "v"):
                assert all(bool((r == 1).all()) for r in rows), path
            else:
                assert bool((rows[1] == 0).all()), path + key
                assert bool((rows[0] == 1).all()) \
                    and bool((rows[2] == 1).all()), path + key
    for sub in cache.get("scan", {}).values():
        walk(sub, 1)
    for sub in cache["tail"].values():
        walk(sub, 0)
    assert (1, False) in seen
    if name == "hymba-1.5b":
        assert (1, True) in seen
    else:
        assert (0, False) in seen


# --------------------------------------------------------------------------
# the port's engine on its own
# --------------------------------------------------------------------------

def _synthetic_fitted_cache(root) -> TuningCache:
    cache = _cache(root)
    for n in (2, 4, 8, 16, 32):
        record_prefill_time(cache, n, n, 1e-4 * n * n)
    for ctx in (4, 8, 16, 32, 64):
        record_decode_time(cache, ctx, 1e-5 * ctx)
    fit_cost_entries(cache, model_factory=LinearModel, save=False)
    return cache


def test_engine_matches_each_request_alone(yi, tmp_path):
    _, _, m, p = yi

    def mk():
        rng = np.random.RandomState(0)
        return [ServeRequest(
            rid=i, prompt=[int(t) for t in rng.randint(1, 256, size=n)],
            max_new=4) for i, n in enumerate([4, 7, 3, 5])]

    reqs = mk()
    eng = ServeEngine(m, _cache(tmp_path), params=p, max_slots=SLOTS,
                      max_seq=MAX_SEQ, admission="fifo")
    assert eng.run_trace(reqs)["completed"] == len(reqs)
    for ref_req, got in zip(mk(), reqs):
        solo = ContinuousBatcher(m, p, max_slots=1, max_seq=MAX_SEQ)
        solo.submit(ref_req)
        solo.run()
        assert got.generated == ref_req.generated, got.rid


@pytest.mark.parametrize("executor", ["sequential", "async"])
def test_stream_kv_matches_dense(yi, tmp_path, executor):
    _, _, m, p = yi
    outs = []
    for stream_kv in (False, True):
        reqs = poisson_trace(4, seed=6)
        eng = ServeEngine(m, _cache(tmp_path), params=p, max_slots=SLOTS,
                          max_seq=MAX_SEQ, admission="fifo",
                          stream_kv=stream_kv, executor=executor)
        eng.run_trace(reqs)
        outs.append(_generated(reqs))
    assert outs[0] == outs[1]


def test_bounded_queue_rejects_overflow(yi, tmp_path):
    _, _, m, p = yi
    tel = Telemetry()
    eng = ServeEngine(m, _cache(tmp_path), params=p, max_slots=1,
                      max_seq=MAX_SEQ, max_queue=2, admission="fifo",
                      telemetry=tel)
    reqs = [ServeRequest(rid=i, prompt=[1] * 2, max_new=2) for i in range(4)]
    assert [eng.submit(r) for r in reqs] == [True, True, False, False]
    assert [r.rejected for r in reqs] == [False, False, True, True]
    assert tel.counters()["serve.requests_rejected"] == 2
    while eng.step():
        pass
    assert eng.stats()["completed"] == 2 and eng.stats()["rejected"] == 2


def test_cold_cache_falls_back_to_fifo_and_still_serves(yi, tmp_path):
    _, _, m, p = yi
    tel = Telemetry()
    eng = ServeEngine(m, _cache(tmp_path), params=p, max_slots=SLOTS,
                      max_seq=MAX_SEQ, admission="sjf", telemetry=tel)
    assert (eng.requested_policy, eng.policy_name) == ("sjf", "fifo")
    assert tel.counters()["serve.admission_fallback"] == 1
    reqs = [ServeRequest(rid=i, prompt=[1 + i] * 3, max_new=3)
            for i in range(3)]
    stats = eng.run_trace(reqs)
    assert stats["completed"] == 3 and stats["admission_fallback"]
    admits = tel.events(cat="admission")
    assert [e["args"]["rid"] for e in admits] == [0, 1, 2]
    assert all(e["args"]["policy"] == "fifo" for e in admits)


def test_sjf_admission_and_reload_order(yi, tmp_path):
    _, _, m, p = yi
    _synthetic_fitted_cache(tmp_path / "tc").save()

    def admitted_first():
        eng = ServeEngine(m, _cache(tmp_path / "tc"), params=p, max_slots=1,
                          max_seq=MAX_SEQ, admission="sjf",
                          record_rows=False)
        assert eng.policy_name == "sjf"
        for rid, n in enumerate((10, 2, 5)):
            eng.submit(ServeRequest(rid=rid, prompt=[1] * n, max_new=3))
        eng.step()
        assert eng.slots[0].predicted_s < eng.queue[-1].predicted_s
        return eng.slots[0].rid, [r.rid for r in eng.queue]

    assert admitted_first() == admitted_first() == (1, [2, 0])


def test_batch_assembly_invariants(yi, tmp_path):
    _, _, m, p = yi
    eng = ServeEngine(m, _cache(tmp_path), params=p, max_slots=SLOTS,
                      max_seq=96, admission="fifo")
    reqs = poisson_trace(6, seed=2)
    for r in reqs:
        r.arrival_step = 0
        eng.submit(r)
    seen = set()
    while eng.step():
        assert sum(s is not None for s in eng.slots) <= eng.max_slots
        assert all(eng.prompt_left >= 0)
        for i, s in enumerate(eng.slots):
            if s is not None:
                assert eng.start[i] <= eng.index
                seen.add(i)
    assert all(r.done and len(r.generated) == r.max_new for r in reqs)
    assert seen == {0, 1}


def test_telemetry_contract(yi, tmp_path):
    """TTFT/per-token histograms, queue-depth gauge, goodput, admission
    instants, residuals and the compiled serve_step's kernel histogram all
    land in the one attached Telemetry."""
    _, _, m, p = yi
    cache = _synthetic_fitted_cache(tmp_path / "tc")
    tel = Telemetry()
    eng = ServeEngine(m, cache, params=p, max_slots=SLOTS, max_seq=96,
                      admission="sjf", telemetry=tel, record_rows=False)
    reqs = [ServeRequest(rid=i, prompt=[1 + i] * (2 + i), max_new=3 + i)
            for i in range(4)]
    stats = eng.run_trace(reqs)
    assert stats["completed"] == 4
    tokens = stats["tokens_generated"]
    s = tel.summary()["histograms"]
    assert s["serve.ttft_s"]["count"] == 4
    assert s["serve.token_latency_s"]["count"] == tokens - 4
    c = tel.counters()
    assert c["serve.requests_completed"] == 4
    assert c["serve.tokens_generated"] == tokens
    assert s["kernel.serve_step.s"]["count"] == stats["engine_steps"]
    assert c["dispatch.predicted"] == stats["engine_steps"]
    assert c.get("dispatch.measured", 0) == 0
    assert "program.wall_s" in s
    admits = tel.events(cat="admission")
    assert len(admits) == 4 and all(
        e["args"]["policy"] == "sjf" and e["args"]["predicted_s"] > 0
        for e in admits)
    assert len(tel.events(cat="serve.step")) == stats["engine_steps"]
    assert tel.series("serve.queue_depth")
    assert tel.series("serve.goodput_tok_s")[-1][1] > 0
    drift = tel.to_json()["drift"]["kernels"]["serve.request"]
    assert drift["n"] == 4
    assert drift["fit_band_pct"] == \
        split_cost_model_from_cache(cache).fit_band_pct
    kv = module.leaves(eng.cache)
    assert tel.series("serve.kv_cache_bytes")[-1][1] == \
        sum(x.numel() * x.element_size() for x in kv)


def test_completed_requests_record_split_rows(yi, tmp_path):
    _, _, m, p = yi
    cache = _cache(tmp_path)
    eng = ServeEngine(m, cache, params=p, max_slots=SLOTS, max_seq=96,
                      admission="fifo")
    eng.run_trace([ServeRequest(rid=i, prompt=[1 + i] * 3, max_new=4)
                   for i in range(5)])
    prefill = cache.entry(PREFILL_STEP_KERNEL)
    decode = cache.entry(DECODE_STEP_KERNEL)
    assert prefill.n_rows == decode.n_rows == 5
    assert np.all(prefill.y > 0) and np.all(decode.y > 0)
    assert fit_cost_entries(cache, model_factory=LinearModel,
                            save=False).request_seconds(2, 2) > 0


def test_engine_device(yi, tmp_path, monkeypatch):
    """Without params the engine makes them on ``device``: the card by
    default (raising without one), the host only when asked for."""
    _, _, m, _ = yi
    with monkeypatch.context() as patch:
        patch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(m, _cache(tmp_path))
    eng = ServeEngine(m, _cache(tmp_path), device="cpu", max_slots=1,
                      max_seq=16)
    want = m.init_params(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(module.leaves(eng.params), module.leaves(want)):
        assert torch.equal(a, b)
    assert eng.device == torch.device("cpu")
    assert all(x.device.type == "cpu" for x in module.leaves(eng.cache))


def test_bursty_trace_completes_under_sjf(yi, tmp_path):
    _, _, m, p = yi
    cache = _synthetic_fitted_cache(tmp_path)
    reqs = bursty_trace(2, seed=2, burst_gap=16)
    stats = ServeEngine(m, cache, params=p, max_slots=SLOTS,
                        max_seq=MAX_SEQ, admission="sjf",
                        record_rows=False).run_trace(reqs)
    assert stats["completed"] == len(reqs) and stats["policy"] == "sjf"


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def test_sample_greedy_without_temperature_or_generator():
    logits = torch.randn(3, 1, 11, generator=torch.Generator().manual_seed(0))
    want = logits.argmax(-1).to(torch.int32)
    assert torch.equal(sample(logits, None, 0.7), want)
    assert torch.equal(sample(logits, torch.Generator(), 0.0), want)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jdecode.sample(jnp.asarray(logits.numpy()),
                                                None, 0.0)))


def test_temperature_sampling_is_seeded():
    logits = torch.randn(4, 1, 32, generator=torch.Generator().manual_seed(1))

    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([sample(logits, g, 0.8) for _ in range(16)])

    assert torch.equal(draws(3), draws(3))
    assert not torch.equal(draws(3), draws(4))
    assert draws(3).dtype == torch.int32 and draws(3).shape[1:] == (4, 1)


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_temperature_draws_follow_softmax(temperature):
    """Chi-square of 40000 draws against softmax(logits / T): below the
    0.1% critical value for 7 degrees of freedom (24.32)."""
    n = 40000
    logits = torch.tensor([1.0, 0.5, -0.3, 2.0, 0.0, -1.0, 1.5, 0.2])
    rows = logits.expand(n, 1, 8)
    got = sample(rows, torch.Generator().manual_seed(11), temperature)
    counts = np.bincount(got.reshape(-1).numpy(), minlength=8)
    expected = n * torch.softmax(logits / temperature, -1).double().numpy()
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, (chi2, counts, expected)


def test_generate_with_temperature(yi):
    _, _, m, p = yi
    prompt = torch.randint(1, 256, (2, 8),
                           generator=torch.Generator().manual_seed(5))
    hot = ServeConfig(temperature=1.0)
    greedy = generate(m, p, prompt, 4, 12)
    # generate's loop is greedy, as the reference's: make_serve_step
    # samples without a generator
    assert torch.equal(generate(m, p, prompt, 4, 12, hot), greedy)
