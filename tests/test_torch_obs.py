"""The port's obs core (``repro_torch.obs``) against the JAX package's
(``repro.obs``): telemetry documents and drift, the dispatcher's,
refiner's, comm model's and executor's instrumentation, the memory ledger,
makespan attribution (``explain``) and the telemetry merge into Chrome
traces.

Both packages see the same inputs — seeded numpy arrays, one toy cache
the JAX package wrote, the same call sequences under one counting clock —
and their documents are compared.  Tolerances: documents built from the
same numbers are compared for equality; analyses of one saved trace agree
to 1e-12 in every float; the ledger's sequential peak equals its
prediction exactly, the async peak within 1.25x both ways (the reference's
``tests/test_memory.py`` bound); explain's buckets sum to the makespan
within 1% (``tests/test_explain.py``).  The JAX side of the workload
memory checks only compiles (its Pallas conv2d/maxpool/blur kernels cannot
run on this jax), so those checks compare plans and predicted peaks.
"""
import dataclasses
import json
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi              # before repro.workloads (import cycle)
import repro.obs as jobs
from repro.core import nnc as jnnc
from repro.exec import AsyncExecutor as JAsyncExecutor
from repro.exec import CommModel as JCommModel
from repro.exec import ExecTask as JExecTask
from repro.exec import ExecutionTrace as JExecutionTrace
from repro.exec import StealPolicy as JStealPolicy
from repro.runtime import Dispatcher as JDispatcher
from repro.runtime import DispatchPolicy as JDispatchPolicy
from repro.runtime import Fingerprint as JFingerprint
from repro.runtime import TuningCache as JTuningCache
from repro.runtime import default_registry as jdefault_registry
from repro.runtime import registry as jregistry_mod
from repro.runtime import seed_from_programs as jseed
from repro.runtime.online import OnlineConfig as JOnlineConfig
from repro.runtime.online import OnlineRefiner as JOnlineRefiner
from repro.runtime.simdev import SimLink as JSimLink
from repro.runtime.simdev import fake_matmul_device as jfake_device
from repro.workloads import get_workload as jget_workload
from repro.workloads import suite_registry as jsuite_registry
import repro_torch.obs as obs
from repro_torch.api import Program, compile_program, ops, trace
from repro_torch.core import nnc
from repro_torch.exec import (AsyncExecutor, CommModel, ExecTask,
                              ExecutionTrace, StealPolicy)
from repro_torch.runtime import (Dispatcher, DispatchPolicy, Fingerprint,
                                 TuningCache, default_registry,
                                 seed_from_programs, shape_bucket)
from repro_torch.runtime import registry as registry_mod
from repro_torch.runtime.online import OnlineConfig, OnlineRefiner
from repro_torch.runtime.simdev import (SimLink, SkewedSimDispatcher,
                                        fake_matmul_device, true_time_at)
from repro_torch.workloads import get_workload, suite_registry

SIM = ("sim", "obs", 1, 1, ("float32",))
COMM_FP = ("sim", "obs-comm", 1, 1, ("float32",))
WORKLOADS = ["mlp_block", "decode_microbatch", "image_pipeline", "mixed_dag",
             "attention_block"]
PROGRAMS = WORKLOADS + ["diamond"]
BOUND = 1.25     # async peak within 1.25x of predicted (tests/test_memory.py)
N = 160          # diamond matmuls: ~8 ms a node on the 1e9 F/s sim device
FLOAT_TOL = 1e-12


def counting_clock(start=0.0, step=1.0):
    """A deterministic clock: each read advances by ``step``."""
    state = {"t": start - step}

    def clock():
        state["t"] += step
        return state["t"]
    return clock


def assert_docs_close(got, want, tol=FLOAT_TOL, path="$"):
    """Recursive equality, floats to ``tol`` (relative, absolute near 0)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_docs_close(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_docs_close(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        assert abs(got - want) <= tol * max(1.0, abs(want)), (path, got, want)
    else:
        assert got == want, (path, got, want)


def _fields(plan) -> dict:
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


# --------------------------------------------------------------------------
# Telemetry and drift
# --------------------------------------------------------------------------

def _drive(tel):
    """One call sequence touching every Telemetry primitive."""
    tel.count("dispatch.predicted")
    tel.count("dispatch.predicted", 2)
    tel.count("exec.steals")
    tel.gauge("exec.queue_depth.d0", 3)
    tel.gauge("exec.queue_depth.d0", 1, t=7.5)
    for v in (4e-6, 1e-6, 3e-6, 2e-6):
        tel.observe("dispatch.overhead_s", v)
    tel.observe("kernel.toy.s", 2e-3)
    tel.instant("gate:toy", cat="gate", kernel="toy", reason="near_tie",
                spread_pct=0.5, band_pct=1.25, bucket=[["m", 32768]])
    with tel.span("compile", cat="span", nodes=3):
        tel.count("inside.span")
    tel.event("serve.step", 1.0, 2.5, cat="serve.step", requests=[])
    for pred, act in ((1.0, 1.1), (1.0, 1.5), (2.0, 1.0)):
        tel.residual("toy", pred, act, fit_band_pct=4.0)
    tel.residual("other", 1.0, 3.0)


def test_telemetry_documents_equal_under_one_counting_clock():
    jtel = jobs.Telemetry(run_id="parity", clock=counting_clock(10.0),
                          drift=jobs.DriftConfig(min_obs=2))
    tel = obs.Telemetry(run_id="parity", clock=counting_clock(10.0),
                        drift=obs.DriftConfig(min_obs=2))
    _drive(jtel)
    _drive(tel)
    assert tel.to_json() == jtel.to_json()
    assert json.dumps(tel.to_json()) == json.dumps(jtel.to_json())
    assert tel.summary() == jtel.summary()
    assert tel.series_names() == jtel.series_names()
    assert tel.events("gate") == jtel.events("gate")
    assert obs.OBS_SCHEMA_VERSION == jobs.OBS_SCHEMA_VERSION == 1
    assert (obs.telemetry.MAX_HIST_SAMPLES, obs.telemetry.MAX_SERIES_POINTS,
            obs.telemetry.MAX_EVENTS) == (
        jobs.telemetry.MAX_HIST_SAMPLES, jobs.telemetry.MAX_SERIES_POINTS,
        jobs.telemetry.MAX_EVENTS)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_telemetry_loads_and_summarizes_alike(tmp_path, writer):
    pkgs = {"jax": jobs, "port": obs}
    w = pkgs[writer].Telemetry(run_id=writer, clock=counting_clock())
    _drive(w)
    path = str(tmp_path / "tel.json")
    w.save(path)
    other = pkgs["port" if writer == "jax" else "jax"]
    doc = other.Telemetry.load(path)
    assert doc == json.loads(json.dumps(w.to_json()))
    assert other.summarize_doc(doc) == pkgs[writer].summarize_doc(doc) \
        == w.summary()
    (tmp_path / "bad.json").write_text('{"obs_schema": 2}')
    with pytest.raises(ValueError, match="not a telemetry file"):
        other.Telemetry.load(str(tmp_path / "bad.json"))


def test_drift_monitor_flags_and_json_match_jax():
    rng = np.random.RandomState(0)
    cfg = dict(window=8, factor=2.0, min_obs=4, default_band_pct=25.0)
    jmon = jobs.DriftMonitor(jobs.DriftConfig(**cfg))
    mon = obs.DriftMonitor(obs.DriftConfig(**cfg))
    kernels = ("good", "bad", "unbanded")
    for i in range(12):
        k = kernels[i % 3]
        pred = float(rng.uniform(0.5, 2.0))
        act = pred * (3.0 if k == "bad" else float(rng.uniform(0.97, 1.03)))
        band = None if k == "unbanded" or i == 7 else 5.0
        assert mon.observe(k, pred, act, band) \
            == jmon.observe(k, pred, act, band)
    assert mon.flags() == jmon.flags() == ["bad"]
    assert mon.status() == jmon.status()
    assert mon.to_json() == jmon.to_json()
    # each package reads the other's document back to the same status
    assert obs.DriftMonitor.from_json(jmon.to_json()).status() \
        == jobs.DriftMonitor.from_json(mon.to_json()).status() == mon.status()
    assert mon.live_mape("never") != mon.live_mape("never")     # NaN


def test_null_telemetry_is_inert_and_documents_alike():
    null = obs.NULL_TELEMETRY
    null.count("x")
    null.gauge("g", 1.0)
    null.observe("h", 1.0)
    null.instant("i")
    null.event("e", 0.0, 1.0)
    null.residual("k", 1.0, 2.0)
    with null.span("s"):
        pass
    assert null.counters() == {} and null.events() == []
    assert null.series("g") == [] and null.series_names() == []
    assert not obs.NullTelemetry.enabled and obs.Telemetry.enabled
    assert null.to_json() == jobs.NULL_TELEMETRY.to_json()
    assert obs.summarize_doc(null.to_json()) \
        == jobs.summarize_doc(jobs.NULL_TELEMETRY.to_json())
    assert obs.as_telemetry(None) is null
    tel = obs.Telemetry()
    assert obs.as_telemetry(tel) is tel


def test_telemetry_concurrent_writers_lose_nothing(tmp_path):
    tel = obs.Telemetry(run_id="stress", drift=obs.DriftConfig(min_obs=1))
    n_threads, n_iter = 8, 200
    errors = []

    def hammer(i):
        try:
            for j in range(n_iter):
                tel.count("shared.counter")
                tel.count(f"per.thread.{i}", 2)
                tel.gauge(f"gauge.{i}", float(j))
                tel.observe("hist.s", 1e-3 * (j + 1))
                tel.residual("stress", 1.0, 1.1, fit_band_pct=50.0)
                tel.instant(f"tick:{i}", cat="tick")
                if j % 50 == 0:
                    tel.to_json()
                    tel.save(str(tmp_path / f"snap_{i}.json"))
        except BaseException as e:          # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    c = tel.counters()
    assert c["shared.counter"] == n_threads * n_iter
    for i in range(n_threads):
        assert c[f"per.thread.{i}"] == 2 * n_iter
        assert len(tel.series(f"gauge.{i}")) == n_iter
    doc = tel.to_json()
    assert doc["histograms"]["hist.s"]["count"] == n_threads * n_iter
    assert len(tel.events("tick")) == n_threads * n_iter
    assert obs.summarize_doc(doc)["drift"]["stress"]["n"] \
        == n_threads * n_iter
    tel.save(str(tmp_path / "final.json"))
    assert jobs.Telemetry.load(str(tmp_path / "final.json"))["counters"] \
        == json.loads(json.dumps(c))


# --------------------------------------------------------------------------
# dispatch: counters, gate instants, residuals
# --------------------------------------------------------------------------

def _toy_registry_of(mod, sleep_s=0.0):
    """The two-variant toy kernel in either package's registry types; its
    calls multiply by one (jax and torch arrays both pass), after an
    optional sleep."""
    def abstract_params(a):
        return {"m": int(a.shape[0])}

    def call(args, p):
        if sleep_s:
            time.sleep(sleep_s)
        return args[0] * 1.0

    variants = tuple(
        mod.Variant("toy", name, call, lambda p, _i=float(i): [p["m"], _i],
                    lambda p: float(p["m"]))
        for i, name in enumerate(("v0", "v1")))
    reg = mod.KernelRegistry()
    reg.register(mod.RegisteredKernel("toy", abstract_params,
                                      ("m", "variant"), variants))
    return reg


def _toy_caches(root, slowdown):
    """A toy cache the JAX package wrote (five shape buckets, v1 at
    ``slowdown`` x v0, a closed-form model), and a copy for the port."""
    cache = JTuningCache(str(root / "jax"), JFingerprint(*SIM))
    reg = _toy_registry_of(jregistry_mod)
    entry = cache.entry("toy", feature_names=["m", "variant"],
                        variant_names=["v0", "v1"])
    for m in (32, 128, 512, 2048, 4096):
        entry.add_rows(reg.feature_rows("toy", {"m": m}),
                       [m / 1e6, slowdown * m / 1e6], shape_bucket({"m": m}))
    entry.fit(model=jnnc.LinearModel())
    cache.save()
    shutil.copytree(root / "jax", root / "port")


def _toy_pair(root, slowdown, sleep_s=0.0, **policy):
    """(JAX dispatcher, port dispatcher) over copies of one toy cache, each
    with its package's Telemetry under its own counting clock."""
    _toy_caches(root, slowdown)
    kw = {"min_window": 1e-4, **policy}
    jtel = jobs.Telemetry(clock=counting_clock())
    tel = obs.Telemetry(clock=counting_clock())
    jd = JDispatcher(registry=_toy_registry_of(jregistry_mod, sleep_s),
                     cache=JTuningCache(str(root / "jax"),
                                        JFingerprint(*SIM)),
                     policy=JDispatchPolicy(**kw), telemetry=jtel)
    td = Dispatcher(registry=_toy_registry_of(registry_mod, sleep_s),
                    cache=TuningCache(str(root / "port"), Fingerprint(*SIM)),
                    policy=DispatchPolicy(**kw), telemetry=tel)
    return (jd, jtel), (td, tel)


# seen shapes, a memo hit, an unseen near-tie shape class (gated), its memo
TOY_SEQUENCE = (32, 32, 512, 32768, 32768, 128, 128)


@pytest.mark.parametrize("online", [False, True])
def test_dispatch_counters_and_gate_instants_match_jax(tmp_path, online):
    (jd, jtel), (td, tel) = _toy_pair(tmp_path, 1.01, online=online,
                                      refit_every=1000)
    for m in TOY_SEQUENCE:
        jd.dispatch("toy", jnp.ones(m, jnp.float32))
        td.dispatch("toy", torch.ones(m))
    assert tel.counters() == jtel.counters()
    c = tel.counters()
    assert c["dispatch.predicted"] == 6 and c["dispatch.gated"] == 1
    assert c["dispatch.memo_hit"] == 3 and c["gate.reject"] == 1
    assert c["dispatch.by_kernel.toy.gated"] == 1
    gate, = tel.events("gate")
    jgate, = jtel.events("gate")
    assert gate["name"] == jgate["name"] == "gate:toy"
    args, jargs = dict(gate["args"]), dict(jgate["args"])
    if online:                      # the band is the live (timed) MAPE
        assert args.pop("band_pct") > 0 and jargs.pop("band_pct") > 0
    assert_docs_close(args, jargs)
    assert args["bucket"] == list(shape_bucket({"m": 32768}))
    # residuals from the same executions (memo hits and the gated one)
    want, got = jtel.summary(), tel.summary()
    assert got["drift"]["toy"]["n"] == want["drift"]["toy"]["n"] == 4
    assert {k: v["count"] for k, v in got["histograms"].items()} \
        == {k: v["count"] for k, v in want["histograms"].items()}
    assert got["decisions"] == want["decisions"]


def test_dispatch_records_modes_memo_hits_and_residuals(tmp_path):
    (jd, jtel), (td, tel) = _toy_pair(tmp_path, 10.0)
    for d, a in ((jd, jnp.ones((128,), jnp.float32)), (td, torch.ones(128))):
        d.dispatch("toy", a)                 # warm predicted
        d.dispatch("toy", a)                 # memo hit: clean wall time
    for t in (jtel, tel):
        c = t.counters()
        assert c["dispatch.predicted"] == 2 and c["dispatch.memo_hit"] == 1
        s = t.summary()
        assert s["histograms"]["dispatch.overhead_s"]["count"] == 2
        assert s["histograms"]["kernel.toy.s"]["count"] == 2
        assert s["drift"]["toy"]["n"] == 1   # the memo hit only
    assert tel.counters() == jtel.counters()


def test_gate_outcomes_are_counted_and_explained(tmp_path):
    (jnear, jtel), (near, tel) = _toy_pair(tmp_path / "near", 1.0)
    jnear.dispatch("toy", jnp.ones((32768,), jnp.float32))
    near.dispatch("toy", torch.ones(32768))
    assert tel.counters()["gate.reject"] == 1
    assert tel.counters()["dispatch.gated"] == 1
    ev = tel.events(cat="gate")[0]
    assert ev["args"]["reason"] == "near_tie"
    assert ev["args"]["spread_pct"] <= ev["args"]["band_pct"]
    assert_docs_close(ev["args"], jtel.events(cat="gate")[0]["args"])
    (jclear, jtel2), (clear, tel2) = _toy_pair(tmp_path / "clear", 10.0)
    jclear.dispatch("toy", jnp.ones((32768,), jnp.float32))
    clear.dispatch("toy", torch.ones(32768))
    assert tel2.counters()["gate.accept"] == 1
    assert tel2.counters() == jtel2.counters()
    assert not tel2.events("gate")
    # _gate_eval gives the gate's three numbers, _confident its verdict
    entry = clear._entry("toy")
    pred = entry.predict(clear.registry.feature_rows("toy", {"m": 32768}))
    order = np.argsort(pred)
    got = clear._gate_eval(pred, order, "toy", entry)
    want = jclear._gate_eval(pred, order, "toy", jclear._entry("toy"))
    assert_docs_close(list(got), list(want))
    assert got[0] is True and clear._confident(pred, order, "toy", entry)


def test_steady_state_dispatch_overhead_under_5pct_with_telemetry(tmp_path):
    _, (d, tel) = _toy_pair(tmp_path, 2.0, sleep_s=0.005)
    a = torch.ones(128)
    d.dispatch("toy", a)                     # warm-up: decision memo
    for _ in range(20):
        d.dispatch("toy", a)
    s = tel.summary()
    assert s["decisions"]["dispatch.memo_hit"] == 20
    assert s["overhead"]["dispatch_frac"] < 0.05


def test_telemetry_attaches_post_construction_and_reaches_refiner(tmp_path):
    _, (d, _) = _toy_pair(tmp_path, 10.0)
    late = obs.Telemetry(run_id="late")
    d.telemetry = late
    assert d._telemetry is late and d.refiner is None
    online = Dispatcher(registry=_toy_registry_of(registry_mod),
                        cache=TuningCache(str(tmp_path / "tc2"),
                                          Fingerprint(*SIM)),
                        policy=DispatchPolicy(online=True))
    online.telemetry = late
    assert online.refiner.telemetry is late
    online.telemetry = None
    assert online.refiner.telemetry is None


def test_fixed_seed_sim_runs_summarize_identically(tmp_path):
    """Two fresh port runs and one JAX run of the same seeded program over
    the same simulated devices: the same decisions, event counts, drift
    kernels and histogram names."""
    rng = np.random.RandomState(0)
    arrs = [rng.rand(96, 96).astype(np.float32) for _ in range(3)]

    def one_run(api, pkg, fake, registry, wrap, tag):
        reg = registry(include=["matmul"])
        devs = {n: fake(str(tmp_path / tag), n, s, reg)
                for n, s in (("d0", 1.0e9), ("d1", 0.9e9))}
        a, b, w = (wrap(x) for x in arrs)
        with api.trace(registry=reg) as tb:
            x = api.ops.matmul(a, b)
            y = api.ops.matmul(x, w)
            api.ops.matmul(x, y)
        tel = pkg.Telemetry(run_id="det")
        c = tb.program.compile(devices=devs, bindings=dict(tb.bindings),
                               executor="async", telemetry=tel)
        c()
        getattr(c, "close", lambda: None)()
        return tel.summary()

    port = [one_run(_PortApi, obs, fake_matmul_device, default_registry,
                    torch.from_numpy, f"port{i}") for i in range(2)]
    jax_ = one_run(japi, jobs, jfake_device, jdefault_registry, jnp.asarray,
                   "jax")
    for s in port[1:] + [jax_]:
        assert s["decisions"] == port[0]["decisions"]
        assert s["events"] == port[0]["events"]
        assert sorted(s["drift"]) == sorted(port[0]["drift"])
        assert set(s["histograms"]) == set(port[0]["histograms"])
    assert sum(port[0]["decisions"].get(f"dispatch.{m}", 0)
               for m in ("predicted", "gated", "measured")) == 3


def test_refit_instants_carry_before_and_after_mape_like_jax(tmp_path):
    """The same observations through each package's refiner over copies of
    one cache: the same refit counts and ``refit:`` instant args."""
    _toy_caches(tmp_path, 10.0)
    jtel, tel = jobs.Telemetry(), obs.Telemetry()
    jref = JOnlineRefiner(
        JTuningCache(str(tmp_path / "jax"), JFingerprint(*SIM)),
        JOnlineConfig(refit_every=2, model_factory=jnnc.LinearModel,
                      save=False), telemetry=jtel)
    ref = OnlineRefiner(
        TuningCache(str(tmp_path / "port"), Fingerprint(*SIM)),
        OnlineConfig(refit_every=2, model_factory=nnc.LinearModel,
                     save=False), telemetry=tel)
    reg = _toy_registry_of(registry_mod)
    rng = np.random.RandomState(3)
    for _ in range(5):
        m = int(rng.randint(32, 4096))
        row = reg.feature_rows("toy", {"m": m})[0]
        actual, pred = 2.0 * m / 1e6, m / 1e6
        jref.observe("toy", row, shape_bucket({"m": m}), actual,
                     predicted_s=pred)
        ref.observe("toy", row, shape_bucket({"m": m}), actual,
                    predicted_s=pred)
    assert tel.counters() == jtel.counters() == {"online.refits": 2}
    got = [(e["name"], e["args"]) for e in tel.events("refit")]
    want = [(e["name"], e["args"]) for e in jtel.events("refit")]
    assert [n for n, _ in got] == [n for n, _ in want] == ["refit:toy"] * 2
    for (_, g), (_, w) in zip(got, want):
        assert_docs_close(g, w)
        assert g["before_mape_pct"] is not None and g["rows"] >= 7


def test_comm_model_counts_predictions_like_jax(tmp_path):
    root = str(tmp_path / "comm")
    jtel, tel = jobs.Telemetry(), obs.Telemetry()
    jcomm = JCommModel(JTuningCache(root=root,
                                    fingerprint=JFingerprint(*COMM_FP)),
                       telemetry=jtel)
    JSimLink(latency_s=1e-3, bytes_per_s=1e9).measure_into(
        jcomm, [("d0", "d1")], sizes=(1 << 10, 1 << 14, 1 << 18),
        min_window=1e-4)
    comm = CommModel(TuningCache(root=root, fingerprint=Fingerprint(*COMM_FP)),
                     telemetry=tel)
    comm.record("d1", "d0", 4096, 1e-3)
    jcomm.record("d1", "d0", 4096, 1e-3)
    for nbytes in (1 << 12, 1 << 20, 3e6):
        assert comm.predict("d0", "d1", nbytes) \
            == jcomm.predict("d0", "d1", nbytes)
    assert comm.predict("d0", "d0", 1 << 20) == 0.0      # not counted
    c, jc = tel.counters(), jtel.counters()
    assert c == {"comm.recorded.d1->d0": 1, "comm.predictions.d0->d1": 3}
    assert jc["comm.predictions.d0->d1"] == 3
    assert jc["comm.recorded.d1->d0"] == 1
    assert tel.to_json()["histograms"]["comm.predicted_s"]["samples"] \
        == jtel.to_json()["histograms"]["comm.predicted_s"]["samples"][-3:]


def _steal_pair(pkg_task, pkg_policy, pkg_executor, pkg_tracer, tel):
    """The reference's steal scenario: a hog loads d0, ``work`` is ready
    at once and d1 is idle, so ``work`` moves."""
    hog = pkg_task("hog", "d0", lambda env: time.sleep(0.1) or "hog",
                   predict=lambda dev: 0.1, run_on=lambda env, dev: "hog",
                   runnable_on=("d0",), priority=0.0)
    work = pkg_task("work", "d0", lambda env: "work",
                    predict={"d0": 0.05, "d1": 0.06}.get,
                    run_on=lambda env, dev: "work",
                    runnable_on=("d0", "d1"), priority=1.0)
    tail = pkg_task("tail", "d1", lambda env: env["work"] + "!",
                    deps=("work",), priority=2.0)
    tracer = pkg_tracer()
    out = pkg_executor(tracer=tracer, steal=pkg_policy(),
                       telemetry=tel).run([hog, work, tail])
    return out, tracer


def test_executor_telemetry_matches_jax():
    jtel, tel = jobs.Telemetry(), obs.Telemetry()
    jout, _ = _steal_pair(JExecTask, JStealPolicy, JAsyncExecutor,
                          JExecutionTrace, jtel)
    out, tracer = _steal_pair(ExecTask, StealPolicy, AsyncExecutor,
                              ExecutionTrace, tel)
    assert out == jout == {"hog": "hog", "work": "work", "tail": "work!"}
    assert tel.counters() == jtel.counters() == {
        "exec.steals": 1, "exec.compute_done": 3}
    steal, = tel.events("steal")
    jsteal, = jtel.events("steal")
    assert steal["name"] == jsteal["name"] == "steal:work"
    assert (steal["args"]["planned"], steal["args"]["chosen"]) \
        == (jsteal["args"]["planned"], jsteal["args"]["chosen"]) \
        == ("d0", "d1")
    assert set(steal["args"]["costs_s"]) == set(jsteal["args"]["costs_s"])
    assert tel.series_names() == jtel.series_names() == [
        "exec.queue_depth.d0", "exec.queue_depth.d1"]
    h = tel.summary()["histograms"]
    assert h["exec.task_wait_s"]["count"] == 3
    assert [e.name for e in tracer.steals()] == ["steal:work"]


# --------------------------------------------------------------------------
# memory: plans, predicted peaks, the ledger, capacity
# --------------------------------------------------------------------------

def _diamond_arrays():
    rng = np.random.RandomState(1)
    return [rng.rand(N, N).astype(np.float32) for _ in range(4)]


def _diamond(api, reg, wrap):
    """Two independent matmuls feeding a third (the reference explain
    tests' diamond): EFT spreads the pair across both devices."""
    a, b, c, d = (wrap(x) for x in _diamond_arrays())
    with api.trace(registry=reg) as tb:
        x = api.ops.matmul(a, b)
        y = api.ops.matmul(c, d)
        api.ops.matmul(x, y)
    return tb.program, dict(tb.bindings)


class _PortApi:
    trace, ops = staticmethod(trace), ops


def _builds(name):
    """``(JAX program, port program, port bindings, port registry, JAX
    registry)`` of a program at ``small``."""
    if name == "diamond":
        jreg = jdefault_registry(include=["matmul"])
        reg = default_registry(include=["matmul"])
        jprog, _ = _diamond(japi, jreg, jnp.asarray)
        prog, bind = _diamond(_PortApi, reg, torch.from_numpy)
        return jprog, prog, bind, reg, jreg
    jreg, reg = jsuite_registry([name]), suite_registry([name])
    jb = jget_workload(name).build("small", registry=jreg)
    tb = get_workload(name).build("small", registry=reg, device="cpu")
    return jb.program, tb.program, dict(tb.bindings), reg, jreg


def _seeded_devices(root, program, reg, jax_side):
    """Two simulated devices per package, seeded from the same program at
    the same synthetic speeds."""
    devices = {}
    for name, speed in (("d0", 4.0e7), ("d1", 3.0e7)):
        fp = (JFingerprint if jax_side else Fingerprint)(
            "sim", f"obs-{name}", 1, 1, ("float32",))
        cache = (JTuningCache if jax_side else TuningCache)(
            root=str(root / ("jax" if jax_side else "port")), fingerprint=fp)
        d = (JDispatcher if jax_side else Dispatcher)(registry=reg,
                                                      cache=cache)
        (jseed if jax_side else seed_from_programs)(d, [program], speed,
                                                    reset=True)
        devices[name] = d
    return devices


@pytest.mark.parametrize("name", PROGRAMS)
def test_memory_plans_and_predicted_peaks_match_jax(tmp_path, name):
    jprog, prog, _, reg, jreg = _builds(name)
    assert prog.to_json() == jprog.to_json()
    jc = jprog.compile(devices=_seeded_devices(tmp_path, jprog, jreg, True))
    tc = prog.compile(devices=_seeded_devices(tmp_path, prog, reg, False))
    assert _fields(tc.memory) == _fields(jc.memory)
    assert tc.memory.devices == jc.memory.devices
    assert tc.predicted_peak_bytes == jc.predicted_peak_bytes
    assert all(p > 0 for p in tc.predicted_peak_bytes.values())
    assert obs.predicted_peak_bytes(tc.memory, tc.order, tc.buffers) \
        == jobs.predicted_peak_bytes(jc.memory, jc.order, jc.buffers) \
        == tc.predicted_peak_bytes


@pytest.mark.parametrize("name,executor",
                         [(n, "sequential") for n in PROGRAMS]
                         + [(n, "async") for n in WORKLOADS])
def test_measured_peak_against_predicted(tmp_path, name, executor):
    """The reference's contract: the sequential ledger peak equals the
    prediction exactly, the async one of a workload stays within 1.25x
    both ways.  (The diamond has no async bound in either package: when
    its transfer lands before the other branch frees its inputs, d0 holds
    4/3 of the predicted peak, in the JAX package's runs as in the
    port's.)"""
    _, prog, bind, reg, _ = _builds(name)
    tel = obs.Telemetry()
    compiled = prog.compile(devices=_seeded_devices(tmp_path, prog, reg,
                                                    False),
                            bindings=bind, executor=executor, telemetry=tel)
    try:
        compiled()
    finally:
        compiled.close()
    predicted = compiled.predicted_peak_bytes
    measured = compiled.last_memory.peak_bytes()
    assert isinstance(compiled.last_memory, obs.MemoryLedger)
    if executor == "sequential":
        assert measured == predicted
    else:
        assert set(measured) <= set(predicted)
        for dev, m in measured.items():
            assert predicted[dev] / BOUND <= m <= BOUND * predicted[dev]
    for dev in measured:
        assert tel.series(f"mem.peak_bytes.{dev}")[-1][1] == measured[dev]
        assert tel.series(f"mem.predicted_peak_bytes.{dev}")[-1][1] \
            == predicted[dev]
        assert tel.series(f"mem.live_bytes.{dev}")
    # the ledger ends holding the pinned outputs only
    live = {d: v for d, v in compiled.last_memory.live_bytes().items() if v}
    pinned: dict = {}
    for dev, val in compiled.memory.pinned:
        nb = compiled.memory.node_allocs[val][1] \
            if val in compiled.memory.node_allocs \
            else {v: n for _, v, n in compiled.memory.input_allocs}[val]
        pinned[dev] = pinned.get(dev, 0) + nb
    assert live == pinned


@pytest.mark.parametrize("capacity", [1024, 1 << 30])
def test_capacity_error_at_the_same_placement_as_jax(tmp_path, capacity):
    jprog, prog, _, reg, jreg = _builds("diamond")
    jdevs = {n: jfake_device(str(tmp_path / "j"), n, s, jreg,
                             capacity_bytes=capacity)
             for n, s in (("d0", 1e11), ("d1", 1e9))}
    devs = {n: fake_matmul_device(str(tmp_path / "t"), n, s, reg,
                                  capacity_bytes=capacity)
            for n, s in (("d0", 1e11), ("d1", 1e9))}
    sim = {n: fake_matmul_device(str(tmp_path / "s"), n, s, reg,
                                 simulate_time=True, capacity_bytes=capacity)
           for n, s in (("d0", 1e11), ("d1", 1e9))}
    assert all(d.capacity_bytes == capacity for d in sim.values())
    if capacity == 1024:
        with pytest.raises(jobs.MemoryCapacityError) as jerr:
            jprog.compile(devices=jdevs)
        for d in (devs, sim):
            with pytest.raises(obs.MemoryCapacityError) as err:
                prog.compile(devices=d)
            assert (err.value.device, err.value.predicted_bytes,
                    err.value.capacity_bytes) == (
                jerr.value.device, jerr.value.predicted_bytes,
                jerr.value.capacity_bytes)
            assert str(err.value) == str(jerr.value)
        return
    tc, jc = prog.compile(devices=devs), jprog.compile(devices=jdevs)
    assert tc.predicted_peak_bytes == jc.predicted_peak_bytes
    assert all(p <= capacity for p in tc.predicted_peak_bytes.values())


def test_fold_memory_and_ledger_documents_match_jax(tmp_path):
    jprog, prog, _, reg, jreg = _builds("diamond")
    jc = jprog.compile(devices=_seeded_devices(tmp_path, jprog, jreg, True))
    tc = prog.compile(devices=_seeded_devices(tmp_path, prog, reg, False))
    jtel = jobs.Telemetry(clock=counting_clock())
    tel = obs.Telemetry(clock=counting_clock())
    jl = jobs.MemoryLedger(jc.memory, telemetry=jtel)
    tl = obs.MemoryLedger(tc.memory, telemetry=tel)
    for ledger in (jl, tl):
        ledger.start()
        for task in tc.order:
            ledger.node_done(task.name)
        for name in tc.memory.transfer_allocs:
            ledger.transfer_done(name)
    jobs.memory.fold_memory(jtel, jl, jc.predicted_peak_bytes)
    obs.fold_memory(tel, tl, tc.predicted_peak_bytes)
    obs.fold_memory(None, tl, tc.predicted_peak_bytes)      # a no-op
    assert tl.to_json() == jl.to_json()
    assert tel.to_json() == jtel.to_json()


# --------------------------------------------------------------------------
# explain
# --------------------------------------------------------------------------

def _sim_run(tmp_path, telemetry=None):
    """A two-lane simulate-time async run of the diamond with a sleeping
    link: the executed CompiledProgram (``last_trace`` is the subject)."""
    reg = default_registry(include=["matmul"])
    devs = {n: fake_matmul_device(str(tmp_path / "devs"), n, s, reg,
                                  simulate_time=True)
            for n, s in (("d0", 1.0e9), ("d1", 0.9e9))}
    link = SimLink(latency_s=2e-4, bytes_per_s=2e9)
    comm = CommModel(TuningCache(root=str(tmp_path / "comm"),
                                 fingerprint=Fingerprint(*COMM_FP)))
    link.measure_into(comm, (("d0", "d1"), ("d1", "d0")))
    prog, bindings = _diamond(_PortApi, reg, torch.from_numpy)
    c = compile_program(prog, devices=devs, bindings=bindings,
                        executor="async", comm=comm, transfer=link.transfer,
                        telemetry=telemetry)
    try:
        c()
    finally:
        c.close()
    return c


def test_port_trace_analyzes_alike_in_both_packages(tmp_path):
    c = _sim_run(tmp_path)
    assert {e.device for e in c.last_trace.events
            if e.kind == "compute"} == {"d0", "d1"}
    path = str(tmp_path / "trace.json")
    c.last_trace.save_chrome(path)
    with open(path) as f:
        saved = json.load(f)
    doc = obs.analyze_chrome(saved)
    jdoc = jobs.analyze_chrome(saved)
    assert_docs_close(doc, jdoc)
    assert obs.format_explain(doc) == jobs.format_explain(jdoc)
    assert obs.summarize_attribution(doc) == jobs.summarize_attribution(jdoc)
    assert obs.EXPLAIN_SCHEMA_VERSION == jobs.EXPLAIN_SCHEMA_VERSION
    # the live analysis agrees with the saved one (Chrome keeps µs)
    live = c.explain()
    assert [r["task"] for r in live["critical_path"]] \
        == [r["task"] for r in doc["critical_path"]]
    assert set(live["buckets"]) == set(doc["buckets"])
    assert live["makespan_s"] == pytest.approx(doc["makespan_s"], abs=1e-4)


def test_port_explain_buckets_sum_to_makespan_within_1pct(tmp_path):
    c = _sim_run(tmp_path)
    doc = c.explain()
    assert not doc.get("empty") and doc["makespan_s"] > 0
    assert doc["residual_frac"] < 0.01
    assert abs(sum(doc["buckets"].values()) - doc["makespan_s"]) \
        <= 0.01 * doc["makespan_s"]
    assert doc["top_bottleneck"] in doc["buckets"]
    cp = doc["critical_path"]
    assert cp[-1]["end_s"] == pytest.approx(doc["makespan_s"])
    for prev, cur in zip(cp, cp[1:]):
        assert cur["ready_s"] == pytest.approx(prev["end_s"])
    for row in cp:
        assert row["run_s"] + row["queue_s"] + row["overhead_s"] \
            == pytest.approx(row["end_s"] - row["ready_s"], abs=1e-9)
    assert all(s >= 0.0 for s in doc["slack_s"].values())
    lanes = doc["lanes"]
    assert set(lanes) >= {"d0", "d1"}
    for u in lanes.values():
        assert u["busy_frac"] + u["wait_frac"] + u["idle_frac"] \
            == pytest.approx(1.0, abs=1e-6)
    records, epoch, _ = obs.explain.records_from_trace(c.last_trace)
    end = max(r.end_s for r in records)
    assert obs.lane_utilization(records, epoch, end) == lanes
    assert obs.format_lanes(lanes) == jobs.explain.format_lanes(lanes)


def test_misseeded_device_kernel_tops_misprediction_ranking(tmp_path):
    """d0's cache claims 10x its true speed; the async executor replays the
    mis-predicted schedule: d0's matmul must top the ranking, in the port's
    analysis and in the JAX package's analysis of the port's trace."""
    reg = default_registry(include=["matmul"])
    rng = np.random.RandomState(0)
    a, b, w = (torch.from_numpy(rng.rand(N, N).astype(np.float32))
               for _ in range(3))
    with trace(registry=reg) as tb:
        x = ops.matmul(a, b)
        y = ops.matmul(x, w)
        ops.matmul(x, y)
    prog, bindings = tb.program, dict(tb.bindings)
    true_time = true_time_at(reg, 1.0e9)
    devs = {}
    tel = obs.Telemetry()
    for name, rate in (("d0", 1.0e10), ("d1", 1.0e9)):
        fp = Fingerprint("sim", f"explain-{name}", 1, 1, ("float32",))
        cache = TuningCache(root=str(tmp_path / "mis"), fingerprint=fp)
        seed_from_programs(Dispatcher(registry=reg, cache=cache), [prog],
                           rate, amplitude=1.0, reset=True)
        devs[name] = SkewedSimDispatcher(registry=reg, cache=cache,
                                         true_time=true_time)
    link = SimLink(latency_s=2e-4, bytes_per_s=2e9)
    comm = CommModel(TuningCache(root=str(tmp_path / "mis-comm"),
                                 fingerprint=Fingerprint(*COMM_FP)))
    link.measure_into(comm, (("d0", "d1"), ("d1", "d0")))
    c = compile_program(prog, devices=devs, bindings=bindings,
                        executor="async", comm=comm, transfer=link.transfer,
                        telemetry=tel)
    try:
        c()
    finally:
        c.close()
    doc = c.explain()
    jdoc = jobs.analyze_chrome(json.loads(json.dumps(
        c.last_trace.to_chrome())))
    assert doc["residual_frac"] < 0.01
    for d in (doc, jdoc):
        top = d["mispredictions"][0]
        assert top["kernel"] == "matmul" and "d0" in top["lanes"]
        assert top["cost_s"] > 0 and top["ape_pct"] > 100.0
        assert top["exceeds_fit_band"] is True
        assert d["predicted"]["path"] and d["divergence"] is not None
    # d0's residuals (APE 90%: predicted a tenth of the truth) lift the
    # kernel's live MAPE far above its seeded fit band
    drift = tel.summary()["drift"]["matmul"]
    assert drift["live_mape_pct"] > 2 * drift["fit_band_pct"]


def test_waterfalls_from_telemetry_match_jax():
    def drive(pkg):
        tel = pkg.Telemetry(run_id="serve", clock=counting_clock())
        for rid in (0, 1):
            tel.instant(f"request.arrival:{rid}", cat="request", rid=rid)
        tel.instant("admission:0", cat="admission", rid=0)
        tel.event("serve.step", 3.0, 5.0, cat="serve.step",
                  requests=[{"rid": 0, "phase": "prefill"}])
        tel.instant("admission:1", cat="admission", rid=1)
        tel.event("serve.step", 6.0, 8.0, cat="serve.step",
                  requests=[{"rid": 0, "phase": "decode"},
                            {"rid": 1, "phase": "prefill"}])
        tel.instant("first_token:0", cat="token", rid=0)
        tel.instant("first_token:1", cat="token", rid=1)
        tel.instant("request.done:0", cat="request", tokens=4)
        return tel.to_json()

    doc = obs.waterfalls_from_telemetry(drive(obs))
    jdoc = jobs.waterfalls_from_telemetry(drive(jobs))
    assert doc == jdoc and doc["n_requests"] == 2
    assert obs.format_waterfalls(doc) == jobs.explain.format_waterfalls(jdoc)


def test_empty_analysis_matches_jax():
    assert obs.analyze_trace(ExecutionTrace()) \
        == jobs.analyze_trace(JExecutionTrace())
    assert obs.format_explain(obs.analyze_trace(ExecutionTrace())) \
        == ["== explain ==", "(empty trace)"]


# --------------------------------------------------------------------------
# the telemetry merge into Chrome traces
# --------------------------------------------------------------------------

def _record(tr):
    tr.set_epoch(5.0)
    tr.record("a", "compute", "d0", 5.0, 6.0,
              meta={"kernel": "matmul", "predicted_s": 0.8})
    tr.record("xfer:a:d0->d1", "transfer", "d0->d1", 6.0, 6.5, deps=("a",))
    tr.record("steal:b", "steal", "d1", 6.5, 6.5, note="d0->d1")
    tr.record("b", "compute", "d1", 6.5, 8.0, note="stolen:d0->d1",
              deps=("xfer:a:d0->d1",))
    return tr


def test_chrome_merge_with_telemetry_matches_jax(tmp_path):
    jtel = jobs.Telemetry(clock=counting_clock(4.0, 0.5))
    tel = obs.Telemetry(clock=counting_clock(4.0, 0.5))
    _drive(jtel)
    _drive(tel)
    jtr, tr = _record(JExecutionTrace()), _record(ExecutionTrace())
    doc = tr.to_chrome(telemetry=tel)
    assert doc == jtr.to_chrome(telemetry=jtel)
    assert tr.to_chrome(telemetry=jtel) == doc
    kinds = {e["ph"] for e in doc["traceEvents"]}
    assert {"C", "i", "X", "M", "s", "f"} <= kinds
    path = str(tmp_path / "merged.json")
    tr.save_chrome(path, telemetry=tel)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(doc))
    # the merged rows do not disturb the task DAG either package rebuilds
    names = [[(e.name, e.deps) for e in cls.from_chrome(doc).by_start()]
             for cls in (ExecutionTrace, JExecutionTrace)]
    assert names[0] == names[1]
    assert sorted(n for n, _ in names[0]) \
        == ["a", "b", "steal:b", "xfer:a:d0->d1"]


def test_compiled_program_telemetry_reaches_every_layer(tmp_path):
    """One compile(telemetry=) over two simulated devices and a link:
    dispatch, comm, executor and makespan records land in one document,
    and its merge into the trace is what JAX's analysis reads back."""
    tel = obs.Telemetry(run_id="compiled")
    c = _sim_run(tmp_path, telemetry=tel)
    assert all(d.telemetry is tel for d in c.dispatchers.values())
    counters = tel.counters()
    n_nodes = len(c.program.nodes)
    assert counters["exec.compute_done"] == n_nodes
    assert counters["exec.transfer_done"] == len(c.transfers) >= 1
    # 160-wide matmuls lie in a bucket the fake devices never saw, and
    # their variants tie: each device's first dispatch is gated
    assert sum(counters.get(f"dispatch.{m}", 0)
               for m in ("predicted", "gated", "measured")) == n_nodes
    assert any(k.startswith("comm.predictions.") for k in counters)
    ev, = tel.events("makespan")
    assert ev["name"] == "makespan:async"
    assert ev["args"]["predicted_s"] == pytest.approx(c.makespan)
    assert tel.summary()["histograms"]["program.wall_s"]["count"] == 1
    doc = c.last_trace.to_chrome(telemetry=tel)
    assert any(e["name"].startswith("exec.queue_depth.")
               for e in doc["traceEvents"] if e["ph"] == "C")
    assert [r["task"] for r in jobs.analyze_chrome(doc)["critical_path"]] \
        == [r["task"] for r in obs.analyze_chrome(doc)["critical_path"]]
    jdoc = jobs.summarize_doc(json.loads(json.dumps(tel.to_json())))
    assert jdoc == obs.summarize_doc(tel.to_json())
    # a program compiled without telemetry runs alike, bit for bit
    plain = Program(c.program.inputs, c.program.nodes, c.program.outputs)
    again = compile_program(plain, devices=c.dispatchers,
                            bindings=c.bindings, comm=c.comm)
    assert torch.equal(again(), c())
    again.close()
    c.close()
