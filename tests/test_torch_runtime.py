"""repro_torch runtime against the JAX package: fitted predictors and tuning
caches move between the packages unchanged, the port's fit reaches the
reference's accuracy, fingerprints never collide, and dispatch has the
cold -> measured -> fitted -> predicted semantics of tests/test_runtime.py."""
import shutil
import sys

import numpy as np
import pytest
import torch

import repro.api  # noqa: F401  (before repro.workloads: import cycle)
from repro.core import nnc as jnnc
from repro.runtime import DispatchPolicy as JDispatchPolicy
from repro.runtime import Dispatcher as JDispatcher
from repro.runtime import Fingerprint as JFingerprint
from repro.runtime import TuningCache as JTuningCache
from repro.runtime import current_fingerprint as jax_fingerprint
from repro.runtime import default_registry as jdefault_registry
from repro.runtime import seed_from_programs as jseed
from repro.workloads import get_workload as jget_workload
from repro.runtime import registry as jregistry_mod
from repro.workloads import suite_registry as jsuite_registry
from repro_torch.core import nnc
from repro_torch.kernels import Aval
from repro_torch.runtime import (Dispatcher, DispatchPolicy, Fingerprint,
                                 OnlineConfig, OnlineRefiner, TuningCache,
                                 current_fingerprint, default_registry,
                                 shape_bucket)
from repro_torch.runtime import dispatch as port_dispatch
from repro_torch.runtime.registry import (KernelRegistry, RegisteredKernel,
                                          Variant)

SIM = ("sim", "parity", 1, 1, ("float32",))


def _fit_xy(n=80, seed=0):
    """Tiny synthetic perf dataset: t ~ c/1e9, features [m, k, c]."""
    rng = np.random.RandomState(seed)
    m = rng.randint(16, 1024, n).astype(float)
    k = rng.randint(16, 1024, n).astype(float)
    c = m * k
    X = np.column_stack([m, k, c])
    y = c / 1e9 * rng.uniform(0.9, 1.1, n)
    return X, y


# --------------------------------------------------------------------------
# fitted state crosses between the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlp", "linear"])
def test_jax_fitted_state_predicts_identically_in_port(kind, tmp_path):
    X, y = _fit_xy()
    ref = jnnc.MLPModel([3, 8, 1], epochs=300) if kind == "mlp" \
        else jnnc.LinearModel()
    ref.fit(X, y)
    ported = nnc.model_from_state(*ref.to_state())
    assert np.array_equal(ported.predict_np(X), ref.predict_np(X))
    # through the files as well: JAX saves, the port loads
    jnnc.save_model(ref, str(tmp_path / "m"))
    loaded = nnc.load_model(str(tmp_path / "m"))
    assert np.array_equal(loaded.predict_np(X), ref.predict_np(X))
    assert type(loaded).__name__ == type(ref).__name__


def test_port_fitted_state_loads_in_jax(tmp_path):
    X, y = _fit_xy()
    model = nnc.MLPModel([3, 8, 1], epochs=300).fit(X, y)
    nnc.save_model(model, str(tmp_path / "m"))
    loaded = jnnc.load_model(str(tmp_path / "m"))
    assert np.array_equal(loaded.predict_np(X), model.predict_np(X))
    meta, arrays = model.to_state()
    jmeta, jarrays = loaded.to_state()
    assert meta == jmeta and arrays.keys() == jarrays.keys()


def test_port_fit_reaches_reference_mape():
    """Same rows, same epochs: the port's batched-restart fit lands within
    1.5x of the JAX fit's training MAPE."""
    X, y = _fit_xy()
    ref = jnnc.MLPModel([3, 8, 1], epochs=2000).fit(X, y)
    port = nnc.MLPModel([3, 8, 1], epochs=2000).fit(X, y)
    ref_mape = jnnc.mape(y, ref.predict_np(X))
    port_mape = nnc.mape(y, port.predict_np(X))
    assert port_mape <= 1.5 * ref_mape, (port_mape, ref_mape)
    # the torch forward agrees with the numpy hot path
    np.testing.assert_allclose(port.predict(X), port.predict_np(X),
                               rtol=1e-5)


def test_concurrent_fits_leave_every_threads_count_alone(monkeypatch):
    """Two threads fit models at once, and no fit sets an intra-op thread
    count: ``torch.set_num_threads`` also sets the process default that a
    thread takes at its first parallel operation, so a fit that set it,
    even on a thread of its own, could hand one thread to a lane's thread
    starting meanwhile.  The calling threads, a thread started while the
    fits train and one started after them keep the process default; the
    fits equal a fit run alone, bit for bit."""
    import threading

    default = torch.get_num_threads()
    X, y = _fit_xy()
    alone = nnc.MLPModel([3, 8, 1], epochs=150, seed=4).fit(X, y)
    train = nnc.MLPModel._train
    sets, started, callers = [], [], []

    def spy(self, *args):
        box = []
        t = threading.Thread(target=lambda: box.append(
            torch.get_num_threads()))
        t.start()
        t.join()
        started.append(box[0])
        return train(self, *args)

    monkeypatch.setattr(nnc.MLPModel, "_train", spy)
    monkeypatch.setattr(torch, "set_num_threads", sets.append)
    models = [nnc.MLPModel([3, 8, 1], epochs=150, seed=4) for _ in range(2)]

    def fit(model):
        model.fit(X, y)
        callers.append(torch.get_num_threads())

    threads = [threading.Thread(target=fit, args=(m,)) for m in models]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    after = []
    t = threading.Thread(target=lambda: after.append(torch.get_num_threads()))
    t.start()
    t.join()
    assert sets == []
    assert started == [default, default]
    assert callers == [default, default]
    assert torch.get_num_threads() == default and after == [default]
    for model in models:
        assert all(np.array_equal(wa, wb) and np.array_equal(ba, bb)
                   for (wa, ba), (wb, bb) in zip(model.params, alone.params))


def test_fit_is_deterministic_and_warm_start_resumes():
    X, y = _fit_xy()
    a = nnc.MLPModel([3, 8, 1], epochs=200, seed=3).fit(X, y)
    b = nnc.MLPModel([3, 8, 1], epochs=200, seed=3).fit(X, y)
    assert all(np.array_equal(wa, wb) and np.array_equal(ba, bb)
               for (wa, ba), (wb, bb) in zip(a.params, b.params))
    loss = a.final_loss
    a.epochs = 200
    a.fit(X, y, warm_start=True)
    assert a.final_loss <= loss


def test_two_hidden_layers_and_tanh_fit():
    X, y = _fit_xy()
    for layers, act in (([3, 5, 4, 1], "relu"), ([3, 8, 1], "tanh")):
        model = nnc.MLPModel(layers, act, epochs=600).fit(X, y)
        assert nnc.mape(y, model.predict_np(X)) < 25.0
        assert [w.shape for w, _ in model.params] == \
            [(layers[i], layers[i + 1]) for i in range(len(layers) - 1)]


def test_unfitted_model_refuses_to_persist(tmp_path):
    with pytest.raises(ValueError):
        nnc.save_model(nnc.MLPModel([3, 8, 1]), str(tmp_path / "m"))


# --------------------------------------------------------------------------
# fingerprint
# --------------------------------------------------------------------------

def test_fingerprint_keys_disjoint_from_jax():
    fp = current_fingerprint("cpu")
    assert fp == current_fingerprint("cpu")
    assert Fingerprint.from_json(fp.to_json()) == fp
    assert fp.backend == "torch-cpu" and fp.key.startswith("torch-cpu-")
    assert {"bfloat16", "float32"} <= set(fp.dtypes)
    jfp = jax_fingerprint()
    assert jfp.backend in ("cpu", "gpu", "tpu")
    assert fp.key != jfp.key
    # a fingerprint the JAX package would write for a card can never key a
    # directory the port writes for it, and the hash matches the JAX rule
    jgpu = JFingerprint("gpu", "NVIDIA H100 80GB HBM3", 1, 8, ("float32",))
    tgpu = Fingerprint("torch-cuda", "NVIDIA H100 80GB HBM3", 1, 8,
                       ("float32",))
    assert jgpu.key != tgpu.key
    assert Fingerprint(*SIM).key == JFingerprint(*SIM).key
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            current_fingerprint()


# --------------------------------------------------------------------------
# tuning cache
# --------------------------------------------------------------------------

def _fill(entry, X, y):
    for i in range(len(y)):
        entry.add_rows(X[i][None], [y[i]],
                       shape_bucket({"m": X[i, 0], "k": X[i, 1]}))


def _filled_cache(root, epochs=400):
    cache = TuningCache(root=str(root), fingerprint=current_fingerprint("cpu"))
    entry = cache.entry("synth", feature_names=["m", "k"],
                        variant_names=["only"])
    X, y = _fit_xy()
    _fill(entry, X, y)
    entry.fit(epochs=epochs)
    cache.save()
    return cache, entry, X


def test_cache_roundtrip_identical_predictions(tmp_path):
    cache, entry, X = _filled_cache(tmp_path / "tc")
    reloaded = TuningCache(root=str(tmp_path / "tc"), fingerprint=cache.fingerprint)
    entry2 = reloaded.entry("synth")
    assert np.array_equal(entry2.predict(X), entry.predict(X))
    assert entry2.buckets == entry.buckets
    assert entry2.n_rows == entry.n_rows
    assert entry2.fit_mape == entry.fit_mape
    # a changed variant axis discards the entry; a torn npz is a cold start
    stale = TuningCache(root=str(tmp_path / "tc"), fingerprint=cache.fingerprint)
    assert stale.entry("synth", feature_names=["m", "k"],
                       variant_names=["only", "new"]).n_rows == 0
    npz = tmp_path / "tc" / cache.fingerprint.key / "synth.npz"
    npz.write_bytes(npz.read_bytes()[:100])
    torn = TuningCache(root=str(tmp_path / "tc"), fingerprint=cache.fingerprint)
    assert torn.entry("synth", feature_names=["m", "k"],
                      variant_names=["only"]).model is None
    with pytest.raises(KeyError):
        torn.entry("never_seen")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_files_move_between_packages(writer, tmp_path):
    """Same layout and CACHE_VERSION: a directory one package writes, the
    other loads, with identical predictions."""
    X, y = _fit_xy()
    make = {"jax": lambda: JTuningCache(str(tmp_path), JFingerprint(*SIM)),
            "port": lambda: TuningCache(str(tmp_path), Fingerprint(*SIM))}
    read = "port" if writer == "jax" else "jax"
    w = make[writer]()
    entry = w.entry("synth", feature_names=["m", "k"], variant_names=["only"])
    _fill(entry, X, y)
    entry.fit(model=(jnnc if writer == "jax" else nnc).LinearModel())
    w.save()
    r = make[read]().entry("synth", feature_names=["m", "k"],
                           variant_names=["only"])
    assert r.n_rows == entry.n_rows and r.buckets == entry.buckets
    assert np.array_equal(r.predict(X), entry.predict(X))


# --------------------------------------------------------------------------
# the registry and JAX-seeded caches carry the slice-2 kernels
# --------------------------------------------------------------------------

REGISTRY_PARAMS = {
    "conv2d": [{"m": 64, "n": 64, "r": 3}, {"m": 1022, "n": 1022, "r": 3},
               {"m": 41, "n": 77, "r": 7}],
    "maxpool": [{"m": 1020, "n": 1020, "r": 2, "s": 2},
                {"m": 65, "n": 43, "r": 5, "s": 1},
                {"m": 384, "n": 384, "r": 2, "s": 2}],
    "blur": [{"m": 1024, "n": 1024}, {"m": 66, "n": 200},
             {"m": 384, "n": 384}],
}


@pytest.mark.parametrize("kernel", sorted(REGISTRY_PARAMS))
def test_registry_matches_jax_for_slice2_kernels(kernel):
    """Same feature names, variant names and order, and candidate rows (the
    c column included) as the JAX registry: fitted states key on them."""
    jreg = jdefault_registry(include=[kernel])
    reg = default_registry(include=[kernel])
    assert reg.get(kernel).feature_names == jreg.get(kernel).feature_names
    assert reg.variant_names(kernel) == jreg.variant_names(kernel)
    for params in REGISTRY_PARAMS[kernel]:
        assert np.array_equal(reg.feature_rows(kernel, params),
                              jreg.feature_rows(kernel, params))
    assert default_registry().kernels() == sorted(
        ["matmul", "matvec", "conv2d", "maxpool", "blur", "flash_attention"])


def test_jax_seeded_cache_for_slice2_workloads_predicts_identically(
        tmp_path):
    """A JAX dispatcher seeded over image_pipeline and mixed_dag writes its
    cache; the port loads the directory and predicts every node alike."""
    names = ["image_pipeline", "mixed_dag"]
    jreg = jsuite_registry(names)
    progs = [jget_workload(n).build("small", registry=jreg).program
             for n in names]
    jd = JDispatcher(registry=jreg, cache=JTuningCache(
        str(tmp_path), JFingerprint(*SIM)))
    seeded = jseed(jd, progs, 1e9)
    assert {"conv2d", "maxpool", "blur"} <= set(seeded)
    reg = default_registry(include=sorted(seeded))
    port = TuningCache(str(tmp_path), Fingerprint(*SIM))
    for kernel in seeded:
        jentry = jd.cache.entry(kernel)
        entry = port.entry(kernel,
                           feature_names=reg.get(kernel).feature_names,
                           variant_names=reg.variant_names(kernel))
        assert list(entry.feature_names) == list(jentry.feature_names)
        assert list(entry.variant_names) == list(jentry.variant_names)
        assert entry.n_rows == jentry.n_rows and entry.model is not None
    td = Dispatcher(registry=reg, cache=port)
    n_nodes = 0
    for prog in progs:
        for node in prog.nodes:
            want = jd.predict_times(node.kernel, node.params)
            got = td.predict_times(node.kernel, node.params)
            assert got.keys() == want.keys()
            np.testing.assert_allclose(list(got.values()),
                                       list(want.values()), rtol=1e-12)
            assert min(got, key=got.get) == min(want, key=want.get)
            n_nodes += 1
    assert n_nodes == 3 + 8          # image_pipeline, mixed_dag (width 3)


# --------------------------------------------------------------------------
# the registry and JAX-fitted models carry the attention variants
# --------------------------------------------------------------------------

ATTENTION_PARAMS = [{"b": 1, "h": 2, "s": 64, "d": 8},
                    {"b": 4, "h": 8, "s": 512, "d": 32},
                    {"b": 2, "h": 8, "s": 1024, "d": 32},
                    {"b": 1, "h": 32, "s": 4096, "d": 128}]


def test_registry_matches_jax_for_flash_attention():
    """The attention variant axis: names, order, feature columns (``qc or
    s``) and candidate rows with the c column, as in the JAX registry, and
    the shared schedule constants."""
    from repro.runtime import registry as jregistry
    from repro_torch.runtime import registry

    jreg = jdefault_registry(include=["flash_attention"])
    reg = default_registry(include=["flash_attention"])
    assert reg.variant_names("flash_attention") == \
        jreg.variant_names("flash_attention") == \
        ["full", "chunked_q128_k256", "chunked_q256_k512",
         "chunked_q512_k1024"]
    assert reg.get("flash_attention").feature_names == \
        jreg.get("flash_attention").feature_names
    for params in ATTENTION_PARAMS:
        assert np.array_equal(reg.feature_rows("flash_attention", params),
                              jreg.feature_rows("flash_attention", params))
    assert registry.ATTENTION_SCHEDULES == jregistry.ATTENTION_SCHEDULES
    assert registry.ATTENTION_SCHEDULE_GRID == \
        jregistry.ATTENTION_SCHEDULE_GRID
    assert registry.attention_flops(2, 4, 96, 16) == \
        jregistry.attention_flops(2, 4, 96, 16)
    aval = Aval((2, 96, 4, 16), "float32")
    assert reg.abstract_params("flash_attention", aval, aval, aval) == \
        jreg.abstract_params("flash_attention", aval, aval, aval)


def test_jax_fitted_attention_model_predicts_identically(tmp_path):
    """A JAX dispatcher seeded over attention_block's presets, its
    ``flash_attention`` entry refitted with the production MLP, writes its
    cache; the port loads the directory and predicts every node alike."""
    names = ["attention_block"]
    jreg = jsuite_registry(names)
    progs = [jget_workload("attention_block").build(size, registry=jreg)
             .program for size in ("small", "medium", "large")]
    jd = JDispatcher(registry=jreg, cache=JTuningCache(
        str(tmp_path), JFingerprint(*SIM)))
    seeded = jseed(jd, progs, 1e9)
    assert seeded == ["flash_attention", "matmul"]
    entry = jd.cache.entry("flash_attention")
    assert type(entry.fit(epochs=300)).__name__ == "MLPModel"
    jd.cache.save()
    reg = default_registry(include=seeded)
    td = Dispatcher(registry=reg, cache=TuningCache(str(tmp_path),
                                                    Fingerprint(*SIM)))
    for prog in progs:
        for node in prog.nodes:
            want = jd.predict_times(node.kernel, node.params)
            got = td.predict_times(node.kernel, node.params)
            assert list(got) == list(want)
            np.testing.assert_allclose(list(got.values()),
                                       list(want.values()), rtol=1e-6)
    # the attention model also predicts the shapes it never saw alike
    for params in ATTENTION_PARAMS:
        want = jd.predict_times("flash_attention", params)
        got = td.predict_times("flash_attention", params)
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   rtol=1e-6)


# --------------------------------------------------------------------------
# dispatch: cold -> measured -> fitted -> predicted, memo, reload
# --------------------------------------------------------------------------

def _matmul_dispatcher(root):
    return Dispatcher(
        registry=default_registry(include=["matmul"]),
        cache=TuningCache(root=str(root), fingerprint=current_fingerprint("cpu")),
        policy=DispatchPolicy(min_rows_to_fit=9, fit_epochs=300,
                              min_window=2e-4))


SHAPES = [(32, 48, 40), (64, 64, 64), (96, 80, 72)]


def _operands(rng, m, n, k):
    return (torch.from_numpy(rng.rand(m, k).astype(np.float32)),
            torch.from_numpy(rng.rand(k, n).astype(np.float32)))


def test_dispatch_cold_measures_then_predicts(tmp_path):
    d = _matmul_dispatcher(tmp_path / "tc")
    rng = np.random.RandomState(0)
    for m, n, k in SHAPES:
        a, b = _operands(rng, m, n, k)
        out = d.dispatch("matmul", a, b)
        sel = d.selections[-1]
        assert sel.mode == "measured"
        assert set(sel.measured_s) == {"ref", "pallas_32", "pallas_128"}
        torch.testing.assert_close(out, a @ b, rtol=1e-5, atol=1e-5)
    # 3 shapes x 3 variants = 9 rows -> model fitted -> warm from here on
    assert d.n_measured == 3 and d.cache.entry("matmul").model is not None
    a, b = _operands(rng, *SHAPES[1])
    d.dispatch("matmul", a, b)
    assert d.selections[-1].mode == "predicted"
    assert d.selections[-1].predicted_s is not None
    memo = dict(d._decisions)
    d.dispatch("matmul", a, b)                     # memo hit, no new entry
    assert d._decisions == memo and d.selections[-1].mode == "predicted"
    assert d.n_measured == 3


def test_dispatch_reload_makes_identical_selections(tmp_path):
    d = _matmul_dispatcher(tmp_path / "tc")
    rng = np.random.RandomState(0)
    arrays = [_operands(rng, *s) for s in SHAPES]
    for a, b in arrays:
        d.dispatch("matmul", a, b)

    def selections(disp):
        out = []
        for a, b in arrays:
            disp.dispatch("matmul", a, b)
            out.append(disp.selections[-1].chosen)
        return out

    first = selections(d)
    d2 = _matmul_dispatcher(tmp_path / "tc")      # fresh process stand-in
    assert selections(d2) == first
    assert d2.n_measured == 0                     # warm purely from disk


def test_online_dispatch_feeds_actual_times(tmp_path):
    """policy.online: measured and memo-hit executions feed the refiner;
    the first warm run of a shape does not."""
    d = Dispatcher(
        registry=default_registry(include=["matmul"]),
        cache=TuningCache(root=str(tmp_path / "tc"),
                          fingerprint=current_fingerprint("cpu")),
        policy=DispatchPolicy(min_rows_to_fit=9, fit_epochs=200,
                              min_window=2e-4, online=True, refit_every=3,
                              refit_epochs=100))
    rng = np.random.RandomState(0)
    for m, n, k in SHAPES:
        d.dispatch("matmul", *_operands(rng, m, n, k))
    entry = d.cache.entry("matmul")
    assert d.refiner.refits["matmul"] == 1 and entry.n_rows == 9 + 3
    assert not np.isfinite(d.refiner.rolling_mape("matmul"))
    a, b = _operands(rng, *SHAPES[0])
    d.dispatch("matmul", a, b)                     # first warm run: not fed
    assert entry.n_rows == 12
    d.dispatch("matmul", a, b)                     # memo hit: fed and scored
    assert entry.n_rows == 13
    assert np.isfinite(d.refiner.rolling_mape("matmul"))


def _toy_registry():
    """Two-variant toy kernel whose calls are near-free."""
    def abstract_params(a):
        return {"m": int(a.shape[0])}

    flops = lambda p: float(p["m"])
    variants = tuple(
        Variant("toy", name, lambda args, p: args[0] * 1.0,
                lambda p, _i=float(i): [p["m"], _i], flops)
        for i, name in enumerate(("v0", "v1")))
    reg = KernelRegistry()
    reg.register(RegisteredKernel(
        "toy", abstract_params, ("m", "variant"), variants,
        abstract_params=abstract_params,
        out_aval=lambda a: Aval(tuple(a.shape), a.dtype)))
    return reg


def _gated_dispatcher(root, slowdown, gate=True):
    reg = _toy_registry()
    d = Dispatcher(registry=reg,
                   cache=TuningCache(root=str(root),
                                     fingerprint=current_fingerprint("cpu")),
                   policy=DispatchPolicy(min_window=1e-4,
                                         confidence_gate=gate))
    entry = d._entry("toy")
    for m in (32, 128, 512, 2048, 4096):
        rows = reg.feature_rows("toy", {"m": m})
        entry.add_rows(rows, [m / 1e6, slowdown * m / 1e6],
                       shape_bucket({"m": m}))
    entry.fit(model=nnc.LinearModel())
    assert entry.fit_mape is not None and entry.fit_mape < 5.0
    return d


@pytest.mark.parametrize("case", ["near_tie", "separated", "gate_off"])
def test_confidence_gate(tmp_path, case):
    slowdown = 10.0 if case == "separated" else 1.0
    d = _gated_dispatcher(tmp_path / "tc", slowdown, gate=case != "gate_off")
    a = torch.ones(32768)                          # unseen shape class
    d.dispatch("toy", a)
    sel = d.selections[-1]
    if case == "near_tie":
        assert sel.mode == "gated" and d.n_gated == 1
        assert sel.predicted_s is not None
        assert set(sel.measured_s) == {"v0", "v1"}
        d.dispatch("toy", a)                       # the rows bought coverage
        assert d.selections[-1].mode == "predicted" and d.n_gated == 1
    else:
        assert sel.mode == "predicted" and sel.measured_s is None
        assert d.n_gated == 0 and d.n_measured == 0
        if case == "separated":
            assert sel.chosen == "v0"


def test_online_refit_lowers_rolling_mape(tmp_path):
    X, y = _fit_xy(n=140, seed=1)
    cache = TuningCache(root=str(tmp_path / "tc"),
                        fingerprint=current_fingerprint("cpu"))
    entry = cache.entry("mv", feature_names=["m", "k"], variant_names=["v"])
    _fill(entry, X[:60], y[:60])
    entry.fit(epochs=500)
    refiner = OnlineRefiner(cache, OnlineConfig(
        refit_every=25, window=25, budget_rows=50, refit_epochs=500))
    mape_start = None
    for i in range(75):                 # the device got 8x slower
        row, t = X[60 + i], 8.0 * y[60 + i]
        pred = float(entry.predict(row[None])[0])
        refiner.observe("mv", row, shape_bucket({"m": row[0], "k": row[1]}),
                        t, predicted_s=pred)
        if i == 24:
            mape_start = refiner.rolling_mape("mv")
    assert refiner.refits["mv"] >= 2
    assert mape_start > 50.0
    assert refiner.rolling_mape("mv") < 0.5 * mape_start


# --------------------------------------------------------------------------
# the Dispatcher's stats, reset, fit and module-level dispatch
# --------------------------------------------------------------------------

def _toy_registry_of(mod):
    """The two-variant toy kernel in either package's registry types; its
    calls multiply by one, so jax and torch arrays both pass."""
    def abstract_params(a):
        return {"m": int(a.shape[0])}

    variants = tuple(
        mod.Variant("toy", name, lambda args, p: args[0] * 1.0,
                    lambda p, _i=float(i): [p["m"], _i],
                    lambda p: float(p["m"]))
        for i, name in enumerate(("v0", "v1")))
    reg = mod.KernelRegistry()
    reg.register(mod.RegisteredKernel("toy", abstract_params,
                                      ("m", "variant"), variants))
    return reg


def _toy_cache_dir(root):
    """A persisted toy cache written by the JAX package: five shape buckets,
    the two variants within 1%, a closed-form model."""
    cache = JTuningCache(str(root), JFingerprint(*SIM))
    reg = _toy_registry_of(jregistry_mod)
    entry = cache.entry("toy", feature_names=["m", "variant"],
                        variant_names=["v0", "v1"])
    for m in (32, 128, 512, 2048, 4096):
        entry.add_rows(reg.feature_rows("toy", {"m": m}),
                       [m / 1e6, 1.01 * m / 1e6], shape_bucket({"m": m}))
    entry.fit(model=jnnc.LinearModel())
    cache.save()
    return root


# seen shapes, a memo hit, an unseen near-tie shape class (gated), its memo
TOY_SEQUENCE = (32, 32, 512, 32768, 32768, 128)
COUNT_KEYS = ("dispatches", "predicted", "measured", "gated", "default")


@pytest.mark.parametrize("online", [False, True])
def test_dispatcher_stats_match_jax_on_the_same_cache(tmp_path, online):
    """Over copies of one persisted cache, the port's and the JAX package's
    Dispatcher, after the same dispatches, report stats() with the same
    keys and the same counts."""
    _toy_cache_dir(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    kw = {"min_window": 1e-4, "online": online, "refit_every": 1000}
    jd = JDispatcher(registry=_toy_registry_of(jregistry_mod),
                     cache=JTuningCache(str(tmp_path / "jax"),
                                        JFingerprint(*SIM)),
                     policy=JDispatchPolicy(**kw))
    from repro_torch.runtime import registry as registry_mod
    td = Dispatcher(registry=_toy_registry_of(registry_mod),
                    cache=TuningCache(str(tmp_path / "port"),
                                      Fingerprint(*SIM)),
                    policy=DispatchPolicy(**kw))
    import jax.numpy as jnp
    for m in TOY_SEQUENCE:
        jd.dispatch("toy", jnp.ones(m, jnp.float32))
        td.dispatch("toy", torch.ones(m))
    want, got = jd.stats(), td.stats()
    assert set(got) == set(want)
    assert {k: got[k] for k in COUNT_KEYS} == {k: want[k] for k in COUNT_KEYS}
    assert got["gated"] == 1 and got["dispatches"] == len(TOY_SEQUENCE)
    assert [s.mode for s in td.selections] == [s.mode for s in jd.selections]
    for key in ("steady_overhead_s", "steady_overhead_pct",
                "steady_overhead_pct_per_call"):
        assert got[key] > 0.0
    assert 0.0 < got["steady_overhead_pct"] < 100.0
    if online:
        assert set(got["rolling_mape"]) == set(want["rolling_mape"]) \
            == {"toy"}


def test_reset_stats_zeroes_counts_and_keeps_the_memo(tmp_path):
    from repro_torch.runtime import registry as registry_mod
    d = Dispatcher(registry=_toy_registry_of(registry_mod),
                   cache=TuningCache(str(_toy_cache_dir(tmp_path)),
                                     Fingerprint(*SIM)),
                   policy=DispatchPolicy(min_window=1e-4))
    for m in TOY_SEQUENCE:
        d.dispatch("toy", torch.ones(m))
    memo = dict(d._decisions)
    d.reset_stats()
    assert d.stats() == dict.fromkeys(COUNT_KEYS, 0)
    assert len(d.selections) == 0 and d._decisions == memo
    assert d.cache.entry("toy").model is not None

    def no_forward(rows):
        raise AssertionError("a memo hit runs no model forward")

    d._entry("toy").predict = no_forward
    d.dispatch("toy", torch.ones(32768))            # seen: a memo hit
    assert d.stats()["predicted"] == 1 and d.selections[-1].mode == "predicted"
    assert d._decisions == memo


def test_fit_writes_the_cache_and_a_fresh_dispatcher_predicts_alike(tmp_path):
    from repro_torch.runtime import registry as registry_mod
    reg = _toy_registry_of(registry_mod)
    d = Dispatcher(registry=reg, cache=TuningCache(str(tmp_path),
                                                   Fingerprint(*SIM)),
                   policy=DispatchPolicy(fit_epochs=150))
    entry = d._entry("toy")
    for m in (32, 128, 512, 2048, 4096):
        entry.add_rows(reg.feature_rows("toy", {"m": m}),
                       [m / 1e6, 2 * m / 1e6], shape_bucket({"m": m}))
    assert entry.model is None
    d.fit("toy")                                    # policy.fit_epochs
    assert entry.model is not None and entry.model.epochs == 150
    fresh = Dispatcher(registry=reg, cache=TuningCache(str(tmp_path),
                                                       Fingerprint(*SIM)))
    for m in (64, 1000, 32768):
        assert fresh.predict_times("toy", {"m": m}) == \
            d.predict_times("toy", {"m": m})
    d.fit("toy", model=nnc.LinearModel())           # other kwargs pass on
    assert type(entry.model).__name__ == "LinearModel"
    again = Dispatcher(registry=reg, cache=TuningCache(str(tmp_path),
                                                       Fingerprint(*SIM)))
    assert again.predict_times("toy", {"m": 64}) == \
        d.predict_times("toy", {"m": 64})


def test_module_dispatch_reuses_one_dispatcher_until_the_policy_changes(
        tmp_path, monkeypatch):
    from repro_torch.runtime import registry as registry_mod
    module = sys.modules["repro_torch.runtime.dispatch"]
    made = []

    def make(policy=None):
        d = Dispatcher(registry=_toy_registry_of(registry_mod),
                       cache=TuningCache(str(tmp_path), Fingerprint(*SIM)),
                       policy=policy)
        made.append(d)
        return d

    monkeypatch.setattr(module, "_DEFAULT", None)
    monkeypatch.setattr(module, "Dispatcher", make)
    out = port_dispatch("toy", torch.full((8,), 2.0))
    torch.testing.assert_close(out, torch.full((8,), 2.0))
    first = module.default_dispatcher()
    port_dispatch("toy", torch.ones(8))
    port_dispatch("toy", torch.ones(8), policy=DispatchPolicy())
    assert len(made) == 1 and module.default_dispatcher() is first
    assert first.stats()["dispatches"] == 3
    other = DispatchPolicy(min_window=1e-4)
    port_dispatch("toy", torch.ones(8), policy=other)
    assert len(made) == 2 and module.default_dispatcher().policy == other
    assert module.default_dispatcher().stats()["dispatches"] == 1


def test_predict_times_are_kept_until_the_next_refit(tmp_path):
    """A repeated prediction of one shape runs no model forward until a
    refit bumps the entry's version; then the new model prices it."""
    from repro_torch.runtime import registry as registry_mod
    d = Dispatcher(registry=_toy_registry_of(registry_mod),
                   cache=TuningCache(str(_toy_cache_dir(tmp_path)),
                                     Fingerprint(*SIM)))
    entry = d._entry("toy")
    first = d.predict_times("toy", {"m": 1000})
    calls = []
    forward = entry.predict
    entry.predict = lambda rows: calls.append(1) or forward(rows)
    assert d.predict_times("toy", {"m": 1000}) == first
    assert d.predict_time("toy", {"m": 1000}) == min(first.values())
    assert not calls
    d.predict_times("toy", {"m": 2000})              # another shape: forward
    assert len(calls) == 1
    for m in (32, 128):
        entry.add_rows(d.registry.feature_rows("toy", {"m": m}),
                       [10 * m / 1e6, 30 * m / 1e6], shape_bucket({"m": m}))
    entry.fit(model=nnc.LinearModel())
    entry.predict = lambda rows: calls.append(1) or entry.model.predict_np(
        np.atleast_2d(rows))
    again = d.predict_times("toy", {"m": 1000})
    assert len(calls) == 2 and again != first
    assert again == dict(zip(["v0", "v1"], entry.model.predict_np(
        d.registry.feature_rows("toy", {"m": 1000})).tolist()))
