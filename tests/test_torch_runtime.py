"""repro_torch runtime against the JAX package: fitted predictors and tuning
caches move between the packages unchanged, the port's fit reaches the
reference's accuracy, fingerprints never collide, and dispatch has the
cold -> measured -> fitted -> predicted semantics of tests/test_runtime.py."""
import numpy as np
import pytest
import torch

import repro.api  # noqa: F401  (before repro.workloads: import cycle)
from repro.core import nnc as jnnc
from repro.runtime import Dispatcher as JDispatcher
from repro.runtime import Fingerprint as JFingerprint
from repro.runtime import TuningCache as JTuningCache
from repro.runtime import current_fingerprint as jax_fingerprint
from repro.runtime import default_registry as jdefault_registry
from repro.runtime import seed_from_programs as jseed
from repro.workloads import get_workload as jget_workload
from repro.workloads import suite_registry as jsuite_registry
from repro_torch.core import nnc
from repro_torch.kernels import Aval
from repro_torch.runtime import (Dispatcher, DispatchPolicy, Fingerprint,
                                 OnlineConfig, OnlineRefiner, TuningCache,
                                 current_fingerprint, default_registry,
                                 shape_bucket)
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
