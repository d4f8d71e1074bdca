"""The port's paper experiments (``repro_torch.core.features``,
``core.selection``, ``core.nnc.mae``, ``perfdata.{simulate,measure,
datasets}``, ``kernels.blur.ops.host_blur_time`` and ``repro_torch.paper``)
against the JAX package's (``repro.core``, ``repro.perfdata`` and the
scripts under ``benchmarks/``).

Both packages run in this one process, so ``datasets.generate``'s
``hash(combo.key)`` seed is the same in both.  Tolerances: samplers,
features, simulated seconds, generated datasets, inputs, host-variant
outputs, the seconds of a faked clock, the linear baselines' MAE and the
summaries' lines exactly; the card variants' plain versions against the
host numpy variants within 1e-5 relative to the output's largest magnitude
above 1; the MLP methods' held-out MAPE within 1.5x of the JAX fit's, as
in ``tests/test_torch_runtime.py``; predicted makespans to rtol 1e-6.
"""
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:           # the JAX package's paper scripts
    sys.path.insert(0, str(ROOT))

import repro.api  # noqa: E402,F401  (before repro.workloads: import cycle)
import repro.runtime.simdev as jsimdev  # noqa: E402
from benchmarks import executor_overlap as jexecutor_overlap  # noqa: E402
from benchmarks import omitted_kernels as jomitted  # noqa: E402
from benchmarks import paper_tables as jtables  # noqa: E402
from benchmarks import runtime_overhead as jruntime_overhead  # noqa: E402
from benchmarks import unconstrained as junconstrained  # noqa: E402
from benchmarks import variant_selection as jvariant_selection  # noqa: E402
from repro.core import features as jfeatures  # noqa: E402
from repro.core import nnc as jnnc  # noqa: E402
from repro.core import selection as jselection  # noqa: E402
from repro.perfdata import datasets as jdatasets  # noqa: E402
from repro.perfdata import measure as jmeasure  # noqa: E402
from repro.perfdata import simulate as jsimulate  # noqa: E402
import repro_torch.runtime.simdev as simdev  # noqa: E402
from repro_torch.core import features, nnc, selection  # noqa: E402
from repro_torch.kernels.blur import ops as blur_ops  # noqa: E402
from repro_torch.paper import (executor_overlap, omitted_kernels,  # noqa: E402
                               runtime_overhead, tables, unconstrained,
                               variant_selection)
from repro_torch.perfdata import datasets, measure, simulate  # noqa: E402
from repro_torch.kernels.build import library_path  # noqa: E402
from repro_torch.paper.__main__ import trailer  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    Fingerprint, current_fingerprint, default_registry)

KERNELS = ("mm", "mv", "mc", "mp", "blur", "chol", "qr")
CARD_TOL = 1e-5
FIT_BAND = 1.5
FIT_EPOCHS = 150
SIM_COMBOS = datasets.paper_combos() + [c for c in datasets.extra_combos()
                                        if c.simulated]
# the registry kernel behind each paper kernel
REGISTRY = {"mm": "matmul", "mv": "matvec", "mc": "conv2d", "mp": "maxpool"}
HOST_REF = {"mm": "blas", "mv": "blas", "mc": "window", "mp": "window"}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Torch ops on one intra-op thread, the count restored after: with
    several test workers on one host, a parallel op's OpenMP team waits
    for cores the other workers hold, and this file's fits and blur
    schedules then slow 50-500x.  The tests check numbers and control
    flow, not speed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcombo(c):
    return jdatasets.Combo(c.kernel, c.variant, c.device, c.simulated)


# --------------------------------------------------------------------------
# features and the simulated devices
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_samplers_complexities_and_features_match(kernel):
    rng, jrng = np.random.RandomState(7), np.random.RandomState(7)
    spec, jspec = features.KERNELS[kernel], jfeatures.KERNELS[kernel]
    assert spec.param_names == jspec.param_names
    for i in range(200):
        p, jp = spec.sample(rng), jspec.sample(jrng)
        assert p == jp and [type(v) for v in p.values()] == \
            [type(v) for v in jp.values()]
        assert spec.complexity(p) == jspec.complexity(jp)
        kw = [{}, {"n_threads": 1 + i % 8}, {"with_c": False},
              {"extra": {"b": 2.0, "a": float(i)}}][i % 4]
        got = features.feature_vector(kernel, p, **kw)
        want = jfeatures.feature_vector(kernel, jp, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for cpu, extra, with_c in itertools.product((False, True),
                                                ((), ("x", "y")),
                                                (False, True)):
        assert features.feature_names(kernel, cpu=cpu, extra=extra,
                                      with_c=with_c) == \
            jfeatures.feature_names(kernel, cpu=cpu, extra=extra,
                                    with_c=with_c)


@pytest.mark.parametrize("device", sorted(jsimulate.DEVICES))
def test_simulate_time_is_equal_bit_for_bit(device):
    dev, jdev = simulate.DEVICES[device], jsimulate.DEVICES[device]
    assert dev == type(dev)(**jdev.__dict__)
    for name in jsimulate.VARIANTS[jdev.kind]:
        var = simulate.VARIANTS[dev.kind][name]
        jvar = jsimulate.VARIANTS[jdev.kind][name]
        assert var == type(var)(**jvar.__dict__)
        for kernel in KERNELS:
            rng, jrng = np.random.RandomState(3), np.random.RandomState(3)
            for _ in range(25):
                p = features.KERNELS[kernel].sample(rng)
                jp = jfeatures.KERNELS[kernel].sample(jrng)
                thd = int(rng.randint(1, 65))
                assert thd == int(jrng.randint(1, 65))
                got = simulate.simulate_time(kernel, dev, var, p, thd, rng)
                want = jsimulate.simulate_time(kernel, jdev, jvar, jp, thd,
                                               jrng)
                assert got == want, (kernel, name, p)


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

def test_combo_lists_match():
    for name in ("paper_combos", "host_combos", "extra_combos"):
        got = [(c.key, c.simulated, c.is_cpu)
               for c in getattr(datasets, name)()]
        want = [(c.key, c.simulated, c.is_cpu)
                for c in getattr(jdatasets, name)()]
        assert got == want, name
    assert len(SIM_COMBOS) == 44
    assert datasets.PAPER_KERNELS == jdatasets.PAPER_KERNELS
    assert datasets.EXTRA_KERNELS == jdatasets.EXTRA_KERNELS


@pytest.mark.parametrize("combo", SIM_COMBOS, ids=lambda c: c.key)
def test_generate_is_equal_for_every_simulated_combo(combo):
    X, y, names = datasets.generate(combo, n=500, cache_dir=None)
    jX, jy, jnames = jdatasets.generate(_jcombo(combo), n=500,
                                        cache_dir=None)
    assert X.shape == jX.shape == (500, len(names))
    assert np.array_equal(X, jX) and np.array_equal(y, jy)
    assert names == jnames
    (trX, trY), (teX, teY) = datasets.train_test_split(X, y)
    assert len(trX) == len(teY) == 250 and np.array_equal(teX, X[250:])


def test_dataset_caches_load_in_either_package(tmp_path):
    jcombo = jdatasets.Combo("mc", "eigen", "i7", True)
    combo = datasets.Combo("mc", "eigen", "i7", True)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jdatasets.generate(jcombo, n=60, seed=2, cache_dir=jdir)
    got = datasets.generate(combo, n=60, seed=2, cache_dir=jdir)  # loads
    other = datasets.generate(datasets.Combo("mv", "boost", "i5", True),
                              n=60, seed=2, cache_dir=pdir)
    back = jdatasets.generate(jdatasets.Combo("mv", "boost", "i5", True),
                              n=60, seed=2, cache_dir=pdir)      # loads
    for (X, y, names), (jX, jy, jnames) in ((got, want), (other, back)):
        assert np.array_equal(X, jX) and np.array_equal(y, jy)
        assert names == jnames
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == \
        ["mc_eigen_i7_60_2.npz"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ["mv_boost_i5_60_2.npz"]


def test_card_combos_need_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        datasets.card_combos("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            datasets.card_combos()
        with pytest.raises(RuntimeError, match="is_available"):
            measure.measure_instance("mm", "ref", {"m": 2, "n": 2, "k": 2},
                                     np.random.RandomState(0),
                                     device="cuda")
    ref_keys = {c.key for c in jdatasets.paper_combos()
                + jdatasets.host_combos() + jdatasets.extra_combos()}
    card = [datasets.Combo(k, v, datasets.CARD, False)
            for k in datasets.PAPER_KERNELS for v in measure.card_variants(k)]
    assert len(card) == 9 and not ref_keys & {c.key for c in card}
    assert not any(c.is_cpu for c in card)


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", list(jmeasure.HOST_VARIANTS))
def test_make_inputs_and_host_variants_match(kernel):
    assert list(measure.HOST_VARIANTS[kernel]) == \
        list(jmeasure.HOST_VARIANTS[kernel])
    rng, jrng = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(3):
        p = features.KERNELS[kernel].sample(rng)
        jp = jfeatures.KERNELS[kernel].sample(jrng)
        # small operands: the naive variants are slow at Table 2's sizes
        for key in ("m", "n", "k"):
            if key in p:
                p[key] = jp[key] = min(p[key], 96)
        if kernel == "qr":
            p["n"] = jp["n"] = min(p["n"], p["m"])
        ops = measure.make_inputs(kernel, p, rng)
        jops = jmeasure.make_inputs(kernel, jp, jrng)
        for x, jx in zip(ops, jops):
            assert (x is None and jx is None) or np.array_equal(x, jx)
        for name, fn in measure.HOST_VARIANTS[kernel].items():
            got = fn(p, *ops)
            want = jmeasure.HOST_VARIANTS[kernel][name](jp, *jops)
            for g, w in zip(got if kernel == "qr" else (got,),
                            want if kernel == "qr" else (want,)):
                assert np.array_equal(g, w), name


def _fake_clock(monkeypatch, module):
    """``module.time.perf_counter`` advancing 6 ms a read: every timing
    window closes after one call."""
    clock = itertools.count()
    monkeypatch.setattr(module.time, "perf_counter",
                        lambda: next(clock) * 6e-3)


@pytest.mark.parametrize("kernel,variant,params", [
    ("mm", "blas", {"m": 40, "n": 30, "k": 20, "d1": 1.0, "d2": 1.0}),
    ("mm", "einsum", {"m": 900, "n": 1000, "k": 256, "d1": 1.0, "d2": 1.0}),
    ("mv", "einsum", {"m": 50, "n": 70, "d": 0.5}),
    ("mc", "fft", {"m": 40, "n": 33, "r": 5, "d": 1.0}),
    ("mp", "offsets", {"m": 40, "n": 33, "r": 3, "s": 2, "d": 1.0}),
    ("chol", "blocked", {"n": 80}),
    ("qr", "mgs", {"m": 50, "n": 20}),
], ids=lambda x: x if isinstance(x, str) else "")
def test_measure_instance_seconds_match_under_a_fake_clock(
        monkeypatch, kernel, variant, params):
    """The einsum case crosses the 2e8 multiply-add cap: both packages
    time the same row slice and scale it alike."""
    got = {}
    for mod in (measure, jmeasure):
        # both modules read the one ``time`` module: a fresh clock each
        _fake_clock(monkeypatch, mod)
        got[mod] = mod.measure_instance(kernel, variant, dict(params),
                                        np.random.RandomState(5))
    assert got[measure] == got[jmeasure]
    if variant == "einsum" and kernel == "mm":
        rows = int(2e8 / (1000 * 256))
        assert got[measure] == pytest.approx(6e-3 * 900 / rows)


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


@pytest.mark.parametrize("kernel", datasets.PAPER_KERNELS)
def test_card_variants_plain_versions_match_the_host_variants(kernel):
    """On the CPU a card variant runs the registry's library path or the
    hand kernel's plain version; both agree with the host numpy variant
    in fp32.  The variants are the registry's own: the same names, tile
    arguments and calls."""
    reg = default_registry(include=[REGISTRY[kernel]])
    card = measure.card_variants(kernel)
    assert measure.CARD_KERNELS[kernel][0] == REGISTRY[kernel]
    assert list(card) == reg.variant_names(REGISTRY[kernel])
    for variant in reg.variants(REGISTRY[kernel]):
        # the registry builds its closures anew: the code and the bound
        # tile are what make two calls one schedule
        got = card[variant.name].call
        assert got.__code__ is variant.call.__code__, variant.name
        assert got.__defaults__ == variant.call.__defaults__, variant.name
    rng = np.random.RandomState(13)
    host = measure.HOST_VARIANTS[kernel][HOST_REF[kernel]]
    for _ in range(3):
        p = features.KERNELS[kernel].sample(rng)
        ops = measure.make_inputs(kernel, p, rng)
        want = host(p, *(None if x is None else x.astype(np.float32)
                         for x in ops))
        args = measure.to_device(*ops, "cpu")
        for name in card:
            out = measure.card_call(kernel, name, p, *args)
            assert out.dtype == torch.float32 and out.shape == want.shape
            assert _rel_err(out.numpy(), want) <= CARD_TOL, (name, p)
            # the same callable dispatch runs
            variant = next(v for v in reg.variants(REGISTRY[kernel])
                           if v.name == name)
            call_args = {"mm": args[:2], "mv": (args[0], args[2]),
                         "mc": args[:2], "mp": args[:1]}[kernel]
            assert torch.equal(out, variant.call(call_args, p)), name


def _fake_card(monkeypatch, kind: str) -> None:
    """Card combos measured on the host (their kernels' plain versions)
    under a card fingerprint of ``kind``."""
    monkeypatch.setattr(measure, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(datasets, "current_fingerprint", lambda device:
                        Fingerprint("torch-cuda", kind, 1, 8, ("float32",)))


def test_card_datasets_are_keyed_by_the_card_and_the_build(
        tmp_path, monkeypatch):
    """A card combo's cache file names the card and its kernel library's
    build: another card measures anew, the same one loads its own."""
    combo = datasets.Combo("mv", "pallas_128", datasets.CARD, False)
    build = library_path("matvec").stem.rsplit("-", 1)[1]
    _fake_card(monkeypatch, "Card A")
    X, y, _ = datasets.generate(combo, n=3, cache_dir=str(tmp_path))
    (first,) = tmp_path.iterdir()
    assert first.name.startswith("mv_pallas_128_cuda_torch-cuda-card-a-1x-")
    assert first.name.endswith(f"-{build}_3_0.npz")
    again = datasets.generate(combo, n=3, cache_dir=str(tmp_path))
    assert np.array_equal(again[1], y)                    # loaded
    _fake_card(monkeypatch, "Card B")
    datasets.generate(combo, n=3, cache_dir=str(tmp_path))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2 and "card-b" in names[1]
    assert datasets.card_stamp(datasets.Combo("mv", "eigen", "i5", True)) \
        is None


def test_measure_instance_times_card_variants_on_the_cpu():
    rng, jrng = np.random.RandomState(4), np.random.RandomState(4)
    p = {"m": 30, "n": 20, "r": 3, "s": 2, "d": 1.0}
    t = measure.measure_instance("mp", "pallas_32", p, rng, device="cpu")
    assert t > 0
    jmeasure.make_inputs("mp", p, jrng)           # the same draws consumed
    assert rng.rand() == jrng.rand()


def test_host_blur_time_runs_each_schedule_on_the_host():
    for sched in blur_ops.HOST_SCHEDULES:
        rng = np.random.RandomState(0)
        t = blur_ops.host_blur_time(sched, 64, 80, rng, reps=2,
                                    device="cpu")
        assert 0 < t < 1
        jrng = np.random.RandomState(0)
        jrng.rand(64, 80)
        assert rng.rand() == jrng.rand()           # one plane drawn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            blur_ops.host_blur_time("direct", 8, 8, np.random.RandomState(0))


# --------------------------------------------------------------------------
# mae, selection and the fits
# --------------------------------------------------------------------------

def test_mae_and_selection_match_on_a_jax_fitted_state(tmp_path):
    rng = np.random.RandomState(1)
    m = rng.randint(64, 2048, 60).astype(float)
    n = rng.randint(64, 2048, 60).astype(float)
    sched = rng.randint(0, 5, 60).astype(float)
    X = np.column_stack([m, n, sched, m * n * 9])
    y = m * n * 9 / 1e9 * (1 + 0.3 * sched) * rng.uniform(0.9, 1.1, 60)
    ref = jnnc.MLPModel(jnnc.lightweight_dims(4, 75, 1), epochs=400).fit(X, y)
    jnnc.save_model(ref, str(tmp_path / "m"))
    port = nnc.load_model(str(tmp_path / "m"))
    assert nnc.mae(y, port.predict(X)) == pytest.approx(
        jnnc.mae(y, ref.predict(X)), rel=1e-5)
    assert nnc.mae(y, y[::-1]) == jnnc.mae(y, y[::-1])
    for i in range(0, 60, 5):
        cands = X[i:i + 5]
        truth = y[i:i + 5]
        sel = selection.VariantSelector(port)
        jsel = jselection.VariantSelector(ref)
        assert sel.select(cands) == jsel.select(cands)
        assert np.array_equal(sel.rank(cands), jsel.rank(cands))
        assert selection.evaluate_selection(sel, cands, truth, i % 5) == \
            jselection.evaluate_selection(jsel, cands, truth, i % 5)


def test_run_combo_matches_the_jax_package(tmp_path, monkeypatch):
    """The linear baselines' MAE equal exactly; the MLP methods' held-out
    MAPE within FIT_BAND of the JAX fit's, at FIT_EPOCHS."""
    monkeypatch.chdir(tmp_path)                   # results/perfdata here
    combo = datasets.Combo("mv", "eigen", "xeon", True)
    got = tables.run_combo(combo, epochs=FIT_EPOCHS)
    want = jtables.run_combo(_jcombo(combo), epochs=FIT_EPOCHS)
    assert list(got) == list(tables.METHODS) == list(jtables.METHODS)
    for method in ("cons", "lr"):
        assert got[method]["mae"] == want[method]["mae"], method
        assert got[method]["mape"] == want[method]["mape"], method
    for method in ("nnc", "nn", "nlr"):
        assert got[method]["n_params"] == want[method]["n_params"] <= 75
        assert np.isfinite(got[method]["mape"])
        assert got[method]["mape"] <= FIT_BAND * want[method]["mape"], \
            (method, got[method]["mape"], want[method]["mape"])
    assert (tmp_path / "results" / "perfdata"
            / "mv_eigen_xeon_500_0.npz").exists()


# --------------------------------------------------------------------------
# the summaries
# --------------------------------------------------------------------------

def _method_rows(rng, methods) -> dict:
    return {m: {"mae": float(rng.lognormal(-10, 1)),
                "mape": float(rng.uniform(0.5, 80)),
                "n_params": 61, "train_s": 0.5} for m in methods}


def _table_results(seed, card: bool) -> dict:
    rng = np.random.RandomState(seed)
    combos = jdatasets.paper_combos() + jdatasets.host_combos()
    out = {c.key: _method_rows(rng, jtables.METHODS) for c in combos}
    if card:
        for k in datasets.PAPER_KERNELS:
            for v in measure.card_variants(k):
                out[f"{k}|{v}|cuda"] = _method_rows(rng, jtables.METHODS)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_tables_summary_matches_and_adds_a_card_row(seed):
    ref = _table_results(seed, card=False)
    assert tables.summarize(ref) == jtables.summarize(ref)
    both = _table_results(seed, card=True)
    lines = tables.summarize(both)
    card = [ln for ln in lines if ln.split(" ")[0].endswith("|cuda")
            or ln.startswith("CARD") or "card combos" in ln]
    assert len(card) == 9 + 1 + 1
    assert [ln for ln in lines if ln not in card] == jtables.summarize(ref)
    row = next(ln for ln in lines if ln.startswith("CARD"))
    cards = [r for k, r in both.items() if k.endswith("|cuda")]
    want = "".join(f"{np.mean([r[m]['mape'] for r in cards]):10.1f}"
                   for m in tables.METHODS)
    assert row == f"{'CARD':10s}" + want
    only = {k: r for k, r in both.items() if k.endswith("|cuda")}
    assert "CPU" not in "".join(tables.summarize(only))


def _reference_trailer(tabs: dict) -> list[str]:
    """``benchmarks/run.py``'s first four trailer lines, its formulas."""
    nnc_mae = np.mean([r["nnc"]["mae"] for r in tabs.values()])
    nn_mae = np.mean([r["nn"]["mae"] for r in tabs.values()])
    nnc_mape = np.mean([r["nnc"]["mape"] for r in tabs.values()])
    wins = sum(1 for r in tabs.values() if r["nnc"]["mae"] <= r["nn"]["mae"])
    return [f"table4_7_nnc_mean_mae_s,{nnc_mae:.6e},lower_is_better",
            f"table4_7_nn_mean_mae_s,{nn_mae:.6e},baseline",
            f"table8_nnc_mean_mape_pct,{nnc_mape:.2f},paper_reports_13pct",
            f"nnc_vs_nn_mae_winrate,{wins}/{len(tabs)},paper_reports_all"]


@pytest.mark.parametrize("card", [False, True])
def test_trailer_keeps_the_reference_lines_over_the_reference_combos(card):
    """The reference's trailer lines are over the reference's combos
    alone; the card combos get ``card_*`` lines of their own."""
    tabs = _table_results(3, card=card)
    ref = _table_results(3, card=False)
    lines = trailer(tabs)
    assert lines[0] == "name,us_per_call,derived"
    assert lines[1:5] == _reference_trailer(ref)
    if not card:
        assert len(lines) == 5
        return
    cards = [r for k, r in tabs.items() if k.endswith("|cuda")]
    wins = sum(1 for r in cards if r["nnc"]["mae"] <= r["nn"]["mae"])
    assert lines[5:] == [
        f"card_nnc_mean_mape_pct,"
        f"{np.mean([r['nnc']['mape'] for r in cards]):.2f},measured_on_card",
        f"card_nnc_vs_nn_mae_winrate,{wins}/9,measured_on_card"]


def test_tables_rerun_a_card_combo_measured_elsewhere(tmp_path, monkeypatch):
    """A stored card row is reused only under the same ``card_stamp``; the
    reference's combos are reused as the JAX package reuses them."""
    stamp = {"now": "card-a"}
    monkeypatch.setattr(tables, "card_stamp", lambda combo: stamp["now"]
                        if combo.device == datasets.CARD else None)
    ran = []
    monkeypatch.setattr(tables, "run_combo", lambda combo, epochs: (
        ran.append(combo.key) or _method_rows(np.random.RandomState(len(ran)),
                                              tables.METHODS)))
    combos = [datasets.Combo("mm", "eigen", "i5", True),
              datasets.Combo("mm", "ref", datasets.CARD, False)]
    out = str(tmp_path / "t.json")
    tables.run(epochs=1, combos=combos, out_path=out)
    tables.run(epochs=1, combos=combos, out_path=out)
    assert ran == ["mm|eigen|i5", "mm|ref|cuda"]
    stamp["now"] = "card-b"
    res = tables.run(epochs=1, combos=combos, out_path=out)
    assert ran == ["mm|eigen|i5", "mm|ref|cuda", "mm|ref|cuda"]
    assert res["mm|ref|cuda"]["stamp"] == "card-b"
    assert "stamp" not in res["mm|eigen|i5"]
    assert json.loads(Path(out).read_text()) == res


def test_unconstrained_omitted_and_selection_summaries_match():
    rng = np.random.RandomState(2)
    unc = {}
    for c in junconstrained.CASES:
        light, big = _method_rows(rng, ("light", "unconstrained")).values()
        unc[c.key] = {"light": light, "unconstrained": big,
                      "size_increase": float(rng.uniform(20, 40)),
                      "time_increase": float(rng.uniform(1, 9))}
    assert unconstrained.summarize(unc) == junconstrained.summarize(unc)
    assert [c.key for c in unconstrained.CASES] == \
        [c.key for c in junconstrained.CASES]
    omitted = {c.key: _method_rows(rng, jomitted.METHODS)
               for c in jdatasets.extra_combos()}
    assert omitted_kernels.summarize(omitted) == jomitted.summarize(omitted)
    scheds = list(blur_ops.HOST_SCHEDULES)
    vs = {"train_mape": 7.25, "cases": {
        f"{m}x{n}": {"chosen": scheds[i % 5], "best": scheds[(i + 1) % 5],
                     "speedup_vs_default": float(rng.uniform(0.5, 2)),
                     "regret_vs_best": float(rng.uniform(1, 2))}
        for i, (m, n) in enumerate(jvariant_selection.TEST_SIZES)}}
    assert variant_selection.summarize(vs) == jvariant_selection.summarize(vs)
    assert variant_selection.TEST_SIZES == jvariant_selection.TEST_SIZES
    assert variant_selection.TRAIN_SIZES == jvariant_selection.TRAIN_SIZES
    rt = {"steady_overhead_s": 1.2e-5, "steady_overhead_pct": 3.5,
          "cases": {"384x384": {"chosen": "conv", "best": "direct",
                                "regret_vs_oracle": 1.25,
                                "speedup_vs_default": 0.8}}}
    assert runtime_overhead.summarize(rt) == jruntime_overhead.summarize(rt)


# --------------------------------------------------------------------------
# the scripts run
# --------------------------------------------------------------------------

def test_variant_selection_runs_on_the_host(tmp_path, monkeypatch):
    monkeypatch.setattr(variant_selection, "TRAIN_SIZES",
                        [(64, 64), (96, 128), (128, 64)])
    monkeypatch.setattr(variant_selection, "TEST_SIZES", [(80, 80)])
    monkeypatch.setattr(variant_selection, "EPOCHS", 300)     # not 25000
    out = str(tmp_path / "vs.json")
    res = variant_selection.run(out_path=out, device="cpu")
    case = res["cases"]["80x80"]
    assert set(case["times"]) == set(blur_ops.HOST_SCHEDULES)
    assert all(t > 0 for t in case["times"].values())
    assert case["regret_vs_best"] >= 1.0 and np.isfinite(res["train_mape"])
    assert variant_selection.run(out_path=out, device="cpu") == json.loads(
        Path(out).read_text())               # read back, nothing measured


def test_variant_selection_does_not_return_another_devices_document(
        tmp_path, monkeypatch):
    """A document the host wrote is measured anew when the card is asked
    for, and the card's is then reused."""
    monkeypatch.setattr(variant_selection, "TRAIN_SIZES",
                        [(64, 64), (96, 128)])
    monkeypatch.setattr(variant_selection, "TEST_SIZES", [(80, 80)])
    monkeypatch.setattr(variant_selection, "EPOCHS", 100)
    out = str(tmp_path / "vs.json")
    host = variant_selection.run(out_path=out, device="cpu")
    assert host["device"].startswith("torch-cpu")
    card = Fingerprint("torch-cuda", "Card A", 1, 8, ("float32",))
    timed = []

    def fake_time(sched, m, n, rng, device):
        timed.append(device)
        return 1e-6 * (1 + list(blur_ops.HOST_SCHEDULES).index(sched))

    monkeypatch.setattr(variant_selection, "current_fingerprint",
                        lambda device: card if device == "cuda"
                        else current_fingerprint(device))
    monkeypatch.setattr(variant_selection, "host_blur_time", fake_time)
    got = variant_selection.run(out_path=out, device="cuda")
    assert got["device"] == card.key and timed == ["cuda"] * (2 + 1) * 5
    assert variant_selection.run(out_path=out, device="cuda") == got
    assert len(timed) == 15                   # read back, nothing measured
    assert json.loads(Path(out).read_text()) == got


def _short_fits(monkeypatch):
    """The dispatcher's fits at 200 epochs, not ``quick``'s 3000: the
    runs' control flow is under test here, not the fit."""
    import repro_torch.runtime as runtime

    policy = runtime.DispatchPolicy
    monkeypatch.setattr(runtime, "DispatchPolicy", lambda **kw: policy(
        **{**kw, "fit_epochs": 200}))


def test_runtime_overhead_runs_on_the_host(tmp_path, monkeypatch):
    _short_fits(monkeypatch)
    res = runtime_overhead.run(quick=True, out_path=str(tmp_path / "rt.json"),
                               cache_root=str(tmp_path / "tc"), device="cpu")
    assert set(res) == {"quick", "fingerprint", "steady_overhead_s",
                        "steady_overhead_pct", "dispatches", "cases"}
    assert res["quick"] and res["fingerprint"]["backend"] == "torch-cpu"
    assert list(res["cases"]) == [f"{m}x{n}" for m, n
                                  in runtime_overhead.QUICK_SHAPES]
    for case in res["cases"].values():
        assert set(case) == {"chosen", "best", "chosen_time", "best_time",
                             "regret_vs_oracle", "speedup_vs_default"}
        assert case["regret_vs_oracle"] >= 1.0
    assert res["dispatches"] == 10 * len(runtime_overhead.QUICK_SHAPES)
    assert json.loads((tmp_path / "rt.json").read_text()) == res


def _exact_link(self, comm, pairs, **kw):
    """``SimLink.measure_into`` recording the link's exact seconds (the
    sleeps it times differ run to run)."""
    for src, dst in pairs:
        for nbytes in (1 << 12, 1 << 16, 1 << 20, 1 << 23):
            comm.record(src, dst, nbytes, self.seconds(nbytes))
        comm.fit(src, dst)


def test_executor_overlap_predicts_the_jax_makespans(tmp_path, monkeypatch):
    monkeypatch.setattr(jsimdev.SimLink, "measure_into", _exact_link)
    monkeypatch.setattr(simdev.SimLink, "measure_into", _exact_link)
    rows = {}
    for name, mod in (("jax", jexecutor_overlap), ("port", executor_overlap)):
        d = tmp_path / name
        rows[name] = mod.run(quick=True, out_csv=str(d / "o.csv"),
                             out_json=str(d / "o.json"),
                             out_trace=str(d / "t.json"),
                             root=str(d / "devs"))
        assert (d / "o.csv").exists() and (d / "t.json").exists()
    assert len(rows["port"]) == len(rows["jax"]) == 2
    for got, want in zip(rows["port"], rows["jax"]):
        for key in ("branches", "nodes", "transfers"):
            assert got[key] == want[key], key
        assert got["predicted_makespan_s"] == pytest.approx(
            want["predicted_makespan_s"], rel=1e-6)
        assert got["sequential_wall_s"] > 0 and got["async_wall_s"] > 0
    assert executor_overlap.summarize(rows["port"])[0] == \
        jexecutor_overlap.summarize(rows["jax"])[0]


def test_paper_cli_runs_on_the_host_and_needs_a_card_by_default(
        tmp_path, monkeypatch, capsys):
    """``--device cpu --quick`` over cut-down combos: the reference's
    trailer names; without ``--device cpu`` it raises here."""
    from repro_torch.paper.__main__ import main

    monkeypatch.chdir(tmp_path)
    run = tables.run
    monkeypatch.setattr(tables, "run", lambda epochs, combos=None, **kw:
                        run(epochs=60, combos=combos[:1], **kw))
    monkeypatch.setattr(runtime_overhead, "QUICK_SHAPES", [(64, 64),
                                                           (96, 96)])
    _short_fits(monkeypatch)
    main(["--device", "cpu", "--quick"])
    out = capsys.readouterr().out
    names = [ln.split(",")[0] for ln in out.split("name,us_per_call,derived")
             [1].split()]
    assert names == ["table4_7_nnc_mean_mae_s", "table4_7_nn_mean_mae_s",
                     "table8_nnc_mean_mape_pct", "nnc_vs_nn_mae_winrate",
                     "runtime_dispatch_overhead_pct",
                     "runtime_mean_regret_vs_oracle"]
    assert "CARD" not in out and "mm|eigen|i5" in out
    assert (tmp_path / "results" / "torch" / "paper_tables.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            main(["--quick"])
    # nothing beyond the host: the card combos were not touched
    assert not any("cuda" in p.name
                   for p in (tmp_path / "results" / "perfdata").iterdir())
