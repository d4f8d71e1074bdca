"""The port's bench layer (``repro_torch.bench``,
``repro_torch.runtime.measure_from_programs``) against the JAX package's
(``repro.bench``, ``repro.runtime.measure_from_programs``).

One quick run of each package is shared by the module: the JAX bench over
its ``simdev2`` config (its ``cpu`` config reaches the Pallas conv2d, which
jax 0.9.0 cannot run), the port's over ``cpu`` and ``simdev2``, both with
the adaptive section.  The simulated link's comm model is normally timed
from wall-clock sleeps, which no two runs repeat; here both packages
record the link's exact seconds instead, so their EFT schedules see the
same transfer prices.  Tolerances: predicted makespans to rtol 1e-6, the
seeded caches' MAPE to 1e-6 percentage points, counts, kernel lists and
operands exactly; compare, history and fold outputs are equal.
"""
import copy
import dataclasses
import itertools
import json
import os

import numpy as np
import pytest
import torch

import repro.api  # noqa: F401  (before repro.workloads: import cycle)
import repro.bench as jbench
import repro.runtime.simdev as jsimdev
from repro.bench.__main__ import main as jbench_main
from repro.core.nnc import LinearModel as JLinearModel
from repro.runtime import Dispatcher as JDispatcher
from repro.runtime import Fingerprint as JFingerprint
from repro.runtime import KernelRegistry as JKernelRegistry
from repro.runtime import TuningCache as JTuningCache
from repro.runtime import measure_from_programs as jmeasure
from repro.workloads import get_workload as jget_workload
from repro.workloads import suite_registry as jsuite_registry
import repro_torch.runtime.simdev as simdev
from repro_torch.bench import (BENCH_SCHEMA_VERSION, compare_docs,
                               fold_external, load_bench, run_bench,
                               validate_bench)
from repro_torch.bench.__main__ import main as bench_main
from repro_torch.bench.history import load_row
from repro_torch.core.nnc import LinearModel
from repro_torch.runtime import (Dispatcher, Fingerprint, KernelRegistry,
                                 TuningCache, measure_from_programs)
from repro_torch.workloads import get_workload, suite_registry, workload_names

WORKLOADS = ["attention_block", "decode_microbatch", "image_pipeline",
             "mixed_dag", "mlp_block"]
MODES = ("best", "default", "worst")
SAMPLES = ("benchmarks/sample_results/bench.json",
           "benchmarks/baseline_bench.json")
MAKESPAN_RTOL = 1e-6
MAPE_TOL_PP = 1e-6


def _exact_link(sizes):
    """``SimLink.measure_into`` recording the link's exact seconds."""
    def measure_into(self, comm, pairs, **kw):
        for src, dst in pairs:
            for nbytes in sizes:
                comm.record(src, dst, int(nbytes), self.seconds(nbytes))
            comm.fit(src, dst)
    return measure_into


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    from repro.exec.comm import DEFAULT_SIZES as JSIZES
    from repro_torch.exec.comm import DEFAULT_SIZES

    root = tmp_path_factory.mktemp("bench")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsimdev.SimLink, "measure_into", _exact_link(JSIZES))
        mp.setattr(simdev.SimLink, "measure_into", _exact_link(DEFAULT_SIZES))
        jdoc = jbench.run_bench(
            quick=True, configs=("simdev2",),
            out_path=str(root / "jax" / "bench.json"),
            results_dir=str(root / "jax"))
        doc = run_bench(quick=True, configs=("cpu", "simdev2"),
                        out_path=str(root / "port" / "bench.json"),
                        results_dir=str(root / "port"))
    return {"jax": jdoc, "port": doc, "root": root,
            "path": str(root / "port" / "bench.json"),
            "jax_path": str(root / "jax" / "bench.json")}


# --------------------------------------------------------------------------
# simdev2 and the adaptive section against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", WORKLOADS)
def test_simdev2_schedules_match_the_jax_document(docs, name):
    got, want = docs["port"]["workloads"][name], docs["jax"]["workloads"][name]
    for key in ("kernels", "n_nodes", "size"):
        assert got[key] == want[key], key
    g, w = got["configs"]["simdev2"], want["configs"]["simdev2"]
    assert g["n_transfers"] == w["n_transfers"]
    for mode in MODES:
        assert g["predicted_makespan_s"][mode] == pytest.approx(
            w["predicted_makespan_s"][mode], rel=MAKESPAN_RTOL), mode
    assert set(g["mape"]) == set(w["mape"])
    for kernel, v in w["mape"].items():
        assert abs(g["mape"][kernel] - v) <= MAPE_TOL_PP, kernel


def test_simdev2_device_mape_matches_the_jax_document(docs):
    got = docs["port"]["configs"]["simdev2"]
    want = docs["jax"]["configs"]["simdev2"]
    assert got["devices"] == want["devices"] == ["d0", "d1"]
    assert (got["kind"], got["executor"]) == (want["kind"], want["executor"])
    for dev, kernels in want["device_mape"].items():
        assert set(got["device_mape"][dev]) == set(kernels)
        for kernel, m in kernels.items():
            g = got["device_mape"][dev][kernel]
            assert g["n_rows"] == m["n_rows"]
            assert abs(g["mape_pct"] - m["mape_pct"]) <= MAPE_TOL_PP


@pytest.mark.parametrize("name", WORKLOADS)
def test_simdev2_best_beats_worst(docs, name):
    for pkg in ("port", "jax"):
        walls = docs[pkg]["workloads"][name]["configs"]["simdev2"]["wall_s"]
        assert walls["best"] < walls["worst"], (pkg, walls)
    assert docs["port"]["geomean"]["simdev2"]["speedup_vs_worst"] > 1.05


def test_adaptive_section_records_steals_feedback_and_exactness(docs):
    for pkg in ("port", "jax"):
        ad = docs[pkg]["adaptive"]
        assert ad["devices"]["d0"]["claimed_flops_per_s"] > \
            ad["devices"]["d0"]["true_flops_per_s"]
        assert ad["geomean_speedup_vs_static"] > 0
        assert sum(w["n_steals"] for w in ad["workloads"].values()) >= 1
        assert all(w["refits"] > 0 for w in ad["workloads"].values())
        assert all(w["bit_exact"] for w in ad["workloads"].values())
        for w in ad["workloads"].values():
            for key in ("static_wall_s", "adaptive_wall_s", "replan_wall_s",
                        "speedup_vs_static", "replan_speedup_vs_static"):
                assert w[key] > 0
    port, jax_ = docs["port"]["adaptive"], docs["jax"]["adaptive"]
    assert port["devices"] == jax_["devices"]
    assert set(port["workloads"]) == set(jax_["workloads"])
    for key in ("trace_path", "telemetry_path"):
        assert os.path.exists(port[key])


# --------------------------------------------------------------------------
# the schema
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", SAMPLES)
def test_schema_accepts_the_committed_documents(path):
    doc = load_bench(path)
    assert doc["schema"] in (2, 4)
    assert set(doc["workloads"]) == set(workload_names())


def test_documents_validate_in_both_packages(docs):
    reloaded = load_bench(docs["path"])
    assert reloaded == json.loads(json.dumps(docs["port"]))
    assert reloaded["schema"] == BENCH_SCHEMA_VERSION
    assert reloaded["quick"] is True
    jbench.validate_bench(copy.deepcopy(reloaded))
    validate_bench(jbench.load_bench(docs["jax_path"]))


def _workload(d):
    return next(iter(d["workloads"].values()))


MALFORMED = {
    "schema": lambda d: d.__setitem__("schema", 99),
    "no-workloads": lambda d: d.__delitem__("workloads"),
    "empty-geomean": lambda d: d.__setitem__("geomean", {}),
    "no-worst-wall": lambda d: _workload(d)["configs"]["cpu"]["wall_s"]
    .__delitem__("worst"),
    "speedup-string": lambda d: _workload(d)["configs"]["cpu"]
    .__setitem__("speedup_vs_worst", "fast"),
    "undeclared-config": lambda d: d["workloads"].__setitem__(
        "rogue", {"size": "small", "kernels": ["matmul"], "n_nodes": 1,
                  "configs": {"undeclared_cfg": {}}}),
    "adaptive-no-geomean": lambda d: d["adaptive"]
    .__delitem__("geomean_speedup_vs_static"),
    "adaptive-no-steals": lambda d: next(iter(
        d["adaptive"]["workloads"].values())).__delitem__("n_steals"),
    "adaptive-exact-string": lambda d: next(iter(
        d["adaptive"]["workloads"].values())).__setitem__("bit_exact",
                                                          "yes"),
    "adaptive-on-schema-1": lambda d: d.__setitem__("schema", 1),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_schema_rejects_malformed(docs, case):
    bad = copy.deepcopy(docs["port"])
    MALFORMED[case](bad)
    with pytest.raises(ValueError, match="bench.json invalid") as got:
        validate_bench(bad)
    with pytest.raises(ValueError, match="bench.json invalid") as want:
        jbench.validate_bench(bad)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the real configs
# --------------------------------------------------------------------------

def test_cpu_config_measures_every_kernel(docs):
    doc = docs["port"]
    cfg = doc["configs"]["cpu"]
    assert (cfg["kind"], cfg["executor"], cfg["devices"]) == \
        ("real", "sequential", ["local"])
    assert doc["host_fingerprint"]["backend"] == "torch-cpu"
    measured = cfg["device_mape"]["local"]
    for name, w in doc["workloads"].items():
        r = w["configs"]["cpu"]
        assert set(r["mape"]) == set(w["kernels"]), name
        assert set(w["kernels"]) <= set(measured)
        assert all(r["wall_s"][m] > 0 for m in MODES)
        assert 0.0 <= r["overhead"]["dispatch_frac"] <= 1.0
        assert 0.0 <= r["overhead"]["executor_frac"] <= 1.0
        assert r["telemetry"]["decisions"]["dispatch.pinned"] > 0
        assert r["attribution"]["buckets"]


def test_cuda_config_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda config runs")
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_bench(quick=True, out_path=str(tmp_path / "b.json"),
                  results_dir=str(tmp_path), configs=("cuda",))
    assert not (tmp_path / "b.json").exists()


def test_run_rejects_unknown_config(tmp_path):
    for run in (run_bench, jbench.run_bench):
        with pytest.raises(ValueError, match="unknown configs"):
            run(quick=True, out_path=str(tmp_path / "b.json"),
                results_dir=str(tmp_path), configs=("tpu-pod",))


def test_run_and_adaptive_cli(tmp_path, capsys):
    out = str(tmp_path / "bench.json")
    assert bench_main(["run", "--quick", "--configs", "cpu", "--workloads",
                       "mlp_block", "--out", out, "--results-dir",
                       str(tmp_path)]) == 0
    doc = load_bench(out)
    assert list(doc["workloads"]) == ["mlp_block"] and "adaptive" not in doc
    assert bench_main(["adaptive", "--quick", "--workloads",
                       "decode_microbatch", "--out", out, "--results-dir",
                       str(tmp_path)]) in (0, 1)
    doc = load_bench(out)
    assert doc["adaptive"]["workloads"]["decode_microbatch"]["bit_exact"]
    assert f"merged adaptive section into {out}" in capsys.readouterr().out
    assert bench_main(["adaptive", "--out",
                       str(tmp_path / "ghost.json")]) == 2


# --------------------------------------------------------------------------
# measure_from_programs
# --------------------------------------------------------------------------

def _recording(registry, kernel_registry, calls):
    """A copy of ``registry`` whose variants record their operands."""
    out = kernel_registry()
    for name in registry.kernels():
        rk = registry.get(name)

        def variant(v):
            def call(args, params):
                calls.append((v.kernel, v.name,
                              [np.asarray(a) for a in args]))
            return dataclasses.replace(v, call=call)
        out.register(dataclasses.replace(
            rk, variants=tuple(variant(v) for v in rk.variants)))
    return out


def _fake_clock():
    tick = itertools.count(1)
    return lambda fn, min_window=0.0: (fn(), 1e-3 * next(tick))[1]


def test_measure_from_programs_draws_the_references_operands(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr("repro.perfdata.measure.time_callable",
                        _fake_clock())
    monkeypatch.setattr("repro_torch.runtime.seeding.time_callable",
                        _fake_clock())
    fp = ("sim", "measure", 1, 1, ("float32",))
    jcalls, calls = [], []
    jreg = _recording(jsuite_registry(["mlp_block"]), JKernelRegistry,
                      jcalls)
    reg = _recording(suite_registry(["mlp_block"]), KernelRegistry, calls)
    jprog = jget_workload("mlp_block").build("small", registry=jreg).program
    prog = get_workload("mlp_block").build("small", registry=reg,
                                           device="cpu").program
    jdisp = JDispatcher(registry=jreg, cache=JTuningCache(
        root=str(tmp_path / "jax"), fingerprint=JFingerprint(*fp)))
    disp = Dispatcher(registry=reg, cache=TuningCache(
        root=str(tmp_path / "port"), fingerprint=Fingerprint(*fp)))
    want = jmeasure(jdisp, [jprog], best_of=2, reset=True,
                    model_factory=JLinearModel)
    got = measure_from_programs(disp, [prog], device="cpu", best_of=2,
                                reset=True, model_factory=LinearModel)
    assert got == want == ["matmul"]
    assert len(calls) == len(jcalls) > 0
    for (k, v, args), (jk, jv, jargs) in zip(calls, jcalls):
        assert (k, v) == (jk, jv)
        assert len(args) == len(jargs) == 2
        for a, ja in zip(args, jargs):
            assert a.dtype == ja.dtype and np.array_equal(a, ja)
    for kernel in got:
        e, je = disp.cache.entry(kernel), jdisp.cache.entry(kernel)
        assert e.n_rows == je.n_rows
        np.testing.assert_array_equal(e.X, je.X)
        np.testing.assert_array_equal(e.y, je.y)


def test_measure_from_programs_needs_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    reg = suite_registry(["mlp_block"])
    prog = get_workload("mlp_block").build("small", registry=reg,
                                           device="cpu").program
    disp = Dispatcher(registry=reg, cache=TuningCache(
        root=str(tmp_path), fingerprint=Fingerprint(
            "sim", "measure", 1, 1, ("float32",))))
    with pytest.raises(RuntimeError, match="CUDA device"):
        measure_from_programs(disp, [prog])


# --------------------------------------------------------------------------
# compare, history and fold_external against the JAX package
# --------------------------------------------------------------------------

def _set(path, value):
    def mutate(d):
        node = d
        for key in path[:-1]:
            node = node[key] if key != "*" else next(iter(node.values()))
        node[path[-1]] = value(node[path[-1]]) if callable(value) else value
    return mutate


def _drop_first_workload(d):
    del d["workloads"][next(iter(d["workloads"]))]


def _drop_adaptive(d):
    del d["adaptive"]


# case -> (mutation of the new document, compare kwargs, swap the pair)
COMPARE = {
    "clean": (lambda d: None, {}, False),
    "geomean-collapse": (_set(("geomean", "simdev2", "speedup_vs_worst"),
                              0.5), {}, False),
    "workload-missing": (_drop_first_workload, {}, False),
    "mape-drift": (_set(("workloads", "*", "configs", "cpu", "mape",
                         "matmul"), lambda v: v + 50.0), {}, False),
    "real-drift-sim-gate": (_set(("workloads", "*", "configs", "cpu",
                                  "mape", "matmul"), lambda v: v + 500.0),
                            {"only_kind": "sim"}, False),
    "real-drift-real-gate": (_set(("workloads", "*", "configs", "cpu",
                                   "mape", "matmul"), lambda v: v + 500.0),
                             {"only_kind": "real"}, False),
    "sim-collapse-sim-gate": (_set(("geomean", "simdev2",
                                    "speedup_vs_worst"), 0.5),
                              {"only_kind": "sim"}, False),
    "sim-collapse-real-gate": (_set(("geomean", "simdev2",
                                     "speedup_vs_worst"), 0.5),
                               {"only_kind": "real"}, False),
    "adaptive-collapse": (_set(("adaptive", "geomean_speedup_vs_static"),
                               0.1), {"only_kind": "sim"}, False),
    "adaptive-collapse-real-gate": (_set(("adaptive",
                                          "geomean_speedup_vs_static"), 0.1),
                                    {"only_kind": "real"}, False),
    "adaptive-not-exact": (_set(("adaptive", "workloads", "*", "bit_exact"),
                                False), {}, False),
    "adaptive-gone": (_drop_adaptive, {}, False),
    "adaptive-new": (_drop_adaptive, {}, True),
}


@pytest.mark.parametrize("case", sorted(COMPARE))
def test_compare_docs_matches_the_jax_function(docs, case):
    mutate, kw, swap = COMPARE[case]
    base = docs["port"]
    new = copy.deepcopy(base)
    mutate(new)
    pair = (new, base) if swap else (base, new)
    got = compare_docs(*pair, **kw)
    assert got == jbench.compare_docs(*pair, **kw)
    regs, notes = got
    assert bool(regs) == (case not in ("clean", "real-drift-sim-gate",
                                       "sim-collapse-real-gate",
                                       "adaptive-collapse-real-gate",
                                       "adaptive-new")), regs
    if case == "adaptive-new":
        assert any("adaptive section new" in n for n in notes)


def test_compare_rejects_an_unknown_kind(docs):
    for compare in (compare_docs, jbench.compare_docs):
        with pytest.raises(ValueError, match="only_kind"):
            compare(docs["port"], docs["port"], only_kind="gpu")


def test_compare_cli_exit_codes(docs, tmp_path):
    out = docs["path"]
    worse = copy.deepcopy(docs["port"])
    for g in worse["geomean"].values():
        g["speedup_vs_worst"] *= 0.5
    worse_path = str(tmp_path / "worse.json")
    with open(worse_path, "w") as f:
        json.dump(worse, f)
    (tmp_path / "junk.json").write_text("{}")
    for main in (bench_main, jbench_main):
        assert main(["compare", out, out]) == 0
        assert main(["compare", out, worse_path]) == 1
        assert main(["compare", out, str(tmp_path / "ghost.json")]) == 2
        assert main(["compare", str(tmp_path / "junk.json"), out]) == 2


@pytest.mark.parametrize("path", SAMPLES + ("benchmarks/sample_results/"
                                            "bench_serve.json",
                                            "benchmarks/run.py"))
def test_history_rows_match_the_jax_function(path):
    from repro.bench.history import load_row as jload_row
    assert load_row(path) == jload_row(path)


def test_history_rows_of_both_runs_match(docs):
    from repro.bench.history import format_history as jformat
    from repro.bench.history import load_row as jload_row
    from repro_torch.bench.history import format_history

    rows = [load_row(p) for p in (docs["path"], docs["jax_path"])]
    assert rows == [jload_row(p) for p in (docs["path"], docs["jax_path"])]
    assert format_history(rows) == jformat(rows)
    assert rows[0]["n_workloads"] == 5 and rows[0]["top_bottleneck"]


def _external_artifacts(root, overlap_csv: bool):
    root.mkdir()
    (root / "runtime_overhead.json").write_text(json.dumps({
        "steady_overhead_pct": 2.5, "dispatches": 40,
        "cases": {"512x512": {"regret_vs_oracle": 1.1,
                              "speedup_vs_default": 1.3}}}))
    if overlap_csv:
        (root / "executor_overlap.csv").write_text(
            "branches,overlap_speedup\n2,1.4\n4,1.6\n")
    else:
        (root / "executor_overlap.json").write_text(json.dumps({
            "rows": [{"branches": 2, "overlap_speedup": 1.4},
                     {"branches": 4, "overlap_speedup": 1.6}]}))
    (root / "paper_tables.json").write_text(json.dumps({
        "mm/cpu": {"nnc": {"mape": 4.0}, "nn": {"mape": 9.0}},
        "mv/cpu": {"nnc": {"mape": 6.0}, "nn": {"mape": 11.0}}}))


@pytest.mark.parametrize("overlap_csv", [False, True])
def test_fold_external_matches_the_jax_function(tmp_path, overlap_csv):
    root = tmp_path / "results"
    _external_artifacts(root, overlap_csv)
    ext = fold_external(str(root))
    assert ext == jbench.fold_external(str(root))
    assert ext["runtime_overhead"]["steady_overhead_pct"] == 2.5
    assert ext["runtime_overhead"]["mean_regret_vs_oracle"] == \
        pytest.approx(1.1)
    assert ext["executor_overlap"]["best_overlap_speedup"] == \
        pytest.approx(1.6)
    assert ext["paper_tables"]["nnc_mean_mape_pct"] == pytest.approx(5.0)
    assert fold_external(str(tmp_path / "empty")) == {}
