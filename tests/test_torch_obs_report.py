"""The rest of the port's obs layer (``repro_torch.obs``: ``cards``,
``slo``, ``report``, ``dashboard`` and the ``python -m repro_torch.obs``
CLI) and the bench history CLI against the JAX package's.

Each case feeds both packages the same input — a tunecache either package
seeded, a telemetry file the port saved, the committed sample results, an
empty directory — and holds the port's output to the JAX function's:
equal documents, equal text, equal exit codes, and the same HTML page
with its generation time masked.
"""
import json
import os
import re

import pytest

import repro.api  # noqa: F401  (before repro.workloads: import cycle)
from repro.bench.__main__ import main as jbench_main
from repro.obs import DEFAULT_SERVE_SLOS as JDEFAULT_SERVE_SLOS
from repro.obs import SLO as JSLO
from repro.obs import evaluate_slos as jevaluate_slos
from repro.obs import format_slos as jformat_slos
from repro.obs.cards import build_cards as jbuild_cards
from repro.obs.cards import format_cards as jformat_cards
from repro.obs.dashboard import render_dashboard as jrender_dashboard
from repro.obs.report import format_summary as jformat_summary
from repro.obs.report import main as jreport_main
from repro.obs.telemetry import summarize_doc as jsummarize_doc
from repro.runtime import Dispatcher as JDispatcher
from repro.runtime import Fingerprint as JFingerprint
from repro.runtime import TuningCache as JTuningCache
from repro.runtime.seeding import seed_from_programs as jseed
from repro.workloads import get_workload as jget_workload
from repro.workloads import suite_registry as jsuite_registry
import repro_torch.obs as obs
from repro_torch.bench.__main__ import main as bench_main
from repro_torch.obs import (DEFAULT_SERVE_SLOS, SLO, Telemetry, build_cards,
                             burned, evaluate_slos, format_cards,
                             format_slos, format_summary, load_slos,
                             render_dashboard, write_dashboard)
from repro_torch.obs.report import main as report_main
from repro_torch.runtime import Dispatcher, Fingerprint, TuningCache
from repro_torch.runtime.seeding import seed_from_programs
from repro_torch.workloads import get_workload, suite_registry

SAMPLE_RESULTS = "benchmarks/sample_results"
SAMPLE_TELEMETRY = os.path.join(SAMPLE_RESULTS, "telemetry_adaptive.json")
SAMPLE_TRACE = os.path.join(SAMPLE_RESULTS, "exec_trace_adaptive.json")
SECTION_TITLES = ("SLO status", "Bench history", "Memory ledger",
                  "Drift timelines", "Predictor model cards")
CARDS_FP = ("sim", "cards", 1, 1, ("float32",))
STAMP = re.compile(r"generated \d{4}-\d\d-\d\d \d\d:\d\d:\d\d ")


def _warm_cache(tmp_path, package: str, workload="image_pipeline"):
    """Seed + fit a multi-kernel tunecache off a bench workload with
    ``package``'s own seeding."""
    root = str(tmp_path / "tc")
    if package == "jax":
        reg = jsuite_registry([workload])
        built = jget_workload(workload).build("small", registry=reg)
        cache = JTuningCache(root=root, fingerprint=JFingerprint(*CARDS_FP))
        kernels = jseed(JDispatcher(registry=reg, cache=cache),
                        [built.program], 1e9, reset=True)
    else:
        reg = suite_registry([workload])
        built = get_workload(workload).build("small", registry=reg,
                                             device="cpu")
        cache = TuningCache(root=root, fingerprint=Fingerprint(*CARDS_FP))
        kernels = seed_from_programs(Dispatcher(registry=reg, cache=cache),
                                     [built.program], 1e9, reset=True)
    return root, Fingerprint(*CARDS_FP), sorted(kernels)


def _run(main, argv, capsys) -> tuple:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _same_cli(port_main, jax_main, argv, capsys) -> tuple:
    """Both CLIs on ``argv``: equal exit codes and standard output."""
    got = _run(port_main, argv, capsys)
    want = _run(jax_main, argv, capsys)
    assert got[:2] == want[:2], (got, want)
    return got


# --------------------------------------------------------------------------
# model cards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("package", ["jax", "port"])
def test_cards_cover_every_kernel_in_warmed_tunecache(tmp_path, package):
    root, fp, kernels = _warm_cache(tmp_path, package)
    assert len(kernels) >= 2
    cards = build_cards(cache_root=root, telemetry_patterns=())
    assert cards == jbuild_cards(cache_root=root, telemetry_patterns=())
    assert sorted(c["kernel"] for c in cards) == kernels
    for c in cards:
        assert "error" not in c
        assert c["fingerprint"]["key"] == fp.key
        assert c["fitted"] and c["model"]
        assert c["n_rows"] > 0 and c["n_buckets"] > 0
        assert isinstance(c["fit_mape_pct"], float)
    assert format_cards(cards) == jformat_cards(cards)
    text = "\n".join(format_cards(cards))
    for k in kernels:
        assert f"== {k} @ {fp.key} ==" in text


def test_cards_fold_live_telemetry_stats(tmp_path):
    root, _, kernels = _warm_cache(tmp_path, "port")
    k = kernels[0]
    tel = Telemetry()
    for pred, actual in ((1.0, 1.1), (1.0, 1.3), (2.0, 2.1)):
        tel.residual(k, pred, actual, fit_band_pct=15.0)
    tel.count(f"dispatch.by_kernel.{k}.nn", 7)
    tel.count(f"dispatch.by_kernel.{k}.measured", 2)
    tel.count(f"gate.by_kernel.{k}.accept", 3)
    tel.count(f"gate.by_kernel.{k}.reject", 1)
    path = str(tmp_path / "telemetry_x.json")
    tel.save(path)
    cards = build_cards(cache_root=root, telemetry_patterns=(path,))
    assert cards == jbuild_cards(cache_root=root, telemetry_patterns=(path,))
    card = next(c for c in cards if c["kernel"] == k)
    assert card["sources"] == [path]
    assert card["n_residuals"] == 3
    assert card["live_mape_pct"] == pytest.approx(
        100 * (0.1 / 1.1 + 0.3 / 1.3 + 0.1 / 2.1) / 3, rel=1e-6)
    assert card["decisions"] == {"nn": 7, "measured": 2}
    assert card["gate"]["accept_rate"] == pytest.approx(0.75)
    cal = card["calibration"]
    assert cal["window"] == 3
    assert cal["within_band_frac"] == pytest.approx(2 / 3)
    assert cal["within_2x_band_frac"] == pytest.approx(1.0)
    assert format_cards(cards) == jformat_cards(cards)


def test_cards_render_error_card_for_stale_entry(tmp_path):
    fp_dir = tmp_path / "tc" / "someprint"
    fp_dir.mkdir(parents=True)
    (fp_dir / "fingerprint.json").write_text(
        json.dumps({"backend": "sim", "device_kind": "x"}))
    (fp_dir / "broken.json").write_text(json.dumps({"version": 999}))
    root = str(tmp_path / "tc")
    cards = build_cards(cache_root=root, telemetry_patterns=())
    assert cards == jbuild_cards(cache_root=root, telemetry_patterns=())
    assert [c["kernel"] for c in cards] == ["broken"]
    assert "error" in cards[0]
    assert format_cards([]) == jformat_cards([])


def test_cards_over_the_committed_sample_tunecache():
    root = os.path.join(SAMPLE_RESULTS, "tunecache")
    pattern = (os.path.join(SAMPLE_RESULTS, "telemetry_*.json"),)
    cards = build_cards(cache_root=root, telemetry_patterns=pattern)
    assert cards == jbuild_cards(cache_root=root, telemetry_patterns=pattern)
    assert len(cards) == 6 and all("error" not in c for c in cards)
    assert format_cards(cards) == jformat_cards(cards)


def test_cards_cli(tmp_path, capsys):
    root, _, kernels = _warm_cache(tmp_path, "port")
    rc, out, _ = _same_cli(report_main, jreport_main,
                           ["cards", "--json", "--root", root,
                            "--telemetry", str(tmp_path / "none_*.json")],
                           capsys)
    assert rc == 0
    assert sorted(c["kernel"] for c in json.loads(out)) == kernels


# --------------------------------------------------------------------------
# SLOs and the report CLI
# --------------------------------------------------------------------------

def _serve_telemetry(tmp_path, ttft=0.01, n=20):
    tel = Telemetry()
    for i in range(n):
        tel.observe("serve.ttft_s", ttft * (1 + 0.01 * i))
        tel.observe("serve.token_latency_s", ttft / 10)
    path = str(tmp_path / "telemetry_serve.json")
    tel.save(path)
    return path


def test_evaluate_slos_met_burned_and_no_data(tmp_path):
    doc = Telemetry.load(_serve_telemetry(tmp_path))
    spec = (("serve.ttft_s", 99, 1.0), ("serve.ttft_s", 50, 1e-6),
            ("absent.metric", 50, 1.0), ("serve.ttft_s", "mean", 1.0))
    rows = evaluate_slos(tuple(SLO(*s) for s in spec), doc)
    assert rows == jevaluate_slos(tuple(JSLO(*s) for s in spec), doc)
    assert [r["met"] for r in rows] == [True, False, None, True]
    assert rows[1]["burn_rate"] > 1.0
    assert rows[2]["observed"] is None and rows[2]["burn_rate"] is None
    assert [r["slo"] for r in burned(rows)] == ["serve.ttft_s:p50"]
    assert format_slos(rows, path="x") == jformat_slos(rows, path="x")
    assert format_slos([]) == jformat_slos([])
    assert evaluate_slos(DEFAULT_SERVE_SLOS, doc) == jevaluate_slos(
        JDEFAULT_SERVE_SLOS, doc)


def test_load_slos_reads_a_spec_and_refuses_a_bad_one(tmp_path):
    from repro.obs.slo import load_slos as jload_slos
    spec = tmp_path / "slo.json"
    spec.write_text(json.dumps([{"metric": "serve.ttft_s", "percentile": 50,
                                 "target": 0.1, "name": "fast"},
                                {"metric": "m", "percentile": "mean",
                                 "target": 2}]))
    got = load_slos(str(spec))
    assert [s.label for s in got] == ["fast", "m:mean"]
    assert [s.label for s in got] == [s.label for s in jload_slos(str(spec))]
    for text in ("{}", json.dumps([{"metric": "m"}])):
        spec.write_text(text)
        with pytest.raises(ValueError):
            load_slos(str(spec))


def test_report_slo_exit_codes(tmp_path, capsys):
    path = _serve_telemetry(tmp_path)
    rc, out, _ = _same_cli(report_main, jreport_main,
                           ["report", path, "--slo"], capsys)
    assert rc == 0 and "all evaluated SLOs met" in out
    spec = str(tmp_path / "slo.json")
    with open(spec, "w") as f:
        json.dump([{"metric": "serve.ttft_s", "percentile": 50,
                    "target": 1e-9, "name": "impossible"}], f)
    rc, out, _ = _same_cli(report_main, jreport_main,
                           ["report", path, "--slo", spec], capsys)
    assert rc == 1 and "SLO BURN" in out
    rc, _, _ = _same_cli(report_main, jreport_main,
                         ["report", path, "--slo",
                          str(tmp_path / "nope.json")], capsys)
    assert rc == 2


@pytest.mark.parametrize("extra", [[], ["--json"], ["--check"],
                                   ["--check", "--factor", "1e6"],
                                   ["--trace", SAMPLE_TRACE],
                                   ["--json", "--trace", SAMPLE_TRACE]],
                         ids=["text", "json", "check", "check-loose",
                              "trace", "json-trace"])
def test_report_matches_the_jax_cli(capsys, extra):
    rc, out, _ = _same_cli(report_main, jreport_main,
                           ["report", SAMPLE_TELEMETRY] + extra, capsys)
    assert rc in (0, 1) and out
    if extra[:1] == ["--json"]:
        json.loads(out)


def test_report_exits_2_on_an_unreadable_file(tmp_path, capsys):
    bad = tmp_path / "telemetry_bad.json"
    bad.write_text("not json")
    for argv in (["report", str(bad)],
                 ["report", SAMPLE_TELEMETRY, "--trace", str(bad)],
                 ["explain", str(bad)],
                 ["explain", SAMPLE_TELEMETRY.replace(
                     "telemetry_adaptive", "bench")]):
        rc, _, _ = _same_cli(report_main, jreport_main, argv, capsys)
        assert rc == 2, argv


def test_format_summary_matches_the_jax_function():
    doc = Telemetry.load(SAMPLE_TELEMETRY)
    summary = obs.summarize_doc(doc)
    assert summary == jsummarize_doc(doc)
    assert format_summary(summary, path="p") == jformat_summary(summary,
                                                                path="p")


@pytest.mark.parametrize("extra", [[], ["--json"], ["--check-band"]],
                         ids=["text", "json", "check-band"])
def test_explain_cli_matches_the_jax_cli(tmp_path, capsys, extra):
    out = str(tmp_path / "explain.json")
    rc, text, _ = _same_cli(
        report_main, jreport_main,
        ["explain", SAMPLE_TRACE, SAMPLE_TELEMETRY, "-o", out] + extra,
        capsys)
    assert rc in (0, 1) and text
    assert json.load(open(out))["traces"][SAMPLE_TRACE]


def test_obs_module_runs_as_a_cli():
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report",
                          SAMPLE_TELEMETRY, "--json"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["run_id"]


# --------------------------------------------------------------------------
# bench history --json
# --------------------------------------------------------------------------

def test_bench_history_json_flag(capsys):
    sample = os.path.join(SAMPLE_RESULTS, "bench.json")
    rc, out, _ = _same_cli(bench_main, jbench_main,
                           ["history", sample, "--json"], capsys)
    assert rc == 0
    rows = json.loads(out)
    assert isinstance(rows, list) and rows[0]["file"] == sample
    assert rows[0]["n_workloads"] > 0
    assert isinstance(rows[0]["geomean_vs_default"], dict)


def test_bench_history_table_and_no_documents(tmp_path, capsys):
    rc, out, _ = _same_cli(bench_main, jbench_main,
                           ["history", os.path.join(SAMPLE_RESULTS, "*.json"),
                            "benchmarks/*bench*.json"], capsys)
    assert rc == 0 and "bench_serve.json" in out
    rc, _, _ = _same_cli(bench_main, jbench_main,
                         ["history", str(tmp_path / "*.json")], capsys)
    assert rc == 2


# --------------------------------------------------------------------------
# dashboard
# --------------------------------------------------------------------------

def _masked(page: str) -> str:
    assert len(STAMP.findall(page)) == 1
    return STAMP.sub("generated <time> ", page)


def test_dashboard_renders_offline_from_sample_results():
    doc = render_dashboard(results_dir=SAMPLE_RESULTS)
    assert _masked(doc) == _masked(jrender_dashboard(
        results_dir=SAMPLE_RESULTS))
    for title in SECTION_TITLES:
        assert f"<h2>{title}</h2>" in doc
    for needle in ("http://", "https://", "src=", "@import", "url(",
                   "<link"):
        assert needle not in doc, needle
    assert "no data</p>" not in doc
    assert 'class="empty"' not in doc
    assert doc.count("<svg") >= 3
    assert 'class="card"' in doc
    assert "BURNED" not in doc
    assert "&#10003; ok" in doc
    assert doc.count("<polyline") >= 2


def test_dashboard_with_a_burning_slo_set():
    slos = (SLO("serve.ttft_s", 50, 1e-9, name="impossible"),)
    doc = render_dashboard(results_dir=SAMPLE_RESULTS, slos=slos)
    want = jrender_dashboard(results_dir=SAMPLE_RESULTS, slos=(
        JSLO("serve.ttft_s", 50, 1e-9, name="impossible"),))
    assert _masked(doc) == _masked(want)
    assert "BURNED" in doc


def test_dashboard_tolerates_empty_results_dir(tmp_path):
    out = str(tmp_path / "dash" / "dashboard.html")
    empty = str(tmp_path / "nothing")
    written = write_dashboard(out, results_dir=empty)
    assert written == out and os.path.exists(out)
    doc = open(out).read()
    assert _masked(doc) == _masked(jrender_dashboard(results_dir=empty))
    for title in SECTION_TITLES:
        assert f"<h2>{title}</h2>" in doc
    assert 'class="empty"' in doc
    assert not os.path.exists(out + ".tmp")


def test_dashboard_cli_writes_file(tmp_path, capsys):
    out = str(tmp_path / "dashboard.html")
    rc, text, _ = _run(report_main, ["dashboard", "-o", out,
                                     "--results-dir", SAMPLE_RESULTS],
                       capsys)
    assert rc == 0 and os.path.exists(out)
    assert f"wrote {out}" in text
    jout = str(tmp_path / "jax.html")
    rc, text, _ = _run(jreport_main, ["dashboard", "-o", jout,
                                      "--results-dir", SAMPLE_RESULTS],
                       capsys)
    assert rc == 0 and f"wrote {jout}" in text
    assert _masked(open(out).read()) == _masked(open(jout).read())
    rc, _, _ = _same_cli(report_main, jreport_main,
                         ["dashboard", "-o", out, "--slo",
                          str(tmp_path / "nope.json")], capsys)
    assert rc == 2
