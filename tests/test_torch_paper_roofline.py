"""``repro_torch.paper.roofline`` and ``paper.kernel_projection`` against
the JAX package's ``benchmarks/roofline_bench.py`` and
``benchmarks/kernel_projection.py``.

``summarize`` gives the reference's lines on the same document, each cell
line with one column more (the sharded argument figure; "-" where the
document has none), over a synthetic document and over one the port's
dry-run wrote at ``reduced()``.  ``kernel_boundary_traffic`` equals the
reference's, and ``project_cell`` equals it given the same plain-path
traffic and memory rate; the plain path's traffic itself comes from the
dry-run's op counter (the reference lowers HLO).  ``python -m
repro_torch.paper`` prints the table where a document exists.
"""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:            # the JAX package's benchmarks
    sys.path.insert(0, str(ROOT))

from benchmarks import kernel_projection as jkp  # noqa: E402
from benchmarks import roofline_bench as jroof  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.paper import kernel_projection as kp  # noqa: E402
from repro_torch.paper import roofline  # noqa: E402


def _cell(c, m, coll, bneck, useful, total, sharded=None):
    mem = {"total_bytes": total}
    if sharded is not None:
        mem["sharded_argument_bytes"] = sharded
    return {"ok": True, "compute_s": c, "memory_s": m, "collective_s": coll,
            "bottleneck": bneck, "useful_ratio": useful,
            "memory_per_device_bytes": mem, "per_device_bytes": 5e11}


DOC = {
    "gemma3-1b|train_4k|pod16x16": _cell(0.632, 3.436, 0.01, "memory",
                                         0.039, 1.3e11, 1.0e8),
    "gemma3-1b|decode_32k|pod16x16": _cell(4e-5, 8.75e-3, 6.1e-3, "memory",
                                           0.8, 9.07e9, 7.25e9),
    "yi-9b|train_4k|pod16x16": _cell(1.0, 2.0, 3.0, "collective", 0.5,
                                     4.4e10),
    "gemma3-1b|decode_32k|pod2x16x16": _cell(2e-5, 7.6e-3, 6.4e-3,
                                             "memory", 0.8, 5.57e9, 3.76e9),
    "gemma3-1b|train_4k|pod16x16|localattn+sp": _cell(1, 1, 1, "memory", 1,
                                                      1),
    "mamba|long_500k|pod16x16": {"ok": True, "skipped": True,
                                 "reason": "no attention"},
    "xlstm|train_4k|pod16x16": {"ok": False, "error": "ValueError: boom"},
}


def _same_lines(got, want, doc, mesh):
    """``got`` is ``want`` with the sharded column appended to the header
    and to each ok cell's line."""
    assert len(got) == len(want)
    assert got[1] == want[1] + f" {'shd/dev':>8s}"
    cells = {k.rsplit("|", 1)[0]: v for k, v in doc.items()
             if k.endswith(mesh) and v.get("ok") and not v.get("skipped")}
    for g, w in zip(got[2:], want[2:]):
        name = w.split(" ")[0]
        if name in cells and not w.startswith(f"{name}:"):
            shd = cells[name]["memory_per_device_bytes"].get(
                "sharded_argument_bytes")
            assert g == w + " " + (f"{shd / 1e9:7.1f}G" if shd is not None
                                   else f"{'-':>8s}")
        else:
            assert g == w
    assert got[0] == want[0]


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_summarize_gives_the_reference_lines(mesh):
    _same_lines(roofline.summarize(DOC, mesh), jroof.summarize(DOC, mesh),
                DOC, mesh)


def test_summarize_over_a_port_dryrun_document(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda name: configs.get_arch(name).reduced())
    monkeypatch.setattr(dryrun, "get_shape", lambda name: dataclasses.replace(
        configs.get_shape(name), seq_len=64))
    out = tmp_path / "dryrun.json"
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                 "--both-meshes", "--out", str(out)])
    doc = roofline.run(str(out))
    assert doc == json.loads(out.read_text()) and len(doc) > 2
    for mesh in ("pod16x16", "pod2x16x16"):
        _same_lines(roofline.summarize(doc, mesh),
                    jroof.summarize(doc, mesh), doc, mesh)
    assert roofline.run(str(tmp_path / "missing.json")) == {}


@pytest.mark.parametrize("shape", [(16, 4, 4096, 128, 1), (16, 4, 256, 256, 1),
                                   (2, 8, 512, 64, None)])
def test_kernel_boundary_traffic_equal(shape):
    b, h, s, d, kv = shape
    assert kp.kernel_boundary_traffic(b, h, s, d, kv) == \
        jkp.kernel_boundary_traffic(b, h, s, d, kv)


@pytest.mark.parametrize("case", list(kp.CASES))
def test_project_cell_equal_given_the_same_traffic(case, monkeypatch):
    traffic = (3.1e10, 8.7e10)
    monkeypatch.setattr(kp, "attention_traffic", lambda *a, **k: traffic)
    monkeypatch.setattr(jkp, "attention_hlo_traffic", lambda *a, **k: traffic)
    monkeypatch.setattr(kp, "HBM_BW", jkp.HBM_BW)
    cell = _cell(0.5, 40.0, 1.5, "memory", 0.4, 1e11)
    kw = kp.CASES[case][1]
    assert kp.project_cell(cell, **kw) == jkp.project_cell(cell, **kw)


def test_attention_traffic_from_the_counter():
    """The plain path's bytes by the op counter: the backward adds to the
    forward, a batch twice as large at most doubles them (the masks do not
    grow with it), and they exceed the kernels' boundary bytes (the score
    tiles the kernel keeps on chip)."""
    f1, fb1 = kp.attention_traffic(1, 2, 2048, 64, window=512)
    f2, fb2 = kp.attention_traffic(2, 2, 2048, 64, window=512)
    assert 0 < f1 < fb1 and f1 < f2 <= 2 * f1 and fb1 < fb2 <= 2 * fb1
    k_f, k_fb = kp.kernel_boundary_traffic(1, 2, 2048, 64, 1)
    assert f1 > k_f and fb1 > k_fb


def test_projection_cli_over_a_document(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(kp, "attention_traffic", lambda *a, **k: (4e9, 1e10))
    doc = {"gemma3-1b|train_4k|pod16x16": _cell(0.6, 3.4, 0.1, "memory",
                                                0.04, 1.3e11)}
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(doc))
    got = kp.main(["--dryrun", str(path), "--out", str(tmp_path / "p.json"),
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert list(got) == ["gemma3-1b|train_4k|pod16x16|pallas"]
    adj = got["gemma3-1b|train_4k|pod16x16|pallas"]
    assert adj["memory_s"] < 3.4 and "kernel_ms" not in adj
    assert json.loads((tmp_path / "p.json").read_text()) == got
    assert "no dry-run cell deepseek-67b|train_4k|pod16x16" in out
    assert "--variant localattn+sp" in out


def test_paper_cli_prints_the_roofline_table(tmp_path, monkeypatch, capsys):
    """The roofline lines from ``python -m repro_torch.paper``, read from
    ``results/torch/dryrun.json``, with the rest of the pass stubbed."""
    from repro_torch.paper import __main__ as paper_main
    from repro_torch.paper import runtime_overhead, tables

    monkeypatch.chdir(tmp_path)
    (tmp_path / "results" / "torch").mkdir(parents=True)
    (tmp_path / "results" / "torch" / "dryrun.json").write_text(
        json.dumps(DOC))
    row = {"nnc": {"mae": 1.0, "mape": 10.0}, "nn": {"mae": 2.0,
                                                    "mape": 20.0}}
    monkeypatch.setattr(tables, "run", lambda **kw: {"mm|eigen|i5": row})
    monkeypatch.setattr(tables, "summarize", lambda tabs: ["tables"])
    monkeypatch.setattr(runtime_overhead, "run", lambda **kw: {
        "steady_overhead_pct": 1.0, "cases": {"a": {"regret_vs_oracle": 1.0}}})
    monkeypatch.setattr(runtime_overhead, "summarize", lambda rt: ["rt"])
    paper_main.main(["--device", "cpu", "--quick"])
    out = capsys.readouterr().out.splitlines()
    table = roofline.summarize(DOC)
    start = out.index(table[0])
    assert out[start:start + len(table)] == table
