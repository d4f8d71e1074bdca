"""``python -m repro_torch.bench serve``, ``repro_torch.launch.serve`` and
``repro_torch.checkpoint`` against the JAX package: the serve section and
its telemetry carry the committed JAX documents' keys and names and pass
both packages' schema checks; the launcher serves reduced yi-9b on the
host (token for token with the JAX launcher in fp32 from one checkpoint);
checkpoints move between the packages bit for bit, a bf16 leaf
included."""
import copy
import dataclasses
import io
import json
import os
import shutil
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.bench.schema import validate_bench as jvalidate_bench
from repro.bench.serve_trace import summarize_serve as jsummarize_serve
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.launch import serve as jlaunch
from repro.obs.telemetry import Telemetry as JTelemetry
from repro.runtime import TuningCache as JTuningCache
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bench.__main__ import main as bench_main
from repro_torch.bench.schema import load_bench, validate_bench
from repro_torch.bench.serve_trace import summarize_serve
from repro_torch.checkpoint import CheckpointManager
from repro_torch.dist import compat
from repro_torch.dist.sharding import train_rules, use_mesh
from repro_torch.launch import serve as launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "benchmarks", "sample_results")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sample(name) -> dict:
    with open(os.path.join(SAMPLES, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One ``bench serve --quick --device cpu`` in process, merging into a
    copy of the committed bench document."""
    root = tmp_path_factory.mktemp("serve")
    out = root / "bench.json"
    shutil.copy(os.path.join(SAMPLES, "bench.json"), out)
    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with redirect_stdout(buf):
            rc = bench_main(["serve", "--quick", "--device", "cpu",
                             "--results-dir", str(root), "--out", str(out)])
    finally:
        torch.set_num_threads(threads)
    with open(root / "bench_serve.json") as f:
        standalone = json.load(f)
    with open(root / "telemetry_serve.json") as f:
        telemetry = json.load(f)
    return {"rc": rc, "stdout": buf.getvalue(), "out": str(out),
            "standalone": standalone, "telemetry": telemetry}


def _paths(tree, prefix=""):
    """Every key path of a JSON tree; the trace and policy names kept."""
    if not isinstance(tree, dict):
        return {prefix}
    out = {prefix} if prefix else set()
    for k, v in tree.items():
        out |= _paths(v, f"{prefix}/{k}")
    return out


# --------------------------------------------------------------------------
# bench serve
# --------------------------------------------------------------------------

def test_serve_cli_exit_code_and_summary(served):
    section = served["standalone"]["serve"]
    assert served["rc"] == (0 if section["sjf_beats_fifo_bursty"] else 1)
    lines = served["stdout"].splitlines()
    assert lines[-1] == f"wrote serve section to {served['out']}"
    assert lines[:-1] == summarize_serve(section) == jsummarize_serve(section)


def test_serve_section_keys_equal_the_committed_document(served):
    got = served["standalone"]
    want = _sample("bench_serve.json")
    assert _paths(got) == _paths(want)
    assert got["serve"]["model"] == want["serve"]["model"] == "yi-9b"
    assert (got["serve"]["max_slots"], got["serve"]["max_seq"],
            got["serve"]["size"]) == (2, 96, "quick")


def test_every_request_completes(served):
    for name, trace in served["standalone"]["serve"]["traces"].items():
        for policy, r in trace["policies"].items():
            assert r["completed"] == trace["n_requests"] == 8, (name, policy)
            assert r["rejected"] == 0 and not r["admission_fallback"]
            assert r["ttft_s"]["count"] == 8
            assert r["goodput_tok_s"] > 0 and 0 < r["occupancy"] <= 1


@pytest.mark.parametrize("validator", [validate_bench, jvalidate_bench],
                         ids=["port", "jax"])
def test_both_schema_checks_accept(served, validator):
    """The section merged into the committed bench document (the
    standalone file, as the JAX package writes it, is no whole bench
    document)."""
    doc = load_bench(served["out"])
    assert validator(doc) is doc
    assert doc["serve"] == served["standalone"]["serve"]
    assert doc["workloads"] == _sample("bench.json")["workloads"]
    bad = copy.deepcopy(doc)
    del bad["serve"]["traces"]["bursty"]["policies"]["sjf"]["ttft_s"]["p99"]
    with pytest.raises(ValueError, match="bench.json invalid"):
        validator(bad)


def _jax_categories(tmp_path) -> set:
    """The event categories the JAX package's engine emits today (its
    committed telemetry predates the per-request and per-step events)."""
    from repro.configs import ARCHS
    from repro.models import build_model
    from repro.serve import ServeRequest
    cfg = dataclasses.replace(ARCHS["yi-9b"].reduced(),
                              compute_dtype="float32")
    model = build_model(cfg)
    tel = JTelemetry()
    eng = JServeEngine(model, JTuningCache(root=str(tmp_path)),
                       params=model.init_params(jax.random.PRNGKey(0)),
                       max_slots=2, max_seq=32, admission="fifo",
                       telemetry=tel)
    eng.run_trace([ServeRequest(rid=i, prompt=[1, 2], max_new=2)
                   for i in range(2)])
    return {e["cat"] for e in tel.to_json()["events"]}


def test_telemetry_names_equal_the_committed_document(served, tmp_path):
    got, want = served["telemetry"], _sample("telemetry_serve.json")
    assert set(got) == set(want)
    for part in ("counters", "histograms", "series"):
        assert set(got[part]) == set(want[part]), part
    assert set(got["drift"]) == set(want["drift"])
    assert set(got["drift"]["kernels"]) == set(want["drift"]["kernels"])
    cats = {e["cat"] for e in got["events"]}
    assert {e["cat"] for e in want["events"]} <= cats
    assert cats == _jax_categories(tmp_path)


def test_serve_cli_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_main(["serve", "--quick", "--results-dir", str(tmp_path),
                    "--out", str(tmp_path / "b.json")])


# --------------------------------------------------------------------------
# launch.serve
# --------------------------------------------------------------------------

LAUNCH = ["--arch", "yi-9b", "--reduced", "--batch", "2",
          "--prompt-len", "16", "--max-new", "8"]


def _quiet(main, argv):
    with redirect_stdout(io.StringIO()) as buf:
        out = main(argv)
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out), \
        buf.getvalue()


def test_launch_serve_on_the_host(monkeypatch):
    out, text = _quiet(launch.main, LAUNCH + ["--device", "cpu"])
    again, _ = _quiet(launch.main, LAUNCH + ["--device", "cpu"])
    assert out.shape == (2, 8) and out.dtype == np.int32
    assert ((out >= 0) & (out < 256)).all()
    np.testing.assert_array_equal(out, again)
    assert "[serve] generated (2, 8)" in text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(LAUNCH)


def _fp32(get_arch):
    return lambda name: dataclasses.replace(get_arch(name),
                                            compute_dtype="float32")


def test_launch_serve_equals_jax_from_one_checkpoint(tmp_path, monkeypatch):
    """The JAX package saves its launcher's weights; both launchers restore
    them (fp32 compute) and serve the same prompts: the same tokens."""
    from repro.configs import get_arch as jget_arch
    from repro.models import build_model as jbuild
    cfg = dataclasses.replace(jget_arch("yi-9b").reduced(),
                              compute_dtype="float32")
    params = jbuild(cfg).init_params(jax.random.PRNGKey(3))
    JCheckpointManager(str(tmp_path)).save(4, {"params": params})
    monkeypatch.setattr(jlaunch, "get_arch", _fp32(jlaunch.get_arch))
    monkeypatch.setattr(launch, "get_arch", _fp32(launch.get_arch))
    argv = LAUNCH + ["--checkpoint-dir", str(tmp_path), "--seed", "5"]
    want, jtext = _quiet(jlaunch.main, argv)
    got, text = _quiet(launch.main, argv + ["--device", "cpu"])
    assert "restored checkpoint step 4" in text and \
        "restored checkpoint step 4" in jtext
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------

def _jtree(seed=0) -> dict:
    rng = np.random.RandomState(seed)
    return {"a": jnp.asarray(rng.randn(4, 8), jnp.float32),
            "nested": {"b": jnp.asarray(rng.randn(3), jnp.float32),
                       "c": jnp.asarray(7, jnp.int32),
                       "list": [jnp.asarray(rng.randint(0, 9, 5), jnp.int32),
                                jnp.asarray(rng.randn(2, 2), jnp.float32)]}}


def _jbf16(seed=0) -> dict:
    tree = _jtree(seed)
    tree["nested"]["w"] = jnp.asarray(np.random.RandomState(seed + 1)
                                      .randn(3, 5), jnp.bfloat16)
    return tree


def _as_port(tree):
    """The JAX tree as tensors, bf16 bit for bit."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_port(v) for v in tree]
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(x) -> tuple:
    """(dtype name, raw bytes) of a tensor or an array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        raw = x.contiguous().view(torch.uint8).numpy().tobytes() \
            if x.dim() else x.reshape(1).view(torch.uint8).numpy().tobytes()
        return name, raw
    a = np.asarray(x)
    return str(a.dtype), a.tobytes()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bits(x) == _bits(y)


@pytest.mark.parametrize("tree", [_jtree, _jbf16], ids=["fp32-int32",
                                                       "with-bf16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, tree):
    jt = tree()
    JCheckpointManager(str(tmp_path)).save(3, jt, extra={"data": 1})
    like = _as_port(jax.tree.map(jnp.zeros_like, jt))
    restored, extra = CheckpointManager(str(tmp_path)).restore(3, like)
    assert extra == {"data": 1}
    _same_bits(restored, _as_port(jt))
    assert isinstance(restored["nested"]["list"], list)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jt = _jtree(2)
    CheckpointManager(str(tmp_path)).save(6, _as_port(jt), extra={"k": [1]})
    restored, extra = JCheckpointManager(str(tmp_path)).restore(6, jt)
    assert extra == {"k": [1]}
    _same_bits(jax.tree.map(np.asarray, restored),
               jax.tree.map(np.asarray, jt))


def test_bf16_checkpoints_are_the_same_files(tmp_path):
    """A bf16 leaf: the port writes the records and the checksum the JAX
    package writes for the same tree.  (The JAX package fails its own
    checksum reading any bf16 checkpoint back, whichever package wrote
    it: numpy names the loaded records ``|V2``.)"""
    jt = _jbf16(5)
    jdir, pdir = tmp_path / "j", tmp_path / "p"
    jpath = JCheckpointManager(str(jdir)).save(1, jt)
    ppath = CheckpointManager(str(pdir)).save(1, _as_port(jt))
    man = [json.load(open(os.path.join(p, "manifest.json")))
           for p in (jpath, ppath)]
    assert man[0] == man[1]
    with np.load(os.path.join(jpath, "arrays.npz")) as zj, \
            np.load(os.path.join(ppath, "arrays.npz")) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for key in zj.files:
            assert zj[key].dtype == zp[key].dtype, key
            assert zj[key].shape == zp[key].shape, key
            assert zj[key].tobytes() == zp[key].tobytes(), key
    for d in (jdir, pdir):
        with pytest.raises(IOError, match="checksum"):
            JCheckpointManager(str(d)).restore(1, jt)
        restored, _ = CheckpointManager(str(d)).restore(1, _as_port(jt))
        _same_bits(restored, _as_port(jt))
        assert restored["nested"]["w"].dtype == torch.bfloat16


def test_port_roundtrip_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _as_port(_jbf16(1))
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, extra={"step": s})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    step, restored, extra = mgr.restore_latest(tree)
    assert (step, extra) == (4, {"step": 4})
    _same_bits(restored, tree)
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        tree) is None


def test_port_checksum_and_missing_key(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _as_port(_jtree())
    path = mgr.save(1, tree)
    with pytest.raises(KeyError, match="missing key extra"):
        mgr.restore(1, {**tree, "extra": torch.zeros(1)})
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["checksum"] = "0" * 64
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(IOError):
        mgr.restore(1, tree)


def test_port_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    tree = _as_port(_jtree(3))
    for s in (1, 2, 3):
        mgr.save_async(s, tree, extra={"s": s})
    snapshot = tree["a"].clone()
    tree["a"].add_(1)          # after the snapshot: not in step 3
    mgr.wait()
    assert mgr.all_steps() == [1, 2, 3]
    restored, extra = mgr.restore(3, tree)
    assert extra == {"s": 3}
    assert torch.equal(restored["a"], snapshot)


def test_port_restore_places_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _as_port(_jtree())
    mgr.save(1, tree)
    places = jax.tree.map(lambda _: "cpu", _jtree())
    restored, _ = mgr.restore(1, tree, shardings=places)
    _same_bits(restored, tree)
    assert all(x.device.type == "cpu" for x in _leaves(restored))
    # under a mesh (a world of one on gloo, in process) every leaf comes
    # back whole on this rank's device
    with compat.process_group("cpu") as device:
        mesh = compat.make_mesh((1,), ("data",), device=device)
        with use_mesh(mesh, train_rules()):
            on_mesh, _ = mgr.restore(1, tree, shardings=places)
    _same_bits(on_mesh, tree)
    assert all(x.device == device for x in _leaves(on_mesh))
