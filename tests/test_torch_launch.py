"""The launch analysis stack (``mesh``, ``hlo_analysis``, ``roofline``,
``dryrun``, ``profile``) and the attention tuner against the JAX package.

The HLO parser, ``collective_bytes`` and ``profile_hlo`` get the same HLO
text in both packages: the programs of ``tests/test_hlo_analysis.py``,
compiled here, and one sharded program with every collective kind,
compiled by the JAX package in a subprocess on a forced 4-device host
platform.  The dry-run runs on fake process groups (``dryrun.fake_group``,
process-wide, destroyed after each cell; the mesh checks run in a
subprocess) at ``reduced()`` widths, reduced through ``get_arch`` and
``get_shape``; its FLOPs are held to ``FlopCounterMode`` over the same step
on real CPU tensors.  ``repro.api`` is imported first (the JAX package's
import cycle)."""
import dataclasses
import json
import os
import subprocess
import sys

import repro.api  # noqa: F401  (before repro.workloads: the import cycle)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as ref_configs
from repro.autotune import tuner as ref_tuner
from repro.core.nnc import MLPModel as RefMLPModel
from repro.core.nnc import lightweight_dims as ref_dims
from repro.launch import hlo_analysis as ref_ha
from repro.launch import roofline as ref_rf
from repro.models import build_model as ref_build_model

# the reference's dryrun and profile append a 512-device flag to XLA_FLAGS
# when imported; put the variable back so this process keeps one device
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
from repro.launch import profile as ref_profile  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro_torch import configs  # noqa: E402
from repro_torch.autotune import tuner  # noqa: E402
from repro_torch.core.nnc import MLPModel  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis, profile, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}

# --------------------------------------------------------------------------
# HLO text: the programs of test_hlo_analysis.py and a sharded one
# --------------------------------------------------------------------------

SHARDED_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist import compat
mesh = compat.make_mesh((4,), ("x",))
def body(a, w):
    s = jax.lax.psum(a @ w, "x")
    g = jax.lax.all_gather(a, "x", axis=0, tiled=True)
    r = jax.lax.ppermute(a, "x", [(i, (i + 1) % 4) for i in range(4)])
    rs = jax.lax.psum_scatter(s, "x", scatter_dimension=0, tiled=True)
    t = jax.lax.all_to_all(a, "x", 0, 0, tiled=True)
    return s, g, r, rs, t
f = compat.shard_map(body, mesh, in_specs=(P("x", None), P(None, None)),
                     out_specs=(P(None, None), P(None, None), P("x", None),
                                P("x", None), P("x", None)))
a = jax.ShapeDtypeStruct((64, 32), jnp.float32)
w = jax.ShapeDtypeStruct((32, 32), jnp.float32)
print(jax.jit(f).lower(a, w).compile().as_text())
"""

COLLECTIVE_TEXT = """
HloModule test
ENTRY %main (p: f32[16]) -> f32[16] {
  %p = f32[16]{0} parameter(0)
  %ar = f32[16]{0} all-reduce(%p), replica_groups={}, to_apply=%add
  ROOT %ag = f32[16]{0} all-gather(%ar), dimensions={0}
}
"""


def _scanned(x, w):
    def body(c, _):
        return c @ w, None
    out, _ = jax.lax.scan(body, x, None, length=8)
    return out


def _unrolled(x, w):
    for _ in range(8):
        x = x @ w
    return x


def _nested(x, w):
    def outer(c, _):
        def inner(c2, _):
            return c2 @ w, None
        c2, _ = jax.lax.scan(inner, c, None, length=3)
        return c2, None
    out, _ = jax.lax.scan(outer, x, None, length=5)
    return out


def _compiled(f, x_shape, w_shape) -> str:
    xs = jax.ShapeDtypeStruct(x_shape, jnp.float32)
    ws = jax.ShapeDtypeStruct(w_shape, jnp.float32)
    return jax.jit(f).lower(xs, ws).compile().as_text()


@pytest.fixture(scope="module")
def hlo_texts():
    out = subprocess.run([sys.executable, "-c", SHARDED_SCRIPT], env=ENV,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return {"scanned": _compiled(_scanned, (64, 32), (32, 32)),
            "unrolled": _compiled(_unrolled, (64, 32), (32, 32)),
            "nested": _compiled(_nested, (16, 16), (16, 16)),
            "sharded": out.stdout, "collectives": COLLECTIVE_TEXT}


PROGRAMS = ("scanned", "unrolled", "nested", "sharded", "collectives")


@pytest.mark.parametrize("shape", ["f32[4,8]{1,0}", "bf16[10]",
                                   "(f32[2,2], s32[3])", "pred[]",
                                   "(bf16[8,128]{1,0}, token[], u8[3,3])",
                                   "f8e4m3fn[16,2]", "c64[5]", "opaque[]"])
def test_shape_elems_bytes_equal(shape):
    assert hlo_analysis.shape_elems_bytes(shape) \
        == ref_ha.shape_elems_bytes(shape)
    assert roofline.shape_bytes(shape) == ref_rf.shape_bytes(shape)


@pytest.mark.parametrize("program", PROGRAMS)
def test_analyze_hlo_every_field_equal(hlo_texts, program):
    text = hlo_texts[program]
    got = dataclasses.asdict(hlo_analysis.analyze_hlo(text))
    want = dataclasses.asdict(ref_ha.analyze_hlo(text))
    assert got == want
    if program == "sharded":      # every kind of collective is in it
        assert all(v > 0 for v in got["collective_bytes"].values())


@pytest.mark.parametrize("program", PROGRAMS)
def test_collective_bytes_equal(hlo_texts, program):
    text = hlo_texts[program]
    assert roofline.collective_bytes(text) == ref_rf.collective_bytes(text)


@pytest.mark.parametrize("program", PROGRAMS)
def test_profile_hlo_rows_equal(hlo_texts, program):
    text = hlo_texts[program]
    assert profile.profile_hlo(text) == ref_profile.profile_hlo(text)


def test_analyze_takes_hlo_text_or_cost_totals(hlo_texts):
    text = hlo_texts["sharded"]
    a = roofline.analyze("a", "s", "m", 4, {}, text, 1e6)
    b = roofline.analyze("a", "s", "m", 4, {},
                         hlo_analysis.analyze_hlo(text), 1e6)
    assert a.to_dict() == b.to_dict()
    ref = ref_rf.analyze("a", "s", "m", 4, {}, text, 1e6).to_dict()
    assert set(a.to_dict()) == set(ref)
    # the same totals, the H100's terms: only the constants differ
    assert a.per_device_flops == ref["per_device_flops"]
    assert a.compute_s == pytest.approx(a.per_device_flops / 989e12)
    assert a.memory_s == pytest.approx(a.per_device_bytes / 3.35e12)
    assert a.collective_s == pytest.approx(
        a.per_device_collective_bytes / 450e9)


# --------------------------------------------------------------------------
# the op counter on the torch twins of those programs
# --------------------------------------------------------------------------

def _chain(n):
    def f(x, w):
        for _ in range(n):
            x = x @ w
        return x
    return f


@pytest.mark.parametrize("program,n,x_shape,w_shape", [
    ("unrolled", 8, (64, 32), (32, 32)), ("scanned", 8, (64, 32), (32, 32)),
    ("nested", 15, (16, 16), (16, 16))])
def test_counter_dot_flops_equal_analyze_hlo(hlo_texts, program, n, x_shape,
                                             w_shape):
    x = torch.empty(x_shape, device="meta")
    w = torch.empty(w_shape, device="meta")
    counter, _, _ = dryrun.trace(_chain(n), (x, w))
    want = ref_ha.analyze_hlo(hlo_texts[program]).dot_flops
    assert counter.totals.dot_flops == want == counter.totals.flops
    assert want == n * 2 * x_shape[0] * w_shape[0] * w_shape[1]
    assert counter.totals.loops == []


def test_counter_peak_of_live_storages():
    """Peak and frees of a known program: a [1000,1000] fp32 tensor is
    4 MB; two live at once plus the arguments, then the first freed."""
    def f(a):
        b = a * 2            # 4 MB
        c = b + 1            # 4 MB: a, b, c live
        del b
        d = c.view(-1)       # a view: no new storage
        return d.sum()
    a = torch.empty((1000, 1000), device="meta")
    counter, mem, _ = dryrun.trace(f, (a,))
    assert mem["argument_bytes"] == 4_000_000
    assert mem["total_bytes"] == counter.peak_bytes == 12_000_000
    assert mem["output_bytes"] == 4 and mem["alias_bytes"] == 0
    # inputs plus outputs, the view free: mul 8e6, add 8e6, sum 4e6 + 4
    assert counter.totals.hbm_bytes == 8e6 + 8e6 + 4e6 + 4


# --------------------------------------------------------------------------
# model FLOPs: every arch x shape from spec trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ref_configs.ARCHS))
def test_count_params_and_model_flops_equal(arch):
    port = build_model(configs.get_arch(arch))
    ref = ref_build_model(ref_configs.get_arch(arch))
    assert roofline.count_params_split(port) \
        == ref_rf.count_params_split(ref)
    for shape in ref_configs.SHAPES:
        assert roofline.model_flops(port, configs.get_shape(shape)) \
            == ref_rf.model_flops(ref, ref_configs.get_shape(shape))


def test_cells_equal():
    assert list(dryrun.cells(include_skips=True)) \
        == list(ref_dryrun.cells(include_skips=True))
    assert dryrun.VARIANTS == ref_dryrun.VARIANTS


# --------------------------------------------------------------------------
# meshes (a subprocess: the fake group is process-wide)
# --------------------------------------------------------------------------

MESH_SCRIPT = r"""
import json
from repro_torch.dist import compat
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
out = {}
try:
    make_production_mesh()
except RuntimeError as e:
    out["no group"] = str(e)
with compat.process_group("cpu"):
    m = make_host_mesh()
    out["host"] = [list(m.shape), list(m.mesh_dim_names)]
    try:
        with dryrun.fake_group(256):
            pass
    except RuntimeError as e:
        out["gloo"] = str(e)
for world, mp in ((256, False), (512, True)):
    with dryrun.fake_group(world):
        m = make_production_mesh(multi_pod=mp)
        out[str(world)] = [list(m.shape), list(m.mesh_dim_names), m.size(),
                           m.transport.backend]
with dryrun.fake_group(4):
    for mp in (False, True):
        try:
            make_production_mesh(multi_pod=mp)
        except RuntimeError as e:
            out[f"4 {mp}"] = str(e)
print(json.dumps(out))
"""


def test_meshes_on_fake_groups():
    out = subprocess.run([sys.executable, "-c", MESH_SCRIPT], env=ENV,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["host"] == [[1, 1], ["data", "model"]]
    assert got["256"] == [[16, 16], ["data", "model"], 256, "fake"]
    assert got["512"] == [[2, 16, 16], ["pod", "data", "model"], 512,
                          "fake"]
    assert "need 256 ranks" in got["4 False"] and "have 4" in got["4 False"]
    assert "need 512 ranks" in got["4 True"] and "have 4" in got["4 True"]
    assert "have 0" in got["no group"]
    assert "gloo" in got["gloo"]


# --------------------------------------------------------------------------
# build_cell / run_cell at reduced() on a fake 256-rank group
# --------------------------------------------------------------------------

SMALL_SEQ = {"train_4k": 64, "prefill_32k": 64, "decode_32k": 64,
             "long_500k": 128}


@pytest.fixture
def reduced(monkeypatch):
    """The dry-run's archs at reduced() and its shapes at SMALL_SEQ (the
    global batches kept: the data axis divides them)."""
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda name: configs.get_arch(name).reduced())
    monkeypatch.setattr(dryrun, "get_shape", lambda name: dataclasses.replace(
        configs.get_shape(name), seq_len=SMALL_SEQ[name]))


def _real(leaf):
    """A seeded real CPU tensor for a meta stand-in."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    gen = torch.Generator().manual_seed(leaf.numel())
    if leaf.dtype.is_floating_point:
        return (torch.randn(leaf.shape, generator=gen) * 0.02).to(leaf.dtype)
    return torch.randint(0, 64, leaf.shape, generator=gen, dtype=leaf.dtype)


REF_KEYS = {f.name for f in dataclasses.fields(ref_rf.RooflineReport)} \
    | {"lower_s", "compile_s", "ok", "variant"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "total_bytes"}


@pytest.mark.parametrize("arch,shape", [("gemma3-1b", "train_4k"),
                                        ("yi-9b", "prefill_32k"),
                                        ("qwen3-moe-235b-a22b",
                                         "decode_32k")])
def test_run_cell_flops_equal_flop_counter(reduced, arch, shape):
    result = dryrun.run_cell(arch, shape, verbose=False)
    assert REF_KEYS <= set(result) and result["ok"]
    assert result["compile_s"] == 0.0 and result["chips"] == 256
    mem = result["memory_per_device_bytes"]
    assert MEM_KEYS <= set(mem)
    # the arguments are held as blocks: exactly the sharded figure
    assert result["layout"] == "blocked"
    assert mem["total_bytes"] >= mem["argument_bytes"] \
        == mem["sharded_argument_bytes"] > 0
    assert mem["total_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                  + mem["temp_bytes"] - mem["alias_bytes"])
    with dryrun.fake_group(256):
        mesh = make_production_mesh()
        fn, args, *_, model, sh = dryrun.build_cell(arch, shape, mesh)
        with FlopCounterMode(display=False) as fc:
            fn(*dryrun._map(_real, args))
    assert result["per_device_flops"] == fc.get_total_flops() > 0
    assert result["model_flops"] == roofline.model_flops(model, sh)


def test_every_variant_builds_and_runs(reduced):
    """Each variant builds and runs on the fake group (qwen3-moe reduced,
    so the MoE variants take their dispatch), as in the reference an
    unknown one raises ValueError."""
    with dryrun.fake_group(256):
        mesh = make_production_mesh()
        for variant in dryrun.VARIANTS:
            fn, args, *_ = dryrun.build_cell("qwen3-moe-235b-a22b",
                                             "train_4k", mesh,
                                             variant=variant)
            counter, _, _ = dryrun.trace(fn, args)
            assert counter.totals.flops > 0, variant
        with pytest.raises(ValueError, match="unknown variants"):
            dryrun.build_cell("gemma3-1b", "train_4k", mesh, variant="nope")
    with pytest.raises(ValueError, match="unknown variants"):
        ref_dryrun.build_cell("gemma3-1b", "train_4k", None, variant="nope")


def test_ring_variant_counts_its_permutes(reduced):
    """sp+ring puts the ring's ppermutes on the fake group: each hop's
    send and receive count once, as collective-permute."""
    result = dryrun.run_cell("gemma3-1b", "train_4k", variant="sp+ring",
                             verbose=False)
    coll = result["collective_breakdown"]
    assert coll["collective-permute"] > 0 and coll["all-reduce"] > 0


def test_profile_counter_rows(reduced):
    counters = []
    dryrun.run_cell("gemma3-1b", "train_4k", verbose=False,
                    counter_out=counters)
    traffic, flops, colls = profile.profile_counter(counters[0])
    totals = counters[0].totals
    for rows, total in ((flops, totals.flops),
                        (colls, totals.collective_total)):
        assert sum(r[0] for r in rows) == pytest.approx(total)
    # as in the reference, a collective's operands and results count in
    # the HBM total but not among the traffic rows
    assert 0 < sum(r[0] for r in traffic) < totals.hbm_bytes
    for rows in (traffic, flops, colls):
        assert rows and all(len(r) == 4 and r[3] == 1 for r in rows)
        assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                              reverse=True)
    assert flops[0][1] in ("aten.mm", "aten.bmm")


def test_dryrun_cli_full_width_decode(tmp_path, capsys):
    """The CLI at gemma3-1b's full width, decode_32k (a few seconds of
    fake trace): the reference's keys and skip records, memory in the
    blocked layout equal to the sharded figure, nothing on a card."""
    out = tmp_path / "d.json"
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--out",
                 str(out)])
    doc = json.loads(out.read_text())
    cell = doc["gemma3-1b|decode_32k|pod16x16"]
    assert REF_KEYS <= set(cell) and cell["ok"]
    skips = [k for k, v in doc.items() if v.get("skipped")]
    assert skips and all(doc[k]["reason"] and doc[k]["ok"] for k in skips)
    mem = cell["memory_per_device_bytes"]
    cache = 26 * 2 * 128 * 32768 * 256 * 2     # every layer's k and v, bf16
    # held as blocks: this rank's 8 of the 128 rows of the cache
    assert mem["total_bytes"] > mem["argument_bytes"] > cache // 16
    assert mem["sharded_argument_bytes"] == mem["argument_bytes"]
    n = roofline.count_params_split(build_model(configs.get_arch(
        "gemma3-1b")))[1]
    assert cell["model_flops"] == 2.0 * n * 128
    assert not torch.cuda.is_initialized()
    assert "[dryrun] gemma3-1b x decode_32k x pod16x16" \
        in capsys.readouterr().out


# --------------------------------------------------------------------------
# the tuner
# --------------------------------------------------------------------------

def test_measure_schedule_on_the_cpu():
    assert tuner.measure_schedule(1, 1, 64, 8, 32, 32, reps=1, seed=123,
                                  device="cpu") > 0.0


def test_measure_schedule_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tuner.measure_schedule(1, 1, 64, 8, 32, 32, reps=1, seed=123)


def test_collect_rows_equal():
    shapes = [(1, 1, 64, 8), (1, 2, 128, 8)]
    schedules = [(32, 32), (64, 32), (32, 64)]
    X, y = tuner.AttentionTuner().collect(shapes, schedules, seed=0,
                                          device="cpu")
    X_ref, y_ref = ref_tuner.AttentionTuner().collect(shapes, schedules,
                                                      seed=0)
    np.testing.assert_array_equal(X, X_ref)
    assert y.shape == y_ref.shape and np.all(y > 0)
    assert tuner.SCHEDULES == ref_tuner.SCHEDULES


def test_fit_builds_the_reference_model(monkeypatch):
    built = []

    class Quick(MLPModel):
        def __init__(self, layers, epochs):
            built.append((list(layers), epochs))
            super().__init__(layers, epochs=50)

    monkeypatch.setattr(tuner, "MLPModel", Quick)
    X = np.asarray([tuner._features(1, 4, s, 64, qc, kc)
                    for s in (256, 512) for qc, kc in tuner.SCHEDULES],
                   dtype=np.float64)
    t = tuner.AttentionTuner().fit(X, np.linspace(1e-3, 2e-3, len(X)))
    assert built == [(ref_dims(7, 75, 1), 25000)]
    assert t.best_schedule(1, 4, 384, 64) in tuner.SCHEDULES


def test_best_schedule_equal_with_the_reference_model():
    """The reference's fitted model carried over by its state: the same
    pick on a grid of shapes."""
    rows = [ref_tuner._features(b, h, s, d, qc, kc)
            for b, h, s, d in [(1, 4, 512, 64), (2, 8, 1024, 64),
                               (1, 4, 2048, 128), (1, 8, 4096, 256)]
            for qc, kc in ref_tuner.SCHEDULES]
    X = np.asarray(rows, dtype=np.float64)
    # a synthetic time with an interior optimum in each of qc and kc
    y = X[:, 6] / 1e12 * (1 + (np.log2(X[:, 4]) - 7.3) ** 2
                          + 0.5 * (np.log2(X[:, 5]) - 8.6) ** 2)
    ref_model = RefMLPModel(ref_dims(7, 75, 1), epochs=400).fit(X, y)
    ref = ref_tuner.AttentionTuner(ref_model)
    port = tuner.AttentionTuner(MLPModel.from_state(*ref_model.to_state()))
    grid = [(b, h, s, d) for b in (1, 2) for h in (4, 8)
            for s in (768, 2048, 3072) for d in (64, 256)]
    picks = [port.best_schedule(*shape) for shape in grid]
    assert picks == [ref.best_schedule(*shape) for shape in grid]
    assert len(set(picks)) > 1
