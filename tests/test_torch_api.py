"""repro_torch api/workloads against the JAX package: the same workload
traces to the same Program JSON from bit-identical inputs, programs move
between the packages and compile in either, identically seeded caches give
identical EFT schedules and variant choices, and the port's compiled
workloads match the JAX references.

``image_pipeline`` and ``mixed_dag`` dispatch the Pallas conv2d/maxpool
kernels, which cannot execute on jax 0.9.0 (no ``pl.load``), so for them
the JAX side only traces, seeds, schedules and predicts; the port's runs
are held against the JAX workloads' pure-jnp ``reference()``."""
import json

import numpy as np
import pytest
import torch

import repro.api as japi              # before repro.workloads (import cycle)
from repro.runtime import Dispatcher as JDispatcher
from repro.runtime import Fingerprint as JFingerprint
from repro.runtime import TuningCache as JTuningCache
from repro.runtime import seed_from_programs as jseed
from repro.workloads import get_workload as jget_workload
from repro.workloads import suite_registry as jsuite_registry
from repro_torch.api import Program, gantt_csv, ops, trace, use_dispatcher
from repro_torch.obs import MemoryLedger, Telemetry
from repro_torch.runtime import (Dispatcher, Fingerprint, TuningCache,
                                 current_fingerprint, seed_from_programs)
from repro_torch.workloads import get_workload, suite_registry

NAMES = ["mlp_block", "decode_microbatch", "image_pipeline", "mixed_dag",
         "attention_block"]
# workloads whose compiled JAX program can execute here (the attention
# variants are jnp, the Pallas matmul runs in interpret mode)
JAX_EXECUTES = {"mlp_block", "decode_microbatch", "attention_block"}


@pytest.fixture(scope="module")
def jreg():
    return jsuite_registry(NAMES)


@pytest.fixture(scope="module")
def reg():
    return suite_registry(NAMES)


def _builds(name, jreg, reg):
    return (jget_workload(name).build("small", registry=jreg),
            get_workload(name).build("small", registry=reg, device="cpu"))


def _devices(root, programs, reg, jax_side: bool):
    """Two simulated devices per package, seeded from the same programs
    with the same synthetic speeds."""
    devices = {}
    for name, speed in [("d0", 1.0e9), ("d1", 0.8e9)]:
        fp = (JFingerprint if jax_side else Fingerprint)(
            "sim", f"api-{name}", 1, 1, ("float32",))
        cache = (JTuningCache if jax_side else TuningCache)(
            root=str(root / ("jax" if jax_side else "port")), fingerprint=fp)
        d = (JDispatcher if jax_side else Dispatcher)(registry=reg,
                                                      cache=cache)
        (jseed if jax_side else seed_from_programs)(d, programs, speed)
        devices[name] = d
    return devices


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_same_workload_same_program_and_inputs(name, jreg, reg):
    jb, tb = _builds(name, jreg, reg)
    assert tb.program.to_json() == jb.program.to_json()
    assert json.dumps(tb.program.to_json()) == json.dumps(jb.program.to_json())
    assert tb.bindings.keys() == jb.bindings.keys()
    for k in jb.bindings:                   # bit-identical seeded inputs
        assert np.array_equal(tb.bindings[k].numpy(),
                              np.asarray(jb.bindings[k]))
    assert set(get_workload(name).presets) == set(jget_workload(name).presets)
    for size, p in jget_workload(name).presets.items():
        assert get_workload(name).presets[size] == p


@pytest.mark.parametrize("name", NAMES)
def test_programs_move_between_packages(name, jreg, reg, tmp_path):
    jb, tb = _builds(name, jreg, reg)
    # JAX exports, the port loads (re-checked against its registry),
    # compiles and runs on its own tensors
    doc = json.loads(json.dumps(jb.program.to_json()))
    prog = Program.from_json(doc, registry=reg)
    assert prog == tb.program
    devs = _devices(tmp_path, [prog], reg, jax_side=False)
    outs = prog.compile(devices=devs)(*[tb.bindings[s.name]
                                        for s in prog.inputs])
    # the port exports, JAX loads, compiles and runs on its own arrays
    jprog = japi.Program.from_json(
        json.loads(json.dumps(tb.program.to_json())), registry=jreg)
    assert jprog == jb.program
    jdevs = _devices(tmp_path, [jprog], jreg, jax_side=True)
    jcompiled = jprog.compile(devices=jdevs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if name in JAX_EXECUTES:
        jouts = jcompiled(*[jb.bindings[s.name] for s in jprog.inputs])
    else:                     # the Pallas kernels cannot run: jnp oracle
        jouts = jb.reference()
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    assert len(outs) == len(jouts) == len(prog.outputs)
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(_np(o), _np(j), rtol=1e-5, atol=1e-5)
    path = str(tmp_path / "prog.json")
    tb.program.save(path)
    assert japi.load_program(path, registry=jreg) == jb.program


@pytest.mark.parametrize("name", NAMES)
def test_seeded_caches_give_identical_schedules_and_choices(name, jreg, reg,
                                                            tmp_path):
    jb, tb = _builds(name, jreg, reg)
    jdevs = _devices(tmp_path, [jb.program], jreg, jax_side=True)
    devs = _devices(tmp_path, [tb.program], reg, jax_side=False)
    jc = jb.program.compile(devices=jdevs, bindings=jb.bindings)
    tc = tb.program.compile(devices=devs, bindings=tb.bindings)
    assert set(jc.assignments) == set(tc.assignments)
    for node in jc.assignments:
        ja, ta = jc.assignments[node], tc.assignments[node]
        assert (ja.device, ja.start, ja.finish) == \
            (ta.device, ta.start, ta.finish)
    assert [t.name for t in jc.order] == [t.name for t in tc.order]
    assert gantt_csv(tc) == japi.gantt_csv(jc)
    if name not in JAX_EXECUTES:
        # per node, the executing device predicts the same variant in both
        # packages, and the port's run executes that prediction
        tc()
        node_by = {n.name: n for n in tb.program.nodes}
        for dev in devs:
            tasks = [t for t in tc.order
                     if tc.assignments[t.name].device == dev]
            assert len(devs[dev].selections) == len(tasks)
            for task, sel in zip(tasks, devs[dev].selections):
                node = node_by[task.name]
                want = jdevs[dev].predict_times(node.kernel, node.params)
                got = devs[dev].predict_times(node.kernel, node.params)
                np.testing.assert_allclose(list(got.values()),
                                           list(want.values()), rtol=1e-12)
                assert sel.mode == "predicted"
                assert sel.chosen == min(want, key=want.get)
        return
    # per node, the executing device runs the same variant in both
    jc()
    tc()
    for jdev, tdev in ((jdevs[d], devs[d]) for d in devs):
        jsel = [(s.params, s.chosen, s.mode) for s in jdev.selections]
        tsel = [(s.params, s.chosen, s.mode) for s in tdev.selections]
        assert tsel == jsel
    assert any(devs[d].selections for d in devs)


@pytest.mark.parametrize("name", NAMES)
def test_compiled_small_matches_jax_reference(name, jreg, reg, tmp_path):
    jb, tb = _builds(name, jreg, reg)
    devs = _devices(tmp_path, [tb.program], reg, jax_side=False)
    outs = tb.program.compile(devices=devs, bindings=tb.bindings)()
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = jb.reference()
    assert len(outs) == len(refs) == len(tb.reference())
    for o, r, own in zip(outs, refs, tb.reference()):
        np.testing.assert_allclose(_np(o), _np(r), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(own), _np(r), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the port's front end on its own
# --------------------------------------------------------------------------

def _seeded(tmp_path, reg):
    d = Dispatcher(registry=reg, cache=TuningCache(
        root=str(tmp_path / "tc"), fingerprint=current_fingerprint("cpu")))
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.rand(48, 40).astype(np.float32))
    b = torch.from_numpy(rng.rand(40, 32).astype(np.float32))
    x = torch.from_numpy(rng.rand(32).astype(np.float32))
    with trace(registry=reg) as tb:
        ops.matvec(ops.matmul(a, b), x)
    seed_from_programs(d, [tb.program], 1e9)
    return d, (a, b, x)


def test_trace_eager_parity_and_dag(tmp_path, reg):
    d, (a, b, x) = _seeded(tmp_path, reg)
    with use_dispatcher(d):
        eager = ops.matvec(ops.matmul(a, b), x)
        chosen = [s.chosen for s in d.selections]
        with trace() as tb:
            y = ops.matvec(ops.matmul(a, b), x)
        prog = tb.program
        assert [s.name for s in prog.inputs] == ["in0", "in1", "in2"]
        assert prog.node("matmul_0").deps == ("in0", "in1")
        assert prog.node(y.name).deps == ("matmul_0", "in2")
        assert prog.outputs == (y.name,)
        assert prog.node("matmul_0").params == {"m": 48, "n": 32, "k": 40}
        assert d.n_measured == 0               # nothing ran while tracing
        out = tb.compile()()
    assert [s.chosen for s in d.selections][-2:] == chosen
    assert torch.equal(out, eager)
    torch.testing.assert_close(out, (a @ b) @ x, rtol=1e-5, atol=1e-5)


def test_compile_contract(tmp_path, reg):
    d, (a, b, x) = _seeded(tmp_path, reg)
    with trace(registry=reg) as tb:
        ops.matmul(a, b)
    # every option compiles and runs, telemetry and explain included
    with pytest.raises(ValueError, match="executor must be one of"):
        tb.program.compile(devices=d, executor="threads")
    tel = Telemetry()
    compiled = tb.program.compile(devices=d, bindings=tb.bindings,
                                  comm=lambda s, t, n: 0.0, online=True,
                                  telemetry=tel)
    with pytest.raises(ValueError, match="no execution recorded"):
        compiled.explain()
    want = compiled()
    for mode in ("async", "adaptive"):
        assert torch.equal(compiled(_executor=mode), want)
        assert [e.name for e in compiled.last_trace.events] == ["matmul_0"]
    doc = compiled.explain()
    assert doc["critical_path"][0]["task"] == "matmul_0"
    assert abs(doc["bucket_total_s"] - doc["makespan_s"]) \
        <= 0.01 * doc["makespan_s"]
    assert isinstance(compiled.last_memory, MemoryLedger)
    assert compiled.last_memory.peak_bytes() == compiled.predicted_peak_bytes
    assert d.telemetry is tel
    assert tel.counters()["dispatch.predicted"] >= 3
    assert [e["name"] for e in tel.events("makespan")] \
        == ["makespan:sequential", "makespan:async", "makespan:adaptive"]
    # same shape class reuses the schedule; another class must re-trace
    small = compiled(torch.ones(47, 40), torch.ones(40, 32))
    assert tuple(small.shape) == (47, 32)
    with pytest.raises(ValueError, match="shape class"):
        compiled(torch.ones(480, 40), torch.ones(40, 32))
    cold = Dispatcher(registry=reg, cache=TuningCache(
        root=str(tmp_path / "cold"), fingerprint=current_fingerprint("cpu")))
    with pytest.raises(ValueError, match="no fitted model"):
        tb.program.compile(devices=cold)


def test_export_schema_gate_and_validation(tmp_path, reg):
    d, (a, b, _) = _seeded(tmp_path, reg)
    with trace(registry=reg) as tb:
        ops.matmul(a, b)
    doc = tb.program.to_json()
    doc["nodes"][0]["params"]["k"] = 999
    with pytest.raises(ValueError, match="stored params"):
        Program.from_json(doc, registry=reg)
    doc["schema"] = 99
    with pytest.raises(ValueError, match="unknown program schema"):
        Program.from_json(doc)
    with trace(registry=reg) as tb16:
        ops.matmul(a.bfloat16(), b.bfloat16())
    assert tb16.program.to_json()["inputs"][0]["dtype"] == "bfloat16"
    assert Program.from_json(tb16.program.to_json(), registry=reg) \
        == tb16.program
