"""repro_torch.exec against repro.exec: the async executor (out-of-order
firing, error propagation, validation), transfer planning and the
comm-aware EFT on the two-simdev diamond built by each package's
``fake_matmul_device`` over the same seeded caches, comm-model caches and
Chrome traces that move between the packages, the bit-exact
async-vs-sequential acceptance, the bucketed shape specs, the workloads'
schedules and transfer plans over two simulated lanes, and the rules of
real devices (a transfer hook is required, operands must lie on their
lane's device)."""
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi              # before repro.workloads (import cycle)
from repro.exec import CommModel as JCommModel
from repro.exec import ExecutionTrace as JExecutionTrace
from repro.runtime import Dispatcher as JDispatcher
from repro.runtime import Fingerprint as JFingerprint
from repro.runtime import TuningCache as JTuningCache
from repro.runtime import default_registry as jdefault_registry
from repro.runtime import seed_from_programs as jseed
from repro.runtime.simdev import SimLink as JSimLink
from repro.runtime.simdev import fake_matmul_device as jfake_device
from repro.workloads import get_workload as jget_workload
from repro.workloads import suite_registry as jsuite_registry
from repro_torch.api import Program, ops, trace, use_dispatcher
from repro_torch.core.scheduler import makespan, schedule
from repro_torch.exec import (AsyncExecutor, CommModel, ExecTask,
                              ExecutionTrace, copy_to_dst, plan_buffers,
                              transfer_kernel, value_nbytes)
from repro_torch.obs import Telemetry
from repro_torch.runtime import (Dispatcher, DispatchPolicy, Fingerprint,
                                 TuningCache, bucket_dim, default_registry,
                                 seed_from_programs, shape_bucket,
                                 shape_class)
from repro_torch.runtime.simdev import SimLink, fake_matmul_device
from repro_torch.workloads import get_workload, suite_registry

N = 160          # square matmul size: ~8ms/node on the 1e9 F/s sim device
# the comm caches both packages read: one fingerprint, so one directory
COMM_FP = ("sim", "comm", 1, 1, ("float32",))


# --------------------------------------------------------------------------
# fixtures: two simulated devices, a simulated link, a diamond program
# --------------------------------------------------------------------------

def _devices(tmp_path, simulate_time=False, time_scale=1.0, policy=None):
    reg = default_registry(include=["matmul"])
    return reg, {
        name: fake_matmul_device(str(tmp_path / "devs"), name, speed, reg,
                                 simulate_time=simulate_time,
                                 time_scale=time_scale, policy=policy)
        for name, speed in (("d0", 1.0e9), ("d1", 0.9e9))}


def _jdevices(tmp_path):
    reg = jdefault_registry(include=["matmul"])
    return reg, {name: jfake_device(str(tmp_path / "jdevs"), name, speed, reg)
                 for name, speed in (("d0", 1.0e9), ("d1", 0.9e9))}


def _comm(tmp_path, link):
    comm = CommModel(TuningCache(root=str(tmp_path / "comm"),
                                 fingerprint=Fingerprint(*COMM_FP)))
    link.measure_into(comm, [("d0", "d1"), ("d1", "d0")])
    return comm


def _jcomm_shared(tmp_path):
    """A comm model the JAX package measured, and the port's over the
    same files."""
    root = str(tmp_path / "comm")
    jcomm = JCommModel(JTuningCache(root=root,
                                    fingerprint=JFingerprint(*COMM_FP)))
    JSimLink(latency_s=1e-3, bytes_per_s=1e9).measure_into(
        jcomm, [("d0", "d1"), ("d1", "d0")])
    return jcomm, CommModel(TuningCache(root=root,
                                        fingerprint=Fingerprint(*COMM_FP)))


def _diamond_arrays(width):
    rng = np.random.RandomState(0)
    return [rng.rand(N, N).astype(np.float32) for _ in range(2 + width)]


def _diamond(reg, width=2):
    """root -> ``width`` independent branches -> join tree; outputs = every
    node, so tests can compare per-node results across executors."""
    arrs = [torch.from_numpy(a) for a in _diamond_arrays(width)]
    with trace(registry=reg) as tb:
        root = ops.matmul(arrs[0], arrs[1])
        branches = [ops.matmul(root, w) for w in arrs[2:]]
        join = branches[0]
        for b in branches[1:]:
            join = ops.matmul(join, b)
    prog = tb.program
    return Program(prog.inputs, prog.nodes,
                   tuple(n.name for n in prog.nodes)), dict(tb.bindings)


def _jdiamond(reg, width=2):
    arrs = [jnp.asarray(a) for a in _diamond_arrays(width)]
    with japi.trace(registry=reg) as tb:
        root = japi.ops.matmul(arrs[0], arrs[1])
        branches = [japi.ops.matmul(root, w) for w in arrs[2:]]
        join = branches[0]
        for b in branches[1:]:
            join = japi.ops.matmul(join, b)
    prog = tb.program
    return japi.Program(prog.inputs, prog.nodes,
                        tuple(n.name for n in prog.nodes)), dict(tb.bindings)


def _plan(compiled):
    return ({k: (v.device, v.start, v.finish)
             for k, v in compiled.assignments.items()},
            [(t.name, t.lane, t.nbytes) for t in compiled.transfers],
            compiled.makespan)


# --------------------------------------------------------------------------
# the two packages plan alike
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", [2, 4])
def test_diamond_plans_identically_in_both_packages(width, tmp_path):
    """Each package's fake_matmul_device over the same seeded rows, and one
    comm cache: identical EFT assignments, transfers (names, lanes,
    bytes), buffer homes and makespans."""
    jreg, jdevs = _jdevices(tmp_path)
    reg, devs = _devices(tmp_path)
    jcomm, comm = _jcomm_shared(tmp_path)
    jprog, jbind = _jdiamond(jreg, width)
    prog, bind = _diamond(reg, width)
    assert prog.to_json() == jprog.to_json()
    jc = jprog.compile(devices=jdevs, bindings=jbind, comm=jcomm,
                       executor="async")
    tc = prog.compile(devices=devs, bindings=bind, comm=comm,
                      executor="async")
    assert _plan(tc) == _plan(jc)
    assert tc.transfers, "the diamond should cross the link"
    assert tc.buffers.placements == jc.buffers.placements
    assert tc.task_meta() == jc.task_meta()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_comm_cache_moves_between_packages(writer, tmp_path):
    root = str(tmp_path / "comm")
    make = {"jax": lambda: JCommModel(JTuningCache(
                root=root, fingerprint=JFingerprint(*COMM_FP))),
            "port": lambda: CommModel(TuningCache(
                root=root, fingerprint=Fingerprint(*COMM_FP)))}
    link = {"jax": JSimLink, "port": SimLink}[writer](latency_s=2e-3,
                                                      bytes_per_s=1e9)
    w = make[writer]()
    link.measure_into(w, [("a", "b")])
    r = make["port" if writer == "jax" else "jax"]()
    assert r.has_pair("a", "b") and not r.has_pair("b", "a")
    for nbytes in (1 << 12, 1 << 20, 3e6):
        assert r.predict("a", "b", nbytes) == w.predict("a", "b", nbytes)
    assert transfer_kernel("a", "b") in r.cache.kernels()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chrome_traces_round_trip_across_packages(writer):
    make = {"jax": JExecutionTrace, "port": ExecutionTrace}
    tr = make[writer](epoch=10.0)
    tr.record("a", "compute", "d0", 10.0, 10.5,
              meta={"kernel": "matmul", "predicted_s": 0.4})
    tr.record("xfer:a:d0->d1", "transfer", "d0->d1", 10.5, 10.6,
              deps=("a",))
    tr.record("steal:b", "steal", "d1", 10.6, 10.6, note="d0->d1")
    tr.record("b", "compute", "d1", 10.6, 11.0, note="stolen:d0->d1",
              deps=("xfer:a:d0->d1",))
    doc = json.loads(json.dumps(tr.to_chrome()))
    back = make["port" if writer == "jax" else "jax"].from_chrome(doc)
    assert back.to_chrome() == doc
    key = lambda e: (e.name, e.kind, e.device, round(e.begin_s, 9),  # noqa
                     round(e.end_s, 9), e.note, e.deps, e.meta)
    assert sorted(map(key, back.events)) == sorted(
        key(type(e)(e.name, e.kind, e.device, e.begin_s - 10.0,
                    e.end_s - 10.0, e.note, e.deps, e.meta))
        for e in tr.events)
    assert [e.name for e in back.steals()] == ["steal:b"]


def test_port_trace_merges_telemetry_counter_tracks_and_instants():
    """``to_chrome(telemetry=)`` adds one ``telemetry`` thread row: every
    gauge point becomes a "C" counter event, instants and spans land on
    that row, all on the trace's epoch; the task events are unchanged and
    ``from_chrome`` skips the merged rows."""
    ticks = iter(range(100))
    tel = Telemetry(clock=lambda: float(next(ticks)))     # epoch 0.0
    tr = ExecutionTrace()
    tr.set_epoch(1.0)
    tr.record("a", "compute", "d0", 1.0, 3.0)
    tr.record("b", "compute", "d1", 2.0, 4.0, deps=("a",))
    tel.gauge("exec.queue_depth.d0", 2)                   # t = 1
    tel.gauge("exec.queue_depth.d0", 0)                   # t = 2
    tel.instant("gate:matmul", cat="gate", kernel="matmul")   # t = 3
    with tel.span("refit", cat="refit"):                  # t = 4 .. 5
        pass
    plain = tr.to_chrome()
    doc = tr.to_chrome(telemetry=tel)
    merged = doc["traceEvents"][len(plain["traceEvents"]):]
    assert doc["traceEvents"][:len(plain["traceEvents"])] \
        == plain["traceEvents"]
    assert merged[0] == {"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": 2, "cat": "__metadata",
                         "args": {"name": "telemetry"}}
    assert [(e["ph"], e["ts"], e["args"]) for e in merged
            if e["name"] == "exec.queue_depth.d0"] \
        == [("C", 0.0, {"value": 2.0}), ("C", 1e6, {"value": 0.0})]
    gate, = [e for e in merged if e["name"] == "gate:matmul"]
    assert (gate["ph"], gate["s"], gate["tid"], gate["ts"], gate["args"]) \
        == ("i", "t", 2, 2e6, {"kernel": "matmul"})
    span, = [e for e in merged if e["name"] == "refit"]
    assert (span["ph"], span["ts"], span["dur"]) == ("X", 3e6, 1e6)
    back = ExecutionTrace.from_chrome(doc)
    assert [(e.name, e.deps) for e in back.by_start()] \
        == [("a", ()), ("b", ("a",))]


# --------------------------------------------------------------------------
# AsyncExecutor: the generic engine, driven directly
# --------------------------------------------------------------------------

def test_out_of_start_order_completion():
    """A slow early task must not block an independent ready task on
    another device — the exact failure mode of the sequential bridge."""
    tracer = ExecutionTrace()
    order = []

    def slow(env):
        time.sleep(0.15)
        order.append("slow")
        return "slow"

    def fast(env):
        time.sleep(0.01)
        order.append("fast")
        return "fast"

    def after_fast(env):
        order.append("after:" + env["fast"])

    tasks = [ExecTask("slow", "d0", slow, priority=0.0),
             ExecTask("fast", "d1", fast, priority=1.0),
             ExecTask("after", "d1", after_fast, deps=("fast",),
                      priority=2.0)]
    AsyncExecutor(tracer=tracer).run(tasks)
    assert order == ["fast", "after:fast", "slow"]
    ev = {e.name: e for e in tracer.events}
    assert ev["after"].end_s < ev["slow"].end_s
    assert ev["slow"].device == "d0" and ev["fast"].device == "d1"


def test_executor_deps_fire_and_env_resolves():
    seen = {}

    def make(name, deps, lane):
        def fn(env, name=name, deps=deps):
            seen[name] = [env[d] for d in deps]
            return name
        return ExecTask(name, lane, fn, tuple(deps))

    tasks = [make("a", (), "dev0"), make("b", ("a",), "dev1"),
             make("c", ("a",), "dev2"), make("d", ("b", "c"), "dev0")]
    assert AsyncExecutor().run(tasks) == {"a": "a", "b": "b", "c": "c",
                                          "d": "d"}
    assert seen["d"] == ["b", "c"]
    assert AsyncExecutor().run([]) == {}


@pytest.mark.parametrize("tasks,match", [
    ([("a", ("b",)), ("b", ("a",))], "cycle"),
    ([("a", ("ghost",))], "unknown task"),
    ([("a", ()), ("a", ())], "duplicate")])
def test_executor_rejects_cycles_and_unknown_deps(tasks, match):
    ok = lambda env: None  # noqa: E731
    with pytest.raises(ValueError, match=match):
        AsyncExecutor().run([ExecTask(n, "d", ok, deps=d) for n, d in tasks])


def test_executor_error_propagates_and_shuts_down():
    def boom(env):
        raise RuntimeError("kernel exploded")

    ran = []
    tasks = [ExecTask("boom", "d0", boom),
             ExecTask("never", "d0", lambda env: ran.append(1),
                      deps=("boom",))]
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="kernel exploded"):
        AsyncExecutor().run(tasks)
    assert not ran                       # dependent never fired
    deadline = time.time() + 5.0         # workers joined, no thread leak
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


# --------------------------------------------------------------------------
# transfer planning + comm-aware EFT on the two-simdev diamond
# --------------------------------------------------------------------------

def test_transfer_insertion_and_makespan_accounting(tmp_path):
    """Cross-device edges on the diamond materialize Transfer tasks, and
    the comm-aware EFT's predicted makespan accounts for them."""
    reg, devices = _devices(tmp_path)
    comm = _comm(tmp_path, SimLink(latency_s=1e-3, bytes_per_s=1e9))
    prog, bindings = _diamond(reg)
    compiled = prog.compile(devices=devices, bindings=bindings, comm=comm)
    a = compiled.assignments
    assert {a[b].device for b in ("matmul_1", "matmul_2")} == {"d0", "d1"}
    node_dev = {n.name: a[n.name].device for n in prog.nodes}
    spec_dev = dict(node_dev)
    for s in prog.inputs:
        spec_dev[s.name] = compiled.buffers.device_of(s.name)
    expected = {(d, node_dev[n.name]) for n in prog.nodes for d in n.deps
                if spec_dev[d] != node_dev[n.name]}
    assert {(t.value, t.dst) for t in compiled.transfers} == expected
    assert len(compiled.transfers) >= 2
    tasks = {t.name: t for t in prog.to_kernel_tasks()}
    for n in prog.nodes:
        for d in n.deps:
            if d not in tasks or a[d].device == a[n.name].device:
                continue
            lag = comm.predict(a[d].device, a[n.name].device,
                               tasks[d].out_bytes)
            assert a[n.name].start >= a[d].finish + lag - 1e-12
    predict = lambda t, dev: devices[dev].predict_time(t.kernel,  # noqa
                                                       t.params)
    free = schedule(prog.to_kernel_tasks(), predict, list(devices))
    assert compiled.makespan >= makespan(free) - 1e-12


def test_input_transfers_priced_by_eft(tmp_path):
    """An input consumed on a device other than its home delays that
    consumer by the predicted transfer, and both back ends still agree."""
    reg, devices = _devices(tmp_path)
    comm = _comm(tmp_path, SimLink(latency_s=2e-3, bytes_per_s=1e9))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(N, N).astype(np.float32))
    wb = torch.from_numpy(rng.rand(N, 4 * N).astype(np.float32))
    ws = torch.from_numpy(rng.rand(N, N).astype(np.float32))
    with trace(registry=reg) as tb:
        big = ops.matmul(x, wb)
        small = ops.matmul(x, ws)
    prog = tb.program
    by_name = {t.name: t for t in prog.to_kernel_tasks()}
    x_bytes = float(value_nbytes((N, N), "float32"))
    assert by_name[big.name].input_deps == (("in0", x_bytes),
                                            ("in1", x_bytes * 4))
    compiled = prog.compile(devices=devices, bindings=tb.bindings,
                            comm=comm)
    a = compiled.assignments
    assert a[big.name].device != a[small.name].device
    home = compiled.buffers.device_of("in0")
    assert home == a[big.name].device
    xfer = compiled.buffers.transfer_for("in0", a[small.name].device)
    assert xfer is not None and xfer.nbytes == int(x_bytes)
    lag = comm.predict(home, a[small.name].device, x_bytes)
    assert lag > 0.0 and a[small.name].start >= lag - 1e-12
    out_seq = compiled(_executor="sequential")
    out_async = compiled(_executor="async")
    for s_, a_ in zip(out_seq, out_async):
        assert torch.equal(s_, a_)


def test_value_nbytes_and_plan_buffers(tmp_path):
    reg, devices = _devices(tmp_path)
    comm = _comm(tmp_path, SimLink())
    prog, bindings = _diamond(reg)
    assert value_nbytes((N, N), "float32") == N * N * 4
    assert value_nbytes((3, 5), torch.bfloat16) == 30
    assert value_nbytes((3, 5), "bfloat16") == 30
    compiled = prog.compile(devices=devices, bindings=bindings, comm=comm)
    for t in compiled.transfers:
        assert t.nbytes == N * N * 4 and t.lane == f"{t.src}->{t.dst}"
    plain = prog.compile(devices=devices, bindings=bindings)
    table = plan_buffers(prog, plain.assignments)
    for node in prog.nodes:
        assert table.device_of(node.name) == plain.device_of(node.name)
    for spec in prog.inputs:
        consumers = [n for n in prog.nodes if spec.name in n.deps]
        first = min(consumers, key=lambda n: plain.assignments[n.name].start)
        assert table.device_of(spec.name) == plain.device_of(first.name)


def test_comm_model_persists_as_pseudo_kernel(tmp_path):
    link = SimLink(latency_s=2e-3, bytes_per_s=1e9)
    fp = Fingerprint(*COMM_FP)
    comm = CommModel(TuningCache(root=str(tmp_path / "comm"),
                                 fingerprint=fp))
    link.measure_into(comm, [("a", "b")])
    assert comm.predict("a", "a", 1 << 20) == 0.0
    p = comm.predict("a", "b", 1 << 20)
    assert 0.2 * link.seconds(1 << 20) < p < 5.0 * link.seconds(1 << 20)
    reloaded = CommModel(TuningCache(root=str(tmp_path / "comm"),
                                     fingerprint=fp))
    assert reloaded.predict("a", "b", 1 << 20) == pytest.approx(p)
    with pytest.raises(ValueError, match="no measured transfer model"):
        reloaded.predict("b", "a", 1 << 20)
    assert not reloaded.has_pair("b", "a")


def test_measure_pair_times_tensor_payloads_on_the_source(tmp_path):
    """The payload is a tensor on src when src names a real device (the
    host here), and real copies fit a finite, positive model."""
    seen = []
    comm = CommModel(TuningCache(root=str(tmp_path / "comm"),
                                 fingerprint=Fingerprint(*COMM_FP)))

    def record(buf):
        seen.append((buf.device.type, buf.dtype, buf.nbytes))
        return buf.clone()
    comm.measure_pair("cpu", "d1", record, sizes=(1 << 10, 1 << 14),
                      min_window=1e-4)
    assert {s[:2] for s in seen} == {("cpu", torch.uint8)}
    assert {s[2] for s in seen} == {1 << 10, 1 << 14}
    assert 0.0 < comm.predict("cpu", "d1", 1 << 12) < 1.0


# --------------------------------------------------------------------------
# CompiledProgram: async vs sequential — determinism and acceptance
# --------------------------------------------------------------------------

def _acceptance_setup(tmp_path, time_scale):
    reg, devices = _devices(tmp_path, simulate_time=True,
                            time_scale=time_scale)
    link = SimLink(latency_s=5e-4, bytes_per_s=2e9)
    comm = _comm(tmp_path, link)
    prog, bindings = _diamond(reg, width=4)
    compiled = prog.compile(devices=devices, bindings=bindings,
                            executor="async", comm=comm,
                            transfer=link.transfer)
    compiled(_executor="sequential")          # first calls outside clocks
    return compiled


def test_async_overlaps_and_matches_bitwise(tmp_path):
    """Async per-node outputs equal the sequential reference bit for bit,
    every planned transfer ran on its link lane in both, and the trace
    shows compute on the two devices overlapping in time."""
    compiled = _acceptance_setup(tmp_path, time_scale=1.0)
    seq = compiled(_executor="sequential")
    seq_moves = {e.name for e in compiled.last_trace.events
                 if e.kind == "transfer"}
    asy = compiled()                          # compiled executor == async
    for s, a in zip(seq, asy):
        assert torch.equal(s, a)
    tr = compiled.last_trace
    moves = {e.name for e in tr.events if e.kind == "transfer"}
    assert moves == seq_moves == {t.name for t in compiled.transfers}
    lanes = tr.devices()
    assert "d0" in lanes and "d1" in lanes and any("->" in x for x in lanes)
    comp = [e for e in tr.events if e.kind == "compute"]
    assert any(a.device != b.device
               and a.begin_s < b.end_s and b.begin_s < a.end_s
               for i, a in enumerate(comp) for b in comp[i + 1:])


def test_async_wall_clock_beats_sequential(tmp_path):
    """The async executor's wall clock is measurably below the sequential
    bridge's, with the JAX test's margin (0.85x, best of three)."""
    compiled = _acceptance_setup(tmp_path, time_scale=6.0)

    def best_of(n, fn):
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return min(walls)

    seq_wall = best_of(3, lambda: compiled(_executor="sequential"))
    async_wall = best_of(3, lambda: compiled())
    assert async_wall < 0.85 * seq_wall, \
        f"no overlap win: async {async_wall:.3f}s vs seq {seq_wall:.3f}s"


def test_async_determinism_under_fixed_tunecache(tmp_path):
    """Same persisted caches -> same schedule, same transfers, and
    bit-identical async outputs across fresh dispatchers (confidence gate
    pinned off, as in the JAX test)."""
    policy = DispatchPolicy(confidence_gate=False)
    reg, first = _devices(tmp_path, policy=policy)
    comm = _comm(tmp_path, SimLink())
    prog, bindings = _diamond(reg)
    c1 = prog.compile(devices=first, bindings=bindings, executor="async",
                      comm=comm)
    out1 = c1()

    def reload(name):
        fp = Fingerprint("sim", name, 1, 1, ("float32",))
        return Dispatcher(registry=reg, policy=policy, cache=TuningCache(
            root=str(tmp_path / "devs"), fingerprint=fp))

    comm2 = CommModel(TuningCache(root=str(tmp_path / "comm"),
                                  fingerprint=Fingerprint(*COMM_FP)))
    c2 = prog.compile(devices={"d0": reload("d0"), "d1": reload("d1")},
                      bindings=bindings, executor="async", comm=comm2)
    out2 = c2()
    assert _plan(c1) == _plan(c2)
    for a, b in zip(out1, out2):
        assert torch.equal(a, b)
    for a, b in zip(out2, c2()):
        assert torch.equal(a, b)


def test_compile_rejects_unknown_executor(tmp_path):
    reg, devices = _devices(tmp_path)
    prog, bindings = _diamond(reg)
    with pytest.raises(ValueError, match="executor must be one of"):
        prog.compile(devices=devices, bindings=bindings, executor="warp")
    compiled = prog.compile(devices=devices, bindings=bindings)
    with pytest.raises(ValueError, match="executor must be one of"):
        compiled(_executor="warp")


def test_compiled_runs_ignore_another_threads_use_dispatcher(tmp_path):
    """Compiled runs use the dispatchers resolved at compile time: a
    ``use_dispatcher`` block held by the caller (or any thread) during the
    run routes none of its nodes."""
    reg, devices = _devices(tmp_path)
    prog, bindings = _diamond(reg)
    compiled = prog.compile(devices=devices, bindings=bindings,
                            executor="async")
    _, other = _devices(tmp_path / "other")
    before = {n: len(d.selections) for n, d in devices.items()}
    with use_dispatcher(other["d0"]):
        outs = compiled()
    assert not other["d0"].selections
    assert sum(len(d.selections) - before[n]
               for n, d in devices.items()) == len(prog.nodes)
    ref = compiled(_executor="sequential")
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# lane workers that live across runs (the compiled program's LanePool)
# --------------------------------------------------------------------------

def _pooled(tmp_path):
    """The width-4 diamond over two simulated devices and a link, compiled
    for the async executor; each dispatcher records the thread of every
    call, and one can be told to fail its next call."""
    reg, devices = _devices(tmp_path)
    link = SimLink(latency_s=1e-4, bytes_per_s=2e9)
    prog, bindings = _diamond(reg, width=4)
    compiled = prog.compile(devices=devices, bindings=bindings,
                            executor="async", comm=_comm(tmp_path, link),
                            transfer=link.transfer)
    seen, fail_next = [], []
    for disp in compiled.dispatchers.values():
        def spy(kernel, *args, _call=disp.dispatch, **kw):
            seen.append(threading.current_thread())
            if fail_next:
                fail_next.pop()
                raise RuntimeError("lane fault")
            return _call(kernel, *args, **kw)
        disp.dispatch = spy
    return compiled, seen, fail_next


def test_lane_threads_persist_across_runs(tmp_path):
    """Three async runs of one compiled program run their nodes on the same
    long-lived lane threads, which the program's pool holds."""
    compiled, seen, _ = _pooled(tmp_path)
    ref = compiled(_executor="sequential")
    runs = []
    for _ in range(3):
        seen.clear()
        for a, b in zip(compiled(), ref):
            assert torch.equal(a, b)
        runs.append(set(seen))
    threads = compiled.lane_pool().threads
    assert runs[0] == runs[1] == runs[2]
    assert runs[0] <= set(threads.values())
    assert {lane for lane, _ in threads} >= {"d0", "d1"}
    assert all(th.is_alive() and th.daemon for th in threads.values())
    assert threading.current_thread() not in runs[0]
    compiled.close()


@pytest.mark.parametrize("mode", ["async", "adaptive"])
def test_pooled_runs_equal_sequential_bit_for_bit(tmp_path, mode):
    compiled, _, _ = _pooled(tmp_path)
    ref = compiled(_executor="sequential")
    for _ in range(3):
        for a, b in zip(compiled(_executor=mode), ref):
            assert torch.equal(a, b)
    compiled.close()


def test_failed_run_leaves_the_pool_usable(tmp_path):
    """A node that raises fails its run with the node's error; the pool's
    threads are back on their inboxes, and the next run is right."""
    compiled, seen, fail_next = _pooled(tmp_path)
    ref = compiled(_executor="sequential")
    compiled()
    threads = compiled.lane_pool().threads
    fail_next.append(True)
    with pytest.raises(RuntimeError, match="lane fault"):
        compiled()
    assert compiled.lane_pool().threads == threads
    assert not compiled.lane_pool().lock.locked()
    for mode in ("async", "adaptive"):
        for a, b in zip(compiled(_executor=mode), ref):
            assert torch.equal(a, b)
    assert compiled.lane_pool().threads == threads
    compiled.close()


def test_concurrent_callers_take_turns_on_the_pool(tmp_path):
    compiled, _, _ = _pooled(tmp_path)
    ref = compiled(_executor="sequential")
    results, errors = [], []

    def call():
        try:
            results.append(compiled())
        except BaseException as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    callers = [threading.Thread(target=call) for _ in range(3)]
    for c in callers:
        c.start()
    for c in callers:
        c.join()
    assert not errors and len(results) == 3
    for outs in results:
        for a, b in zip(outs, ref):
            assert torch.equal(a, b)
    compiled.close()


def test_close_and_collection_release_the_lane_threads(tmp_path):
    """After close() the thread count is back to its value before compile,
    and a program dropped without close() releases its threads when it is
    collected."""
    import gc

    before = threading.active_count()
    compiled, _, _ = _pooled(tmp_path)
    compiled()
    assert threading.active_count() > before
    compiled.close()
    assert threading.active_count() == before
    compiled(_executor="adaptive")              # a later run starts anew
    assert threading.active_count() > before
    del compiled
    gc.collect()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_executor_pool_initialises_each_slot_once():
    """The pool calls init(lane) once per thread; an init that fails raises
    from the run and leaves that slot to be started again."""
    from repro_torch.exec import LanePool

    calls, broken = [], ["d1"]

    def init(lane):
        calls.append((lane, threading.current_thread()))
        if lane in broken:
            broken.remove(lane)
            raise RuntimeError("no such card")

    pool = LanePool(init=init)
    tasks = [ExecTask("a", "d0", lambda env: 1),
             ExecTask("b", "d1", lambda env: env["a"] + 1, deps=("a",))]
    with pytest.raises(RuntimeError, match="no such card"):
        AsyncExecutor().run(tasks, pool=pool)
    assert set(pool.threads) == {("d0", 0)}
    for _ in range(2):
        assert AsyncExecutor().run(tasks, pool=pool) == {"a": 1, "b": 2}
    assert sorted(lane for lane, _ in calls[:2]) == ["d0", "d1"]
    assert len(calls) == 3 and calls[2][0] == "d1"
    assert calls[2][1] is pool.threads[("d1", 0)]
    pool.close()
    assert pool.threads == {}


# --------------------------------------------------------------------------
# real devices: transfers need a hook, operands must lie on their lane
# --------------------------------------------------------------------------

def test_real_two_device_compile_needs_a_transfer_hook(tmp_path):
    reg, sims = _devices(tmp_path)
    prog, bindings = _diamond(reg)
    real = {"cuda:0": sims["d0"], "cpu": sims["d1"]}
    with pytest.raises(ValueError, match="give a transfer hook"):
        prog.compile(devices=real, bindings=bindings)
    # one real device moves nothing; simulated lanes share the host
    prog.compile(devices={"cpu": sims["d0"]}, bindings=bindings)
    prog.compile(devices=sims, bindings=bindings)
    compiled = prog.compile(devices=real, bindings=bindings,
                            transfer=copy_to_dst)
    assert {t.src for t in compiled.transfers} <= {"cuda:0", "cpu"}


def test_operands_off_their_lane_device_raise(tmp_path):
    """A compute task on the ``cpu`` lane whose operand lies on another
    device (``meta`` here) raises instead of running it elsewhere."""
    reg, sims = _devices(tmp_path)
    prog, bindings = _diamond(reg)
    compiled = prog.compile(devices={"cpu": sims["d0"]}, bindings=bindings)
    env = {name: t.to("meta") if name == "in0" else t
           for name, t in compiled._bind((), {}).items()}
    root = next(t for t in compiled._exec_tasks(env)
                if t.name == "matmul_0")
    with pytest.raises(ValueError, match="lies on meta"):
        root.fn({})
    outs = compiled(_executor="async")        # home-placed inputs run
    assert all(o.device.type == "cpu" for o in outs)


def test_copy_to_dst_moves_to_named_devices():
    from repro_torch.exec import Transfer
    x = torch.arange(6.0)
    moved = copy_to_dst(x, Transfer("x", "cuda:0", "cpu", x.nbytes))
    assert torch.equal(moved, x) and moved.device.type == "cpu"
    with pytest.raises(ValueError, match="names no torch device"):
        copy_to_dst(x, Transfer("x", "cpu", "d1", x.nbytes))


# --------------------------------------------------------------------------
# execution trace exports
# --------------------------------------------------------------------------

def test_trace_chrome_and_gantt_exports(tmp_path):
    tr = ExecutionTrace()
    tr.record("a", "compute", "d0", 10.0, 10.5)
    tr.record("x", "transfer", "d0->d1", 10.5, 10.6)
    tr.record("b", "compute", "d1", 10.6, 11.0)
    assert tr.wall_s == pytest.approx(1.0)
    assert tr.busy_s("d0") == pytest.approx(0.5)
    assert tr.devices() == ["d0", "d0->d1", "d1"]
    doc = tr.to_chrome()
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(xs) == 3 and len(metas) == 3
    first = next(e for e in xs if e["name"] == "a")
    assert first["ts"] == 0.0 and first["dur"] == pytest.approx(5e5)
    lines = tr.to_gantt_csv().strip().splitlines()
    assert lines[0] == "task,kind,device,start_s,finish_s"
    assert len(lines) == 4 and lines[1].startswith("a,compute,d0,0.0")
    path = str(tmp_path / "trace.json")
    tr.save_chrome(path)
    assert json.load(open(path))["displayTimeUnit"] == "ms"


# --------------------------------------------------------------------------
# bucketed shape specs
# --------------------------------------------------------------------------

def test_shape_class_agrees_with_cache_buckets():
    assert shape_class((100, 64)) == (bucket_dim(100), bucket_dim(64))
    assert shape_bucket({"m": 100})[0][1] == shape_class((100,))[0]
    assert shape_class((96, 100)) == shape_class((100, 100))
    assert shape_class((8, 8)) != shape_class((100, 100))


def test_compiled_program_reuses_schedule_across_shape_jitter(tmp_path):
    reg, devices = _devices(tmp_path)
    prog, bindings = _diamond(reg)
    compiled = prog.compile(devices=devices, bindings=bindings)
    rng = np.random.RandomState(1)
    M = N - 8                                  # same log2 class as N
    jitter = [torch.from_numpy(rng.rand(M, M).astype(np.float32))
              for _ in range(4)]
    outs = compiled(*jitter)
    torch.testing.assert_close(outs[0], jitter[0] @ jitter[1], rtol=2e-4,
                               atol=2e-4)
    assert tuple(outs[0].shape) == (M, M)
    with pytest.raises(ValueError, match="shape class"):
        compiled(*[torch.zeros(8, 8)] * 4)
    bad = [torch.zeros(M, M), torch.zeros(N, M), torch.zeros(M, M),
           torch.zeros(M, M)]
    with pytest.raises(ValueError, match="contraction dims"):
        compiled(*bad)
    # the transfer hook sees payload sizes of the LIVE tensors, in every
    # back end
    seen = []

    def hook(v, tr):
        seen.append(tr.nbytes)
        return v
    resized = prog.compile(devices=devices, bindings=bindings,
                           executor="async", comm=_comm(tmp_path, SimLink()),
                           transfer=hook)
    assert resized.transfers
    for mode in ("async", "sequential"):
        seen.clear()
        resized(*jitter, _executor=mode)
        assert seen and all(nb == M * M * 4 for nb in seen)


# --------------------------------------------------------------------------
# the workloads over two simulated lanes, in both packages
# --------------------------------------------------------------------------

def _seeded(root, programs, reg, jax_side):
    devices = {}
    for name, speed in (("d0", 1.0e9), ("d1", 0.8e9)):
        fp = (JFingerprint if jax_side else Fingerprint)(
            "sim", f"exec-{name}", 1, 1, ("float32",))
        cache = (JTuningCache if jax_side else TuningCache)(
            root=str(root / ("jax" if jax_side else "port")), fingerprint=fp)
        d = (JDispatcher if jax_side else Dispatcher)(registry=reg,
                                                      cache=cache)
        (jseed if jax_side else seed_from_programs)(d, programs, speed)
        devices[name] = d
    return devices


@pytest.mark.parametrize("name", ["image_pipeline", "mixed_dag"])
def test_workloads_plan_alike_and_run_async(name, tmp_path):
    """Compiled async over two simulated lanes with one comm cache: the
    same schedule and transfer plan in both packages (the JAX program
    cannot run its Pallas kernels here), and the port's async outputs
    equal its sequential ones and match the JAX reference."""
    jreg, reg = jsuite_registry([name]), suite_registry([name])
    jb = jget_workload(name).build("small", registry=jreg)
    tb = get_workload(name).build("small", registry=reg, device="cpu")
    jcomm, comm = _jcomm_shared(tmp_path)
    jc = jb.program.compile(devices=_seeded(tmp_path, [jb.program], jreg,
                                            True),
                            bindings=jb.bindings, comm=jcomm,
                            executor="async")
    tc = tb.program.compile(devices=_seeded(tmp_path, [tb.program], reg,
                                            False),
                            bindings=tb.bindings, comm=comm,
                            executor="async")
    assert _plan(tc) == _plan(jc)
    assert tc.buffers.placements == jc.buffers.placements
    assert len({a.device for a in tc.assignments.values()}) == 2 or \
        name == "image_pipeline"
    outs, seq = tc(), tc(_executor="sequential")
    outs = outs if isinstance(outs, tuple) else (outs,)
    seq = seq if isinstance(seq, tuple) else (seq,)
    for o, s, r in zip(outs, seq, jb.reference()):
        assert torch.equal(o, s)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
