"""Adaptive execution in the port against repro.exec: the steal rule gives
the same answer in both packages for the same loads and predictors;
idle-only and min_advantage gating, no blind steals, static tasks never
move; runtime re-dispatch and online feedback flipping a later decision
mid-run; determinism under reloaded tuning caches; shared-bus contention
in the EFT, the executor's lanes and SimFabric's wall clock; the
first-error abort; and the adaptive back end's bit-exactness against the
sequential bridge."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.exec import AsyncExecutor as JAsyncExecutor
from repro.exec import ExecTask as JExecTask
from repro.exec import StealPolicy as JStealPolicy
from repro_torch.api import compile_program, ops, trace
from repro_torch.core.nnc import LinearModel
from repro_torch.core.scheduler import KernelTask, makespan, schedule
from repro_torch.exec import (AsyncExecutor, Bus, CommModel, ExecTask,
                              ExecutionTrace, StealPolicy, Topology,
                              Transfer)
from repro_torch.runtime import (Dispatcher, DispatchPolicy, Fingerprint,
                                 TuningCache, default_registry)
from repro_torch.runtime.online import OnlineConfig
from repro_torch.runtime.simdev import (SimFabric, SimLink,
                                        SkewedSimDispatcher,
                                        fake_matmul_device, true_time_at)

N = 160
COMM_FP = ("sim", "comm", 1, 1, ("float32",))


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

def _devices(tmp_path, simulate_time=False, time_scale=1.0, policy=None):
    reg = default_registry(include=["matmul"])
    return reg, {
        name: fake_matmul_device(str(tmp_path / "devs"), name, speed, reg,
                                 simulate_time=simulate_time,
                                 time_scale=time_scale, policy=policy)
        for name, speed in (("d0", 1.0e9), ("d1", 0.9e9))}


def _comm(tmp_path, link, pairs=(("d0", "d1"), ("d1", "d0"))):
    comm = CommModel(TuningCache(root=str(tmp_path / "comm"),
                                 fingerprint=Fingerprint(*COMM_FP)))
    link.measure_into(comm, pairs)
    return comm


def _three_matmuls(reg):
    rng = np.random.RandomState(0)
    a, b, w = (torch.from_numpy(rng.rand(N, N).astype(np.float32))
               for _ in range(3))
    with trace(registry=reg) as tb:
        x = ops.matmul(a, b)
        y = ops.matmul(x, w)
        ops.matmul(x, y)
    return tb.program, dict(tb.bindings)


def _steal_task(name, planned, predict, deps=(), inputs=(), fn=None,
                prio=0.0, task_type=ExecTask):
    """A steal-eligible task whose body records where it ran."""
    ran = {}

    def body(env, dev):
        ran["device"] = dev
        if fn is not None:
            fn()
        return name
    task = task_type(name, planned, lambda env: body(env, planned),
                     deps=deps, priority=prio, run_on=body,
                     runnable_on=("d0", "d1"), predict=predict,
                     inputs=inputs)
    return task, ran


# --------------------------------------------------------------------------
# the pure steal rule, in both packages
# --------------------------------------------------------------------------

def _cold(src, dst, nbytes):
    raise ValueError("no measured transfer model")


def _half_blind(dev):
    if dev == "d1":
        raise KeyError("no model for this kernel on d1")
    return 0.05


# (policy kwargs, comm, predictions or predictor, inputs, load, expected)
RULE_CASES = [
    ({}, 0.03, {"d0": 0.05, "d1": 0.06}, (("x", "d0", 1024),),
     {"d0": 0.2, "d1": 0.0}, "d1"),
    ({}, 0.03, {"d0": 0.05, "d1": 0.06}, (("x", "d0", 1024),),
     {"d0": 0.0, "d1": 0.0}, "d0"),
    ({}, 0.03, {"d0": 0.05, "d1": 0.06}, (("x", "d0", 1024),),
     {"d0": 0.03, "d1": 0.0}, "d0"),
    ({}, 0.03, {"d0": 0.05, "d1": 0.06}, (("x", "d1", 1024),),
     {"d0": 0.02, "d1": 0.0}, "d1"),
    ({"idle_only": True}, None, {"d0": 0.05, "d1": 0.01}, (),
     {"d0": 0.5, "d1": 0.001}, "d0"),
    ({"idle_only": False}, None, {"d0": 0.05, "d1": 0.01}, (),
     {"d0": 0.5, "d1": 0.001}, "d1"),
    ({"min_advantage": 0.5}, None, {"d0": 0.05, "d1": 0.04}, (),
     {"d0": 0.01, "d1": 0.0}, "d0"),
    ({"min_advantage": 0.5}, None, {"d0": 0.05, "d1": 0.04}, (),
     {"d0": 0.5, "d1": 0.0}, "d1"),
    ({}, _cold, {"d0": 0.05, "d1": 0.01}, (("x", "d0", 1024),),
     {"d0": 1.0, "d1": 0.0}, "d0"),
    ({}, _cold, _half_blind, (), {"d0": 1.0, "d1": 0.0}, "d0"),
]


@pytest.mark.parametrize("policy,comm,predict,inputs,load,want", RULE_CASES)
def test_price_decision_agrees_with_jax(policy, comm, predict, inputs, load,
                                        want):
    """``decide_device`` and ``price_decision`` give the same device and the
    same priced alternatives in both packages: the move+run-vs-wait rule,
    idle-only and min_advantage gating, and never stealing blind (a cold
    comm pair or a device with no model drops the candidate)."""
    if isinstance(comm, float):
        comm = (lambda c: lambda src, dst, nbytes: c)(comm)
    if isinstance(predict, dict):
        predict = predict.get
    got = {}
    for side, (ex_type, task_type, pol_type) in {
            "port": (AsyncExecutor, ExecTask, StealPolicy),
            "jax": (JAsyncExecutor, JExecTask, JStealPolicy)}.items():
        ex = ex_type(steal=pol_type(**policy), comm=comm)
        task, _ = _steal_task("t", "d0", predict, inputs=inputs,
                              task_type=task_type)
        got[side] = (ex.decide_device(task, load),
                     ex.price_decision(task, load))
    assert got["port"] == got["jax"]
    assert got["port"][0] == want


def test_static_tasks_never_move():
    ex = AsyncExecutor(steal=StealPolicy(), comm=None)
    plain = ExecTask("t", "d0", lambda env: None)
    assert ex.decide_device(plain, {"d0": 9.9, "d1": 0.0}) == "d0"
    task, _ = _steal_task("t2", "d0", {"d0": 0.5, "d1": 0.01}.get)
    assert AsyncExecutor().decide_device(task, {"d0": 9.9, "d1": 0.0}) \
        == "d0"


# --------------------------------------------------------------------------
# executor: re-dispatch fires, feedback flips later decisions
# --------------------------------------------------------------------------

def test_executor_steals_loaded_lane_to_idle_device_and_traces():
    tracer = ExecutionTrace()
    hog = ExecTask("hog", "d0", lambda env: time.sleep(0.15) or "hog",
                   predict=lambda dev: 0.15, run_on=lambda env, dev: "hog",
                   runnable_on=("d0",), priority=0.0)
    task, ran = _steal_task("work", "d0", {"d0": 0.05, "d1": 0.06}.get,
                            prio=1.0)
    out = AsyncExecutor(tracer=tracer, steal=StealPolicy()).run([hog, task])
    assert out == {"hog": "hog", "work": "work"}
    assert ran["device"] == "d1"
    steals = tracer.steals()
    assert [e.name for e in steals] == ["steal:work"]
    assert steals[0].note == "d0->d1"
    ev = {e.name: e for e in tracer.events if e.kind == "compute"}
    assert ev["work"].device == "d1" and ev["work"].note == "stolen:d0->d1"
    assert ev["hog"].device == "d0" and ev["hog"].note == ""


def test_online_feedback_flips_a_later_steal_decision_mid_run():
    """The candidate device first predicts terribly; the observation hook
    corrects the model after the probe completes, and only then does the
    next ready task steal.  Without the hook nothing steals."""
    model = {"d1": 10.0}

    def predict(dev):
        return 0.01 if dev == "d0" else model["d1"]

    def build():
        hog = ExecTask("hog", "d0", lambda env: time.sleep(0.3) or None,
                       predict=lambda dev: 0.3, run_on=lambda e, d: None,
                       runnable_on=("d0",), priority=0.0)
        probe = ExecTask("probe", "d1",
                         lambda env: time.sleep(0.02) or "p", priority=0.0)
        early, early_ran = _steal_task("early", "d0", predict, prio=1.0)
        late, late_ran = _steal_task("late", "d0", predict,
                                     deps=("probe",), prio=2.0)
        return [hog, probe, early, late], early_ran, late_ran

    def observe(task, dev, seconds):
        model["d1"] = 0.001

    tasks, early_ran, late_ran = build()
    AsyncExecutor(steal=StealPolicy(), observe=observe).run(tasks)
    assert early_ran["device"] == "d0" and late_ran["device"] == "d1"
    model["d1"] = 10.0
    tasks, early_ran, late_ran = build()
    AsyncExecutor(steal=StealPolicy()).run(tasks)
    assert early_ran["device"] == "d0" and late_ran["device"] == "d0"


def test_observe_hook_sees_compute_tasks_only():
    seen = []
    tasks = [ExecTask("move", "d0->d1", lambda env: None, kind="transfer"),
             ExecTask("calc", "d0", lambda env: time.sleep(0.01) or 7,
                      deps=("move",))]
    AsyncExecutor(observe=lambda t, d, s: seen.append((t.name, d, s))).run(
        tasks)
    assert [(n, d) for n, d, _ in seen] == [("calc", "d0")]
    assert seen[0][2] >= 0.005


def test_memory_hook_sees_every_task_before_its_dependents():
    order = []
    tasks = [ExecTask("move", "d0->d1", lambda env: order.append("move"),
                      kind="transfer"),
             ExecTask("calc", "d1", lambda env: order.append("calc"),
                      deps=("move",))]
    AsyncExecutor(memory=lambda t, lane: order.append(f"done:{t.name}")
                  ).run(tasks)
    assert order == ["move", "done:move", "calc", "done:calc"]


# --------------------------------------------------------------------------
# determinism: reloaded tuning caches, confidence gate off
# --------------------------------------------------------------------------

def test_steal_decisions_deterministic_under_reloaded_tunecaches(tmp_path):
    policy = DispatchPolicy(confidence_gate=False)
    reg = default_registry(include=["matmul"])
    for name, f in (("d0", 1.0e9), ("d1", 0.9e9)):     # seed disk state once
        fake_matmul_device(str(tmp_path / "devs"), name, f, reg)
    prog, bind = _three_matmuls(reg)
    comm = _comm(tmp_path / "c", SimLink(latency_s=1e-4, bytes_per_s=2e9))
    compiled, probes = [], []
    for _ in range(2):              # fresh reloads of the same cache files
        devices = {
            name: Dispatcher(
                registry=reg, policy=policy,
                cache=TuningCache(root=str(tmp_path / "devs"),
                                  fingerprint=Fingerprint(
                                      "sim", name, 1, 1, ("float32",))))
            for name in ("d0", "d1")}
        c = compile_program(prog, devices=devices, bindings=bind,
                            executor="adaptive", comm=comm,
                            topology=Topology.shared_bus(["d0", "d1"]),
                            steal=StealPolicy())
        env = c._bind((), {})
        tasks = {t.name: t for t in c._exec_tasks(env, adaptive=True)
                 if t.kind == "compute"}
        ex = AsyncExecutor(steal=c.steal, comm=c.comm)
        decisions = [
            (name, ex.decide_device(t, load))
            for name, t in sorted(tasks.items())
            for load in ({"d0": 0.0, "d1": 0.0}, {"d0": 1.0, "d1": 0.0},
                         {"d0": 0.0, "d1": 1.0}, {"d0": 1e-4, "d1": 0.0})]
        preds = [(name, dev, t.predict(dev))
                 for name, t in sorted(tasks.items())
                 for dev in ("d0", "d1")]
        compiled.append(c)
        probes.append((decisions, preds))
    a, b = compiled
    assert {n: (x.device, x.start, x.finish)
            for n, x in a.assignments.items()} == \
           {n: (x.device, x.start, x.finish)
            for n, x in b.assignments.items()}
    assert probes[0] == probes[1]
    assert torch.equal(a(), b())


# --------------------------------------------------------------------------
# bus contention: EFT schedule, executor lanes, SimFabric wall clock
# --------------------------------------------------------------------------

def test_eft_same_bus_transfers_serialize_and_extra_lanes_overlap():
    tasks = [KernelTask("p0", "k", {}, out_bytes=1024.0),
             KernelTask("p1", "k", {}, out_bytes=1024.0),
             KernelTask("c0", "k", {}, deps=("p0",)),
             KernelTask("c1", "k", {}, deps=("p1",))]

    def predict(task, dev):
        if task.name.startswith("p"):
            return 0.01 if dev == "d0" else 1.0
        return 0.01 if dev == "d1" else 1.0

    def plan(topology):
        return schedule(tasks, predict, ["d0", "d1"],
                        comm=lambda src, dst, nbytes: 0.1, topology=topology)
    one = plan(Topology.shared_bus(["d0", "d1"], lanes=1))
    two = plan(Topology.shared_bus(["d0", "d1"], lanes=2))
    free = plan(None)
    starts = sorted(a.start for n, a in one.items() if n.startswith("c"))
    assert starts[1] - starts[0] >= 0.1 - 1e-9
    assert makespan(one) > makespan(two) + 0.05
    assert makespan(two) == pytest.approx(makespan(free))


def test_executor_bus_lane_width_serializes_then_overlaps():
    def sleeper(env):
        time.sleep(0.08)

    def run(lanes):
        tracer = ExecutionTrace()
        tasks = [ExecTask("x0", "bus:b", sleeper, kind="transfer"),
                 ExecTask("x1", "bus:b", sleeper, kind="transfer")]
        AsyncExecutor(tracer=tracer).run(tasks,
                                         lane_width={"bus:b": lanes})
        ev = sorted((e for e in tracer.events if e.kind == "transfer"),
                    key=lambda e: e.begin_s)
        return ev, tracer.wall_s

    ev, wall = run(1)
    assert ev[1].begin_s >= ev[0].end_s - 1e-6
    assert wall >= 0.15
    ev, wall = run(2)
    assert ev[1].begin_s < ev[0].end_s
    assert wall <= 0.13


def test_sim_fabric_serializes_same_bus_in_wall_clock():
    link = SimLink(latency_s=0.05, bytes_per_s=1e12)

    def race(topology, trs):
        fabric = SimFabric(topology, link)
        threads = [threading.Thread(target=fabric.transfer, args=(None, tr))
                   for tr in trs]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=5.0)
        assert not any(t.is_alive() for t in threads)
        return time.perf_counter() - t0

    same = [Transfer("a", "d0", "d1", 8, bus="pcie0"),
            Transfer("b", "d1", "d0", 8, bus="pcie0")]
    assert race(Topology.shared_bus(["d0", "d1"], lanes=1), same) >= 0.1
    split = [Transfer("a", "d0", "d1", 8, bus="x"),
             Transfer("b", "d2", "d3", 8, bus="y")]
    assert race(Topology([Bus("x", ("d0", "d1")), Bus("y", ("d2", "d3"))]),
                split) < 0.09


def test_topology_lanes_and_validation():
    topo = Topology.point_to_point(["d1", "d0", "d2"], lanes=2)
    assert topo.lane_of("d0", "d2") == "bus:d0--d2"
    assert topo.lane_widths() == {"bus:d0--d1": 2, "bus:d0--d2": 2,
                                  "bus:d1--d2": 2}
    assert Topology([]).lane_of("a", "b") == "a->b"
    with pytest.raises(ValueError, match="duplicate bus"):
        Topology([Bus("x", ("a",)), Bus("x", ("b",))])
    with pytest.raises(ValueError, match="lanes must be"):
        Topology([Bus("x", ("a", "b"), lanes=0)])


# --------------------------------------------------------------------------
# first-error abort: original error, cancelled futures, no hang
# --------------------------------------------------------------------------

def test_abort_raises_original_error_and_cancels_pending_futures():
    boom = ValueError("kernel exploded")

    def bad(env):
        time.sleep(0.02)
        raise boom

    tasks = [ExecTask("bad", "d0", bad),
             ExecTask("child", "d0", lambda env: env["bad"], deps=("bad",)),
             ExecTask("grandchild", "d1", lambda env: env["child"],
                      deps=("child",)),
             ExecTask("slow", "d1", lambda env: time.sleep(0.1) or "ok")]
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="kernel exploded") as err:
        AsyncExecutor().run(tasks)
    assert err.value is boom
    assert time.perf_counter() - t0 < 5.0


def test_a_failing_steal_decision_fails_the_run_instead_of_hanging():
    """A predictor that raises while a ready task is priced (at start, or
    when a dependency completes on a worker) fails the run with that error;
    it must not kill a worker and leave the run waiting."""
    def broken(dev):
        raise KeyError("no model for this kernel")
    result = {}

    def run(tasks):
        try:
            AsyncExecutor(steal=StealPolicy()).run(tasks)
        except KeyError as exc:
            result.setdefault("errors", []).append(exc)

    first = ExecTask("first", "d0", lambda env: 1)
    late, _ = _steal_task("late", "d0", broken, deps=("first",))
    root, _ = _steal_task("root", "d0", broken)
    for tasks in ([first, late], [root]):
        t = threading.Thread(target=run, args=(tasks,), daemon=True)
        t.start()
        t.join(timeout=10.0)
        assert not t.is_alive(), "the run hung"
    assert len(result["errors"]) == 2


def test_failing_simdev_task_raises_through_compiled_program(tmp_path):
    reg, devices = _devices(tmp_path)
    prog, bind = _three_matmuls(reg)
    calls = {"n": 0}
    victim = devices["d0"]
    real = victim.dispatch

    def dying(kernel, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("simdev d0 fell off the bus")
        return real(kernel, *args, **kwargs)
    victim.dispatch = dying
    c = compile_program(prog, devices=devices, bindings=bind,
                        executor="async")
    for a in c.assignments.values():
        a.device = "d0"
    with pytest.raises(RuntimeError, match="fell off the bus"):
        c()
    assert c.last_trace is not None
    assert [e.name for e in c.last_trace.events if e.kind == "compute"]


# --------------------------------------------------------------------------
# end to end: the adaptive back end against the sequential reference
# --------------------------------------------------------------------------

def test_adaptive_backend_bit_exact_vs_sequential(tmp_path):
    reg, devices = _devices(tmp_path, simulate_time=True, time_scale=0.05)
    prog, bind = _three_matmuls(reg)
    link = SimLink(latency_s=1e-4, bytes_per_s=2e9)
    topo = Topology.shared_bus(["d0", "d1"])
    c = compile_program(prog, devices=devices, bindings=bind,
                        executor="adaptive", comm=_comm(tmp_path, link),
                        transfer=SimFabric(topo, link).transfer,
                        topology=topo, steal=StealPolicy())
    assert torch.equal(c(_executor="sequential"), c())


def test_adaptive_online_feedback_reaches_the_refiners(tmp_path):
    reg, devices = _devices(tmp_path, simulate_time=True, time_scale=0.02)
    prog, bind = _three_matmuls(reg)
    c = compile_program(prog, devices=devices, bindings=bind,
                        executor="adaptive", steal=StealPolicy(),
                        online=OnlineConfig(refit_every=1, budget_rows=8,
                                            model_factory=LinearModel,
                                            save=False))
    assert set(c.refiners) == {"d0", "d1"}
    c()
    assert sum(sum(r.refits.values()) for r in c.refiners.values()) >= 1
    assert {k for r in c.refiners.values()
            for k in r.observed_kernels()} == {"matmul"}
    mapes = [r.rolling_mape("matmul") for r in c.refiners.values()
             if r.observed_kernels()]
    assert mapes and all(np.isfinite(m) for m in mapes)


def test_skewed_device_steals_to_the_idle_truthful_one(tmp_path):
    """A mis-seeded device that claims to be fast but sleeps its true
    (slow) time, with every node planned on it: the adaptive executor
    moves ready work to the idle device, which computes real values, while
    the liar's own nodes return zeros."""
    reg, devices = _devices(tmp_path, simulate_time=True, time_scale=0.05)
    liar = SkewedSimDispatcher(registry=reg, cache=devices["d0"].cache,
                               true_time=true_time_at(reg, 1.0e7),
                               time_scale=0.05)
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.rand(N, N).astype(np.float32))
          for _ in range(6)]
    with trace(registry=reg) as tb:
        for i in range(0, 6, 2):
            ops.matmul(xs[i], xs[i + 1])
    c = compile_program(tb.program, devices={"d0": liar, "d1": devices["d1"]},
                        bindings=tb.bindings, executor="adaptive",
                        steal=StealPolicy())
    for a in c.assignments.values():
        a.device = "d0"
    outs = c()
    assert [e.note for e in c.last_trace.steals()][:1] == ["d0->d1"]
    ran = {e.name: e.device for e in c.last_trace.events
           if e.kind == "compute"}
    assert set(ran.values()) == {"d0", "d1"}
    for name, out in zip(tb.program.outputs, outs):
        if ran[name] == "d1":
            i = 2 * int(name.split("_")[1])
            torch.testing.assert_close(out, xs[i] @ xs[i + 1])
        else:
            assert not out.any()            # the liar returns zeros


def test_stolen_output_returns_to_its_planned_real_device(tmp_path):
    """Values on a real device's lane must lie there: a node planned on
    ``cpu`` and stolen to another device sends its output back to ``cpu``
    through the transfer hook, traced, so its consumers find it where the
    plan put it."""
    reg, devices = _devices(tmp_path, simulate_time=True, time_scale=0.05)
    liar = SkewedSimDispatcher(registry=reg, cache=devices["d0"].cache,
                               true_time=true_time_at(reg, 1.0e7),
                               time_scale=0.05)
    rng = np.random.RandomState(1)
    xs = [torch.from_numpy(rng.rand(N, N).astype(np.float32))
          for _ in range(6)]
    with trace(registry=reg) as tb:
        for i in range(0, 6, 2):
            ops.matmul(xs[i], xs[i + 1])
    moves = []

    def hook(value, tr):
        moves.append((tr.value, tr.src, tr.dst))
        return value
    c = compile_program(tb.program, devices={"cpu": liar, "d1": devices["d1"]},
                        bindings=tb.bindings, executor="adaptive",
                        steal=StealPolicy(), transfer=hook)
    for a in c.assignments.values():
        a.device = "cpu"
    c()
    stolen = [e.name.removeprefix("steal:") for e in c.last_trace.steals()]
    assert stolen
    returns = {e.name for e in c.last_trace.events
               if e.note == "steal-return"}
    assert returns == {f"xfer:{n}:d1->cpu" for n in stolen}
    for n in stolen:
        assert (n, "d1", "cpu") in moves


def test_adaptive_refits_are_timed_apart(tmp_path):
    """Each refiner keeps the wall seconds its refits took, per kernel, so
    a run's wall time can be split from the refits it carried."""
    reg, devices = _devices(tmp_path, simulate_time=True, time_scale=0.02)
    prog, bind = _three_matmuls(reg)
    c = compile_program(prog, devices=devices, bindings=bind,
                        executor="adaptive", steal=StealPolicy(),
                        online=OnlineConfig(refit_every=1, budget_rows=8,
                                            model_factory=LinearModel,
                                            save=False))
    c()
    for r in c.refiners.values():
        assert set(r.refit_s) == {k for k, n in r.refits.items() if n}
        assert all(s > 0.0 for s in r.refit_s.values())


@pytest.mark.parametrize("out_nbytes,want", [(0, "d1"), (1 << 20, "cpu")])
def test_steal_prices_the_return_copy(out_nbytes, want):
    """A task planned on a real lane whose output must come back there:
    the copy home is priced like the input moves, and a costly one keeps
    the task where it was planned."""
    task, _ = _steal_task("t", "cpu", {"cpu": 0.05, "d1": 0.01}.get,
                          inputs=(("x", "cpu", 1000),))
    task = ExecTask(**{**task.__dict__, "runnable_on": ("cpu", "d1"),
                       "out_nbytes": out_nbytes})
    ex = AsyncExecutor(steal=StealPolicy(),
                       comm=lambda src, dst, nbytes: nbytes * 1e-7)
    dev, costs = ex.price_decision(task, {"cpu": 0.02, "d1": 0.0})
    assert dev == want
    assert costs["d1"] == pytest.approx(1000 * 1e-7 + 0.01
                                        + out_nbytes * 1e-7)


@pytest.mark.parametrize("return_s,stolen", [(0.0, True), (10.0, False)])
def test_costly_return_copy_stops_steals_from_a_real_lane(return_s, stolen,
                                                          tmp_path):
    """Nodes planned on the real ``cpu`` lane carry their output's bytes
    as ``out_nbytes`` (nodes on simulated lanes carry none).  The loaded
    liar on ``cpu`` is stolen from while the copy back is free, and kept
    once the copy back costs more than the wait."""
    reg, devices = _devices(tmp_path, simulate_time=True, time_scale=0.05)
    liar = SkewedSimDispatcher(registry=reg, cache=devices["d0"].cache,
                               true_time=true_time_at(reg, 1.0e7),
                               time_scale=0.05)
    rng = np.random.RandomState(1)
    xs = [torch.from_numpy(rng.rand(N, N).astype(np.float32))
          for _ in range(6)]
    with trace(registry=reg) as tb:
        for i in range(0, 6, 2):
            ops.matmul(xs[i], xs[i + 1])

    def comm(src, dst, nbytes):
        return return_s if dst == "cpu" else 0.0
    c = compile_program(tb.program, devices={"cpu": liar, "d1": devices["d1"]},
                        bindings=tb.bindings, executor="adaptive",
                        steal=StealPolicy(), comm=comm,
                        transfer=lambda value, tr: value)
    for a in c.assignments.values():
        a.device = "cpu"
    tasks = [t for t in c._exec_tasks(dict(tb.bindings), adaptive=True)
             if t.kind == "compute"]
    assert {t.out_nbytes for t in tasks} == {N * N * 4}
    c()
    assert bool(c.last_trace.steals()) == stolen
