"""``Program.compile``: DAG -> heterogeneous schedule -> executable, the
port of ``repro.api.compile_``.

``compile_program`` fans the program's kernel tasks through the
``core.scheduler`` earliest-finish-time scheduler, with absolute times
coming from ``predictor_from_runtime`` over per-device runtime dispatchers
(each carrying its own fingerprinted tuning cache) and — when a ``comm``
model is given — cross-device edges priced by predicted transfer time.
The result is a ``CompiledProgram`` holding the schedule, the buffer
placement table, and the materialized ``Transfer`` tasks.

Execution has three interchangeable back ends over the same schedule:

- ``executor="sequential"`` — the reference bridge: every node in frozen
  start-time order on the calling thread, each planned transfer paid in
  line before its first consumer.  Kept bit-exact: the async path must
  reproduce it per node.
- ``executor="async"`` — ``repro_torch.exec.AsyncExecutor``: one worker
  per device plus one per link lane; nodes fire when their deps resolve,
  so independent branches genuinely overlap and transfers run
  concurrently with compute.  The workers are the compiled program's own
  ``exec.LanePool``: threads that live across calls (a ``cuda:<i>`` lane's
  worker makes card i current once, when it starts), one call at a time
  (a concurrent caller waits for the running call; a node must not call
  its own program asynchronously), stopped by ``close()`` or when the
  program is collected.  Every back end records an ``ExecutionTrace``
  (``last_trace``).
- ``executor="adaptive"`` — the async executor with runtime re-dispatch:
  when a node becomes ready and its planned device is loaded, the
  executor asks the *live* predictors whether moving the inputs and
  running on an idle device beats waiting (moves priced through the same
  comm model the EFT used), steals when it does, and pays the physical
  input moves inline through the ``transfer`` hook.  With ``online=``
  every completed node's actual wall time feeds back through a per-device
  ``runtime.online.OnlineRefiner``, so predictions — and therefore later
  steal decisions — improve mid-run and across runs.  With ``topology=``
  (a ``repro_torch.exec.Topology``) transfers contend for shared-bus lanes
  in both the EFT schedule and the executor.

Devices are simulated (any label, such as ``"d0"``: values pass between
them untouched unless a ``transfer`` hook is given) or real, named as
torch devices (``"cuda:0"``, ``"cpu"``).  On real devices every value must
lie on its lane's device: a bound input is copied to its planned home
before the run (``_place_inputs``), each planned transfer copies through
the ``transfer`` hook (``exec.copy_to_dst``; a map of several real
devices without one raises), a node stolen away from a real device
sends its output back there (a ``steal-return`` move, which the steal
rule prices as the task's ``out_nbytes``), and a compute task whose
operands lie elsewhere raises instead of letting a kernel wrapper run
where the operands happen to be.  All work on a card goes to its default
stream: the dispatcher synchronises the card after every call to time
it, which waits for copies on it too.

Every compiled program carries its memory plan (``obs.memory``): the
predicted per-device peak from the frozen order, checked at compile time
against any dispatcher's advertised ``capacity_bytes``, and per call a
``MemoryLedger`` (``last_memory``) that accounts bound inputs at their
planned homes from the run's start (a bind copy moves an input there, it
adds no residency), and each node and planned transfer as it completes.
``telemetry=`` threads an ``obs.Telemetry`` through the dispatchers, the
comm model, the refiners and the executor, and ``explain()`` attributes
the last call's makespan (``obs.explain``).

Input shape specs are *bucketed*: a call whose shapes fall in the same
``runtime.cache.shape_class`` as the compiled specs reuses the schedule
(the graph is re-type-checked through the abstract hooks first); only a
different shape class forces a re-trace/re-compile.  A cold cache raises
(``predictor_from_runtime``'s contract): a schedule built from unfitted
predictions would be silent garbage.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Optional

import torch

from repro_torch.api.program import Program
from repro_torch.core.scheduler import (Assignment, execution_order, makespan,
                                        predictor_from_runtime, schedule)
from repro_torch.exec.buffers import (BufferTable, Transfer, lane_device,
                                      on_device, plan_buffers, value_nbytes)
from repro_torch.exec.executor import (AsyncExecutor, ExecTask, LanePool,
                                       StealPolicy)
from repro_torch.exec.trace import ExecutionTrace
from repro_torch.kernels import Aval
from repro_torch.obs.memory import (MemoryLedger, check_capacity, fold_memory,
                                    memory_plan, predicted_peak_bytes)
from repro_torch.runtime.cache import shape_bucket, shape_class
from repro_torch.runtime.online import OnlineConfig, OnlineRefiner

EXECUTORS = ("sequential", "async", "adaptive")


def _resolve_devices(devices, policy) -> dict:
    from repro_torch.api.ops import current_dispatcher, pinned_dispatcher
    from repro_torch.runtime.dispatch import Dispatcher, default_dispatcher
    if devices is None:
        if policy is not None:
            if pinned_dispatcher() is not None:
                raise ValueError(
                    "policy= conflicts with an active use_dispatcher() "
                    "pin — the pinned dispatcher already carries its "
                    "policy")
            return {"local": default_dispatcher(policy)}
        return {"local": current_dispatcher()}
    if isinstance(devices, Dispatcher):
        return {"local": devices}
    if isinstance(devices, dict):
        bad = [n for n, d in devices.items()
               if not hasattr(d, "predict_time")]
        if bad:
            raise TypeError(
                f"devices {bad} are not dispatcher-like (need "
                "predict_time/dispatch); each device name must map to a "
                "runtime Dispatcher whose cache carries that device's "
                "fingerprint")
        return dict(devices)
    raise TypeError(
        "devices must be None (the active dispatcher), a Dispatcher, or a "
        "{name: Dispatcher} map — bare device-name lists are ambiguous "
        "because a dispatcher's tuning cache IS the device identity")


def _check_executor(executor: str) -> None:
    if executor not in EXECUTORS:
        raise ValueError(f"executor must be one of {EXECUTORS}, "
                         f"got {executor!r}")


def compile_program(program: Program, devices=None, policy=None,
                    bindings=None, executor: str = "sequential",
                    comm=None, transfer=None, topology=None,
                    steal=None, online=None,
                    telemetry=None) -> "CompiledProgram":
    """``comm`` is a ``repro_torch.exec.CommModel`` (or a bare
    ``(src, dst, nbytes) -> seconds`` callable) that makes the EFT
    schedule transfer-aware; ``transfer`` is the physical move hook
    ``(value, Transfer) -> value`` every back end applies per
    materialized transfer (None: simulated devices share the host's
    memory, the move is free; a map of several real devices needs one,
    ``exec.copy_to_dst``).

    ``topology`` is a ``repro_torch.exec.Topology``: transfers then queue
    on shared-bus lanes in both the EFT schedule and the executor (a bus
    with capacity k gets k lane workers).  ``steal`` is a
    ``repro_torch.exec.StealPolicy`` for the adaptive back end (defaults
    to ``StealPolicy()`` when ``executor="adaptive"``).  ``online``
    enables execution-time feedback: ``True`` or a
    ``runtime.online.OnlineConfig`` builds one ``OnlineRefiner`` per
    device over that device's tuning cache, fed the actual duration of
    every completed node.

    ``telemetry`` is a ``repro_torch.obs.Telemetry`` threaded through every
    decision point of this compiled program: the device dispatchers
    (decision counters, gate events, per-kernel residuals — attached only
    where none is set, an explicitly instrumented dispatcher keeps its
    own), the comm model, the per-device refiners (refit events), the
    executor (steals, queue depths, transfer waits), and each call's
    predicted-vs-realized makespan."""
    _check_executor(executor)
    dispatchers = _resolve_devices(devices, policy)
    real = sorted(n for n in dispatchers if lane_device(n) is not None)
    if real and len(dispatchers) > 1 and transfer is None:
        raise ValueError(
            f"devices {sorted(dispatchers)} include real devices {real}: "
            "values must be copied between them, so give a transfer hook "
            "(repro_torch.exec.copy_to_dst)")
    for disp in dispatchers.values():
        program.check(disp.registry)
    if telemetry is not None:
        for disp in dispatchers.values():
            if getattr(disp, "telemetry", None) is None:
                disp.telemetry = telemetry
        if hasattr(comm, "comm_fn") and \
                getattr(comm, "telemetry", None) is None:
            comm.telemetry = telemetry
    tasks = program.to_kernel_tasks()
    predict = predictor_from_runtime(dispatchers)
    comm_fn = comm.comm_fn() if hasattr(comm, "comm_fn") else comm
    homes: dict = {}
    assignments = schedule(tasks, predict, list(dispatchers), comm=comm_fn,
                           input_homes=homes, topology=topology)
    refiners: dict = {}
    if online:
        config = online if isinstance(online, OnlineConfig) else \
            OnlineConfig()
        refiners = {name: OnlineRefiner(disp.cache, config,
                                        telemetry=telemetry)
                    for name, disp in dispatchers.items()}
    buffers = plan_buffers(program, assignments, input_homes=homes,
                           topology=topology)
    order = execution_order(tasks, assignments)
    # the memory ledger's compile half: derive the accounting plan from
    # the value homes, replay it over the frozen order for the predicted
    # per-device peak, and refuse placements that cannot fit a device's
    # advertised capacity — typed failure now beats an OOM mid-run
    plan = memory_plan(program, buffers)
    predicted_peak = predicted_peak_bytes(plan, order, buffers)
    check_capacity(predicted_peak, dispatchers)
    return CompiledProgram(program=program, dispatchers=dispatchers,
                           assignments=assignments,
                           bindings=dict(bindings or {}),
                           order=order,
                           executor=executor, comm=comm_fn,
                           buffers=buffers,
                           transfer=transfer, topology=topology,
                           steal=steal, refiners=refiners,
                           telemetry=telemetry,
                           memory=plan,
                           predicted_peak_bytes=predicted_peak)


def _check_on_lane(name: str, values, lane: str) -> None:
    """Raise unless every tensor operand of task ``name`` lies on the
    device lane ``lane`` names (simulated lanes take anything): a kernel
    wrapper runs where its operands lie, so a misplaced operand would run
    the node on another device than the one the trace credits."""
    device = lane_device(lane)
    if device is None:
        return
    for v in values:
        if isinstance(v, torch.Tensor) and not on_device(v, device):
            raise ValueError(f"{name}: an operand lies on {v.device}, but "
                             f"the task runs on lane {lane!r}")


def _bind_lane_device(lane: str) -> None:
    """A lane worker's one-time set-up: the worker of a ``cuda:<i>`` lane
    makes card i its current device, so that the card's libraries set up
    their per-thread state once, on this long-lived thread."""
    device = lane_device(lane)
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)


@dataclasses.dataclass
class CompiledProgram:
    program: Program
    dispatchers: dict                 # device name -> runtime Dispatcher
    assignments: dict                 # node name -> Assignment
    bindings: dict                    # input name -> default tensor
    order: list                       # KernelTasks, frozen execution order
                                      # (dependency-checked at compile time)
    executor: str = "sequential"      # default back end for __call__
    comm: Optional[Callable] = None   # (src, dst, nbytes) -> seconds
    buffers: Optional[BufferTable] = None
    transfer: Optional[Callable] = None   # (value, Transfer) -> value
    topology: Optional[object] = None     # repro_torch.exec.Topology
    steal: Optional[StealPolicy] = None   # adaptive re-dispatch policy
    refiners: dict = dataclasses.field(default_factory=dict)
    #   device name -> OnlineRefiner; non-empty enables execution feedback
    telemetry: Optional[object] = None    # obs.Telemetry (or None):
    #   per-call predicted-vs-realized makespan + executor decision events
    memory: Optional[object] = None       # obs.memory.MemoryPlan: the
    #   plan-derived ref-count table both ledger sides account from
    predicted_peak_bytes: dict = dataclasses.field(default_factory=dict)
    #   device -> compile-time predicted peak bytes (EFT-order replay)
    last_trace: Optional[ExecutionTrace] = None  # set by every execution
    last_memory: Optional[MemoryLedger] = None   # measured ledger, per call

    @property
    def makespan(self) -> float:
        """Predicted end-to-end seconds of the scheduled DAG (transfer
        delays included when compiled with a comm model)."""
        return makespan(self.assignments)

    @property
    def transfers(self) -> tuple:
        """The materialized cross-device ``Transfer`` tasks."""
        return self.buffers.transfers if self.buffers is not None else ()

    def device_of(self, node_name: str) -> str:
        return self.assignments[node_name].device

    def task_meta(self) -> dict:
        """Per-task schedule context carried into every trace event (and
        so into saved Chrome documents): kernel, shape bucket, planned
        lane, the EFT's predicted start/finish (model units), the
        predicted duration in *wall* units (sim dispatchers sleep
        ``predicted * time_scale``), and the planned device's fit-time
        error band for the kernel when its cache entry carries one.
        Built once per compiled program; ``obs.explain`` reads it back out
        of the trace."""
        metas = getattr(self, "_task_metas", None)
        if metas is not None:
            return metas
        metas = {}
        for kt in self.order:
            a: Assignment = self.assignments[kt.name]
            disp = self.dispatchers[a.device]
            m = {"kernel": kt.kernel,
                 "shape_bucket": str(shape_bucket(kt.params)),
                 "planned": a.device,
                 "predicted_s": (a.finish - a.start)
                 * self._wall_scale(disp),
                 "predicted_start_s": float(a.start),
                 "predicted_finish_s": float(a.finish)}
            band = disp._entry(kt.kernel).fit_mape
            if band is not None:
                m["fit_band_pct"] = float(band)
            metas[kt.name] = m
        for tr in self.transfers:
            m = {"kernel": "transfer", "src": tr.src, "dst": tr.dst,
                 "nbytes": int(tr.nbytes), "planned": tr.lane}
            if self.comm is not None:
                try:
                    m["predicted_s"] = float(
                        self.comm(tr.src, tr.dst, tr.nbytes))
                except ValueError:      # an unmeasured pair: no price
                    pass
            metas[tr.name] = m
        self._task_metas = metas
        return metas

    def explain(self):
        """Causal critical-path analysis of the last execution (see
        ``repro_torch.obs.explain.analyze_trace``)."""
        from repro_torch.obs.explain import analyze_trace
        if self.last_trace is None or not self.last_trace.events:
            raise ValueError("no execution recorded yet — call the "
                             "compiled program first")
        return analyze_trace(self.last_trace)

    def gantt(self) -> list[dict]:
        """Schedule rows (sorted by predicted start) for reports/CSV."""
        rows = []
        for node in self.program.nodes:
            a: Assignment = self.assignments[node.name]
            rows.append({"task": node.name, "kernel": node.kernel,
                         "device": a.device, "start_s": a.start,
                         "finish_s": a.finish})
        return sorted(rows, key=lambda r: (r["start_s"], r["task"]))

    # -- input binding -------------------------------------------------------
    def _bind(self, args, named) -> dict:
        env = dict(self.bindings)
        specs = self.program.inputs
        if len(args) > len(specs):
            raise TypeError(f"program takes {len(specs)} inputs, got "
                            f"{len(args)}")
        for spec, arr in zip(specs, args):
            env[spec.name] = arr
        unknown = set(named) - {s.name for s in specs}
        if unknown:
            raise TypeError(f"unknown inputs {sorted(unknown)}")
        env.update(named)
        missing = [s.name for s in specs if s.name not in env]
        if missing:
            raise TypeError(f"unbound inputs {missing}")
        exact = True
        for spec in specs:
            got = tuple(env[spec.name].shape)
            if got == tuple(spec.shape):
                continue
            exact = False
            if shape_class(got) != shape_class(spec.shape):
                raise ValueError(
                    f"input {spec.name!r}: shape {got} is outside the "
                    f"compiled spec's shape class "
                    f"(spec {tuple(spec.shape)}, class "
                    f"{shape_class(spec.shape)}) — re-trace and re-compile "
                    "for a new shape class")
        if not exact:
            # same shape class: reuse the schedule, but re-type-check the
            # graph over the actual avals so an internally inconsistent
            # binding (e.g. disagreeing contraction dims) fails here, not
            # deep inside a kernel
            registry = next(iter(self.dispatchers.values())).registry
            avals = {s.name: Aval(tuple(env[s.name].shape),
                                  env[s.name].dtype) for s in specs}
            for node in self.program.nodes:
                ins = [avals[d] for d in node.deps]
                registry.abstract_params(node.kernel, *ins, **node.kwargs)
                avals[node.name] = registry.out_aval(node.kernel, *ins,
                                                     **node.kwargs)
        return env

    def _place_inputs(self, env, tracer: ExecutionTrace) -> None:
        """Copy each bound input that lies off its planned home device
        (a real device) there, recorded as a transfer on its link lane
        (note ``bind``).  The plan's transfers then start from the homes
        the EFT priced."""
        for spec in self.program.inputs:
            home = self.buffers.device_of(spec.name)
            device = lane_device(home)
            v = env[spec.name]
            if device is None or on_device(v, device):
                continue
            src = str(v.device)
            t0 = time.perf_counter()
            env[spec.name] = v.to(device)
            tracer.record(f"bind:{spec.name}:{src}->{home}", "transfer",
                          f"{src}->{home}", t0, time.perf_counter(),
                          note="bind")

    # -- execution back ends -------------------------------------------------
    def _move(self, v, tr: Transfer):
        """Pay one planned transfer of value ``v`` through the hook (free
        without one).  The payload is re-sized from the live value: under
        shape-class reuse the actual tensors may be smaller than the
        compiled specs, and a real hook sizing its copy from tr.nbytes
        must never overread."""
        if self.transfer is None:
            return v
        live = dataclasses.replace(tr, nbytes=value_nbytes(v.shape, v.dtype))
        return self.transfer(v, live)

    def _run_sequential(self, env, tracer: ExecutionTrace,
                        ledger=None) -> None:
        """The reference bridge: frozen start-time order, calling thread;
        each planned transfer is paid once, just before its first
        consumer — the event order the compile-time predicted peak
        replayed, so sequential measured peaks match the prediction
        exactly."""
        node_by = {n.name: n for n in self.program.nodes}
        metas = self.task_meta()
        landed: dict = {}               # transfer name -> moved value
        for task in self.order:
            node = node_by[task.name]
            dev = self.assignments[task.name].device
            vals = []
            for d in node.deps:
                tr = self.buffers.transfer_for(d, dev)
                if tr is None:
                    vals.append(env[d])
                    continue
                if tr.name not in landed:
                    t0 = time.perf_counter()
                    landed[tr.name] = self._move(env[d], tr)
                    tracer.record(tr.name, "transfer", tr.lane, t0,
                                  time.perf_counter(),
                                  deps=(d,) if d in node_by else (),
                                  meta=metas.get(tr.name))
                    if ledger is not None:
                        ledger.transfer_done(tr.name)
                vals.append(landed[tr.name])
            _check_on_lane(task.name, vals, dev)
            t0 = time.perf_counter()
            env[task.name] = self.dispatchers[dev].dispatch(
                node.kernel, *vals, **node.kwargs)
            tracer.record(task.name, "compute", dev, t0,
                          time.perf_counter(),
                          deps=tuple(d for d in node.deps if d in node_by),
                          meta=metas.get(task.name))
            if ledger is not None:
                ledger.node_done(task.name)

    # -- adaptive helpers ----------------------------------------------------
    @staticmethod
    def _wall_scale(disp) -> float:
        """Simulated dispatchers sleep ``predicted * time_scale`` wall
        seconds; scaling their predictions by the same factor keeps the
        executor's load ledger (wall clock) and the steal rule's predicted
        costs in one unit.  Real dispatchers have no scale (1.0)."""
        return float(getattr(disp, "time_scale", 1.0) or 1.0)

    def _inline_move(self, v, value: str, src: str, dst: str, note: str):
        """Move ``v`` (named ``value``) from src to dst through the hook,
        outside the plan, traced with ``note``."""
        bus = self.topology.bus_of(src, dst) \
            if self.topology is not None else None
        tr = Transfer(value, src, dst, value_nbytes(v.shape, v.dtype),
                      bus=bus.name if bus else None)
        t0 = time.perf_counter()
        out = self.transfer(v, tr)
        if self.last_trace is not None:
            self.last_trace.record(tr.name, "transfer", tr.lane, t0,
                                   time.perf_counter(), note=note)
        return out

    def _steal_fetch(self, env_, env, value: str, dev: str,
                     node_names: frozenset):
        """Read ``value`` raw (producer output or program input) and pay
        the physical move to ``dev`` when it lives elsewhere — the inline
        transfer a stolen task owes instead of the planned one."""
        v = env_[value] if value in node_names else env[value]
        home = self.buffers.device_of(value)
        if home == dev or self.transfer is None:
            return v
        return self._inline_move(v, value, home, dev, "steal-move")

    def _observe_hook(self) -> Optional[Callable]:
        """``(ExecTask, device, seconds) -> None`` feeding actual node
        durations into the executing device's refiner (best-variant row,
        wall time de-scaled back to model units), or None when compiled
        without ``online=``."""
        if not self.refiners:
            return None
        kt_by = {t.name: t for t in self.order}

        def observe(task: ExecTask, lane: str, seconds: float) -> None:
            refiner = self.refiners.get(lane)
            kt = kt_by.get(task.name)
            if refiner is None or kt is None:
                return
            disp = self.dispatchers[lane]
            pred = disp.predict_times(kt.kernel, kt.params)
            names = disp.registry.variant_names(kt.kernel)
            best = min(pred, key=pred.get)
            rows = disp.registry.feature_rows(kt.kernel, kt.params)
            refiner.observe(kt.kernel, rows[names.index(best)],
                            shape_bucket(kt.params),
                            seconds / self._wall_scale(disp),
                            predicted_s=float(pred[best]))
        return observe

    def _lane_widths(self) -> Optional[dict]:
        return self.topology.lane_widths() \
            if self.topology is not None else None

    def _exec_tasks(self, env, adaptive: bool = False) -> list[ExecTask]:
        """Lower the scheduled program to executor tasks: one compute task
        per node on its assigned device, one transfer task per materialized
        move on its link lane; priorities follow the predicted timeline.

        With ``adaptive`` every compute task additionally carries the
        re-dispatch metadata: a device-parameterized body (``run_on``) that
        pays inline input moves when running away from the plan, a live
        ``predict`` closure over the device dispatchers, and the input
        (value, home, nbytes) triples the steal rule prices.  Dependencies
        are identical to the static lowering — a stolen task still waits
        for its planned transfers, so steal decisions always happen with
        every dependency resolved and bit-exactness is placement-invariant.
        """
        node_by = {n.name: n for n in self.program.nodes}
        node_names = frozenset(node_by)
        kt_by = {t.name: t for t in self.order}
        metas = self.task_meta()
        tasks: list[ExecTask] = []
        for tr in self.buffers.transfers:
            from_node = tr.value in node_by
            # a node output can move only after it exists; input payloads
            # are ready at t=0
            deps = (tr.value,) if from_node else ()
            prio = self.assignments[tr.value].finish if from_node else 0.0

            def move(env_, tr=tr, from_node=from_node):
                return self._move(env_[tr.value] if from_node
                                  else env[tr.value], tr)
            tasks.append(ExecTask(tr.name, tr.lane, move, deps,
                                  kind="transfer", priority=prio,
                                  meta=metas.get(tr.name)))
        for task in self.order:
            node = node_by[task.name]
            dev = self.assignments[task.name].device
            disp = self.dispatchers[dev]
            sources = []        # per positional dep: task to read, or None
            deps = []
            for d in node.deps:
                moved = self.buffers.transfer_for(d, dev)
                if moved is not None:
                    sources.append(moved.name)
                    deps.append(moved.name)
                elif d in node_by:
                    sources.append(d)
                    deps.append(d)
                else:
                    sources.append(None)        # input already home here

            def run(env_, node=node, dev=dev, disp=disp,
                    sources=tuple(sources)):
                vals = [env[d] if s is None else env_[s]
                        for d, s in zip(node.deps, sources)]
                _check_on_lane(node.name, vals, dev)
                return disp.dispatch(node.kernel, *vals, **node.kwargs)
            extra: dict = {}
            if adaptive:
                kt = kt_by[task.name]
                # a stolen node's output goes back to a planned real device
                returns = lane_device(dev) is not None \
                    and self.transfer is not None

                def run_on(env_, on_dev, node=node, dev=dev,
                           sources=tuple(sources), returns=returns):
                    if on_dev == dev:       # planned device: planned moves
                        vals = [env[d] if s is None else env_[s]
                                for d, s in zip(node.deps, sources)]
                    else:                   # stolen: raw values, inline moves
                        vals = [self._steal_fetch(env_, env, d, on_dev,
                                                  node_names)
                                for d in node.deps]
                    _check_on_lane(node.name, vals, on_dev)
                    out = self.dispatchers[on_dev].dispatch(
                        node.kernel, *vals, **node.kwargs)
                    if on_dev == dev or not returns:
                        return out
                    # a value's home is a property of the plan: a stolen
                    # node's output goes back to its planned device, where
                    # its consumers and planned transfers read it
                    return self._inline_move(out, node.name, on_dev, dev,
                                             "steal-return")

                def predict(on_dev, kt=kt):
                    disp_ = self.dispatchers[on_dev]
                    return float(disp_.predict_time(kt.kernel, kt.params)) \
                        * self._wall_scale(disp_)

                inputs = tuple(
                    (d, self.buffers.device_of(d),
                     value_nbytes(self.program.aval_of(d).shape,
                                  self.program.aval_of(d).dtype))
                    for d in node.deps)
                out_aval = self.program.aval_of(node.name)
                extra = {"run_on": run_on, "predict": predict,
                         "runnable_on": tuple(self.dispatchers),
                         "inputs": inputs,
                         "out_nbytes": value_nbytes(out_aval.shape,
                                                    out_aval.dtype)
                         if returns else 0}
            tasks.append(ExecTask(node.name, dev, run, tuple(deps),
                                  kind="compute",
                                  priority=self.assignments[node.name].start,
                                  meta=metas.get(node.name), **extra))
        return tasks

    def lane_pool(self) -> LanePool:
        """The program's lane workers, made at its first async or adaptive
        call and stopped when the program is collected."""
        pool = getattr(self, "_pool", None)
        if pool is None:
            pool = self._pool = LanePool(init=_bind_lane_device)
            weakref.finalize(self, pool.close)
        return pool

    def close(self) -> None:
        """Stop and join the lane workers; a later async or adaptive call
        starts new ones."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.close()

    @staticmethod
    def _memory_hook(ledger) -> Optional[Callable]:
        """Executor ``(task, lane) -> None`` hook routing completions into
        the run's ledger.  Keyed by task name against the *plan* (stolen
        tasks account at their planned home — value homes are plan
        properties, a steal's inline move is extra traffic, not a
        re-homing)."""
        if ledger is None:
            return None

        def hook(task: ExecTask, lane: str) -> None:
            if task.kind == "transfer":
                ledger.transfer_done(task.name)
            else:
                ledger.node_done(task.name)
        return hook

    def _run_async(self, env, tracer: ExecutionTrace, ledger=None) -> None:
        results = AsyncExecutor(tracer=tracer,
                                telemetry=self.telemetry,
                                memory=self._memory_hook(ledger)).run(
            self._exec_tasks(env), lane_width=self._lane_widths(),
            pool=self.lane_pool())
        for node in self.program.nodes:
            env[node.name] = results[node.name]

    def _run_adaptive(self, env, tracer: ExecutionTrace,
                      ledger=None) -> None:
        executor = AsyncExecutor(tracer=tracer,
                                 steal=self.steal or StealPolicy(),
                                 comm=self.comm,
                                 observe=self._observe_hook(),
                                 telemetry=self.telemetry,
                                 memory=self._memory_hook(ledger))
        results = executor.run(self._exec_tasks(env, adaptive=True),
                               lane_width=self._lane_widths(),
                               pool=self.lane_pool())
        for node in self.program.nodes:
            env[node.name] = results[node.name]

    def __call__(self, *args, _executor: Optional[str] = None, **named):
        """Execute the schedule.  Inputs bind positionally (program input
        order), by name, or fall back to the bindings captured at trace
        time; shapes must fall in the compiled specs' shape classes.
        ``_executor`` overrides the compiled back end for this call (the
        underscore keeps the name out of the input namespace)."""
        mode = _executor or self.executor
        _check_executor(mode)
        env = self._bind(args, named)
        ledger = None
        if self.memory is not None:
            ledger = MemoryLedger(self.memory, telemetry=self.telemetry)
            self.last_memory = ledger
            ledger.start()
        t0 = time.perf_counter()
        tracer = ExecutionTrace()
        # installed up front so a mid-run failure leaves the partial trace
        # (the events up to the dying node), not the previous run's
        self.last_trace = tracer
        tracer.set_epoch(t0)
        self._place_inputs(env, tracer)
        if mode == "adaptive":
            self._run_adaptive(env, tracer, ledger)
        elif mode == "async":
            self._run_async(env, tracer, ledger)
        else:
            self._run_sequential(env, tracer, ledger)
        fold_memory(self.telemetry, ledger, self.predicted_peak_bytes)
        if self.telemetry is not None:
            wall = time.perf_counter() - t0
            predicted = self.makespan
            self.telemetry.observe("program.wall_s", wall)
            self.telemetry.instant(
                f"makespan:{mode}", cat="makespan", executor=mode,
                predicted_s=float(predicted), realized_s=float(wall),
                ape_pct=100.0 * abs(wall - predicted)
                / max(abs(wall), 1e-12))
        outs = tuple(env[o] for o in self.program.outputs)
        return outs[0] if len(outs) == 1 else outs
