"""Dependency-driven asynchronous multi-device executor with optional
runtime re-dispatch (work stealing), the port of ``repro.exec.executor``.

One worker per lane slot (device, point-to-point link, or shared-bus
lane — buses with capacity k get k workers), each draining a priority
queue ordered by predicted start time.  A task becomes *ready* the moment
its last dependency completes — not when its turn arrives in the global
start-time order — so a slow early task on one device never blocks an
independent ready task on another, which is exactly the overlap the
sequential ``run_schedule`` bridge cannot express.  Every task's output is
a future; dependents read dependency values through the environment
mapping (resolved futures, so reads never block).

**Adaptive mode** (``steal=StealPolicy(...)``): when a ready task's
planned device is loaded, the executor consults the task's *predictor*
(``task.predict(device)`` — live, so online refits change later
decisions) and the shared ``comm`` model to ask whether moving the inputs
and running on another device beats waiting for the planned slot:

    steal to d  iff  load(d) + move(inputs -> d) + run(d) + return(d)
                     <  load(planned) + run(planned)   [by min_advantage]

``load`` is the lane's predicted backlog: queued tasks' predicted
durations plus the *remaining* predicted time of whatever is running —
repriced live through each task's predictor at every decision, so an
online refit immediately changes how loaded every lane looks.
Move cost prices every task input whose home is not ``d`` through the
same ``comm(src, dst, nbytes)`` the EFT scheduler used, so plans and
runtime decisions never disagree about what a byte costs.  ``return``
prices ``comm(d, planned, task.out_nbytes)``: the copy that sends a
stolen output back to a planned real device (zero on simulated lanes,
where ``out_nbytes`` stays 0).  A stolen task
runs via ``task.run_on(env, device)`` (which pays the physical input
moves) and the trace records a ``"steal"`` event.

The executor stays deliberately generic: it runs ``ExecTask``s, not
program nodes.  ``repro_torch.api.CompiledProgram`` lowers its scheduled
DAG —
compute nodes on their assigned devices plus the ``buffers.plan_buffers``
transfer tasks on their bus/link lanes — into this form; tests drive it
directly with hand-built graphs.  Worker threads run PyTorch calls, which
release the interpreter lock while a kernel or a copy runs, so lanes on
the CPU and on a card overlap.

**Lane workers that outlive a run** (``LanePool``): a run hands each
lane slot's loop to that slot's thread in a pool.  On a card a thread's
first library call sets up per-thread state (a cuDNN or cuBLAS handle,
the current device) that costs milliseconds; a pool that lives across
runs (each compiled program keeps one) pays it once, not once per run.  A
run given no pool makes one of its own and closes it at its end.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.exec.trace import ExecutionTrace


@dataclasses.dataclass(frozen=True)
class ExecTask:
    """One schedulable unit: runs ``fn(env)`` on lane ``device`` once every
    dep has completed; ``env[dep]`` is the dep's output.  The optional
    adaptive fields let the executor re-dispatch the task at run time:
    all three of ``run_on``/``runnable_on``/``predict`` must be set for a
    task to be steal-eligible (static tasks leave the defaults)."""
    name: str
    device: str
    fn: Callable[[Mapping], object]
    deps: tuple = ()
    kind: str = "compute"           # "compute" | "transfer" (trace category)
    priority: float = 0.0           # predicted start; orders a lane's queue
    # -- adaptive metadata ---------------------------------------------------
    run_on: Optional[Callable[[Mapping, str], object]] = None
    #   device-parameterized body; pays input moves when device != planned
    runnable_on: tuple = ()         # devices this task may re-dispatch to
    predict: Optional[Callable[[str], float]] = None
    #   device -> predicted seconds, consulted at decision time
    inputs: tuple = ()              # (value, home device, nbytes) triples
    #   priced through comm when running away from the inputs' homes
    out_nbytes: int = 0             # bytes a run away from ``device``
    #   copies back there (its output's return move), priced through comm
    meta: Optional[Mapping] = None  # schedule context carried into the
    #   trace event (kernel, shape bucket, predicted seconds)


@dataclasses.dataclass(frozen=True)
class StealPolicy:
    """When may a ready task leave its planned device?

    ``min_advantage`` is the required relative predicted win (0.0 keeps
    the pure "move+run beats the planned wait" rule); ``idle_only``
    restricts candidate devices to ones with zero predicted load, the
    conservative default that can never delay the target device's own
    planned work."""
    min_advantage: float = 0.0
    idle_only: bool = True


class _Env:
    """Read-only view over completed task futures (deps are guaranteed
    resolved before a task fires, so ``result()`` never blocks)."""

    def __init__(self, futures: dict):
        self._futures = futures

    def __getitem__(self, name: str):
        return self._futures[name].result()

    def __contains__(self, name: str) -> bool:
        return name in self._futures


_SENTINEL_PRIORITY = float("inf")


class _Job:
    """One run's loop for one lane slot, handed to a pool thread."""

    def __init__(self, fn: Callable[[], None]):
        self.fn: Optional[Callable[[], None]] = fn
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class LanePool:
    """Long-lived worker threads for ``AsyncExecutor.run``, one per lane
    slot ``(lane, i)`` (a lane with width k has slots 0..k-1), started on
    first use and kept until ``close``.

    Each thread calls ``init(lane)`` once, when it starts (a real lane's
    device binding), then serves one run's loop at a time.  One run uses
    the pool at a time: ``run`` holds ``lock`` from the first enqueue until
    every slot's loop has returned, so a second caller waits for the first
    run to end and a task must not start a run on the pool it runs on.  A
    run that fails still posts every slot's sentinel and waits for its
    loops, so no thread is left on a dead run's queue.  ``close`` waits for
    a running run, then stops and joins the threads; a later run starts
    new ones.  Threads are daemons and hold no reference to what owns the
    pool."""

    def __init__(self, init: Optional[Callable[[str], None]] = None):
        self.init = init
        self.lock = threading.Lock()
        self._guard = threading.Lock()
        self._slots: dict = {}          # (lane, i) -> (thread, inbox)

    @property
    def threads(self) -> dict:
        """(lane, i) -> the live thread serving that slot."""
        with self._guard:
            return {slot: th for slot, (th, _) in self._slots.items()}

    def _serve(self, lane: str, inbox: queue.SimpleQueue,
               ready: threading.Event, failed: list) -> None:
        if self.init is not None:
            try:
                self.init(lane)
            except BaseException as exc:  # noqa: BLE001 — raised in reserve
                failed.append(exc)
                ready.set()
                return
        ready.set()
        while True:
            job = inbox.get()
            if job is None:
                return
            try:
                job.fn()
            except BaseException as exc:  # noqa: BLE001 — raised in run()
                job.error = exc
            finally:
                job.fn = None           # drop the run's closures
                job.done.set()
                job = None

    def reserve(self, slots) -> None:
        """Start (and initialise) a thread for every slot that has none;
        raises the first ``init`` failure, leaving that slot empty."""
        started = []
        with self._guard:
            for lane, i in slots:
                if (lane, i) in self._slots:
                    continue
                inbox, ready, failed = queue.SimpleQueue(), \
                    threading.Event(), []
                th = threading.Thread(target=self._serve,
                                      args=(lane, inbox, ready, failed),
                                      name=f"exec-{lane}-{i}", daemon=True)
                th.start()
                self._slots[(lane, i)] = (th, inbox)
                started.append(((lane, i), th, ready, failed))
        error = None
        for slot, th, ready, failed in started:
            ready.wait()
            if failed:
                th.join()
                with self._guard:
                    self._slots.pop(slot, None)
                error = error or failed[0]
        if error is not None:
            raise error

    def submit(self, slot, fn: Callable[[], None]) -> _Job:
        """Run ``fn`` on the thread of ``slot`` (reserved); the returned
        job's ``done`` is set when it returns."""
        job = _Job(fn)
        with self._guard:
            self._slots[slot][1].put(job)
        return job

    def close(self) -> None:
        """Stop and join every thread, after the running run if there is
        one (idempotent)."""
        with self.lock, self._guard:
            slots, self._slots = self._slots, {}
        for _, inbox in slots.values():
            inbox.put(None)
        for th, _ in slots.values():
            if th is not threading.current_thread():
                th.join()


class AsyncExecutor:
    """Runs a task graph across per-lane worker threads.

    ``steal`` enables runtime re-dispatch (see module docstring); ``comm``
    is the ``(src, dst, nbytes) -> seconds`` pricing steal moves (None
    prices moves at zero); ``observe(task, device, seconds)`` is called
    after every completed compute task — the online-feedback hook
    ``repro_torch.api`` wires to ``runtime.online.OnlineRefiner.observe``.
    ``telemetry`` (a ``repro_torch.obs.Telemetry``) makes the run
    observable: per-lane queue-depth gauge series, queue-wait histograms
    (transfers keyed by their bus/link lane), and steal instants carrying
    the priced alternatives the decision weighed.  ``memory(task, lane)``
    is called after every completed task, before its dependents fire (the
    memory ledger's hook).
    """

    def __init__(self, tracer: Optional[ExecutionTrace] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 steal: Optional[StealPolicy] = None,
                 comm: Optional[Callable[[str, str, float], float]] = None,
                 observe: Optional[Callable[[ExecTask, str, float],
                                            None]] = None,
                 telemetry=None,
                 memory: Optional[Callable[[ExecTask, str], None]] = None):
        self.tracer = tracer
        self.clock = clock
        self.steal = steal
        self.comm = comm
        self.observe = observe
        self.telemetry = telemetry
        # memory-ledger hook: called (task, lane) after EVERY completed
        # task (compute and transfer), before dependents fire — the
        # ordering guarantee the ref-counted accounting relies on (a
        # transfer must never release its source before the producer's
        # completion alloc'd it)
        self.memory = memory

    # -- validation ----------------------------------------------------------
    @staticmethod
    def _validate(tasks: Sequence[ExecTask]) -> None:
        names = set()
        for t in tasks:
            if t.name in names:
                raise ValueError(f"duplicate task name {t.name!r}")
            names.add(t.name)
        for t in tasks:
            for d in t.deps:
                if d not in names:
                    raise ValueError(
                        f"task {t.name!r} depends on unknown task {d!r}")
        # Kahn's algorithm: anything left over sits on a cycle
        pending = {t.name: len(t.deps) for t in tasks}
        succ: dict = {t.name: [] for t in tasks}
        for t in tasks:
            for d in t.deps:
                succ[d].append(t.name)
        ready = deque(n for n, c in pending.items() if c == 0)
        seen = 0
        while ready:
            n = ready.popleft()
            seen += 1
            for s in succ[n]:
                pending[s] -= 1
                if pending[s] == 0:
                    ready.append(s)
        if seen != len(tasks):
            stuck = sorted(n for n, c in pending.items() if c > 0)
            raise ValueError(f"dependency cycle among tasks {stuck}")

    # -- the steal decision --------------------------------------------------
    def _move_cost(self, task: ExecTask, device: str) -> float:
        if self.comm is None:
            return 0.0
        back = self.comm(device, task.device, task.out_nbytes) \
            if task.out_nbytes and device != task.device else 0.0
        return back + sum(self.comm(home, device, nbytes)
                          for _, home, nbytes in task.inputs
                          if home != device)

    def price_decision(self, task: ExecTask,
                       load: Mapping[str, float]) -> tuple:
        """``(device, costs)``: the device the task should run on given
        the current predicted per-device load, plus every alternative the
        rule priced (device -> predicted load+move+run seconds; devices
        skipped as non-idle or unpriceable are absent) — the record of
        *why* a steal happened."""
        if (self.steal is None or task.run_on is None
                or task.predict is None or not task.runnable_on):
            return task.device, {}
        planned = task.device
        planned_cost = load.get(planned, 0.0) + task.predict(planned)
        costs = {planned: planned_cost}
        best_dev, best_cost = planned, planned_cost
        for dev in task.runnable_on:
            if dev == planned:
                continue
            dev_load = load.get(dev, 0.0)
            if self.steal.idle_only and dev_load > 0.0:
                continue
            try:
                cost = dev_load + self._move_cost(task, dev) \
                    + task.predict(dev)
            except Exception:
                # unpriceable candidate (e.g. cold comm pair, no model for
                # this kernel on that device) — never steal blind
                continue
            costs[dev] = cost
            if cost < best_cost:
                best_dev, best_cost = dev, cost
        if best_dev != planned \
                and best_cost < planned_cost * (1.0 - self.steal.min_advantage):
            return best_dev, costs
        return planned, costs

    def decide_device(self, task: ExecTask, load: Mapping[str, float]) -> str:
        """Pure decision rule (exposed for direct testing); see
        ``price_decision`` for the priced-alternatives variant."""
        return self.price_decision(task, load)[0]

    # -- execution -----------------------------------------------------------
    def run(self, tasks: Sequence[ExecTask],
            lane_width: Optional[Mapping[str, int]] = None,
            pool: Optional[LanePool] = None) -> dict:
        """Execute the graph; returns name -> output.  ``lane_width`` maps
        lane -> concurrent worker count (default 1 — buses with capacity k
        pass k).  With ``pool`` the lane loops run on the pool's long-lived
        threads (one run at a time); without, on a pool of this run's own,
        closed when it ends.  The first task exception aborts the run:
        not-yet-started tasks are skipped and their futures *cancelled* (so
        nothing ever blocks on them) and the original error re-raises in
        the caller."""
        tasks = list(tasks)
        if not tasks:
            return {}
        self._validate(tasks)
        own = pool is None
        pool = LanePool() if own else pool
        try:
            with pool.lock:
                return self._run(tasks, lane_width, pool)
        finally:
            if own:
                pool.close()

    def _run(self, tasks: list, lane_width: Optional[Mapping[str, int]],
             pool: LanePool) -> dict:
        tel = self.telemetry
        # one run epoch, captured before any work: Chrome trace, Gantt CSV
        # and telemetry all normalize against this single clock value
        if self.tracer is not None:
            self.tracer.set_epoch(self.clock())

        by_name = {t.name: t for t in tasks}
        futures: dict = {t.name: Future() for t in tasks}
        env = _Env(futures)
        succ: dict = {t.name: [] for t in tasks}
        for t in tasks:
            for d in t.deps:
                succ[d].append(t.name)

        lock = threading.Lock()
        done = threading.Event()
        abort = threading.Event()
        state = {"pending": {t.name: len(t.deps) for t in tasks},
                 "n_done": 0, "error": None, "seq": 0}
        lanes = {t.device for t in tasks}
        if self.steal is not None:
            for t in tasks:
                lanes.update(t.runnable_on)
        lanes = sorted(lanes)
        queues: dict = {lane: queue.PriorityQueue() for lane in lanes}
        # predicted load ledger (adaptive mode): per lane, the queued-not-
        # yet-started tasks and the running one.  Estimates are *live*
        # closures over task.predict, re-evaluated at every decision — so
        # an online refit immediately reprices the whole backlog, which is
        # how execution feedback changes later steal decisions mid-run (a
        # snapshot taken at enqueue time would keep lying until the queue
        # drained).
        queued: dict = {lane: {} for lane in lanes}   # lane -> {name: est fn}
        running: dict = {}              # task name -> (lane, est fn, t_start)
        enq_t: dict = {}                # task name -> enqueue clock time

        def _est_fn(task: ExecTask, lane: str):
            if task.predict is None:    # transfers / non-adaptive tasks
                return lambda: 0.0
            return lambda: task.predict(lane)

        def _safe(fn) -> float:
            try:
                return float(fn())
            except Exception:
                return 0.0

        def _load(now: float) -> dict:
            out = {lane: 0.0 for lane in queued}
            for lane, ests in queued.items():
                for fn in ests.values():
                    out[lane] += _safe(fn)
            for _, (lane, fn, t0) in running.items():
                out[lane] = out.get(lane, 0.0) \
                    + max(0.0, _safe(fn) - (now - t0))
            return out

        def enqueue(task: ExecTask) -> None:
            now = self.clock()
            costs: dict = {}
            with lock:
                state["seq"] += 1
                seq = state["seq"]
                if self.steal is not None:
                    lane, costs = self.price_decision(task, _load(now))
                else:
                    lane = task.device
                queued[lane][task.name] = _est_fn(task, lane)
                enq_t[task.name] = now
                depth = len(queued[lane])
            if lane != task.device:
                if self.tracer is not None:
                    self.tracer.record(f"steal:{task.name}", "steal", lane,
                                       now, now,
                                       note=f"{task.device}->{lane}")
                if tel is not None:
                    tel.count("exec.steals")
                    tel.instant(f"steal:{task.name}", cat="steal",
                                planned=task.device, chosen=lane,
                                costs_s=costs)
            if tel is not None:
                tel.gauge(f"exec.queue_depth.{lane}", depth, t=now)
            queues[lane].put((task.priority, seq, task))

        def complete(task: ExecTask, value) -> None:
            try:
                futures[task.name].set_result(value)
            except Exception:           # future cancelled by a racing abort
                return
            ready = []
            with lock:
                state["n_done"] += 1
                running.pop(task.name, None)
                for s in succ[task.name]:
                    state["pending"][s] -= 1
                    if state["pending"][s] == 0:
                        ready.append(by_name[s])
                finished = state["n_done"] == len(tasks)
            try:
                for r in sorted(ready, key=lambda t: t.priority):
                    enqueue(r)
            except BaseException as exc:  # noqa: BLE001 — re-raised in run()
                # a failed steal decision must fail the run: a worker that
                # died here would leave run() waiting forever
                fail(task, exc)
                return
            if finished:
                done.set()

        def fail(task: ExecTask, exc: BaseException) -> None:
            try:
                futures[task.name].set_exception(exc)
            except Exception:
                pass
            with lock:
                if state["error"] is None:
                    state["error"] = exc
                running.pop(task.name, None)
            abort.set()
            done.set()

        def worker(lane: str) -> None:
            q = queues[lane]
            while True:
                _, _, task = q.get()
                if task is None:
                    return
                now = self.clock()
                with lock:
                    est = queued[lane].pop(task.name, None)
                    t_enq = enq_t.pop(task.name, None)
                    depth = len(queued[lane])
                    if not abort.is_set():
                        running[task.name] = (lane, est or (lambda: 0.0),
                                              now)
                if tel is not None:
                    tel.gauge(f"exec.queue_depth.{lane}", depth, t=now)
                    if t_enq is not None:
                        # queue wait: ready (deps resolved) -> lane free.
                        # Transfers keyed per lane = the per-bus wait
                        # histogram the contention model is judged by.
                        wait = now - t_enq
                        if task.kind == "transfer":
                            tel.observe(f"exec.transfer_wait_s.{lane}", wait)
                        else:
                            tel.observe("exec.task_wait_s", wait)
                if abort.is_set():
                    # abort cleanup: a skipped task's future must never be
                    # awaited into a hang — cancel it so readers raise
                    futures[task.name].cancel()
                    continue
                stolen = lane != task.device
                t0 = self.clock()
                try:
                    if stolen:
                        value = task.run_on(env, lane)
                    else:
                        value = task.fn(env)
                except BaseException as exc:  # noqa: BLE001 — re-raised in run()
                    fail(task, exc)
                    continue
                t1 = self.clock()
                if self.tracer is not None:
                    self.tracer.record(task.name, task.kind, lane, t0, t1,
                                       note=f"stolen:{task.device}->{lane}"
                                       if stolen else "",
                                       deps=task.deps,
                                       meta=dict(task.meta)
                                       if task.meta else None)
                if tel is not None:
                    tel.count(f"exec.{task.kind}_done")
                if self.observe is not None and task.kind == "compute":
                    try:
                        self.observe(task, lane, t1 - t0)
                    except BaseException as exc:  # noqa: BLE001
                        fail(task, exc)
                        continue
                if self.memory is not None:
                    try:
                        self.memory(task, lane)
                    except BaseException as exc:  # noqa: BLE001
                        fail(task, exc)
                        continue
                complete(task, value)

        widths = dict(lane_width or {})
        slots = [(lane, i) for lane in lanes
                 for i in range(max(1, int(widths.get(lane, 1))))]
        pool.reserve(slots)
        jobs = [pool.submit(slot, lambda lane=slot[0]: worker(lane))
                for slot in slots]
        try:
            try:
                for t in sorted(tasks, key=lambda t: t.priority):
                    if not t.deps:
                        enqueue(t)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                fail(t, exc)
            done.wait()
        finally:
            for lane, _ in slots:       # one sentinel per worker loop
                queues[lane].put((_SENTINEL_PRIORITY, 0, None))
            for job in jobs:
                job.done.wait()
        if state["error"] is None:
            # a lane loop that died outside a task (an executor fault)
            state["error"] = next((j.error for j in jobs if j.error), None)
        if state["error"] is not None:
            # cancel every future the abort left unresolved: a dependent
            # (or CompiledProgram.__call__) blocked on one would hang
            # forever instead of seeing the original error
            for fut in futures.values():
                if not fut.done():
                    fut.cancel()
            raise state["error"]
        return {name: futures[name].result() for name in futures}
