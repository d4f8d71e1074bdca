"""Kernel-DAG -> heterogeneous-device mapping from predicted times (§1).

The paper's motivating example: two independent matmuls, a CPU and a GPU —
the small one must take the CPU so the GPU is free for the big one, which
only falls out of *absolute time* predictions, not per-kernel winners.
Greedy earliest-finish-time list scheduling over predicted times, honouring
DAG dependencies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence



@dataclasses.dataclass(frozen=True)
class KernelTask:
    name: str
    kernel: str
    params: dict
    deps: tuple = ()
    out_bytes: float = 0.0      # payload size of this task's output — what
                                # a cross-device successor must pull over
                                # the link (0 disables comm costing)
    input_deps: tuple = ()      # (program-input name, nbytes) pairs this
                                # task reads — lets the comm-aware EFT
                                # price input->consumer transfers too


@dataclasses.dataclass
class Assignment:
    device: str
    start: float
    finish: float


def schedule(tasks: Sequence[KernelTask],
             predict: Callable[[KernelTask, str], float],
             devices: Sequence[str],
             comm: Optional[Callable[[str, str, float], float]] = None,
             input_homes: Optional[dict] = None,
             topology=None
             ) -> dict[str, Assignment]:
    """predict(task, device) -> seconds.  Returns task -> Assignment.

    With ``comm(src_device, dst_device, nbytes) -> seconds`` (a comm
    model's ``comm_fn()``) the EFT becomes communication-aware: an edge
    whose producer ran on a different device delays the consumer's
    earliest start by the predicted transfer time of the producer's output
    payload — so the makespan already accounts for the transfers a buffer
    plan will materialize, and a placement that looks fast compute-wise
    loses when it forces the bytes across a slow link.  (The port's
    ``api.compile_`` does not pass ``comm`` or ``topology`` yet; the
    executor layer that moves the bytes comes with them.)

    With a ``Topology`` (``bus_of(src, dst)``) the links are *contended*: each
    transfer additionally waits for a free lane of the shared bus carrying
    its (src, dst) pair, and occupies that lane for its predicted
    duration — two same-bus transfers serialize in the schedule exactly as
    they will on the executor's bus-lane workers, while pairs on
    different buses (or pairs no bus covers) still overlap freely.  Bus
    lanes are claimed in greedy scheduling order — the same approximation
    the rest of the EFT already makes.

    Program *inputs* are priced the same way: each task's ``input_deps``
    names the input payloads it reads.  An input's home is pinned to the
    device of its first *scheduled* consumer; any later-scheduled consumer
    placed elsewhere waits for the predicted input transfer.  Input
    payloads exist at t=0, so the transfer bounds the consumer's start
    directly rather than adding to a producer finish.  Note the greedy
    loop's scheduling order is not start-time order, so this pinning can
    differ from an after-the-fact earliest-starting-consumer reading of
    the assignments — pass ``input_homes`` (an empty dict, filled in
    place) and hand it to the buffer planner so the materialized placement
    matches what the EFT actually priced.
    """
    done: dict[str, Assignment] = {}
    producer = {t.name: t for t in tasks}
    device_free = {d: 0.0 for d in devices}
    input_home: dict[str, str] = \
        input_homes if input_homes is not None else {}
    bus_free: dict[str, list] = {}      # bus name -> per-lane free times

    def arrival(src: str, dst: str, nbytes: float, ready_s: float,
                bus_state: dict) -> float:
        """When the payload lands on dst: predicted duration on the pair's
        pseudo-kernel, queued behind ``bus_state``'s lane availability."""
        dur = comm(src, dst, nbytes)
        bus = topology.bus_of(src, dst) if topology is not None else None
        if bus is None:
            return ready_s + dur
        lanes = bus_state.setdefault(bus.name, [0.0] * bus.lanes)
        i = min(range(len(lanes)), key=lanes.__getitem__)
        start = max(ready_s, lanes[i])
        lanes[i] = start + dur
        return start + dur

    def earliest_start(task: KernelTask, dev: str, bus_state: dict) -> float:
        start = device_free[dev]
        for d in task.deps:
            avail = done[d].finish
            if comm is not None and done[d].device != dev:
                avail = arrival(done[d].device, dev, producer[d].out_bytes,
                                done[d].finish, bus_state)
            start = max(start, avail)
        if comm is not None:
            for iname, nbytes in task.input_deps:
                home = input_home.get(iname)
                if home is not None and home != dev:
                    start = max(start, arrival(home, dev, nbytes, 0.0,
                                               bus_state))
        return start

    remaining = list(tasks)
    while remaining:
        ready = [t for t in remaining if all(d in done for d in t.deps)]
        if not ready:
            raise ValueError("dependency cycle in kernel DAG")
        # pick the ready task with the LARGEST minimal predicted time first
        # (longest-processing-time heuristic) ...
        ready.sort(key=lambda t: -min(predict(t, d) for d in devices))
        task = ready[0]
        best = None
        for dev in devices:
            # candidates probe a copy of the bus lanes; only the chosen
            # device's transfers actually claim them below
            trial = {k: list(v) for k, v in bus_free.items()}
            start = earliest_start(task, dev, trial)
            finish = start + predict(task, dev)
            if best is None or finish < best[1].finish:
                best = (dev, Assignment(dev, start, finish))
        dev, assign = best
        earliest_start(task, dev, bus_free)     # commit bus lane claims
        device_free[dev] = assign.finish
        done[task.name] = assign
        if comm is not None:
            # pinning only matters when transfers are priced; a comm-free
            # schedule leaves placement to plan_buffers' earliest-starting-
            # consumer rule (the pre-comm behaviour)
            for iname, _ in task.input_deps:
                input_home.setdefault(iname, dev)
        remaining.remove(task)
    return done


def makespan(assignments: dict[str, Assignment]) -> float:
    return max(a.finish for a in assignments.values())


def execution_order(tasks: Sequence[KernelTask],
                    assignments: dict[str, Assignment]) -> list[KernelTask]:
    """Tasks in predicted-start-time order, verified dependency-safe.

    An earliest-finish-time schedule always starts a task at or after every
    dependency's finish, so start-time order is a topological order; this
    re-checks the invariant (ties broken by submission order) so a
    hand-edited or buggy assignment map fails loudly instead of executing a
    node before its inputs exist.
    """
    pos = {t.name: i for i, t in enumerate(tasks)}
    missing = [t.name for t in tasks if t.name not in assignments]
    if missing:
        raise KeyError(f"tasks without assignments: {missing}")
    order = sorted(tasks, key=lambda t: (assignments[t.name].start,
                                         pos[t.name]))
    done: set = set()
    for t in order:
        if not all(d in done for d in t.deps):
            raise ValueError(f"schedule violates dependencies at {t.name!r}")
        done.add(t.name)
    return order


def run_schedule(tasks: Sequence[KernelTask],
                 assignments: dict[str, Assignment],
                 run: Callable[[KernelTask, str], object]) -> dict[str, object]:
    """The generic Assignment -> execution bridge: call ``run(task,
    device)`` for every task in dependency-respecting start order; returns
    name -> result.  (``repro_torch.api.CompiledProgram`` freezes
    ``execution_order`` once at compile time instead, so repeated
    executions skip the sort and dependency re-check.)"""
    results: dict[str, object] = {}
    for t in execution_order(tasks, assignments):
        results[t.name] = run(t, assignments[t.name].device)
    return results


def predictor_from_runtime(dispatchers: dict[str, object]
                           ) -> Callable[[KernelTask, str], float]:
    """Build ``predict(task, device)`` from per-device runtime dispatchers.

    Each value is a ``repro_torch.runtime.Dispatcher`` (duck-typed:
    anything with ``predict_time(kernel, params) -> seconds``) whose tuning
    cache carries
    that device's fingerprint — so the scheduler's absolute-time estimates
    come from the same persisted NN+C state the dispatch path uses, not an
    ad-hoc table.  Raises ``ValueError`` on a cold cache: a scheduler fed
    unfitted predictions would silently produce garbage mappings.
    """
    def predict(task: KernelTask, device: str) -> float:
        if device not in dispatchers:
            raise KeyError(f"no dispatcher for device {device!r}")
        return float(dispatchers[device].predict_time(task.kernel,
                                                      task.params))
    return predict
