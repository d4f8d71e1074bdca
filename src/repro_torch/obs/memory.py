"""Per-device memory accounting over the buffer plan (the memory ledger),
the port of ``repro.obs.memory``.

The scheduler decides where every value lives (``exec.buffers.plan_buffers``
value homes); this module derives from that *how many bytes each device
holds over time* — the capacity axis the EFT and steal policies will need
once real model graphs land on the executor.  Two sides of one coin,
deliberately built from the same accounting rules so they are comparable:

- ``MemoryPlan`` / ``MemoryLedger`` — *measured*: a per-run ref-counted
  ledger.  A value's buffer is alloc'd on its home device when its
  producer completes (program inputs at run start, transferred copies when
  their transfer lands), and freed when its last planned consumer has read
  it; program outputs stay pinned to run end.  Every alloc/free appends a
  ``mem.live_bytes.<device>`` gauge point to the run's ``Telemetry``, and
  per-device peaks are re-read via ``peak_bytes()`` (mirrored as
  ``mem.peak_bytes.<device>`` gauges at run end by ``CompiledProgram``).
- ``predicted_peak_bytes`` — *predicted*: the same ledger replayed over
  the EFT schedule's frozen execution order at compile time, before any
  byte moves.  Because both sides process the identical event sequence
  (alloc output, then release dep reads), the sequential backend's
  measured peak equals the prediction exactly; the async/adaptive
  backends only reorder *across* devices (each device's local order is
  fixed by the plan), so their measured peaks track the prediction
  closely — the bench acceptance bound is 1.25x.

Stolen tasks (adaptive mode) are accounted at their *planned* home: value
homes are a property of the plan, and the ledger measures residency of
the planned placement — a steal's inline move is extra traffic the comm
model prices, not a re-homing.

``MemoryCapacityError`` is the typed compile-time failure: a device
dispatcher may advertise ``capacity_bytes`` (``SimDispatcher(capacity_bytes=
...)``), and ``compile_program`` refuses a placement whose predicted peak
exceeds it — an over-capacity plan should die at compile, not OOM mid-run.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.exec.buffers import BufferTable, value_nbytes


class MemoryCapacityError(RuntimeError):
    """A planned placement's predicted peak exceeds a device's capacity."""

    def __init__(self, device: str, predicted_bytes: int,
                 capacity_bytes: int):
        self.device = device
        self.predicted_bytes = int(predicted_bytes)
        self.capacity_bytes = int(capacity_bytes)
        super().__init__(
            f"predicted peak {self.predicted_bytes} bytes on device "
            f"{device!r} exceeds its capacity {self.capacity_bytes} bytes "
            "— the placement cannot fit; shrink the program, raise the "
            "capacity, or re-schedule across more devices")


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """The plan-derived accounting table one program compiles to.

    ``reads`` carries the total planned read count per (device, value)
    residency — the ref-count a live copy starts from; ``pinned`` names
    residencies that never free (program outputs at their homes).
    ``node_reads`` lists, per node, the residency each positional dep is
    read from: the transferred copy on the node's device when the plan
    materialized one, else the home copy (duplicated deps count twice —
    both sides of the ledger process them identically)."""
    input_allocs: tuple     # (device, value, nbytes) at run start
    node_allocs: dict       # node name -> (device, nbytes) on completion
    node_reads: dict        # node name -> ((device, value), ...) releases
    transfer_allocs: dict   # transfer name -> (dst, value, nbytes)
    transfer_reads: dict    # transfer name -> (src, value) release
    reads: dict             # (device, value) -> planned read count
    pinned: frozenset       # (device, value) residencies never freed

    @property
    def devices(self) -> tuple:
        devs = {d for d, _, _ in self.input_allocs}
        devs.update(d for d, _ in self.node_allocs.values())
        devs.update(d for d, _, _ in self.transfer_allocs.values())
        return tuple(sorted(devs))


def memory_plan(program, buffers: BufferTable) -> MemoryPlan:
    """Derive the accounting table from the program + its buffer plan."""
    avals = {s.name: s.aval for s in program.inputs}
    for node in program.nodes:
        avals[node.name] = node.aval

    input_allocs = tuple(
        (buffers.device_of(s.name), s.name,
         value_nbytes(s.aval.shape, s.aval.dtype))
        for s in program.inputs if s.name in buffers.placements)

    node_allocs: dict = {}
    node_reads: dict = {}
    reads: dict = {}
    for node in program.nodes:
        dev = buffers.device_of(node.name)
        node_allocs[node.name] = (
            dev, value_nbytes(node.aval.shape, node.aval.dtype))
        targets = []
        for dep in node.deps:
            tr = buffers.transfer_for(dep, dev)
            residency = (dev, dep) if tr is not None \
                else (buffers.device_of(dep), dep)
            targets.append(residency)
            reads[residency] = reads.get(residency, 0) + 1
        node_reads[node.name] = tuple(targets)

    transfer_allocs: dict = {}
    transfer_reads: dict = {}
    for tr in buffers.transfers:
        aval = avals[tr.value]
        transfer_allocs[tr.name] = (
            tr.dst, tr.value, value_nbytes(aval.shape, aval.dtype))
        src_res = (tr.src, tr.value)
        transfer_reads[tr.name] = src_res
        reads[src_res] = reads.get(src_res, 0) + 1

    pinned = frozenset((buffers.device_of(o), o) for o in program.outputs
                       if o in buffers.placements)
    return MemoryPlan(input_allocs=input_allocs, node_allocs=node_allocs,
                      node_reads=node_reads, transfer_allocs=transfer_allocs,
                      transfer_reads=transfer_reads, reads=reads,
                      pinned=pinned)


class MemoryLedger:
    """Ref-counted live/peak per-device byte accounting for one run.

    Thread-safe: the async executor reports completions from per-lane
    worker threads.  With a ``Telemetry`` attached every live-bytes change
    appends a ``mem.live_bytes.<device>`` gauge point."""

    def __init__(self, plan: MemoryPlan, telemetry=None):
        self.plan = plan
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._live: dict = {d: 0 for d in plan.devices}
        self._peak: dict = dict(self._live)
        self._refs: dict = {}        # (device, value) -> remaining reads
        self._sizes: dict = {}       # (device, value) -> nbytes while live

    # -- primitive accounting ------------------------------------------------
    def _gauge(self, device: str, value: int) -> None:
        if self.telemetry is not None:
            self.telemetry.gauge(f"mem.live_bytes.{device}", value)

    def _alloc(self, device: str, value: str, nbytes: int) -> None:
        res = (device, value)
        with self._lock:
            if res in self._sizes:          # idempotent: dup transfer/replay
                return
            self._sizes[res] = int(nbytes)
            self._refs[res] = self.plan.reads.get(res, 0)
            live = self._live.get(device, 0) + int(nbytes)
            self._live[device] = live
            if live > self._peak.get(device, 0):
                self._peak[device] = live
        self._gauge(device, live)
        # a residency nothing reads and nothing pins is dead on arrival
        # (e.g. an unconsumed non-output input) — free it immediately so
        # it cannot leak for the whole run
        if self.plan.reads.get(res, 0) == 0 and res not in self.plan.pinned:
            self._free(device, value)

    def _free(self, device: str, value: str) -> None:
        res = (device, value)
        with self._lock:
            nbytes = self._sizes.pop(res, None)
            self._refs.pop(res, None)
            if nbytes is None:
                return
            live = self._live.get(device, 0) - nbytes
            self._live[device] = live
        self._gauge(device, live)

    def _release(self, device: str, value: str) -> None:
        res = (device, value)
        with self._lock:
            if res not in self._refs:
                return
            self._refs[res] -= 1
            exhausted = self._refs[res] <= 0
        if exhausted and res not in self.plan.pinned:
            self._free(device, value)

    # -- plan-driven events --------------------------------------------------
    def start(self) -> None:
        """Run start: program inputs materialize on their planned homes."""
        for device, value, nbytes in self.plan.input_allocs:
            self._alloc(device, value, nbytes)

    def node_done(self, name: str) -> None:
        """A compute node completed: its output exists on its home, and
        every positional dep read is released (last reader frees)."""
        alloc = self.plan.node_allocs.get(name)
        if alloc is None:
            return
        device, nbytes = alloc
        self._alloc(device, name, nbytes)
        for dep_device, dep_value in self.plan.node_reads.get(name, ()):
            self._release(dep_device, dep_value)

    def transfer_done(self, name: str) -> None:
        """A planned transfer landed: the copy exists on the destination
        and the home copy loses one reader."""
        alloc = self.plan.transfer_allocs.get(name)
        if alloc is None:
            return
        dst, value, nbytes = alloc
        self._alloc(dst, value, nbytes)
        src, src_value = self.plan.transfer_reads[name]
        self._release(src, src_value)

    # -- reading -------------------------------------------------------------
    def live_bytes(self) -> dict:
        with self._lock:
            return dict(self._live)

    def peak_bytes(self) -> dict:
        with self._lock:
            return dict(self._peak)

    def to_json(self) -> dict:
        with self._lock:
            return {"live_bytes": dict(self._live),
                    "peak_bytes": dict(self._peak)}


def predicted_peak_bytes(plan: MemoryPlan, order,
                         buffers: BufferTable) -> dict:
    """Compile-time predicted peak bytes per device: the ledger replayed
    over the EFT schedule's frozen execution order (``CompiledProgram.
    order``), each planned transfer completing just before its first
    consumer — the same event sequence ``_run_sequential`` produces, so
    sequential measured peaks match this exactly."""
    ledger = MemoryLedger(plan)
    ledger.start()
    done: set = set()
    for task in order:
        dev = plan.node_allocs[task.name][0]
        for _, dep in plan.node_reads.get(task.name, ()):
            tr = buffers.transfer_for(dep, dev)
            if tr is not None and tr.name not in done:
                done.add(tr.name)
                ledger.transfer_done(tr.name)
        ledger.node_done(task.name)
    for name in plan.transfer_allocs:   # plan-dead transfers still land
        if name not in done:
            ledger.transfer_done(name)
    return ledger.peak_bytes()


def check_capacity(predicted: dict, dispatchers: dict) -> None:
    """Raise ``MemoryCapacityError`` when any device's predicted peak
    exceeds its dispatcher's advertised ``capacity_bytes`` (devices
    without one are unconstrained)."""
    for device, peak in sorted(predicted.items()):
        cap = getattr(dispatchers.get(device), "capacity_bytes", None)
        if cap is not None and peak > cap:
            raise MemoryCapacityError(device, peak, cap)


def fold_memory(telemetry, ledger: Optional[MemoryLedger],
                predicted: Optional[dict]) -> None:
    """End-of-run summary gauges: measured peaks next to the prediction,
    so a saved telemetry file carries both sides of the 1.25x check."""
    if telemetry is None:
        return
    for device, peak in sorted((predicted or {}).items()):
        telemetry.gauge(f"mem.predicted_peak_bytes.{device}", peak)
    if ledger is not None:
        for device, peak in sorted(ledger.peak_bytes().items()):
            telemetry.gauge(f"mem.peak_bytes.{device}", peak)
