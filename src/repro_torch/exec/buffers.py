"""Buffer placement table + explicit transfer materialization, the port of
``repro.exec.buffers``.

The scheduler decides *where each node runs*; this module derives from
that *where each value lives* and which values must physically move.  A
node's output lives on the device that ran it; a program input is placed
on the device of its earliest-starting consumer.  Every DAG edge whose
consumer device differs from the value's home device materializes one
``Transfer`` task — data movement as first-class scheduled work (the
SDFG/DaCe lesson), deduplicated per (value, destination): a value fanning
out to two nodes on the same remote device crosses the link once.

A device name is either a simulated device's label (``"d0"``, ``"local"``)
or a real torch device (``"cuda:0"``, ``"cpu"``); ``lane_device`` tells
them apart.  Values on a real device's lane must lie on that device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def _itemsize(dtype) -> int:
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, str(dtype))   # a name: "float32", "bfloat16"
    return dtype.itemsize


def value_nbytes(shape, dtype) -> int:
    """Payload size of a value from its aval: a torch dtype or a dtype
    name."""
    return math.prod(int(d) for d in shape) * _itemsize(dtype)


def lane_device(name: str) -> Optional[torch.device]:
    """The torch device a device name denotes (``"cuda:0"``, ``"cpu"``), or
    None for a simulated device's label, a link or a bus lane."""
    try:
        device = torch.device(name)
    except (RuntimeError, TypeError):
        return None
    return device if device.type in ("cpu", "cuda") else None


def on_device(value, device: torch.device) -> bool:
    """Does tensor ``value`` lie on ``device`` (``cuda`` without an index
    matches any card)?"""
    d = value.device
    return d.type == device.type and (device.index is None
                                      or d.index == device.index)


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One materialized cross-device move of a named value."""
    value: str                  # value being moved (input or node output)
    src: str                    # home device
    dst: str                    # consumer device
    nbytes: int
    bus: Optional[str] = None   # shared bus carrying this pair (topology)

    @property
    def name(self) -> str:
        return f"xfer:{self.value}:{self.src}->{self.dst}"

    @property
    def lane(self) -> str:
        """The lane that carries this transfer: the shared bus when a
        topology covers the pair (same-bus copies queue on its workers),
        else a dedicated point-to-point link lane (copies overlap with
        both endpoints' compute)."""
        if self.bus is not None:
            return f"bus:{self.bus}"
        return f"{self.src}->{self.dst}"


@dataclasses.dataclass(frozen=True)
class BufferTable:
    """value name -> home device, plus the transfers the plan requires."""
    placements: dict
    transfers: tuple

    def device_of(self, value: str) -> str:
        return self.placements[value]

    def transfer_for(self, value: str, device: str) -> Optional[Transfer]:
        """The transfer that lands ``value`` on ``device``, if one exists
        (none means the value is already home there)."""
        for t in self.transfers:
            if t.value == value and t.dst == device:
                return t
        return None


def plan_buffers(program, assignments,
                 input_homes: Optional[dict] = None,
                 topology=None) -> BufferTable:
    """Derive the placement table and transfer list for a scheduled program.

    ``assignments`` is the scheduler's node -> Assignment map.
    ``input_homes`` is the input -> device pinning the comm-aware EFT
    recorded while scheduling (``core.scheduler.schedule(...,
    input_homes=)``); passing it keeps the materialized placement
    identical to what the schedule priced.  Inputs it does not name (or
    all inputs, when it is None) are placed on their earliest-starting
    consumer's device (ties broken by node order); an input no node
    consumes (a passthrough output) stays on the first device seen.
    Transfers are emitted for every edge whose consumer runs away from
    the value's home, one per (value, dst); with a ``Topology`` each
    transfer is labelled with the shared bus carrying its pair, so its
    executor lane (and hence contention) follows the topology.
    """
    placements: dict = {}
    for node in program.nodes:
        placements[node.name] = assignments[node.name].device

    avals = {s.name: s.aval for s in program.inputs}
    for node in program.nodes:
        avals[node.name] = node.aval

    # inputs: the scheduler's pinning when given, else earliest consumer
    pinned = input_homes or {}
    for spec in program.inputs:
        if spec.name in pinned:
            placements[spec.name] = pinned[spec.name]
            continue
        consumers = [n for n in program.nodes if spec.name in n.deps]
        if consumers:
            first = min(consumers,
                        key=lambda n: assignments[n.name].start)
            placements[spec.name] = assignments[first.name].device
        elif assignments:
            placements[spec.name] = next(iter(assignments.values())).device

    transfers: list = []
    seen: set = set()
    for node in program.nodes:
        dst = assignments[node.name].device
        for dep in node.deps:
            src = placements[dep]
            if src == dst or (dep, dst) in seen:
                continue
            seen.add((dep, dst))
            aval = avals[dep]
            bus = topology.bus_of(src, dst) if topology is not None else None
            transfers.append(Transfer(dep, src, dst,
                                      value_nbytes(aval.shape, aval.dtype),
                                      bus=bus.name if bus else None))
    return BufferTable(placements=placements, transfers=tuple(transfers))
