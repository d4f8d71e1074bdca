"""Bytes -> seconds inter-device transfer cost model + bus topology, the
port of ``repro.exec.comm``.

Transfers are predicted exactly like kernels: each (src, dst) device pair
is a *pseudo-kernel* in the runtime tuning cache whose rows are measured
copy times over a sweep of payload sizes, with ``bytes`` as both the
single feature and the analytic ``c`` augmentation (the operation count of
a copy *is* its byte count).  The fitted closed-form model — latency +
bandwidth in log space — persists next to the kernel models in the JAX
package's file layout, so a re-compiled program on the same fingerprint
prices its links without re-measuring, a cache either package wrote loads
in the other, and the comm-aware EFT scheduler
(``core.scheduler.schedule(..., comm=)``) reads predicted transfer seconds
from the same cache state execution will.

``Topology`` models the *shared* part of real interconnects (PCIe tree /
NVLink fabric): named buses, each attaching a set of devices with a lane
capacity.  A transfer between two devices on the same bus occupies one of
its lanes for the predicted duration — so same-bus transfers serialize
once the lanes are full (in the EFT via per-lane free times, at run time
via one executor worker per lane), while pairs on different buses overlap
freely.  Per-transfer *duration* still comes from the (src, dst) pseudo-
kernel above.

Real devices (``"cpu"``, ``"cuda:0"``) move values with ``copy_to_dst``,
the ``transfer`` hook of a compiled program over them, and are measured
into a ``CommModel`` by ``measure_copies``, which times that same copy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.nnc import LinearModel
from repro_torch.exec.buffers import Transfer, lane_device
from repro_torch.perfdata.measure import time_callable
from repro_torch.runtime.cache import TuningCache, shape_bucket

TRANSFER_FEATURES = ("bytes",)
# payload sweep for measure_pair: small enough to stay fast, wide enough
# (3 decades) that the log-space fit separates latency from bandwidth
DEFAULT_SIZES = (1 << 12, 1 << 15, 1 << 18, 1 << 21)


@dataclasses.dataclass(frozen=True)
class Bus:
    """One shared interconnect segment: ``lanes`` concurrent transfers
    among ``devices``; further same-bus transfers queue."""
    name: str
    devices: tuple
    lanes: int = 1

    @property
    def lane(self) -> str:
        """The executor lane name for this bus."""
        return f"bus:{self.name}"


class Topology:
    """Which bus carries each device pair.  Pairs no bus covers fall back
    to a dedicated point-to-point lane (the pre-topology behaviour)."""

    def __init__(self, buses: Sequence[Bus]):
        names = [b.name for b in buses]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate bus names in {names}")
        for b in buses:
            if b.lanes < 1:
                raise ValueError(f"bus {b.name!r}: lanes must be >= 1")
        self.buses = tuple(buses)

    def bus_of(self, src: str, dst: str) -> Optional[Bus]:
        """The first bus attaching both endpoints (declaration order is
        priority order), or None for an uncovered pair."""
        for b in self.buses:
            if src in b.devices and dst in b.devices:
                return b
        return None

    def lane_of(self, src: str, dst: str) -> str:
        b = self.bus_of(src, dst)
        return b.lane if b is not None else f"{src}->{dst}"

    def lane_widths(self) -> dict:
        """Executor lane -> worker count (bus lanes with capacity > 1 get
        that many concurrent workers)."""
        return {b.lane: b.lanes for b in self.buses}

    @classmethod
    def shared_bus(cls, devices: Sequence[str], name: str = "pcie0",
                   lanes: int = 1) -> "Topology":
        """PCIe-tree-style: every device hangs off one root complex, all
        transfers share its ``lanes``."""
        return cls([Bus(name, tuple(devices), lanes)])

    @classmethod
    def point_to_point(cls, devices: Sequence[str],
                       lanes: int = 1) -> "Topology":
        """NVLink-style: a dedicated bus per device pair (both directions
        share it — a full-duplex fabric would use two)."""
        devs = sorted(devices)
        return cls([Bus(f"{a}--{b}", (a, b), lanes)
                    for i, a in enumerate(devs) for b in devs[i + 1:]])


def transfer_kernel(src: str, dst: str) -> str:
    """Cache entry name of the (src, dst) pseudo-kernel (doubles as its
    on-disk file stem, hence no path-hostile characters)."""
    return f"transfer__{src}__{dst}"


def _synchronize(*names: str) -> None:
    """Wait for every card among the named devices."""
    for name in names:
        device = lane_device(name)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)


class CommModel:
    """Per-device-pair bytes->seconds predictor backed by a tuning cache.

    ``telemetry`` (a ``repro_torch.obs.Telemetry``) counts predictions and
    recorded rows per pair and keeps a predicted-seconds histogram — how
    often (and how expensively) the scheduler/steal rule priced each
    link."""

    def __init__(self, cache: Optional[TuningCache] = None, telemetry=None):
        self.cache = cache or TuningCache()
        self.telemetry = telemetry

    def _entry(self, src: str, dst: str):
        return self.cache.entry(transfer_kernel(src, dst),
                                feature_names=list(TRANSFER_FEATURES),
                                variant_names=["copy"])

    # -- recording -----------------------------------------------------------
    def record(self, src: str, dst: str, nbytes: int,
               seconds: float) -> None:
        """Append one observed transfer (features row is [bytes, c=bytes])."""
        entry = self._entry(src, dst)
        entry.add_rows(np.asarray([[float(nbytes), float(nbytes)]]),
                       [seconds], shape_bucket({"bytes": nbytes}))
        if self.telemetry is not None:
            self.telemetry.count(f"comm.recorded.{src}->{dst}")

    def fit(self, src: str, dst: str) -> None:
        entry = self._entry(src, dst)
        entry.fit(model=LinearModel())
        self.cache.save(entry.kernel)

    def measure_pair(self, src: str, dst: str,
                     transfer_fn: Callable[[torch.Tensor], object],
                     sizes: Sequence[int] = DEFAULT_SIZES,
                     min_window: float = 1e-3) -> None:
        """Measure ``transfer_fn`` (takes the payload tensor) over the size
        sweep, record the rows, fit, and persist — the black-box protocol
        kernels use, applied to the link.  The payload lies on ``src``
        when that names a real device (else on the CPU), and every timed
        call waits for the endpoints' cards, so a copy is timed, not
        queued."""
        home = lane_device(src) or torch.device("cpu")
        for nbytes in sizes:
            buf = torch.zeros(int(nbytes), dtype=torch.uint8, device=home)

            def move(buf=buf):
                out = transfer_fn(buf)
                _synchronize(src, dst)
                return out
            self.record(src, dst, int(nbytes),
                        time_callable(move, min_window=min_window))
        self.fit(src, dst)

    # -- prediction ----------------------------------------------------------
    def has_pair(self, src: str, dst: str) -> bool:
        return self.cache.has(transfer_kernel(src, dst))

    def predict(self, src: str, dst: str, nbytes: float) -> float:
        """Predicted seconds to move ``nbytes`` from src to dst; 0 for a
        same-device 'move'.  A cold/unknown pair raises — a scheduler fed
        silent zeros would hide every link from the makespan."""
        if src == dst:
            return 0.0
        # guard before _entry(): touching an unmeasured pair would register
        # an empty cache entry, and has_pair would then misreport it known
        if not self.has_pair(src, dst):
            raise ValueError(
                f"no measured transfer model for {src!r}->{dst!r} — run "
                "measure_pair (or record+fit) for this device pair first")
        entry = self._entry(src, dst)
        row = np.asarray([[float(nbytes), float(nbytes)]])
        seconds = float(entry.predict(row)[0])
        if self.telemetry is not None:
            self.telemetry.count(f"comm.predictions.{src}->{dst}")
            self.telemetry.observe("comm.predicted_s", seconds)
        return seconds

    def comm_fn(self) -> Callable[[str, str, float], float]:
        """The ``comm(src, dst, nbytes) -> seconds`` callable the EFT
        scheduler takes."""
        return self.predict


# -- real devices -------------------------------------------------------------

def copy_to_dst(value: torch.Tensor, tr: Transfer) -> torch.Tensor:
    """``CompiledProgram(transfer=copy_to_dst)`` hook for real devices:
    a copy of ``value`` on the device ``tr.dst`` names, returned once the
    copy is done (a blocking ``Tensor.to``, so the transfer task's span is
    the copy itself).  The real-device counterpart of ``SimLink.transfer``."""
    device = lane_device(tr.dst)
    if device is None:
        raise ValueError(f"transfer {tr.name}: {tr.dst!r} names no torch "
                         "device")
    return value.to(device)


def measure_copies(comm: CommModel, pairs, **kw) -> None:
    """Measure ``copy_to_dst`` into ``comm`` for every (src, dst) pair of
    real devices (``measure_pair``'s keywords pass through)."""
    for src, dst in pairs:
        comm.measure_pair(
            src, dst,
            lambda buf, src=src, dst=dst: copy_to_dst(
                buf, Transfer("payload", src, dst, buf.nbytes)),
            **kw)
