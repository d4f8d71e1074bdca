"""Predictor-seeded simulated "devices" for examples and tests, the port of
``repro.runtime.simdev``.

A simulated device is just a runtime ``Dispatcher`` whose fingerprinted
tuning cache was filled with synthetic (features, time) rows at a given
sustained FLOP rate and fitted with the closed-form linear baseline —
which gives the DAG scheduler honest *absolute-time* predictions without
needing two real machines in CI.  Everything downstream (scheduling,
compile, execution) is the production path.  A simulated device's kernels
run on the CPU, on the tensors it is given.

Two extensions serve the ``repro_torch.exec`` layer:

- ``SimDispatcher`` (``fake_matmul_device(..., simulate_time=True)``)
  additionally *sleeps* the predicted kernel time before dispatching, so
  node durations on CPU match the device's advertised speed and executor
  overlap is demonstrable (and testable) deterministically.
- ``SimLink`` models an inter-device interconnect: transfers sleep
  ``latency + nbytes/bandwidth``.  Its ``transfer`` method plugs into
  ``CompiledProgram(transfer=...)``; ``measure_into`` runs the link
  through ``CommModel.measure_pair`` so the *measured* pseudo-kernel path
  is exercised end-to-end, not short-circuited with analytic numbers.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.api.program import norm_dtype
from repro_torch.core.nnc import LinearModel
from repro_torch.runtime.cache import TuningCache, shape_bucket
from repro_torch.runtime.dispatch import Dispatcher
from repro_torch.runtime.fingerprint import Fingerprint


class SimDispatcher(Dispatcher):
    """Dispatcher that sleeps each kernel's predicted time before running
    it — a device that is exactly as fast as its tuning cache claims.

    ``capacity_bytes`` advertises a finite device memory: ``compile_program``
    checks the plan's predicted per-device peak against it and raises a
    typed ``obs.memory.MemoryCapacityError`` for placements that cannot
    fit (None — the default — is unconstrained)."""

    def __init__(self, *args, time_scale: float = 1.0,
                 capacity_bytes=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.time_scale = time_scale
        self.capacity_bytes = None if capacity_bytes is None \
            else int(capacity_bytes)

    def dispatch(self, kernel: str, *args, **kwargs):
        params = self.registry.get(kernel).params_of(*args, **kwargs)
        time.sleep(self.predict_time(kernel, params) * self.time_scale)
        return super().dispatch(kernel, *args, **kwargs)

    __call__ = dispatch


def fake_matmul_device(root: str, name: str, flops_per_s: float,
                       registry, seed: int = 0,
                       simulate_time: bool = False,
                       time_scale: float = 1.0,
                       policy=None, capacity_bytes=None) -> Dispatcher:
    """A matmul-tuned dispatcher running at ``flops_per_s`` sustained.
    With ``simulate_time`` the returned dispatcher also *takes* the
    predicted time per dispatch (see ``SimDispatcher``);
    ``capacity_bytes`` bounds the simulated device's memory (enforced at
    compile via the predicted memory peak).  The synthetic
    rows are drawn as the JAX package draws them, so both packages' caches
    predict alike."""
    fp = Fingerprint("sim", name, 1, 1, ("float32",))
    cache = TuningCache(root=root, fingerprint=fp)
    rk = registry.get("matmul")
    entry = cache.entry("matmul", feature_names=rk.feature_names,
                        variant_names=registry.variant_names("matmul"))
    rng = np.random.RandomState(seed)
    for _ in range(40):
        p = {"m": int(rng.randint(16, 2048)), "n": int(rng.randint(16, 2048)),
             "k": int(rng.randint(16, 2048))}
        rows = registry.feature_rows("matmul", p)
        entry.add_rows(rows, rows[:, -1] / flops_per_s, shape_bucket(p))
    entry.fit(model=LinearModel())
    cache.save()
    if simulate_time:
        return SimDispatcher(registry=registry, cache=cache, policy=policy,
                             time_scale=time_scale,
                             capacity_bytes=capacity_bytes)
    disp = Dispatcher(registry=registry, cache=cache, policy=policy)
    if capacity_bytes is not None:
        disp.capacity_bytes = int(capacity_bytes)
    return disp


class SkewedSimDispatcher(Dispatcher):
    """A device whose *model is wrong*: predictions come from this
    dispatcher's (deliberately mis-seeded) tuning cache, but each dispatch
    sleeps the TRUE time (``true_time(kernel, params)`` seconds) and
    returns zeros of the output aval, on the first operand's device,
    instead of running the kernel.  The gap between the two is what the
    adaptive executor's runtime re-dispatch and online feedback exist to
    absorb — a static replay of the mis-predicted schedule eats it as idle
    devices."""

    def __init__(self, *args, true_time, time_scale: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.true_time = true_time
        self.time_scale = time_scale

    def dispatch(self, kernel: str, *args, **kwargs):
        params = self.registry.get(kernel).params_of(*args, **kwargs)
        tel = self._telemetry
        predicted = None
        if tel is not None:
            t0 = time.perf_counter()
            predicted = float(self.predict_time(kernel, params))
            overhead = time.perf_counter() - t0
        true_s = self.true_time(kernel, params) * self.time_scale
        time.sleep(true_s)
        aval = self.registry.out_aval(kernel, *args, **kwargs)
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
        out = torch.zeros(tuple(aval.shape),
                          dtype=getattr(torch, norm_dtype(aval.dtype)),
                          device=device)
        if tel is not None:
            # predicted-vs-TRUE residuals are this dispatcher's whole
            # point: the drift monitor flags the lying cache, and the
            # live-MAPE counter track decays as online refits correct it
            tel.count("dispatch.predicted")
            tel.observe("dispatch.overhead_s", overhead)
            tel.observe(f"kernel.{kernel}.s", true_s)
            tel.residual(kernel, predicted * self.time_scale, true_s,
                         fit_band_pct=self._entry(kernel).fit_mape)
        return out

    __call__ = dispatch


def true_time_at(registry, flops_per_s: float):
    """``true_time(kernel, params)`` for a device sustaining the given
    flop rate (variant-independent — the truth the skews distort)."""
    def true_time(kernel: str, params: dict) -> float:
        rows = registry.feature_rows(kernel, params)
        return float(rows[0, -1]) / flops_per_s
    return true_time


@dataclasses.dataclass(frozen=True)
class SimLink:
    """Deterministic simulated interconnect: moving ``n`` bytes takes
    ``latency_s + n / bytes_per_s`` of wall time."""
    latency_s: float = 1e-3
    bytes_per_s: float = 1e9
    time_scale: float = 1.0

    def seconds(self, nbytes: float) -> float:
        return (self.latency_s + float(nbytes) / self.bytes_per_s) \
            * self.time_scale

    def transfer(self, value, tr):
        """``CompiledProgram(transfer=link.transfer)`` hook: sleep the
        link time for the payload, hand the value through untouched (the
        simulated devices share the host's memory — simulation must never
        perturb numerics)."""
        time.sleep(self.seconds(tr.nbytes))
        return value

    def measure_into(self, comm, pairs, **kw) -> None:
        """Measure this link into a ``repro_torch.exec.CommModel`` for
        every (src, dst) pair — the production measurement protocol run
        against the simulated wire, so predictions come from fitted
        rows."""
        for src, dst in pairs:
            comm.measure_pair(
                src, dst, lambda buf: time.sleep(self.seconds(buf.nbytes)),
                **kw)


class SimFabric:
    """A ``SimLink`` behind a shared-bus ``repro_torch.exec.Topology``:
    each transfer holds one lane of its pair's bus (a semaphore of the
    bus's lane count) while it sleeps the wire time, so same-bus copies
    genuinely serialize in wall clock — including the adaptive executor's
    inline steal moves, which never pass through a bus lane worker.
    Per-transfer duration is the plain link time; contention shows up as
    queueing, exactly like the EFT's per-lane free times model it."""

    def __init__(self, topology, link: SimLink = None):
        self.topology = topology
        self.link = link or SimLink()
        self._lanes = {b.name: threading.Semaphore(b.lanes)
                       for b in topology.buses}

    def transfer(self, value, tr):
        bus = self.topology.bus_of(tr.src, tr.dst)
        if bus is None:
            return self.link.transfer(value, tr)
        with self._lanes[bus.name]:
            return self.link.transfer(value, tr)

    def measure_into(self, comm, pairs, **kw) -> None:
        """Uncontended per-pair measurement (the pseudo-kernel predicts
        the wire time; the bus queueing is the scheduler/executor's job)."""
        self.link.measure_into(comm, pairs, **kw)
