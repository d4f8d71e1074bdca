"""``Program.compile``: DAG -> heterogeneous schedule -> executable.

``compile_program`` fans the program's kernel tasks through the
``core.scheduler`` earliest-finish-time scheduler, with absolute times
coming from ``predictor_from_runtime`` over per-device runtime dispatchers
(each carrying its own fingerprinted tuning cache).  The result is a
``CompiledProgram`` holding the schedule and its frozen execution order.

This slice has the ``sequential`` executor only: every node in frozen
start-time order on the calling thread, each through its assigned device's
dispatcher.  The asynchronous and adaptive executors, and with them
transfer pricing (``comm``, ``transfer``, ``topology``), work stealing
(``steal``), execution feedback (``online``) and ``telemetry``, come with
the port's exec slice; asking for any of them raises
``NotImplementedError``.

Input shape specs are *bucketed*: a call whose shapes fall in the same
``runtime.cache.shape_class`` as the compiled specs reuses the schedule
(the graph is re-type-checked through the abstract hooks first); only a
different shape class forces a re-trace/re-compile.  A cold cache raises
(``predictor_from_runtime``'s contract): a schedule built from unfitted
predictions would be silent garbage.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.api.program import Program
from repro_torch.core.scheduler import (Assignment, execution_order, makespan,
                                        predictor_from_runtime, schedule)
from repro_torch.kernels import Aval
from repro_torch.runtime.cache import shape_class

EXECUTORS = ("sequential",)
_LATER = "the port's exec slice (async/adaptive executor, comm, trace)"


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
    if executor in ("async", "adaptive"):
        raise NotImplementedError(
            f"executor={executor!r} comes with {_LATER}")
    if executor not in EXECUTORS:
        raise ValueError(f"executor must be one of {EXECUTORS}, "
                         f"got {executor!r}")


def compile_program(program: Program, devices=None, policy=None,
                    bindings=None, executor: str = "sequential",
                    comm=None, transfer=None, topology=None,
                    steal=None, online=None,
                    telemetry=None) -> "CompiledProgram":
    """Schedule ``program`` over ``devices`` (None: the active dispatcher;
    a Dispatcher; or a {name: Dispatcher} map) from predicted times.
    ``bindings`` are default input tensors.  The remaining keywords belong
    to the exec slice and raise when given."""
    _check_executor(executor)
    later = {"comm": comm, "transfer": transfer, "topology": topology,
             "steal": steal, "online": online, "telemetry": telemetry}
    given = sorted(k for k, v in later.items() if v is not None
                   and v is not False)
    if given:
        raise NotImplementedError(f"{', '.join(given)} come(s) with {_LATER}")
    dispatchers = _resolve_devices(devices, policy)
    for disp in dispatchers.values():
        program.check(disp.registry)
    tasks = program.to_kernel_tasks()
    assignments = schedule(tasks, predictor_from_runtime(dispatchers),
                           list(dispatchers))
    return CompiledProgram(program=program, dispatchers=dispatchers,
                           assignments=assignments,
                           bindings=dict(bindings or {}),
                           order=execution_order(tasks, assignments),
                           executor=executor)


@dataclasses.dataclass
class CompiledProgram:
    program: Program
    dispatchers: dict                 # device name -> runtime Dispatcher
    assignments: dict                 # node name -> Assignment
    bindings: dict                    # input name -> default tensor
    order: list                       # KernelTasks, frozen execution order
                                      # (dependency-checked at compile time)
    executor: str = "sequential"      # default back end for __call__

    @property
    def makespan(self) -> float:
        """Predicted end-to-end seconds of the scheduled DAG."""
        return makespan(self.assignments)

    def device_of(self, node_name: str) -> str:
        return self.assignments[node_name].device

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

    # -- execution -----------------------------------------------------------
    def _run_sequential(self, env) -> None:
        """The reference bridge: frozen start-time order, calling thread."""
        node_by = {n.name: n for n in self.program.nodes}
        for task in self.order:
            node = node_by[task.name]
            dev = self.assignments[task.name].device
            env[task.name] = self.dispatchers[dev].dispatch(
                node.kernel, *(env[d] for d in node.deps), **node.kwargs)

    def __call__(self, *args, _executor: Optional[str] = None, **named):
        """Execute the schedule.  Inputs bind positionally (program input
        order), by name, or fall back to the bindings captured at trace
        time; shapes must fall in the compiled specs' shape classes.
        ``_executor`` overrides the compiled back end for this call (the
        underscore keeps the name out of the input namespace)."""
        _check_executor(_executor or self.executor)
        env = self._bind(args, named)
        self._run_sequential(env)
        outs = tuple(env[o] for o in self.program.outputs)
        return outs[0] if len(outs) == 1 else outs
