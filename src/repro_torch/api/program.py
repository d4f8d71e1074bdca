"""The typed lazy op-graph IR behind ``repro_torch.api``.

A ``Program`` is a validated kernel DAG: ``InputSpec`` placeholders (shape
and dtype only — no data, so a program is portable across hosts), ``Node``s
in topological order, and named outputs.  Every node carries the kernel
name, the predictor params derived from its input avals at trace time (the
NN+C feature source), the static keyword operands, and its inferred output
aval.  Data dependencies are value names — program inputs or earlier nodes
— in positional order, inferred from value flow by the tracer in
``repro_torch.api.ops``.

Dtypes are stored as the JAX package's strings (``"float32"``,
``"bfloat16"``, ...), so a program traced in either package serialises to
the same JSON and loads in the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.scheduler import KernelTask
from repro_torch.kernels import Aval


def norm_dtype(dtype) -> str:
    """Canonical string form ('float32', 'bfloat16', ...) of a torch dtype,
    a numpy dtype or a dtype name.  bfloat16 needs no numpy extension."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return str(np.dtype(dtype))
    except TypeError:
        named = getattr(torch, str(dtype), None)
        if isinstance(named, torch.dtype):
            return str(named).removeprefix("torch.")
        raise


@dataclasses.dataclass(frozen=True)
class InputSpec:
    name: str
    shape: tuple
    dtype: str

    @property
    def aval(self) -> Aval:
        return Aval(tuple(self.shape), self.dtype)


@dataclasses.dataclass(frozen=True)
class Node:
    """One lazy kernel application."""
    name: str
    kernel: str
    deps: tuple            # value names (inputs / earlier nodes), positional
    params: dict           # predictor params derived from input avals
    kwargs: dict           # static keyword operands forwarded at execution
    out_shape: tuple
    out_dtype: str

    @property
    def aval(self) -> Aval:
        return Aval(tuple(self.out_shape), self.out_dtype)


@dataclasses.dataclass(frozen=True)
class Program:
    inputs: tuple
    nodes: tuple
    outputs: tuple

    def __post_init__(self):
        self.validate()

    # -- validation ----------------------------------------------------------
    def validate(self) -> "Program":
        """Structural checks; raises ValueError on a malformed DAG."""
        names: set = set()
        for spec in self.inputs:
            if spec.name in names:
                raise ValueError(f"duplicate value name {spec.name!r}")
            names.add(spec.name)
        for node in self.nodes:
            if node.name in names:
                raise ValueError(f"duplicate value name {node.name!r}")
            for d in node.deps:
                if d not in names:
                    raise ValueError(
                        f"node {node.name!r} depends on undefined value "
                        f"{d!r} (deps must precede, so node order is "
                        "topological)")
            names.add(node.name)
        if not self.outputs:
            raise ValueError("program has no outputs")
        for o in self.outputs:
            if o not in names:
                raise ValueError(f"unknown output {o!r}")
        return self

    def check(self, registry) -> "Program":
        """Re-derive every node's params and output aval through the
        registry's abstract hooks; a mismatch means the IR was hand-edited
        or built against a different registry."""
        avals = {s.name: s.aval for s in self.inputs}
        for node in self.nodes:
            args = [avals[d] for d in node.deps]
            params = registry.abstract_params(node.kernel, *args,
                                              **node.kwargs)
            if dict(params) != dict(node.params):
                raise ValueError(
                    f"node {node.name!r}: stored params {node.params} != "
                    f"derived {params}")
            out = registry.out_aval(node.kernel, *args, **node.kwargs)
            if tuple(out.shape) != tuple(node.out_shape) or \
                    norm_dtype(out.dtype) != node.out_dtype:
                raise ValueError(
                    f"node {node.name!r}: stored aval "
                    f"{node.out_shape}/{node.out_dtype} != derived "
                    f"{tuple(out.shape)}/{norm_dtype(out.dtype)}")
            avals[node.name] = node.aval
        return self

    # -- introspection -------------------------------------------------------
    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(f"no node named {name!r}")

    def input_names(self) -> list[str]:
        return [s.name for s in self.inputs]

    def aval_of(self, name: str) -> Aval:
        for s in self.inputs:
            if s.name == name:
                return s.aval
        return self.node(name).aval

    # -- lowering ------------------------------------------------------------
    def to_kernel_tasks(self) -> list[KernelTask]:
        """Lower to the ``core.scheduler`` form: one task per node, deps
        filtered to node names (program inputs are materialised values, not
        schedulable work).  ``out_bytes`` and ``input_deps`` carry payload
        sizes so a comm-aware schedule can price cross-device edges."""
        from repro_torch.exec.buffers import value_nbytes
        node_names = {n.name for n in self.nodes}
        in_bytes = {s.name: float(value_nbytes(s.shape, s.dtype))
                    for s in self.inputs}
        return [KernelTask(n.name, n.kernel, dict(n.params),
                           tuple(d for d in n.deps if d in node_names),
                           out_bytes=float(value_nbytes(n.out_shape,
                                                        n.out_dtype)),
                           input_deps=tuple((d, in_bytes[d]) for d in n.deps
                                            if d in in_bytes))
                for n in self.nodes]

    # -- conveniences (lazy imports avoid package cycles) --------------------
    def compile(self, devices=None, policy=None, bindings=None,
                executor: str = "sequential", comm=None, transfer=None,
                topology=None, steal=None, online=None, telemetry=None):
        """Schedule + specialise this program; see ``repro_torch.api.compile_``."""
        from repro_torch.api.compile_ import compile_program
        return compile_program(self, devices=devices, policy=policy,
                               bindings=bindings, executor=executor,
                               comm=comm, transfer=transfer,
                               topology=topology, steal=steal, online=online,
                               telemetry=telemetry)

    def to_json(self) -> dict:
        from repro_torch.api.export import program_to_json
        return program_to_json(self)

    @staticmethod
    def from_json(doc: dict, registry=None) -> "Program":
        from repro_torch.api.export import program_from_json
        return program_from_json(doc, registry=registry)

    def save(self, path: str) -> None:
        from repro_torch.api.export import save_program
        save_program(self, path)

    @staticmethod
    def load(path: str, registry=None) -> "Program":
        from repro_torch.api.export import load_program
        return load_program(path, registry=registry)
