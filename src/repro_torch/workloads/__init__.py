"""repro_torch.workloads — named, parameterized multi-kernel programs, the
port of ``repro.workloads``.

Each workload

- builds a ``repro_torch.api`` ``Program`` by *tracing* the public ops
  surface (``build(size, device=...)``), with the concrete input tensors
  captured as default bindings so the compiled program runs as-is,
- carries a reference implementation computing the same outputs from the
  same tensors with the kernels' plain versions, and
- exposes ``small`` / ``medium`` / ``large`` size presets.

Importing this package imports ``repro_torch.api.ops`` but not the
compiler, so it has no import cycle with ``repro_torch.api``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.workloads.library import WORKLOAD_BUILDERS

SIZES = ("small", "medium", "large")


@dataclasses.dataclass(frozen=True)
class BuiltWorkload:
    """One materialized workload instance: the traced program, its captured
    input bindings, and the matching reference."""
    name: str
    size: str
    params: dict
    program: object                  # repro_torch.api Program
    bindings: dict                   # input name -> tensor
    reference: Callable[[], tuple]   # () -> outputs in program.outputs order

    @property
    def n_nodes(self) -> int:
        return len(self.program.nodes)

    @property
    def kernels_used(self) -> frozenset:
        return frozenset(n.kernel for n in self.program.nodes)


@dataclasses.dataclass(frozen=True)
class Workload:
    """A named, parameterized program family.

    ``factory(params, rng, device)`` returns ``(make, reference)``:
    ``make()`` is called under an active trace and returns the output
    ``LazyRef``s in order; ``reference()`` computes the same outputs with
    the kernels' plain versions over the identical tensors.
    """
    name: str
    kernels: tuple                   # kernel names the program uses
    presets: dict                    # size -> params dict
    factory: Callable

    def build(self, size: str = "small", registry=None, seed: int = 0,
              device="cuda") -> BuiltWorkload:
        """Trace the ``size`` preset with inputs drawn from ``seed`` on
        ``device`` (the card unless ``device="cpu"``)."""
        import numpy as np

        from repro_torch.api.ops import trace
        from repro_torch.kernels import resolve_device

        if size not in self.presets:
            raise KeyError(f"workload {self.name!r} has no {size!r} preset "
                           f"(have {sorted(self.presets)})")
        params = dict(self.presets[size])
        make, reference = self.factory(params, np.random.RandomState(seed),
                                       resolve_device(device))
        with trace(registry=registry) as tb:
            outs = make()
            tb.mark_output(*outs)
        return BuiltWorkload(self.name, size, params, tb.program,
                             dict(tb.bindings), reference)


WORKLOADS: dict[str, Workload] = {
    name: Workload(name=name, kernels=tuple(kernels),
                   presets={s: dict(p) for s, p in presets.items()},
                   factory=factory)
    for name, (kernels, presets, factory) in WORKLOAD_BUILDERS.items()
}


def workload_names() -> list[str]:
    return sorted(WORKLOADS)


def get_workload(name: str) -> Workload:
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; available: "
                       f"{workload_names()}")
    return WORKLOADS[name]


def suite_registry(names: Optional[list] = None):
    """A kernel registry covering exactly the kernels the named workloads
    (default: all) use."""
    from repro_torch.runtime import default_registry

    kernels: set = set()
    for name in (names or workload_names()):
        kernels |= set(get_workload(name).kernels)
    return default_registry(include=sorted(kernels))
