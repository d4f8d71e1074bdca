"""One user-facing function per registered kernel; script API and graph
builder in the same call.

Outside a trace, ``ops.matmul(a, b)`` routes through the predictor-driven
runtime dispatcher and returns a tensor on the operands' device — the
paper's "domain specialist writes matrix-multiply, the compiler picks the
variant".  Inside ``with trace() as tb:`` the identical call executes
nothing: it records a lazy ``Node`` into ``tb``'s ``Program``, deriving
predictor params and the output aval through the registry's
``abstract_params``/``out_aval`` hooks, and returns a ``LazyRef`` whose
``.shape``/``.dtype`` let further ops compose.  Tensors consumed under a
trace become program inputs (deduplicated by identity) and are remembered
as default bindings so ``tb.compile()()`` runs without re-supplying them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.api.program import InputSpec, Node, Program, norm_dtype
from repro_torch.kernels import Aval

_TRACE_STACK: list = []
_EAGER = None          # use_dispatcher override; None -> process default


def current_dispatcher():
    """The dispatcher eager calls route through: the ``use_dispatcher``
    override when active, else the process-wide default."""
    if _EAGER is not None:
        return _EAGER
    from repro_torch.runtime.dispatch import default_dispatcher
    return default_dispatcher()


def pinned_dispatcher():
    """The active ``use_dispatcher`` override, or None."""
    return _EAGER


@contextlib.contextmanager
def use_dispatcher(dispatcher):
    """Pin eager ops (and default compiles) to ``dispatcher`` — tests and
    demos point this at a throwaway cache instead of the process one."""
    global _EAGER
    prev, _EAGER = _EAGER, dispatcher
    try:
        yield dispatcher
    finally:
        _EAGER = prev


@dataclasses.dataclass(frozen=True, eq=False)
class LazyRef:
    """Symbolic handle to a traced value (program input or node output)."""
    name: str
    shape: tuple
    dtype: str
    builder: "TraceBuilder"

    @property
    def aval(self) -> Aval:
        return Aval(tuple(self.shape), self.dtype)

    def __repr__(self):
        return f"LazyRef({self.name}: {self.dtype}{list(self.shape)})"


class TraceBuilder:
    """Accumulates ops calls into a ``Program``."""

    def __init__(self, registry=None):
        self._registry = registry
        self.inputs: list = []
        self.nodes: list = []
        self.bindings: dict = {}       # input name -> captured tensor
        self._by_id: dict = {}         # id(tensor) -> LazyRef (dedup)
        self._counts: dict = {}
        self._outputs: list = []       # mark_output overrides the leaf rule

    @property
    def registry(self):
        if self._registry is None:
            self._registry = current_dispatcher().registry
        return self._registry

    def _value(self, x) -> LazyRef:
        if isinstance(x, LazyRef):
            if x.builder is not self:
                raise ValueError(
                    f"{x!r} belongs to a different trace() context")
            return x
        ref = self._by_id.get(id(x))
        if ref is not None:
            return ref
        arr = x if hasattr(x, "shape") and hasattr(x, "dtype") \
            else np.asarray(x)
        name = f"in{len(self.inputs)}"
        spec = InputSpec(name, tuple(arr.shape), norm_dtype(arr.dtype))
        self.inputs.append(spec)
        ref = LazyRef(name, spec.shape, spec.dtype, self)
        self._by_id[id(x)] = ref
        self.bindings[name] = x
        return ref

    def add(self, kernel: str, args: tuple, kwargs: dict) -> LazyRef:
        refs = [self._value(a) for a in args]
        avals = [r.aval for r in refs]
        params = self.registry.abstract_params(kernel, *avals, **kwargs)
        out = self.registry.out_aval(kernel, *avals, **kwargs)
        i = self._counts.get(kernel, 0)
        self._counts[kernel] = i + 1
        node = Node(name=f"{kernel}_{i}", kernel=kernel,
                    deps=tuple(r.name for r in refs), params=dict(params),
                    kwargs=dict(kwargs), out_shape=tuple(out.shape),
                    out_dtype=norm_dtype(out.dtype))
        self.nodes.append(node)
        return LazyRef(node.name, node.out_shape, node.out_dtype, self)

    def mark_output(self, *refs: LazyRef) -> None:
        """Declare the program's outputs explicitly (in call order, deduped).
        Without this, outputs default to the unconsumed leaves.  Refs must
        be node outputs recorded by *this* trace."""
        node_names = {n.name for n in self.nodes}
        for r in refs:
            if not isinstance(r, LazyRef) or r.builder is not self:
                raise ValueError(f"{r!r} is not a value of this trace()")
            if r.name not in node_names:
                raise ValueError(
                    f"{r.name!r} is a program input, not a node output — "
                    "inputs pass through unchanged and cannot be outputs")
            if r.name not in self._outputs:
                self._outputs.append(r.name)

    @property
    def program(self) -> Program:
        """The recorded DAG; outputs are the ``mark_output`` declarations
        when any were made, else the unconsumed leaves."""
        if self._outputs:
            outs = tuple(self._outputs)
        else:
            consumed = {d for n in self.nodes for d in n.deps}
            outs = tuple(n.name for n in self.nodes if n.name not in consumed)
        return Program(tuple(self.inputs), tuple(self.nodes), outs)

    def compile(self, devices=None, policy=None, executor: str = "sequential",
                comm=None, transfer=None, topology=None, steal=None,
                online=None):
        """Compile the recorded program with the captured tensors pre-bound,
        so the returned ``CompiledProgram`` can be called with no args."""
        return self.program.compile(devices=devices, policy=policy,
                                    bindings=dict(self.bindings),
                                    executor=executor, comm=comm,
                                    transfer=transfer, topology=topology,
                                    steal=steal, online=online)


@contextlib.contextmanager
def trace(registry: Optional[object] = None):
    """Record ops calls instead of executing them::

        with trace() as tb:
            y = ops.matvec(ops.matmul(a, b), x)
        compiled = tb.compile()        # or export tb.program to JSON
        out = compiled()

    ``registry`` defaults to the active dispatcher's (so traced feature
    layouts always match what dispatch will predict with).
    """
    tb = TraceBuilder(registry)
    _TRACE_STACK.append(tb)
    try:
        yield tb
    finally:
        _TRACE_STACK.pop()


def tracing() -> Optional[TraceBuilder]:
    return _TRACE_STACK[-1] if _TRACE_STACK else None


def _apply(kernel: str, *args, **kwargs):
    tb = tracing()
    if tb is not None:
        return tb.add(kernel, args, kwargs)
    return current_dispatcher().dispatch(kernel, *args, **kwargs)


# -- the per-kernel entry points ---------------------------------------------

def matmul(a, b):
    """C[m,n] = A[m,k] @ B[k,n] — variant (library / hand-kernel tile)
    chosen by the predictor."""
    return _apply("matmul", a, b)


def matvec(a, x):
    """y[m] = A[m,k] @ x[k]."""
    return _apply("matvec", a, x)


def conv2d(a, w):
    """Valid 2-D convolution of A[m,n] with W[r,r]."""
    return _apply("conv2d", a, w)


def maxpool(a, *, r: int, s: int):
    """r x r max pooling with stride s over A[m,n]."""
    return _apply("maxpool", a, r=r, s=s)


def blur(a):
    """3x3 box blur of A[m,n] (valid region) — host schedule chosen by the
    predictor."""
    return _apply("blur", a)


def attention(q, k, v):
    """Causal attention over [B, S, H, D] — full vs chunked (q_chunk,
    k_chunk) schedule chosen by the predictor."""
    return _apply("flash_attention", q, k, v)


flash_attention = attention

# kernel name -> front-end function (the port's registry surface)
KERNEL_OPS = {"matmul": matmul, "matvec": matvec, "conv2d": conv2d,
              "maxpool": maxpool, "blur": blur, "flash_attention": attention}
