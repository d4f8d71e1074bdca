"""repro_torch.api — the lazy op-graph front-end, the port of ``repro.api``:
one user-facing surface over variant selection (runtime dispatch),
predictor-driven device placement (core.scheduler), and portable program
export::

    from repro_torch.api import ops, trace
    with trace() as tb:
        y = ops.matvec(ops.matmul(a, b), x)   # records a DAG, executes nothing
    compiled = tb.compile()                   # schedule from predicted times
    out = compiled()                          # predicted-best variant per node

The same ``ops.matmul(a, b)`` call *outside* a trace executes eagerly
through the runtime dispatcher.  ``Program`` round-trips to JSON in the
JAX package's schema.  The compiler (``compile_``) loads on first use, so
importing ``repro_torch.workloads`` (which traces through ``ops``) never
imports it.
"""
from repro_torch.api import ops
from repro_torch.api.export import (SCHEMA_VERSION, gantt_csv, load_program,
                                    program_from_json, program_to_json,
                                    save_gantt_csv, save_program)
from repro_torch.api.ops import (KERNEL_OPS, LazyRef, TraceBuilder,
                                 current_dispatcher, trace, tracing,
                                 use_dispatcher)
from repro_torch.api.program import InputSpec, Node, Program

__all__ = ["ops", "SCHEMA_VERSION", "gantt_csv", "load_program",
           "program_from_json", "program_to_json", "save_gantt_csv",
           "save_program", "KERNEL_OPS", "LazyRef", "TraceBuilder",
           "current_dispatcher", "trace", "tracing", "use_dispatcher",
           "InputSpec", "Node", "Program", "CompiledProgram",
           "compile_program"]


def __getattr__(name):
    if name in ("CompiledProgram", "compile_program"):
        from repro_torch.api import compile_
        return getattr(compile_, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
