"""repro_torch.exec — asynchronous multi-device execution with
transfer-aware scheduling and runtime re-dispatch, the port of
``repro.exec``.

The layer that turns a placement plan into concurrent execution: explicit
buffer placement and ``Transfer`` tasks (``buffers``), a per-device-pair
bytes->seconds cost model plus shared-bus ``Topology`` persisted in the
tuning cache, and the real-device copy hook (``comm``), a
dependency-driven per-lane threaded executor with predictor-consulted work
stealing (``executor``), and a begin/end/device trace — including steal
events — exportable as Chrome ``trace_event`` JSON or Gantt CSV
(``trace``).  ``repro_torch.api.CompiledProgram(...,
executor="async"|"adaptive")`` is the front door; the sequential bridge
stays as the bit-exact reference.
"""
from repro_torch.exec.buffers import (BufferTable, Transfer, plan_buffers,
                                      value_nbytes)
from repro_torch.exec.comm import (DEFAULT_SIZES, TRANSFER_FEATURES, Bus,
                                   CommModel, Topology, copy_to_dst,
                                   measure_copies, transfer_kernel)
from repro_torch.exec.executor import (AsyncExecutor, ExecTask, LanePool,
                                       StealPolicy)
from repro_torch.exec.trace import ExecutionTrace, TraceEvent
