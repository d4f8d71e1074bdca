"""repro_torch.obs — run-scoped telemetry across dispatch, execution and
bench, the port of ``repro.obs``.

One ``Telemetry`` per run collects counters/gauges/histograms, span and
instant events on the executor's clock, and per-kernel prediction-drift
status (live MAPE vs the fit-time band).  Every decision point in the
stack reports into it when one is attached — dispatch modes and gate
outcomes (``runtime.dispatch``), refits (``runtime.online``), steals,
queue depths and transfer waits (``exec.executor``), comm-model pricing
(``exec.comm``), and predicted-vs-realized makespans (``api.compile_``).
``exec.ExecutionTrace.to_chrome(telemetry=...)`` merges gauge series as
counter tracks and telemetry instants into the task timeline;
``python -m repro_torch.obs report`` summarizes a saved telemetry file and
``--check`` gates on drift.

The memory ledger (``obs.memory``) accounts per-device live/peak bytes
against the compile-time predicted peak; ``obs.explain`` reconstructs the
dependency DAG from an execution trace, computes the realized critical
path and per-task slack, partitions the makespan into compute/transfer/
queue/overhead buckets, diffs against the frozen EFT schedule's predicted
path, and ranks (kernel, shape-bucket) pairs by the makespan-seconds
their prediction error cost.  Model cards (``obs.cards``) fold tunecache
coverage with live accuracy per predictor, SLOs (``obs.slo``) price
latency objectives with burn rates, and ``obs.dashboard`` renders bench
documents, cards, drift and memory series and SLO status as one
self-contained static HTML file.

Documents (telemetry files, Chrome traces, explain documents) have the
JAX package's format, so either package reads what the other wrote.
"""
from repro_torch.obs.cards import build_cards, format_cards
from repro_torch.obs.dashboard import render_dashboard, write_dashboard
from repro_torch.obs.drift import DriftConfig, DriftMonitor
from repro_torch.obs.explain import (EXPLAIN_SCHEMA_VERSION, analyze_chrome,
                                     analyze_trace, format_explain,
                                     format_lanes, format_waterfalls,
                                     lane_utilization, summarize_attribution,
                                     waterfalls_from_telemetry)
from repro_torch.obs.memory import (MemoryCapacityError, MemoryLedger,
                                    MemoryPlan, check_capacity, fold_memory,
                                    memory_plan, predicted_peak_bytes)
from repro_torch.obs.report import format_summary
from repro_torch.obs.slo import (DEFAULT_SERVE_SLOS, SLO, burned,
                                 evaluate_slos, format_slos, load_slos)
from repro_torch.obs.telemetry import (NULL_TELEMETRY, OBS_SCHEMA_VERSION,
                                       NullTelemetry, Telemetry, as_telemetry,
                                       summarize_doc)
