"""repro_torch.bench — the standing end-to-end benchmark surface, the port
of ``repro.bench``.

``python -m repro_torch.bench run [--quick]`` measures every workload in
``repro_torch.workloads`` across the standing device configs (``cuda``,
the card, and ``simdev2``; ``cpu`` when asked for) and writes a
schema-versioned ``results/bench.json`` in the JAX package's format
(speedups of predicted-best dispatch over default/worst variants,
per-kernel prediction MAPE over the tuned grid, dispatch/executor overhead
fractions, folded sibling artifacts).  ``python -m repro_torch.bench
compare A B`` diffs two documents and exits nonzero on regression;
``history`` lists saved documents.
"""
from repro_torch.bench.compare_ import compare_docs, format_compare
from repro_torch.bench.harness import fold_external, run_bench, summarize
from repro_torch.bench.pinned import MODES, PinnedDispatcher
from repro_torch.bench.schema import (BENCH_SCHEMA_VERSION, load_bench,
                                      validate_bench)
