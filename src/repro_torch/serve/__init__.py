"""Serving: continuous batching driven by the NN+C cost predictors, the
port of ``repro.serve``.

``ContinuousBatcher`` (serve.continuous) is the slot/queue mechanism;
``ServeEngine`` (serve.engine) is the full predictor-driven engine —
bounded admission queue, SJF-via-tuning-cache ordering, compiled
``repro_torch.api`` execution, and ``repro_torch.obs`` telemetry.
``serve.request`` builds seeded arrival traces; ``serve.policy`` holds the
split prefill/decode cost model; ``serve.decode`` is prefill + decode
generation (``repro_torch.launch.serve``'s loop).
"""
from repro_torch.serve.continuous import ContinuousBatcher, Request
from repro_torch.serve.engine import SERVE_STEP_KERNEL, ServeEngine
from repro_torch.serve.policy import (ADMISSION_POLICIES, ColdCacheError,
                                      DECODE_STEP_KERNEL,
                                      PREFILL_STEP_KERNEL, SplitCostModel,
                                      cost_model_from_cache,
                                      fit_cost_entries, fifo_order,
                                      migrate_whole_request_rows,
                                      record_decode_time,
                                      record_prefill_time,
                                      record_request_time, sjf_order,
                                      split_cost_model_from_cache)
from repro_torch.serve.request import (ServeRequest, bursty_trace,
                                       poisson_trace)

__all__ = [
    "ADMISSION_POLICIES", "ColdCacheError", "ContinuousBatcher",
    "DECODE_STEP_KERNEL", "PREFILL_STEP_KERNEL", "Request",
    "SERVE_STEP_KERNEL", "ServeEngine", "ServeRequest", "SplitCostModel",
    "bursty_trace", "cost_model_from_cache", "fifo_order",
    "fit_cost_entries", "migrate_whole_request_rows", "poisson_trace",
    "record_decode_time", "record_prefill_time", "record_request_time",
    "sjf_order", "split_cost_model_from_cache",
]
