"""repro_torch.runtime — predictor-driven kernel dispatch with a persistent
tuning cache and online refinement, the port of ``repro.runtime``.

A variant registry (``registry``), a hardware fingerprint keying the model
zoo (``fingerprint``), a persistent per-(kernel, hardware) tuning cache
(``cache``), predict-best dispatch with measured cold-start (``dispatch``),
online refit from actual wall times (``online``), and deterministic cache
seeding (``seeding``).
"""
from repro_torch.runtime.cache import (CacheEntry, TuningCache, bucket_dim,
                                       shape_bucket, shape_class,
                                       TRAIN_BUDGET_ROWS)
from repro_torch.runtime.dispatch import (DispatchPolicy, Dispatcher,
                                          Selection, default_dispatcher,
                                          dispatch)
from repro_torch.runtime.fingerprint import Fingerprint, current_fingerprint
from repro_torch.runtime.online import OnlineConfig, OnlineRefiner
from repro_torch.runtime.registry import (ATTENTION_SCHEDULE_GRID,
                                          ATTENTION_SCHEDULES, KernelRegistry,
                                          RegisteredKernel, Variant,
                                          attention_flops, default_registry)
from repro_torch.runtime.seeding import (measure_from_programs,
                                         seed_from_programs, variant_skews)

__all__ = ["CacheEntry", "TuningCache", "bucket_dim", "shape_bucket",
           "shape_class", "TRAIN_BUDGET_ROWS", "DispatchPolicy", "Dispatcher",
           "Selection", "default_dispatcher", "dispatch", "Fingerprint",
           "current_fingerprint", "OnlineConfig", "OnlineRefiner",
           "ATTENTION_SCHEDULE_GRID", "ATTENTION_SCHEDULES", "KernelRegistry",
           "RegisteredKernel", "Variant", "attention_flops",
           "default_registry", "measure_from_programs", "seed_from_programs",
           "variant_skews"]
