"""The ``results/bench.json`` schema: version gate + structural validator,
the port of ``repro.bench.schema``.  The document format is the JAX
package's, so a ``bench.json`` either package writes validates and loads
in the other.

Hand-rolled (no jsonschema dependency) but strict: every consumer —
``bench compare``, CI, the tier-1 round-trip test — goes through
``validate_bench``, so a malformed or stale document fails loudly with a
path to the offending key instead of producing silently-wrong diffs.

Document shape (schema 1)::

    {
      "schema": 1,
      "quick": bool,
      "generated_unix": float,
      "host_fingerprint": {...},          # runtime.Fingerprint.to_json()
      "configs": {                        # one entry per device config
        "<cfg>": {"kind": "real"|"sim", "executor": str,
                   "devices": [str, ...],
                   "device_mape": {dev: {kernel: {"mape_pct": float,
                                                   "n_rows": int}}}}},
      "workloads": {
        "<name>": {"size": str, "kernels": [str, ...], "n_nodes": int,
          "configs": {"<cfg>": {
            "n_transfers": int,
            "wall_s": {"best"|"default"|"worst": float},
            "predicted_makespan_s": {"best"|"default"|"worst": float},
            "speedup_vs_default": float,   # default wall / best wall
            "speedup_vs_worst": float,     # worst wall / best wall
            "overhead": {"dispatch_frac": float,   # decision / wall
                          "executor_frac": float},  # non-modelled wall share
            "mape": {kernel: float}}}}},   # %, over the tuned grid
      "geomean": {"<cfg>": {"speedup_vs_default": float,
                             "speedup_vs_worst": float}},
      "external": {...}                   # folded sibling artifacts, or {}
    }

Schema 2 adds one *optional* top-level section — documents without it
(and whole schema-1 documents) stay loadable, so ``bench compare`` works
across the version bump::

      "adaptive": {                       # mis-seeded adaptive-vs-static
        "size": str,
        "devices": {dev: {"claimed_flops_per_s": float,
                           "true_flops_per_s": float}},
        "workloads": {name: {
          "static_wall_s"|"adaptive_wall_s"|"replan_wall_s": float,
          "speedup_vs_static": float,     # static wall / adaptive wall
          "replan_speedup_vs_static": float,
          "n_steals": int, "refits": int, "bit_exact": bool}},
        "geomean_speedup_vs_static": float,
        "trace_path": str}                # Chrome trace of the adaptive run

Schema 3 folds run-scoped telemetry (``repro_torch.obs``) in.  Both
additions are again *optional*, so schema-1/2 documents — and schema-3
documents produced with telemetry disabled — stay loadable::

      # per workload x config, next to "overhead"/"mape":
      "telemetry": {
        "decisions": {counter: int},      # dispatch.*/gate.*/exec.steals/...
        "overhead": {"dispatch_frac": float},   # from recorded histograms
        "drift": {kernel: {"live_mape_pct": float, "fit_band_pct": float,
                            "n": int, "flagged": bool}},
        "drift_flags": [str, ...]}        # kernels whose live MAPE left
                                          #   the fit-time error band

      # inside "adaptive":
      "telemetry_path": str               # saved obs.Telemetry JSON of the
                                          #   traced adaptive run

Schema 4 adds the *optional* ``serve`` section — the serving-engine
arrival-trace scenario (the JAX package's ``python -m repro.bench serve``;
the port validates and reads the section)::

      "serve": {
        "size": str,                      # "quick" | "full"
        "model": str, "max_slots": int, "max_seq": int,
        "cost_model": {"prefill_mape_pct": float,
                        "decode_mape_pct": float},
        "traces": {                       # one per arrival process
          "<trace>": {"arrival": str, "n_requests": int,
            "policies": {"fifo"|"sjf": {
              "ttft_s": {"p50"|"p99"|"mean": float, "count": int},
              "token_latency_s": {...},   # same stat shape
              "goodput_tok_s": float,
              "completed": int, "rejected": int,
              "engine_steps": int, "occupancy": float,
              "admission_fallback": bool}}}},
        "sjf_beats_fifo_bursty": bool,    # p99 OR mean TTFT improved
        "telemetry_path": str}            # saved obs.Telemetry JSON

Schema 5 adds the *optional* ``attribution`` block — the compact
``repro_torch.obs.explain`` summary (critical-path makespan attribution) —
in two places::

      # per workload x config, next to "telemetry":
      "attribution": {
        "makespan_s": float,
        "residual_frac": float,           # |makespan - sum(buckets)| share
        "buckets": {bucket: seconds},     # compute.<kernel>/transfer.<lane>
                                          #   /queue.<lane>/overhead.*
        "top_bottleneck": str,            # largest bucket
        "critical_path_len": int, "n_steals": int,
        "top_misprediction":              # worst-ranked (kernel, bucket)
          null | {"kernel": str, "shape_bucket": str, "cost_s": float,
                   "ape_pct": float, "fit_band_pct": float|null,
                   "exceeds_fit_band": bool, "lanes": [str, ...]}}

      # inside "adaptive": the same block for the traced adaptive run
      "attribution": {...}
"""
from __future__ import annotations

import json

BENCH_SCHEMA_VERSION = 5
ACCEPTED_SCHEMAS = (1, 2, 3, 4, 5)
MODES = ("best", "default", "worst")


def _require(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"bench.json invalid at {path}: {msg}")


def _num(doc, path, key, lo=None):
    _require(key in doc, path, f"missing {key!r}")
    v = doc[key]
    _require(isinstance(v, (int, float)) and not isinstance(v, bool),
             f"{path}.{key}", f"expected a number, got {type(v).__name__}")
    if lo is not None:
        _require(v >= lo, f"{path}.{key}", f"expected >= {lo}, got {v}")
    return float(v)


def _validate_attribution(att, path: str) -> None:
    _require(isinstance(att, dict), path, "expected an object")
    _num(att, path, "makespan_s", lo=0)
    _num(att, path, "residual_frac", lo=0)
    buckets = att.get("buckets")
    _require(isinstance(buckets, dict) and buckets, f"{path}.buckets",
             "expected a non-empty object")
    for b, v in buckets.items():
        _num(buckets, f"{path}.buckets", b, lo=0)
    _require(att.get("top_bottleneck") in buckets,
             f"{path}.top_bottleneck", "expected a key of .buckets")
    _num(att, path, "critical_path_len", lo=1)
    _num(att, path, "n_steals", lo=0)
    top = att.get("top_misprediction")
    if top is not None:
        tp = f"{path}.top_misprediction"
        _require(isinstance(top, dict), tp, "expected an object or null")
        _require(isinstance(top.get("kernel"), str), f"{tp}.kernel",
                 "expected a string")
        _num(top, tp, "cost_s")
        _num(top, tp, "ape_pct", lo=0)
        _require(isinstance(top.get("exceeds_fit_band"), bool),
                 f"{tp}.exceeds_fit_band", "expected bool")
        _require(isinstance(top.get("lanes"), list), f"{tp}.lanes",
                 "expected a list")


def validate_bench(doc: dict) -> dict:
    """Raise ValueError on a structurally invalid document; return it."""
    _require(isinstance(doc, dict), "$", "expected an object")
    _require(doc.get("schema") in ACCEPTED_SCHEMAS, "$.schema",
             f"unknown bench schema {doc.get('schema')!r} "
             f"(this build reads {ACCEPTED_SCHEMAS})")
    _require(isinstance(doc.get("quick"), bool), "$.quick", "expected bool")
    _num(doc, "$", "generated_unix", lo=0)
    _require(isinstance(doc.get("host_fingerprint"), dict),
             "$.host_fingerprint", "expected an object")

    configs = doc.get("configs")
    _require(isinstance(configs, dict) and configs, "$.configs",
             "expected a non-empty object")
    for cfg, c in configs.items():
        path = f"$.configs.{cfg}"
        _require(isinstance(c, dict), path, "expected an object")
        _require(c.get("kind") in ("real", "sim"), f"{path}.kind",
                 "expected 'real' or 'sim'")
        _require(isinstance(c.get("executor"), str), f"{path}.executor",
                 "expected a string")
        _require(isinstance(c.get("devices"), list) and c["devices"],
                 f"{path}.devices", "expected a non-empty list")
        _require(isinstance(c.get("device_mape"), dict),
                 f"{path}.device_mape", "expected an object")
        for dev, kernels in c["device_mape"].items():
            for kernel, m in kernels.items():
                kp = f"{path}.device_mape.{dev}.{kernel}"
                _num(m, kp, "mape_pct", lo=0)
                _num(m, kp, "n_rows", lo=1)

    workloads = doc.get("workloads")
    _require(isinstance(workloads, dict) and workloads, "$.workloads",
             "expected a non-empty object")
    for name, w in workloads.items():
        path = f"$.workloads.{name}"
        _require(isinstance(w.get("size"), str), f"{path}.size",
                 "expected a string")
        _require(isinstance(w.get("kernels"), list) and w["kernels"],
                 f"{path}.kernels", "expected a non-empty list")
        _num(w, path, "n_nodes", lo=1)
        _require(isinstance(w.get("configs"), dict) and w["configs"],
                 f"{path}.configs", "expected a non-empty object")
        for cfg, r in w["configs"].items():
            cp = f"{path}.configs.{cfg}"
            _require(cfg in configs, cp, "config not declared in $.configs")
            _num(r, cp, "n_transfers", lo=0)
            for section in ("wall_s", "predicted_makespan_s"):
                _require(isinstance(r.get(section), dict), f"{cp}.{section}",
                         "expected an object")
                for mode in MODES:
                    _num(r[section], f"{cp}.{section}", mode, lo=0)
            _num(r, cp, "speedup_vs_default", lo=0)
            _num(r, cp, "speedup_vs_worst", lo=0)
            _require(isinstance(r.get("overhead"), dict), f"{cp}.overhead",
                     "expected an object")
            _num(r["overhead"], f"{cp}.overhead", "dispatch_frac", lo=0)
            _num(r["overhead"], f"{cp}.overhead", "executor_frac", lo=0)
            _require(isinstance(r.get("mape"), dict) and r["mape"],
                     f"{cp}.mape", "expected a non-empty object")
            for kernel, v in r["mape"].items():
                _require(isinstance(v, (int, float)),
                         f"{cp}.mape.{kernel}", "expected a number")
            tel = r.get("telemetry")
            if tel is not None:             # optional, schema-3 only
                tp = f"{cp}.telemetry"
                _require(doc["schema"] >= 3, tp,
                         "telemetry section requires schema >= 3")
                _require(isinstance(tel, dict), tp, "expected an object")
                _require(isinstance(tel.get("decisions"), dict),
                         f"{tp}.decisions", "expected an object")
                for k, v in tel["decisions"].items():
                    _num(tel["decisions"], f"{tp}.decisions", k, lo=0)
                _require(isinstance(tel.get("overhead"), dict),
                         f"{tp}.overhead", "expected an object")
                _require(isinstance(tel.get("drift"), dict),
                         f"{tp}.drift", "expected an object")
                _require(isinstance(tel.get("drift_flags"), list),
                         f"{tp}.drift_flags", "expected a list")
                for k in tel["drift_flags"]:
                    _require(isinstance(k, str), f"{tp}.drift_flags",
                             "expected kernel-name strings")
            att = r.get("attribution")
            if att is not None:             # optional, schema-5 only
                _require(doc["schema"] >= 5, f"{cp}.attribution",
                         "attribution section requires schema >= 5")
                _validate_attribution(att, f"{cp}.attribution")

    geo = doc.get("geomean")
    _require(isinstance(geo, dict) and geo, "$.geomean",
             "expected a non-empty object")
    for cfg, g in geo.items():
        _require(cfg in configs, f"$.geomean.{cfg}",
                 "config not declared in $.configs")
        _num(g, f"$.geomean.{cfg}", "speedup_vs_default", lo=0)
        _num(g, f"$.geomean.{cfg}", "speedup_vs_worst", lo=0)

    _require(isinstance(doc.get("external"), dict), "$.external",
             "expected an object")

    ad = doc.get("adaptive")
    if ad is not None:                  # optional, schema-2 only
        _require(doc["schema"] >= 2, "$.adaptive",
                 "adaptive section requires schema >= 2")
        _require(isinstance(ad, dict), "$.adaptive", "expected an object")
        _require(isinstance(ad.get("devices"), dict) and ad["devices"],
                 "$.adaptive.devices", "expected a non-empty object")
        for dev, d in ad["devices"].items():
            dp = f"$.adaptive.devices.{dev}"
            _num(d, dp, "claimed_flops_per_s", lo=0)
            _num(d, dp, "true_flops_per_s", lo=0)
        _require(isinstance(ad.get("workloads"), dict) and ad["workloads"],
                 "$.adaptive.workloads", "expected a non-empty object")
        for name, w in ad["workloads"].items():
            wp = f"$.adaptive.workloads.{name}"
            for key in ("static_wall_s", "adaptive_wall_s", "replan_wall_s",
                        "speedup_vs_static", "replan_speedup_vs_static"):
                _num(w, wp, key, lo=0)
            _num(w, wp, "n_steals", lo=0)
            _num(w, wp, "refits", lo=0)
            _require(isinstance(w.get("bit_exact"), bool),
                     f"{wp}.bit_exact", "expected bool")
        _num(ad, "$.adaptive", "geomean_speedup_vs_static", lo=0)
        if ad.get("telemetry_path") is not None:    # optional, schema-3
            _require(doc["schema"] >= 3, "$.adaptive.telemetry_path",
                     "telemetry_path requires schema >= 3")
            _require(isinstance(ad["telemetry_path"], str),
                     "$.adaptive.telemetry_path", "expected a string")
        if ad.get("attribution") is not None:       # optional, schema-5
            _require(doc["schema"] >= 5, "$.adaptive.attribution",
                     "attribution section requires schema >= 5")
            _validate_attribution(ad["attribution"],
                                  "$.adaptive.attribution")

    sv = doc.get("serve")
    if sv is not None:                  # optional, schema-4 only
        _require(doc["schema"] >= 4, "$.serve",
                 "serve section requires schema >= 4")
        _require(isinstance(sv, dict), "$.serve", "expected an object")
        _require(isinstance(sv.get("size"), str), "$.serve.size",
                 "expected a string")
        _require(isinstance(sv.get("model"), str), "$.serve.model",
                 "expected a string")
        _num(sv, "$.serve", "max_slots", lo=1)
        _num(sv, "$.serve", "max_seq", lo=1)
        cm = sv.get("cost_model")
        _require(isinstance(cm, dict), "$.serve.cost_model",
                 "expected an object")
        _num(cm, "$.serve.cost_model", "prefill_mape_pct", lo=0)
        _num(cm, "$.serve.cost_model", "decode_mape_pct", lo=0)
        traces = sv.get("traces")
        _require(isinstance(traces, dict) and traces, "$.serve.traces",
                 "expected a non-empty object")
        for tname, t in traces.items():
            tp = f"$.serve.traces.{tname}"
            _require(isinstance(t.get("arrival"), str), f"{tp}.arrival",
                     "expected a string")
            _num(t, tp, "n_requests", lo=1)
            pols = t.get("policies")
            _require(isinstance(pols, dict) and pols, f"{tp}.policies",
                     "expected a non-empty object")
            for pol, r in pols.items():
                pp = f"{tp}.policies.{pol}"
                _require(pol in ("fifo", "sjf"), pp,
                         "expected policy 'fifo' or 'sjf'")
                for hist in ("ttft_s", "token_latency_s"):
                    _require(isinstance(r.get(hist), dict), f"{pp}.{hist}",
                             "expected an object")
                    for stat in ("p50", "p99", "mean"):
                        _num(r[hist], f"{pp}.{hist}", stat, lo=0)
                    _num(r[hist], f"{pp}.{hist}", "count", lo=0)
                _num(r, pp, "goodput_tok_s", lo=0)
                _num(r, pp, "completed", lo=0)
                _num(r, pp, "rejected", lo=0)
                _num(r, pp, "engine_steps", lo=0)
                _num(r, pp, "occupancy", lo=0)
                _require(isinstance(r.get("admission_fallback"), bool),
                         f"{pp}.admission_fallback", "expected bool")
        _require(isinstance(sv.get("sjf_beats_fifo_bursty"), bool),
                 "$.serve.sjf_beats_fifo_bursty", "expected bool")
        if sv.get("telemetry_path") is not None:
            _require(isinstance(sv["telemetry_path"], str),
                     "$.serve.telemetry_path", "expected a string")
    return doc


def load_bench(path: str) -> dict:
    with open(path) as f:
        return validate_bench(json.load(f))
