"""``bench history``: one-line-per-run ledger of saved bench documents, the
port of ``repro.bench.history`` (it reads either package's documents).

Every ``bench run`` (and the CI baseline) leaves a ``bench.json`` behind;
this renders them side by side — schema version, when and how they ran,
per-config geomean speedups, drift flags (schema 3), and the adaptive
geomean — so a regression hunt starts from a table instead of N ``jq``
invocations.  Deliberately *schema-tolerant*: rows are extracted with
``.get`` fallbacks rather than ``validate_bench``, because the whole
point is reading documents older (v1/v2) than the current writer, and a
half-broken artifact should render as a row with an error, not kill the
listing.
"""
from __future__ import annotations

import glob
import json
import time

DEFAULT_PATTERNS = ("results/bench*.json", "benchmarks/*bench*.json")


def discover(patterns=DEFAULT_PATTERNS) -> list:
    """Expand the path/glob list, deduped, in pattern-then-name order."""
    out, seen = [], set()
    for pat in patterns:
        for p in sorted(glob.glob(pat)) or ():
            if p not in seen:
                seen.add(p)
                out.append(p)
    return out


def load_row(path: str) -> dict:
    """One history row from a bench document, tolerant across schema 1-5.

    Unreadable or non-bench files yield ``{"file", "error"}`` so the
    table can show them without aborting the rest."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return {"file": path, "error": str(e)}
    if not isinstance(doc, dict) or not isinstance(doc.get("workloads"),
                                                   dict):
        if isinstance(doc, dict) and isinstance(doc.get("serve"), dict):
            # standalone bench_serve.json (schema 4, serve section only)
            return {"file": path, "schema": doc.get("schema"),
                    "quick": doc.get("quick"),
                    "generated_unix": doc.get("generated_unix"),
                    "n_workloads": 0, "geomean_vs_default": {},
                    "drift_flags": [], "adaptive_geomean": None,
                    "serve_sjf_wins":
                        doc["serve"].get("sjf_beats_fifo_bursty")}
        return {"file": path, "error": "not a bench document"}
    flags = sorted({
        f"{cfg}:{k}"
        for w in doc["workloads"].values() if isinstance(w, dict)
        for cfg, r in (w.get("configs") or {}).items() if isinstance(r, dict)
        for k in ((r.get("telemetry") or {}).get("drift_flags") or ())})
    ad = doc.get("adaptive") or {}
    sv = doc.get("serve") or {}
    # schema-5 attribution blocks, aggregated: the run's dominant makespan
    # bucket across every workload x config (plus the adaptive run)
    buckets: dict = {}
    atts = [r.get("attribution")
            for w in doc["workloads"].values() if isinstance(w, dict)
            for r in (w.get("configs") or {}).values()
            if isinstance(r, dict)]
    atts.append(ad.get("attribution"))
    for att in atts:
        if isinstance(att, dict):
            for b, v in (att.get("buckets") or {}).items():
                if isinstance(v, (int, float)):
                    buckets[b] = buckets.get(b, 0.0) + float(v)
    top_bottleneck = None
    if buckets:
        top = max(buckets, key=buckets.get)
        top_bottleneck = {"bucket": top,
                          "share": buckets[top] / sum(buckets.values())}
    return {
        "top_bottleneck": top_bottleneck,
        "serve_sjf_wins": sv.get("sjf_beats_fifo_bursty"),
        "file": path,
        "schema": doc.get("schema"),
        "quick": doc.get("quick"),
        "generated_unix": doc.get("generated_unix"),
        "n_workloads": len(doc["workloads"]),
        "geomean_vs_default": {
            cfg: g.get("speedup_vs_default")
            for cfg, g in (doc.get("geomean") or {}).items()
            if isinstance(g, dict)},
        "drift_flags": flags,
        "adaptive_geomean": ad.get("geomean_speedup_vs_static"),
    }


def format_history(rows: list) -> list:
    """The human table (one line per document, newest metadata verbatim)."""
    lines = [f"{'file':36s} {'schema':>6s} {'quick':>5s} "
             f"{'generated':>16s} {'wl':>3s} {'drift':>5s} {'adapt':>6s}  "
             f"geomean speedup vs default"]
    for r in rows:
        if "error" in r:
            lines.append(f"{r['file']:36s} -- {r['error']}")
            continue
        gen = r.get("generated_unix")
        when = time.strftime("%Y-%m-%d %H:%M", time.localtime(gen)) \
            if isinstance(gen, (int, float)) else "?"
        geo = " ".join(f"{cfg}:{v:.2f}x" if isinstance(v, (int, float))
                       else f"{cfg}:?"
                       for cfg, v in sorted(r["geomean_vs_default"].items()))
        ad = r.get("adaptive_geomean")
        lines.append(
            f"{r['file']:36s} {str(r.get('schema', '?')):>6s} "
            f"{'yes' if r.get('quick') else 'no':>5s} {when:>16s} "
            f"{r['n_workloads']:3d} {len(r['drift_flags']):5d} "
            + (f"{ad:5.2f}x" if isinstance(ad, (int, float)) else f"{'-':>6s}")
            + f"  {geo}")
        if r.get("serve_sjf_wins") is not None:
            lines.append(f"{'':36s} serve: SJF beats FIFO on bursty: "
                         + ("yes" if r["serve_sjf_wins"] else "NO"))
        tb = r.get("top_bottleneck")
        if isinstance(tb, dict):
            lines.append(f"{'':36s} bottleneck: {tb['bucket']} "
                         f"({100 * tb['share']:.0f}% of attributed "
                         f"makespan)")
        for flag in r["drift_flags"]:
            lines.append(f"{'':36s} drift: {flag}")
    return lines
