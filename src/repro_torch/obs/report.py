"""``python -m repro_torch.obs {report,cards,dashboard,explain}`` — the obs
CLI, the port of ``repro.obs``'s, with its arguments and exit codes.

    PYTHONPATH=src python -m repro_torch.obs report \\
        results/telemetry_adaptive.json
    PYTHONPATH=src python -m repro_torch.obs report \\
        results/telemetry_*.json --check
    PYTHONPATH=src python -m repro_torch.obs report \\
        results/telemetry_serve.json --slo [slo_spec.json]
    PYTHONPATH=src python -m repro_torch.obs report \\
        results/telemetry_adaptive.json \\
        --trace results/exec_trace_adaptive.json
    PYTHONPATH=src python -m repro_torch.obs cards [--json]
    PYTHONPATH=src python -m repro_torch.obs dashboard \\
        -o results/dashboard.html
    PYTHONPATH=src python -m repro_torch.obs explain \\
        results/exec_trace_adaptive.json

``report`` prints the standing summary (decision counts, histogram
percentiles, overhead fractions, drift status) as text or ``--json``.
``--check`` turns the report into a health gate: exit 1 when any
kernel's live MAPE exceeds ``--factor`` (default 2.0) times its
fit-time band — CI runs it as a non-blocking drift warning.  ``--slo``
evaluates an SLO set (a JSON spec path, or the default serve set)
against the loaded telemetry: exit 1 when any evaluated SLO burns.
``--trace`` additionally prints the per-lane busy/wait/idle utilization
breakdown of saved Chrome execution traces.
Exit 2 means a file could not be loaded (tooling, not drift/burn).

``cards`` renders one predictor model card per (kernel, fingerprint) in
the tunecache (``obs.cards``); ``dashboard`` writes the self-contained
static HTML dashboard (``obs.dashboard``).

``explain`` runs the causal critical-path analysis (``obs.explain``) on
saved artifacts: Chrome execution traces get makespan attribution
(critical path, buckets, slack, misprediction ranking), telemetry files
with serve-request instants get per-request TTFT waterfalls.  ``--json``
prints the combined document; ``-o`` saves it; ``--check-band`` exits 1
when the top misprediction's error exceeds its kernel's fit band (CI's
non-blocking warning hook).  Exit 2 means a file could not be loaded or
contained no analyzable events.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.slo import (DEFAULT_SERVE_SLOS, burned, evaluate_slos,
                           format_slos, load_slos)
from repro_torch.obs.telemetry import Telemetry, summarize_doc


def format_summary(summary: dict, path: str = "") -> list:
    """Human-readable rendering of ``summarize_doc`` output."""
    lines = [f"== telemetry: {summary.get('run_id')}"
             + (f" ({path})" if path else "") + " =="]
    dec = summary.get("decisions", {})
    if dec:
        lines.append("decisions: " + "  ".join(
            f"{k.split('.', 1)[1]}={v}" for k, v in sorted(dec.items())))
    oh = summary.get("overhead", {})
    if "dispatch_frac" in oh:
        lines.append(f"dispatch overhead: {100 * oh['dispatch_frac']:.2f}% "
                     "of dispatch+kernel wall")
    ev = summary.get("events", {})
    if ev:
        lines.append("events: " + "  ".join(
            f"{k}={v}" for k, v in sorted(ev.items())))
    hists = summary.get("histograms", {})
    if hists:
        lines.append(f"{'histogram':34s} {'count':>7s} {'mean':>10s} "
                     f"{'p50':>10s} {'p99':>10s} {'max':>10s}")
        for name, h in hists.items():
            if not h.get("count"):
                continue
            lines.append(
                f"{name:34s} {h['count']:7d} {h['mean']:10.3g} "
                f"{h.get('p50', float('nan')):10.3g} "
                f"{h.get('p99', float('nan')):10.3g} {h['max']:10.3g}")
    drift = summary.get("drift", {})
    if drift:
        lines.append(f"{'kernel':24s} {'live_mape%':>10s} {'fit_band%':>10s} "
                     f"{'n':>5s} {'drift':>6s}")
        for kernel, d in sorted(drift.items()):
            lines.append(
                f"{kernel:24s} {d['live_mape_pct']:10.2f} "
                f"{d['fit_band_pct']:10.2f} {d['n']:5d} "
                f"{'FLAG' if d['flagged'] else 'ok':>6s}")
    flags = summary.get("drift_flags", [])
    lines.append("drift flags: " + (", ".join(flags) if flags else "none"))
    return lines


def _check_flags(doc: dict, factor: float) -> list:
    """Re-evaluate drift flags at the requested factor (the saved monitor
    keeps raw residual windows, so the threshold is a read-time choice)."""
    mon = DriftMonitor.from_json(doc.get("drift", {}))
    mon.config = dataclasses.replace(mon.config, factor=factor)
    return mon.flags()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="summarize saved telemetry files")
    rp.add_argument("paths", nargs="+", help="telemetry JSON file(s)")
    rp.add_argument("--json", action="store_true", dest="as_json",
                    help="print the summary document instead of text")
    rp.add_argument("--check", action="store_true",
                    help="exit 1 when any kernel's live MAPE exceeds "
                         "--factor times its fit band")
    rp.add_argument("--factor", type=float, default=2.0,
                    help="drift-flag threshold factor for --check")
    rp.add_argument("--slo", nargs="?", const="", default=None,
                    metavar="SPEC",
                    help="evaluate an SLO set against the telemetry and "
                         "exit 1 on any burn; SPEC is a JSON spec file "
                         "(omit it for the default serve SLOs)")
    rp.add_argument("--trace", nargs="*", default=None, metavar="TRACE",
                    help="saved Chrome execution trace(s): print each "
                         "lane's busy/wait/idle utilization breakdown")

    cp = sub.add_parser("cards", help="render predictor model cards from "
                                      "the tunecache + saved telemetry")
    cp.add_argument("--json", action="store_true", dest="as_json")
    cp.add_argument("--root", default=None,
                    help="tunecache root (default results/tunecache)")
    cp.add_argument("--telemetry", nargs="*", default=None,
                    metavar="GLOB",
                    help="telemetry file globs folded into the cards "
                         "(default results/telemetry_*.json)")

    dp = sub.add_parser("dashboard",
                        help="write the self-contained static HTML "
                             "dashboard (no external requests)")
    dp.add_argument("-o", "--out", default="results/dashboard.html")
    dp.add_argument("--results-dir", default="results",
                    help="directory scanned for bench/telemetry "
                         "documents and the tunecache")
    dp.add_argument("--slo", default=None, metavar="SPEC",
                    help="SLO JSON spec (default: the serve set)")

    ep = sub.add_parser("explain",
                        help="causal critical-path analysis of saved "
                             "traces; TTFT waterfalls from telemetry")
    ep.add_argument("paths", nargs="+",
                    help="Chrome execution trace and/or telemetry JSON "
                         "file(s)")
    ep.add_argument("--json", action="store_true", dest="as_json",
                    help="print the analysis document instead of text")
    ep.add_argument("-o", "--out", default=None,
                    help="also write the analysis document to this path")
    ep.add_argument("--check-band", action="store_true",
                    help="exit 1 when the top misprediction's error "
                         "exceeds its kernel's fit-time band")

    args = ap.parse_args(argv)
    if args.cmd == "cards":
        return _cards_main(args)
    if args.cmd == "dashboard":
        return _dashboard_main(args)
    if args.cmd == "explain":
        return _explain_main(args)

    slos = None
    if args.slo is not None:
        try:
            slos = load_slos(args.slo) if args.slo else DEFAULT_SERVE_SLOS
        except (OSError, ValueError) as e:
            print(f"obs report: cannot load SLO spec: {e}", file=sys.stderr)
            return 2

    flagged: list = []
    burns: list = []
    summaries = {}
    for path in args.paths:
        try:
            doc = Telemetry.load(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"obs report: cannot load {path}: {e}", file=sys.stderr)
            return 2
        summary = summarize_doc(doc)
        summaries[path] = summary
        if args.check:
            flagged += [f"{path}:{k}"
                        for k in _check_flags(doc, args.factor)]
        if not args.as_json:
            for line in format_summary(summary, path=path):
                print(line)
        if slos is not None:
            results = evaluate_slos(slos, doc)
            burns += [f"{path}:{r['slo']}" for r in burned(results)]
            if not args.as_json:
                for line in format_slos(results, path=path):
                    print(line)
    lane_docs = {}
    for tpath in (args.trace or ()):
        from repro_torch.obs.explain import analyze_chrome, format_lanes
        try:
            with open(tpath) as f:
                analysis = analyze_chrome(json.load(f))
        except (OSError, ValueError, KeyError) as e:
            print(f"obs report: cannot analyze trace {tpath}: {e}",
                  file=sys.stderr)
            return 2
        lane_docs[tpath] = analysis.get("lanes") or {}
        if not args.as_json:
            print(f"-- lane utilization: {tpath} --")
            for line in format_lanes(lane_docs[tpath]):
                print(line)
    if args.as_json:
        out = next(iter(summaries.values())) if len(summaries) == 1 \
            else dict(summaries)
        if lane_docs:
            out = dict(out)
            out["lane_utilization"] = lane_docs
        print(json.dumps(out, indent=1, sort_keys=True))
    rc = 0
    if args.check:
        if flagged:
            print(f"DRIFT: live MAPE > {args.factor:g}x fit band for: "
                  + ", ".join(flagged))
            rc = 1
        else:
            print(f"drift check clean (factor {args.factor:g})")
    if slos is not None:
        if burns:
            print("SLO BURN: " + ", ".join(burns))
            rc = 1
        else:
            print("all evaluated SLOs met")
    return rc


def _explain_main(args) -> int:
    from repro_torch.obs.explain import (analyze_chrome, format_explain,
                                   format_waterfalls,
                                   waterfalls_from_telemetry)
    combined: dict = {"traces": {}, "serve": {}}
    exceeded: list = []
    for path in args.paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"obs explain: cannot load {path}: {e}", file=sys.stderr)
            return 2
        if isinstance(doc, dict) and "traceEvents" in doc:
            try:
                analysis = analyze_chrome(doc)
            except (ValueError, KeyError) as e:
                print(f"obs explain: cannot analyze {path}: {e}",
                      file=sys.stderr)
                return 2
            if analysis.get("empty"):
                print(f"obs explain: {path}: no task events",
                      file=sys.stderr)
                return 2
            combined["traces"][path] = analysis
            top = (analysis.get("mispredictions") or [None])[0]
            if top is not None and top.get("exceeds_fit_band"):
                exceeded.append(
                    f"{path}: {top['kernel']}{top['shape_bucket']} cost "
                    f"{top['cost_s'] * 1e3:.2f} ms, ape "
                    f"{top['ape_pct']:.1f}% > band "
                    f"{top['fit_band_pct']:.1f}%")
            if not args.as_json:
                for line in format_explain(analysis, path=path):
                    print(line)
        elif isinstance(doc, dict) and "obs_schema" in doc:
            wf = waterfalls_from_telemetry(doc)
            combined["serve"][path] = wf
            if not args.as_json:
                for line in format_waterfalls(wf, path=path):
                    print(line)
        else:
            print(f"obs explain: {path}: neither a Chrome trace nor a "
                  f"telemetry document", file=sys.stderr)
            return 2
    if args.as_json:
        print(json.dumps(combined, indent=1, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(combined, f, indent=1, sort_keys=True)
        if not args.as_json:
            print(f"wrote {args.out}")
    if args.check_band:
        if exceeded:
            print("FIT-BAND EXCEEDED by top misprediction: "
                  + "; ".join(exceeded))
            return 1
        print("fit-band check clean: no top misprediction outside its "
              "kernel's band")
    return 0


def _cards_main(args) -> int:
    from repro_torch.obs.cards import (DEFAULT_TELEMETRY_PATTERNS, build_cards,
                                 format_cards)
    from repro_torch.runtime.cache import DEFAULT_ROOT
    cards = build_cards(
        cache_root=args.root or DEFAULT_ROOT,
        telemetry_patterns=tuple(args.telemetry)
        if args.telemetry else DEFAULT_TELEMETRY_PATTERNS)
    if args.as_json:
        print(json.dumps(cards, indent=1, sort_keys=True))
    else:
        for line in format_cards(cards):
            print(line)
    return 0


def _dashboard_main(args) -> int:
    from repro_torch.obs.dashboard import write_dashboard
    try:
        slos = load_slos(args.slo) if args.slo else None
    except (OSError, ValueError) as e:
        print(f"obs dashboard: cannot load SLO spec: {e}", file=sys.stderr)
        return 2
    path = write_dashboard(args.out, results_dir=args.results_dir,
                           slos=slos)
    print(f"wrote {path}")
    return 0
