"""CLI: ``python -m repro_torch.bench {run,adaptive,serve,compare,history}``,
the port of ``repro.bench``'s.

    PYTHONPATH=src python -m repro_torch.bench run --quick
    PYTHONPATH=src python -m repro_torch.bench run --quick \\
        --configs cpu,simdev2
    PYTHONPATH=src python -m repro_torch.bench adaptive --quick
    PYTHONPATH=src python -m repro_torch.bench serve --quick [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench compare \\
        benchmarks/baseline_bench.json results/bench.json --only-kind sim
    PYTHONPATH=src python -m repro_torch.bench history
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.bench.compare_ import compare_docs, format_compare
from repro_torch.bench.harness import (DEFAULT_CONFIGS, run_adaptive,
                                       run_bench, summarize)
from repro_torch.bench.history import (DEFAULT_PATTERNS, discover,
                                       format_history, load_row)
from repro_torch.bench.schema import load_bench, validate_bench
from repro_torch.workloads import SIZES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="measure the workload suite")
    runp.add_argument("--quick", action="store_true",
                      help="small presets, fewer reps, shorter NN+C fits")
    runp.add_argument("--out", default="results/bench.json")
    runp.add_argument("--results-dir", default="results",
                      help="where sibling artifacts are folded from")
    runp.add_argument("--workloads", default=None,
                      help="comma-separated subset (default: all)")
    runp.add_argument("--size", choices=SIZES, default=None)
    runp.add_argument("--reps", type=int, default=None)
    runp.add_argument("--configs", default=",".join(DEFAULT_CONFIGS),
                      help="comma-separated device configs (cuda,cpu,simdev2)")

    adp = sub.add_parser("adaptive",
                         help="run the mis-seeded adaptive-vs-static "
                              "scenario and merge it into an existing "
                              "bench.json (as the schema-2 'adaptive' "
                              "section)")
    adp.add_argument("--quick", action="store_true")
    adp.add_argument("--out", default="results/bench.json",
                     help="bench document to merge into (must exist; "
                          "run 'bench run' first)")
    adp.add_argument("--results-dir", default="results")
    adp.add_argument("--workloads", default=None)
    adp.add_argument("--size", choices=SIZES, default=None)

    svp = sub.add_parser("serve",
                         help="run the serving-engine arrival-trace "
                              "scenario (FIFO vs cost-aware SJF "
                              "admission) and merge it into bench.json "
                              "as the schema-4 'serve' section; exit 1 "
                              "when SJF fails to beat FIFO on the "
                              "bursty trace")
    svp.add_argument("--quick", action="store_true")
    svp.add_argument("--out", default="results/bench.json",
                     help="bench document to merge into when it exists "
                          "(a standalone bench_serve.json is always "
                          "written)")
    svp.add_argument("--results-dir", default="results")
    svp.add_argument("--seed", type=int, default=0)
    svp.add_argument("--device", default="cuda",
                     help="where the engines run: the card (default) or "
                          "cpu")

    hp = sub.add_parser("history",
                        help="list saved bench.json documents (schema "
                             "v1-v3 tolerated) with geomean speedups, "
                             "drift flags, and adaptive geomeans; exit 2 "
                             "when none are found")
    hp.add_argument("paths", nargs="*",
                    help="files or globs (default: "
                         + " ".join(DEFAULT_PATTERNS) + ")")
    hp.add_argument("--json", action="store_true", dest="as_json",
                    help="print the rows as a JSON list (the dashboard "
                         "and external tooling consume this)")

    cmpp = sub.add_parser("compare",
                          help="diff two bench.json files; exit 1 on "
                               "regression, 2 when a document cannot be "
                               "loaded")
    cmpp.add_argument("baseline")
    cmpp.add_argument("new")
    cmpp.add_argument("--rel-tol", type=float, default=0.10,
                      help="allowed relative geomean-speedup drop")
    cmpp.add_argument("--mape-tol", type=float, default=10.0,
                      help="allowed per-kernel MAPE rise (pp)")
    cmpp.add_argument("--only-kind", choices=("sim", "real"), default=None,
                      help="restrict to configs of this kind (CI blocks "
                           "on sim, warns on real)")

    args = ap.parse_args(argv)
    if args.cmd == "run":
        doc = run_bench(
            quick=args.quick, out_path=args.out,
            results_dir=args.results_dir,
            workloads=args.workloads.split(",") if args.workloads else None,
            size=args.size, reps=args.reps,
            configs=tuple(args.configs.split(",")))
        for line in summarize(doc):
            print(line)
        print(f"wrote {args.out}")
        return 0
    if args.cmd == "adaptive":
        try:
            doc = load_bench(args.out)
        except (OSError, ValueError) as e:
            print(f"bench adaptive: cannot load {args.out} ({e}); "
                  "run 'python -m repro_torch.bench run' first",
                  file=sys.stderr)
            return 2
        section = run_adaptive(
            quick=args.quick, results_dir=args.results_dir,
            workloads=args.workloads.split(",") if args.workloads else None,
            size=args.size)
        doc["adaptive"] = section
        # the merged section carries schema-3 fields (telemetry_path)
        from repro_torch.bench.schema import BENCH_SCHEMA_VERSION
        doc["schema"] = max(int(doc["schema"]), BENCH_SCHEMA_VERSION)
        validate_bench(doc)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, args.out)
        for line in summarize(doc):
            print(line)
        g = section["geomean_speedup_vs_static"]
        print(f"adaptive geomean speedup vs static replay: {g:.2f}x")
        print(f"merged adaptive section into {args.out}")
        return 0 if g > 1.0 else 1
    if args.cmd == "serve":
        from repro_torch.bench.serve_trace import (run_serve,
                                                   summarize_serve,
                                                   write_serve)
        section = run_serve(quick=args.quick, results_dir=args.results_dir,
                            seed=args.seed, device=args.device)
        written = write_serve(section, out_path=args.out,
                              results_dir=args.results_dir,
                              quick=args.quick)
        for line in summarize_serve(section):
            print(line)
        print(f"wrote serve section to {written}")
        return 0 if section["sjf_beats_fifo_bursty"] else 1
    if args.cmd == "history":
        paths = discover(tuple(args.paths) if args.paths
                         else DEFAULT_PATTERNS)
        if not paths:
            print("bench history: no bench documents found",
                  file=sys.stderr)
            return 2
        rows = [load_row(p) for p in paths]
        if args.as_json:
            print(json.dumps(rows, indent=1, sort_keys=True))
        else:
            for line in format_history(rows):
                print(line)
        return 0
    try:
        baseline = load_bench(args.baseline)
        new = load_bench(args.new)
    except (OSError, ValueError) as e:
        # distinct exit code: a missing/invalid document is a tooling
        # failure, not a performance regression
        print(f"bench compare: cannot load documents: {e}",
              file=sys.stderr)
        return 2
    regressions, notes = compare_docs(baseline, new, rel_tol=args.rel_tol,
                                      mape_tol=args.mape_tol,
                                      only_kind=args.only_kind)
    for line in format_compare(regressions, notes):
        print(line)
    return 1 if regressions else 0


if __name__ == "__main__":
    sys.exit(main())
