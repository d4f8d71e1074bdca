"""The paper's experiments, one function per table/figure: the port of
``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.paper            # standard pass
    PYTHONPATH=src python -m repro_torch.paper --quick    # subset, low epochs
    PYTHONPATH=src python -m repro_torch.paper --full     # + omitted kernels
    PYTHONPATH=src python -m repro_torch.paper --device cpu --quick

``--device cuda`` (the default) raises without a card.  On a card the
tables also measure the 9 card combos (``datasets.card_combos``), and
Fig. 4 and the runtime overhead run their blur schedules on the card;
``--device cpu`` runs the reference's combos and both on the host.  The
roofline table (``paper.roofline``) renders the dry-run document
``results/torch/dryrun.json`` where ``python -m repro_torch.launch.dryrun``
wrote one.

Prints ``name,value,derived`` CSV lines at the end for machine scraping
(``trailer``: the reference's lines over the reference's combos, and
``card_*`` lines over the card combos); full tables go to stdout and
results/torch/*.json.
"""
from __future__ import annotations

import argparse

import numpy as np


def _nnc_vs_nn(rows: dict) -> tuple:
    """NN+C's and NN's mean MAE, NN+C's mean MAPE and its MAE wins."""
    nnc_mae = np.mean([r["nnc"]["mae"] for r in rows.values()])
    nn_mae = np.mean([r["nn"]["mae"] for r in rows.values()])
    nnc_mape = np.mean([r["nnc"]["mape"] for r in rows.values()])
    wins = sum(1 for r in rows.values() if r["nnc"]["mae"] <= r["nn"]["mae"])
    return nnc_mae, nn_mae, nnc_mape, wins


def trailer(tabs: dict, vs: dict | None = None,
            rt: dict | None = None) -> list[str]:
    """The ``name,us_per_call,derived`` lines.  The reference's lines are
    over the reference's combos, so they mean what the JAX package's do;
    the card combos, where there are any, have lines of their own."""
    from repro_torch.paper.tables import is_card

    ref = {k: r for k, r in tabs.items() if not is_card(k)}
    card = {k: r for k, r in tabs.items() if is_card(k)}
    nnc_mae, nn_mae, nnc_mape, wins = _nnc_vs_nn(ref)
    lines = ["name,us_per_call,derived",
             f"table4_7_nnc_mean_mae_s,{nnc_mae:.6e},lower_is_better",
             f"table4_7_nn_mean_mae_s,{nn_mae:.6e},baseline",
             f"table8_nnc_mean_mape_pct,{nnc_mape:.2f},paper_reports_13pct",
             f"nnc_vs_nn_mae_winrate,{wins}/{len(ref)},paper_reports_all"]
    if card:
        _, _, nnc_mape, wins = _nnc_vs_nn(card)
        lines += [f"card_nnc_mean_mape_pct,{nnc_mape:.2f},measured_on_card",
                  f"card_nnc_vs_nn_mae_winrate,{wins}/{len(card)},"
                  f"measured_on_card"]
    if vs:
        sp = max(r["speedup_vs_default"] for r in vs["cases"].values())
        lines.append(f"fig4_blur_max_speedup,{sp:.3f},paper_reports_1.5x")
    if rt:
        regrets = [c["regret_vs_oracle"] for c in rt["cases"].values()]
        lines += [f"runtime_dispatch_overhead_pct,"
                  f"{rt['steady_overhead_pct']:.2f},target_lt_5pct",
                  f"runtime_mean_regret_vs_oracle,{np.mean(regrets):.3f},"
                  f"oracle_is_1.0"]
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.paper")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.kernels import resolve_device
    from repro_torch.paper import (roofline, runtime_overhead, tables,
                                   unconstrained, variant_selection)
    from repro_torch.perfdata.datasets import Combo, card_combos

    device = resolve_device(args.device)
    epochs = 4000 if args.quick else 20000
    if args.quick:
        combos = [Combo("mm", "eigen", "i5", True),
                  Combo("mv", "cuda_global", "tesla", True),
                  Combo("mp", "eigen", "xeon", True)]
        if device.type == "cuda":
            combos += card_combos(device)
        tabs = tables.run(epochs=epochs, combos=combos)
    else:
        tabs = tables.run(epochs=epochs, include_host=True, device=device)

    print()
    for line in tables.summarize(tabs):
        print(line)

    if not args.quick:
        unc = unconstrained.run(epochs=epochs)
        print()
        for line in unconstrained.summarize(unc):
            print(line)

        vs = variant_selection.run(device=device)
        print()
        for line in variant_selection.summarize(vs):
            print(line)

    if args.full:
        from repro_torch.paper import omitted_kernels
        ok_res = omitted_kernels.run(epochs=epochs)
        print()
        for line in omitted_kernels.summarize(ok_res):
            print(line)

    roof = roofline.run()
    if roof:
        print()
        for line in roofline.summarize(roof):
            print(line)

    rt = runtime_overhead.run(quick=args.quick, device=device)
    print()
    for line in runtime_overhead.summarize(rt):
        print(line)

    # machine-readable trailer: name,us_per_call,derived
    print()
    for line in trailer(tabs, None if args.quick else vs, rt):
        print(line)


if __name__ == "__main__":
    main()
