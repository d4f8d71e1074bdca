#!/usr/bin/env python3
"""One dry-run cell of either package, its arch cut to fewer layers.

The JAX package's ``repro.launch.dryrun`` and the port's
``repro_torch.launch.dryrun`` take a cell at its arch's full depth.  This
script replaces the chosen package's ``launch.dryrun.get_arch`` with one
that cuts ``n_layers`` (as ``tests/test_torch_dist_tp.py``'s
``dryrun_cells`` does for the port), runs ``run_cell`` and writes the
result as JSON.  It lives beside the tests because it imports the JAX
package; neither package is edited.

    PYTHONPATH=src python3 tests/dryrun_depth.py --package repro_torch \\
        --arch xlstm-1.3b --shape train_4k --layers 8 --out /tmp/d.json

``--layers 0`` keeps the full depth.  ``--package repro`` compiles on the
JAX package's forced 512-device host platform (set on its import);
``--dots`` adds its HLO's FLOPs split by kind (``repro.launch.profile``:
``dot_flops`` the dot instructions', ``fusion_flops`` the fusions', whose
elementwise work the port's product count leaves out).
"""
import argparse
import dataclasses
import importlib
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("repro", "repro_torch"),
                    required=True)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", required=True)
    ap.add_argument("--dots", action="store_true")
    args = ap.parse_args(argv)

    dryrun = importlib.import_module(f"{args.package}.launch.dryrun")
    full = dryrun.get_arch
    if args.layers:
        dryrun.get_arch = lambda name: dataclasses.replace(
            full(name), n_layers=args.layers)
    t0 = time.perf_counter()
    result = dryrun.run_cell(args.arch, args.shape,
                             multi_pod=args.multi_pod)
    result["wall_s"] = time.perf_counter() - t0
    result["n_layers"] = args.layers or full(args.arch).n_layers
    result["package"] = args.package
    if args.dots and args.package == "repro":
        result.update(_hlo_flops(dryrun, args))
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1, default=str)
    print(json.dumps({k: result.get(k) for k in (
        "package", "arch", "shape", "n_layers", "per_device_flops",
        "dot_flops", "fusion_flops", "memory_per_device_bytes",
        "collective_breakdown", "lower_s", "compile_s", "wall_s")
        if k in result}, default=str))
    return 0


def _hlo_flops(dryrun, args) -> dict:
    """The JAX package's per-device FLOPs of the cell's compiled HLO, by
    instruction kind (``repro.launch.profile.profile_hlo``)."""
    import jax
    from repro.launch import profile
    from repro.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    fn, fargs, in_sh, out_sh, donate, _, _ = dryrun.build_cell(
        args.arch, args.shape, mesh)
    text = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                   donate_argnums=donate).lower(*fargs).compile().as_text()
    _, flops, _ = profile.profile_hlo(text)
    return {"dot_flops": sum(r[0] for r in flops if r[1] == "dot"),
            "fusion_flops": sum(r[0] for r in flops if r[1] != "dot")}


if __name__ == "__main__":
    sys.exit(main())
