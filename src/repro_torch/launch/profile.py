"""Structural profiler: top traffic/flops/collective contributors per cell,
the port of the JAX package's ``launch/profile.py``.

Every hillclimb iteration starts from "what are the top-K ops by modelled
device-memory traffic / collective payload in this cell?".
:func:`profile_hlo` answers it from the JAX package's optimized HLO text,
with the trip-count-aware analyzer the roofline uses;
:func:`profile_counter` answers it for the port's own step, from the
records of the dry-run's op counter (``launch.dryrun.OpCounter``: eager
torch has no loops to multiply, so every multiplier is 1).

    PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen3-moe-235b-a22b \\
        --shape train_4k --variant moeshard --top 15
"""
import argparse
import collections

from repro_torch.launch import hlo_analysis as ha


def profile_hlo(hlo_text: str) -> tuple[list, list, list]:
    """Returns (traffic rows, dot-flops rows, collective rows), each
    [(value, op, shape, multiplier)] sorted descending."""
    comps = ha.parse_module(hlo_text)
    traffic = collections.Counter()
    flops = collections.Counter()
    colls = collections.Counter()

    def walk(comp_name, mult):
        comp = comps.get(comp_name)
        if comp is None:
            return
        for instr in comp.instrs:
            if instr.op in ha._SKIP_OPS or instr.name in comp.artifacts:
                continue
            if instr.op == "while":
                for sub in instr.called:
                    walk(sub, mult * instr.trip_count)
                continue
            if instr.op in ("call", "conditional"):
                for sub in instr.called:
                    walk(sub, mult)
                continue
            key = (instr.op, instr.shape.split("{")[0][:48], int(mult))
            if instr.op in ha._COLLECTIVES:
                res = ha.shape_elems_bytes(instr.shape)[1]
                payload = max(res, ha._operand_bytes(comp, instr))
                colls[key] += payload * mult
                continue
            if instr.op.endswith("-done"):
                continue
            rb = ha.shape_elems_bytes(instr.shape)[1]
            if instr.op == "dynamic-update-slice" and len(instr.operands) >= 2:
                upd = comp.symbols.get(comp.resolve(instr.operands[1]))
                tb = 2 * ha.shape_elems_bytes(upd)[1] if upd else rb
            elif instr.op == "dynamic-slice":
                tb = 2 * rb
            elif instr.op == "fusion" and instr.called:
                tb = ha._fusion_traffic(comps, comp, instr)
                flops[key] += ha._fusion_flops(comps, instr.called[0]) * mult
            else:
                tb = rb + ha._operand_bytes(comp, instr)
            if instr.op == "dot":
                flops[key] += ha._dot_flops(comp, instr) * mult
            traffic[key] += tb * mult

    walk(comps["__entry__"].name, 1.0)
    fmt = lambda c: [(v,) + k for k, v in c.most_common()]
    return fmt(traffic), fmt(flops), fmt(colls)


def profile_counter(counter) -> tuple[list, list, list]:
    """The same three lists from an ``OpCounter``'s records of one step:
    [(value, op, shape, 1)] sorted descending (op as ``aten.mm``, shape as
    ``bf16[512,1152]``, the first output's)."""
    fmt = lambda c: [(v, op, shp[:48], 1) for (op, shp), v in c.most_common()]
    return fmt(counter.traffic), fmt(counter.flops), fmt(counter.colls)


def print_tables(traffic, flops, colls, top: int) -> None:
    for title, rows, unit in (("HBM traffic", traffic, "GB"),
                              ("dot/fused flops", flops, "GF"),
                              ("collective payload", colls, "GB")):
        print(f"\n== top {top} by {title} (per device) ==")
        for v, op, shp, mult in rows[:top]:
            print(f"{v/1e9:10.1f}{unit}  x{mult:<5d} {op:20s} {shp}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell

    counters = []
    run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
             variant=args.variant, counter_out=counters)
    print_tables(*profile_counter(counters[0]), args.top)


if __name__ == "__main__":
    main()
