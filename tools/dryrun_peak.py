#!/usr/bin/env python3
"""What one dry-run cell's peak a rank holds, by the op that made it.

``launch.dryrun.OpCounter`` tracks the bytes of the live fake storages of
a cell's step; this subclass also labels each storage with the op that
first returned it and that output's dtype and shape, and keeps the live
bytes by label as the live total reaches each new high, SNAP_BYTES apart:
the last snapshot lies within SNAP_BYTES of the step's peak.  The figures
are counts, equal on any host.

    PYTHONPATH=src python3 tools/dryrun_peak.py [--arch gemma3-1b]
        [--shape train_4k] [--multi-pod] [--top 20] [--layers N]

``--layers N`` cuts the arch to its first N layers (the dry-run's
``get_arch`` replaced for the run), for a cell whose full depth traces
too long.
"""
import argparse
import collections
import dataclasses
import sys
import weakref
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun  # noqa: E402

SNAP_BYTES = 64 << 20


class PeakCounter(dryrun.OpCounter):
    """An ``OpCounter`` that keeps the live bytes by (op, output) label
    and their snapshot at the peak (``at_peak``)."""

    def __init__(self):
        super().__init__()
        self._op = "argument"
        self.live_by = collections.Counter()
        self.at_peak = collections.Counter()
        self.snap_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        outer = self._op
        self._op = func._overloadpacket._qualified_op_name.replace("::", ".")
        try:
            return super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._op = outer

    def _drop(self, label, n: int) -> None:
        self.live_by[label] -= n

    def track(self, tensors) -> None:
        for t in dryrun._tensors(tensors):
            st = t.untyped_storage()
            if st in self._live:
                continue
            label = (self._op, dryrun._shape_str(t))
            self.live_by[label] += st.nbytes()
            weakref.finalize(st, self._drop, label, st.nbytes())
            # the base class counts each storage once
            super().track(t)
            if self.live_bytes >= self.snap_bytes + SNAP_BYTES:
                self.at_peak = +self.live_by
                self.snap_bytes = self.live_bytes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args(argv)
    counters = []
    real, dryrun.OpCounter = dryrun.OpCounter, PeakCounter
    full = dryrun.get_arch
    if args.layers:
        dryrun.get_arch = lambda name: dataclasses.replace(
            full(name), n_layers=args.layers)
    try:
        cell = dryrun.run_cell(args.arch, args.shape,
                               multi_pod=args.multi_pod, verbose=False,
                               counter_out=counters)
    finally:
        dryrun.OpCounter, dryrun.get_arch = real, full
    counter = counters[0]
    peak = counter.peak_bytes
    print(f"{args.arch}{f' ({args.layers} layers)' if args.layers else ''} "
          f"{args.shape} {dryrun.mesh_name_of(args.multi_pod)}: "
          f"peak {peak} bytes = {peak / 2**30:.2f} GiB a rank, "
          f"{cell['per_device_flops']:.4g} FLOPs; the labels below at "
          f"{counter.snap_bytes} bytes = {counter.snap_bytes / 2**30:.2f} GiB")
    by_op = collections.Counter()
    for (op, _), n in counter.at_peak.items():
        by_op[op] += n
    print("\nlive at the peak, by op and output (GiB, storages):")
    for (op, shape), n in counter.at_peak.most_common(args.top):
        print(f"{n / 2**30:9.2f}  {op:28s} {shape}")
    print("\nby op (GiB):")
    for op, n in by_op.most_common(args.top):
        print(f"{n / 2**30:9.2f}  {op}")
    return {"peak_bytes": peak, "snap_bytes": counter.snap_bytes,
            "at_peak": {f"{op} {shape}": n
                        for (op, shape), n in counter.at_peak.items()}}


if __name__ == "__main__":
    main()
