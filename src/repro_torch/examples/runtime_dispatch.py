"""End-to-end runtime dispatch: cold -> warm -> cross-process reload, the
port of ``examples/runtime_dispatch.py``, on the device (the card unless
``--device cpu``).

1. COLD: a fresh tuning cache forces measured dispatch — every variant of
   the blur kernel is timed (black-box protocol), rows are recorded, and
   the lightweight NN+C model is fitted and persisted.
2. WARM: the same shapes dispatch again — now every decision is a
   <75-weight prediction, no measurement; steady-state overhead is
   reported as a fraction of kernel wall time.
3. RELOAD: a second *process* opens the cache from disk and must make
   identical selections (the persisted model round-trips bit-exactly).

The cache lives under ``results/torch/tunecache-demo``.  ``main`` returns
the numbers; run as a script it exits 1 when the overhead target (<5%) is
missed, as the reference does.

    PYTHONPATH=src python -m repro_torch.examples.runtime_dispatch [--device cpu]
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

import repro_torch
from repro_torch.kernels import resolve_device

SHAPES = [(384, 384), (512, 384), (512, 512), (768, 512),
          (768, 768), (1024, 768), (1024, 1024), (1536, 1024)]
WARM_REPS = 25
ROOT = os.path.join("results", "torch", "tunecache-demo")


def make_dispatcher(root, device):
    from repro_torch.runtime import (Dispatcher, DispatchPolicy, TuningCache,
                                     current_fingerprint, default_registry)
    return Dispatcher(
        registry=default_registry(include=["blur"]),
        cache=TuningCache(root=root, fingerprint=current_fingerprint(device)),
        policy=DispatchPolicy(min_rows_to_fit=5 * len(SHAPES),
                              fit_epochs=6000))


def run_shapes(dispatcher, device, reps=1, shapes=None):
    rng = np.random.RandomState(0)
    selections = {}
    for (m, n) in shapes or SHAPES:
        a = torch.from_numpy(rng.rand(m, n).astype(np.float32)).to(device)
        for _ in range(reps):
            dispatcher.dispatch("blur", a)
        sel = dispatcher.selections[-1]
        selections[f"{m}x{n}"] = sel.chosen
    return selections


def child_main(root, device, shapes):
    """Second process: reload the cache, dispatch the parent's shapes,
    print selections."""
    d = make_dispatcher(root, device)
    print(json.dumps({"selections": run_shapes(d, device, shapes=shapes),
                      "measured": d.n_measured}))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "runtime_dispatch")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shapes", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.child:
        child_main(args.child, device, [
            tuple(map(int, s.split("x"))) for s in args.shapes.split(",")])
        return {}
    # dedicated demo root, cleared so the cold run is genuinely cold
    shutil.rmtree(ROOT, ignore_errors=True)
    d = make_dispatcher(ROOT, device)

    print(f"== cold run (cache: {d.cache.dir}) ==")
    cold = run_shapes(d, device)
    print(f"dispatches: {d.stats()['dispatches']}, measured: {d.n_measured}, "
          f"predicted: {d.n_predicted}")
    if d._entry("blur").model is None:
        d.fit("blur")               # small shape set: fit explicitly
    for size, chosen in cold.items():
        print(f"  {size:10s} -> {chosen}")

    print("\n== warm run (same process) ==")
    run_shapes(d, device)           # decision-memo warm-up pass
    d.reset_stats()                 # ...then measure the steady state
    n_measured_before = d.n_measured
    warm = run_shapes(d, device, reps=WARM_REPS)
    stats = d.stats()
    assert d.n_measured == n_measured_before, "warm run must not measure"
    for size, chosen in warm.items():
        print(f"  {size:10s} -> {chosen}")
    print(f"steady-state dispatch overhead: "
          f"{stats['steady_overhead_s']*1e6:.0f}us "
          f"= {stats['steady_overhead_pct']:.2f}% of wall time "
          f"(target <5%)")

    print("\n== second process reloads the cache ==")
    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.runtime_dispatch",
         "--child", ROOT, "--device", str(device),
         "--shapes", ",".join(f"{m}x{n}" for m, n in SHAPES)],
        capture_output=True, text=True, env=env, check=True)
    child = json.loads(out.stdout.strip().splitlines()[-1])
    assert child["measured"] == 0, "child must dispatch purely from cache"
    assert child["selections"] == warm, (child["selections"], warm)
    print("child selections identical to warm run; 0 measurements — OK")

    overhead_ok = stats["steady_overhead_pct"] < 5.0
    print(f"\noverhead target met: {overhead_ok}")
    return {"cold": cold, "warm": warm, "child": child,
            "overhead_pct": stats["steady_overhead_pct"],
            "overhead_ok": overhead_ok}


if __name__ == "__main__":
    res = main()
    sys.exit(0 if not res or res["overhead_ok"] else 1)
