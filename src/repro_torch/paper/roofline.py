"""The roofline report over a dry-run results document: the port of
``benchmarks/roofline_bench.py``.

Renders the per-(arch x shape x mesh) three-term table from
``python -m repro_torch.launch.dryrun`` (default ``results/torch/dryrun.json``).
The keys are the reference's, so it reads either package's document.
The port's document holds memory in the blocked layout
(``memory_per_device_bytes["total_bytes"]``, the reference's ``mem/dev``
column); one more column, ``shd/dev``, gives the reference's sharded
argument figure beside it (``sharded_argument_bytes``; "-" where a
document has none).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.paper --device cpu --quick
"""
from __future__ import annotations

import json
import os

DEFAULT_PATH = "results/torch/dryrun.json"


def run(path: str = DEFAULT_PATH) -> dict:
    if not os.path.exists(path):
        print(f"[roofline] {path} missing — run "
              "`python -m repro_torch.launch.dryrun --all --both-meshes` "
              "first")
        return {}
    with open(path) as f:
        return json.load(f)


def summarize(results: dict, mesh: str = "pod16x16") -> list[str]:
    lines = [f"== Roofline terms per (arch x shape), mesh={mesh} "
             f"(trip-count-corrected analytic model) =="]
    lines.append(f"{'cell':42s} {'compute':>10s} {'memory':>10s} "
                 f"{'collect':>10s} {'bneck':>10s} {'useful':>7s} "
                 f"{'mem/dev':>8s} {'shd/dev':>8s}")
    skips = []
    for key in sorted(results):
        v = results[key]
        if not key.endswith(mesh):
            continue
        cell = key.rsplit("|", 1)[0]
        if v.get("skipped"):
            skips.append(f"{cell}: SKIP ({v['reason']})")
            continue
        if not v.get("ok"):
            lines.append(f"{cell:42s} FAILED: {v.get('error','')[:40]}")
            continue
        mem = v.get("memory_per_device_bytes") or {}
        mb = mem.get("total_bytes", 0) / 1e9
        shd = mem.get("sharded_argument_bytes")
        lines.append(
            f"{cell:42s} {v['compute_s']*1e3:9.1f}m {v['memory_s']*1e3:9.1f}m "
            f"{v['collective_s']*1e3:9.1f}m {v['bottleneck']:>10s} "
            f"{v['useful_ratio']:7.2f} {mb:7.1f}G "
            + (f"{shd / 1e9:7.1f}G" if shd is not None else f"{'-':>8s}"))
    lines.extend(skips)
    multi = sum(1 for k, v in results.items()
                if k.endswith("pod2x16x16") and v.get("ok")
                and not v.get("skipped"))
    lines.append(f"multi-pod (2x16x16) compiled cells: {multi}")
    return lines
