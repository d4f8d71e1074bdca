"""Roofline terms of a dry-run cell: the port of the JAX package's
``launch/roofline.py``.

  compute term    = FLOPs / peak_FLOP/s
  memory term     = bytes / HBM_bw
  collective term = collective_bytes / link_bw

all per device.  ``analyze`` takes the per-device totals either from the
JAX package's post-SPMD HLO text (``hlo_analysis.analyze_hlo``, loop trip
counts applied) or, for the port's own steps, as the
``hlo_analysis.CostTotals`` that ``launch.dryrun``'s op counter filled.
``collective_bytes`` parses HLO text: the summed result bytes of
all-reduce / all-gather / reduce-scatter / all-to-all / collective-permute
ops (start/done variants counted once).

The constants are one NVIDIA H100 SXM's, from NVIDIA's H100 Tensor Core GPU
data sheet (dense rates, no sparsity, at the 700 W limit).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

import numpy as np

from repro_torch.launch import hlo_analysis

# NVIDIA H100 SXM data sheet, per card
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
ICI_BW = 450e9               # NVLink 4: 900 GB/s both ways, 450e9 a direction

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all", "collective-permute")


def shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape string, e.g. 'bf16[8,128]{1,0}' or a tuple."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Per-kind summed result bytes of collective ops in post-SPMD HLO."""
    out: dict[str, int] = {k: 0 for k in _COLLECTIVE_KINDS}
    for line in hlo_text.splitlines():
        line = line.strip()
        if "=" not in line:
            continue
        lhs, rhs = line.split("=", 1)
        rhs = rhs.strip()
        m = re.match(r"^(\([^)]*\)|\S+)\s+([\w-]+)", rhs)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        for kind in _COLLECTIVE_KINDS:
            # count the -start variant once; skip -done (same payload)
            if op == kind or op == f"{kind}-start":
                out[kind] += shape_bytes(shape_str)
                break
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device analytic terms (primary)
    per_device_flops: float
    per_device_bytes: float
    per_device_collective_bytes: float
    collective_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    bottleneck: str
    # the reference's raw cost_analysis (loop bodies counted once); the
    # port's dry-run gives its counter's totals here
    raw_flops: float = 0.0
    raw_bytes: float = 0.0
    memory_per_device_bytes: Optional[dict] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            cost: dict, hlo_text: Union[str, hlo_analysis.CostTotals],
            model_flops: float,
            memory_stats: Optional[dict] = None) -> RooflineReport:
    """The report of one cell from its per-device totals: ``hlo_text`` is
    HLO text (walked by ``analyze_hlo``) or a ``CostTotals`` already
    filled."""
    totals = (hlo_text if isinstance(hlo_text, hlo_analysis.CostTotals)
              else hlo_analysis.analyze_hlo(hlo_text))
    flops = totals.flops
    bytes_accessed = totals.hbm_bytes
    coll = {k: float(v) for k, v in totals.collective_bytes.items()}
    coll_total = float(sum(coll.values()))
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll_total / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    hlo_global = flops * chips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        per_device_flops=flops, per_device_bytes=bytes_accessed,
        per_device_collective_bytes=coll_total, collective_breakdown=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=model_flops, hlo_flops_global=hlo_global,
        useful_ratio=(model_flops / hlo_global) if hlo_global else 0.0,
        bottleneck=bottleneck,
        raw_flops=float(cost.get("flops", 0.0)),
        raw_bytes=float(cost.get("bytes accessed", 0.0)),
        memory_per_device_bytes=memory_stats)


# ---------------------------------------------------------------------------
# MODEL_FLOPS: the analytic c = f(K, H) of a cell
# ---------------------------------------------------------------------------

def _spec_paths(tree, path=()):
    """(key path, ParamSpec) for every leaf of a nested-dict spec tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], path + (k,))
    else:
        yield path, tree


def count_params_split(model) -> tuple[int, int]:
    """(total_params, active_params): MoE experts count top_k/E when active."""
    cfg = model.cfg
    total = active = 0
    for keys, leaf in _spec_paths(model.param_specs()):
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        total += n
        is_expert = "moe" in keys and any(
            k in ("w_gate", "w_up", "w_down") for k in keys) and "shared" not in keys
        if is_expert:
            active += n * cfg.moe_top_k // max(cfg.n_experts, 1)
        else:
            active += n
    return total, active


def model_flops(model, shape) -> float:
    """6*N_active*D for train; 2*N_active*D forward-only (prefill);
    2*N_active*B per decode step."""
    _, active = count_params_split(model)
    if shape.is_decode:
        return 2.0 * active * shape.global_batch
    factor = 2.0 if shape.kind == "prefill" else 6.0
    return factor * active * shape.global_batch * shape.seq_len
