"""Declarative SLOs over telemetry histograms, with burn-rate output, the
port of ``repro.obs.slo``.

An ``SLO(metric, percentile, target)`` asserts that a percentile of a
recorded histogram (e.g. ``serve.ttft_s``) stays at or under a target.
``evaluate_slos`` prices a set of them against a telemetry document —
saved (``Telemetry.load``) or live (``Telemetry.to_json()``) — and
reports per-SLO status plus a **burn rate**: observed / target, the
standard "how fast is the error budget burning" ratio (1.0 = exactly at
target, 2.0 = twice over).  A metric with no recorded samples is
*no-data*, not a violation: CI runs the check against smoke-test
telemetry where some surfaces legitimately never fire.

``python -m repro_torch.obs report <file> --slo [spec.json]`` wires this into
exit codes (0 = every evaluated SLO met, 1 = at least one burned) —
mirrored by a non-blocking CI step.  The JSON spec is a list of
``{"metric", "percentile", "target", ["name"]}`` objects; without one
the default serve set below applies.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLO:
    """``percentile`` of histogram ``metric`` must be <= ``target``.

    ``percentile`` is 0-100 (50 = median); the special value ``"mean"``
    targets the histogram mean (count-weighted, not sample-window-only).
    """
    metric: str
    percentile: object          # float in (0, 100] or "mean"
    target: float
    name: str = ""

    @property
    def label(self) -> str:
        if self.name:
            return self.name
        p = self.percentile
        ptxt = "mean" if p == "mean" else f"p{p:g}"
        return f"{self.metric}:{ptxt}"


# the standing serve-path objectives: generous for a local sim engine
# (quick-trace TTFTs run ~10-30ms), tight enough that a scheduling or
# admission regression of several-x trips them
DEFAULT_SERVE_SLOS = (
    SLO("serve.ttft_s", 50, 0.20),
    SLO("serve.ttft_s", 99, 1.50),
    SLO("serve.token_latency_s", 99, 0.25),
)


def load_slos(path: str) -> tuple:
    """Read an SLO set from a JSON spec file (list of objects)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, list):
        raise ValueError(f"{path}: SLO spec must be a JSON list")
    out = []
    for i, d in enumerate(doc):
        try:
            pct = d["percentile"]
            if pct != "mean":
                pct = float(pct)
            out.append(SLO(metric=str(d["metric"]), percentile=pct,
                           target=float(d["target"]),
                           name=str(d.get("name", ""))))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: bad SLO entry #{i}: {e}") from e
    return tuple(out)


def _observed(slo: SLO, hist: dict) -> Optional[float]:
    count = int(hist.get("count", 0))
    if not count:
        return None
    if slo.percentile == "mean":
        return float(hist.get("sum", 0.0)) / count
    samples = np.asarray(hist.get("samples", ()), dtype=float)
    if not samples.size:
        return None
    return float(np.percentile(samples, float(slo.percentile)))


def evaluate_slos(slos: Sequence[SLO], doc: dict) -> list:
    """Per-SLO status dicts against one telemetry document.

    ``met`` is True/False when the metric has data, None on no-data (the
    exit-code gate skips those); ``burn_rate`` is observed/target."""
    hists = doc.get("histograms", {}) or {}
    out = []
    for slo in slos:
        observed = _observed(slo, hists.get(slo.metric, {}))
        row = {"slo": slo.label, "metric": slo.metric,
               "percentile": slo.percentile, "target": float(slo.target),
               "observed": observed, "met": None, "burn_rate": None}
        if observed is not None:
            row["burn_rate"] = observed / max(slo.target, 1e-12)
            row["met"] = observed <= slo.target
        out.append(row)
    return out


def burned(results: Sequence[dict]) -> list:
    """The violated subset (no-data rows never burn)."""
    return [r for r in results if r["met"] is False]


def format_slos(results: Sequence[dict], path: str = "") -> list:
    lines = [f"== SLOs{f' ({path})' if path else ''} =="]
    if not results:
        return lines + ["  (empty SLO set)"]
    lines.append(f"  {'slo':34s} {'target':>10s} {'observed':>10s} "
                 f"{'burn':>6s}  status")
    for r in results:
        obs = r["observed"]
        burn = r["burn_rate"]
        status = "no data" if r["met"] is None \
            else ("ok" if r["met"] else "BURNED")
        lines.append(
            f"  {r['slo']:34s} {r['target']:10.4g} "
            + (f"{obs:10.4g}" if obs is not None else f"{'-':>10s}")
            + " "
            + (f"{burn:5.2f}x" if burn is not None else f"{'-':>6s}")
            + f"  {status}")
    return lines
