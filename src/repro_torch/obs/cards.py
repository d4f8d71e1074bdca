"""Predictor model cards: one quality summary per (kernel, fingerprint),
the port of ``repro.obs.cards`` (it reads either package's tunecache and
telemetry files: their formats are the same).

The Learned-TPU-model evaluation lesson (PAPERS.md): a performance
predictor is judged by *coverage* and *calibration*, not a single MAPE.
A card folds everything the stack knows about one predictor into one
record:

- **coverage** — from the tunecache entry: measured shape buckets, row
  count (vs the 250-row training budget), variant and feature layout,
  fitted model kind;
- **accuracy** — the fit-time training MAPE next to the rolling *live*
  MAPE from recorded residuals (saved/live ``Telemetry`` drift state);
- **calibration** — the recorded APE window summarized: p50/p90 APE and
  the fraction of live predictions inside 1x / 2x the fit-time band (a
  well-calibrated model keeps most residuals inside its own band);
- **decision mix** — the per-kernel ``dispatch.by_kernel.*`` counters
  plus the gate accept rate, i.e. how the dispatcher actually *used*
  this model.

Cards are the warm-start source for cross-hardware transfer (ROADMAP
item 3): picking the "nearest" donor fingerprint needs exactly this
coverage/accuracy record per candidate.  ``python -m repro_torch.obs cards
[--json]`` renders them; the builder reads per-kernel cache metadata
straight off disk (schema-tolerant — a torn entry renders as an error
card, it never kills the listing).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch.runtime.cache import CACHE_VERSION, DEFAULT_ROOT

DEFAULT_TELEMETRY_PATTERNS = ("results/telemetry_*.json",)


def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def load_telemetry_docs(patterns: Sequence[str]) -> dict:
    """path -> telemetry document, for every readable match."""
    out: dict = {}
    for pat in patterns:
        for p in sorted(glob.glob(pat)):
            doc = _load_json(p)
            if doc is not None and "counters" in doc:
                out[p] = doc
    return out


def _kernel_live_stats(kernel: str, docs: dict) -> dict:
    """Fold drift + per-kernel counters for ``kernel`` across telemetry
    documents: live MAPE over the merged residual windows, the merged APE
    calibration window, decision mix, and gate accept rate."""
    apes: list = []
    band = None
    n_obs = 0
    decisions: dict = {}
    accepts = rejects = 0
    sources: list = []
    dk_prefix = f"dispatch.by_kernel.{kernel}."
    gk_prefix = f"gate.by_kernel.{kernel}."
    for path, doc in docs.items():
        d = (doc.get("drift") or {}).get("kernels", {}).get(kernel)
        used = False
        if d:
            window = [float(a) for a in d.get("apes", ())]
            apes += window
            n_obs += int(d.get("n", 0))
            if d.get("fit_band_pct") is not None:
                band = float(d["fit_band_pct"])
            used = True
        for name, v in (doc.get("counters") or {}).items():
            if name.startswith(dk_prefix):
                mode = name[len(dk_prefix):]
                decisions[mode] = decisions.get(mode, 0) + int(v)
                used = True
            elif name == gk_prefix + "accept":
                accepts += int(v)
                used = True
            elif name == gk_prefix + "reject":
                rejects += int(v)
                used = True
        if used:
            sources.append(path)

    out: dict = {"sources": sources, "n_residuals": n_obs,
                 "live_mape_pct":
                     100.0 * float(np.mean(apes)) if apes else None,
                 "decisions": decisions}
    if accepts or rejects:
        out["gate"] = {"accept": accepts, "reject": rejects,
                       "accept_rate": accepts / (accepts + rejects)}
    if apes:
        arr = np.asarray(apes, dtype=float)
        cal = {"window": int(arr.size),
               "p50_ape_pct": 100.0 * float(np.percentile(arr, 50)),
               "p90_ape_pct": 100.0 * float(np.percentile(arr, 90))}
        if band is not None and band > 0:
            frac = band / 100.0
            cal["within_band_frac"] = float(np.mean(arr <= frac))
            cal["within_2x_band_frac"] = float(np.mean(arr <= 2 * frac))
        out["calibration"] = cal
    return out


def build_cards(cache_root: str = DEFAULT_ROOT,
                telemetry_patterns: Sequence[str]
                = DEFAULT_TELEMETRY_PATTERNS) -> list:
    """One card dict per (kernel, fingerprint dir) under ``cache_root``.

    Telemetry-side stats are folded per *kernel* across the matched
    documents: a saved telemetry file does not record which fingerprint
    produced it, so when several fingerprints share a kernel name the
    live stats describe the union of their runs (the ``sources`` list
    names the documents folded in)."""
    docs = load_telemetry_docs(telemetry_patterns)
    cards: list = []
    for fp_path in sorted(glob.glob(os.path.join(cache_root, "*",
                                                 "fingerprint.json"))):
        fp_dir = os.path.dirname(fp_path)
        fp = _load_json(fp_path) or {}
        fp_key = os.path.basename(fp_dir)
        for meta_path in sorted(glob.glob(os.path.join(fp_dir, "*.json"))):
            kernel = os.path.basename(meta_path)[:-5]
            if kernel == "fingerprint":
                continue
            card: dict = {"kernel": kernel,
                          "fingerprint": {"key": fp_key,
                                          "backend": fp.get("backend"),
                                          "device_kind":
                                              fp.get("device_kind")}}
            meta = _load_json(meta_path)
            if meta is None or meta.get("version") != CACHE_VERSION:
                card["error"] = "unreadable or stale cache entry"
                cards.append(card)
                continue
            buckets = meta.get("buckets", [])
            model = meta.get("model") or {}
            card.update({
                "n_rows": int(meta.get("n_rows", 0)),
                "n_buckets": len(buckets),
                "buckets": [dict((k, v) for k, v in b) for b in buckets],
                "variants": list(meta.get("variant_names", [])),
                "features": list(meta.get("feature_names", [])),
                "model": model.get("kind"),
                "fitted": meta.get("model") is not None,
                "fit_mape_pct": meta.get("fit_mape"),
            })
            card.update(_kernel_live_stats(kernel, docs))
            cards.append(card)
    return cards


def format_cards(cards: list) -> list:
    """The human rendering: one block per card."""
    if not cards:
        return ["no model cards (empty or missing tunecache root)"]
    lines: list = []
    for c in cards:
        head = f"== {c['kernel']} @ {c['fingerprint']['key']} =="
        lines.append(head)
        if "error" in c:
            lines.append(f"  ERROR: {c['error']}")
            continue
        fit = c.get("fit_mape_pct")
        live = c.get("live_mape_pct")
        lines.append(
            f"  model: {c.get('model') or 'unfitted'}"
            f"  variants: {len(c['variants'])}"
            f"  rows: {c['n_rows']}  buckets: {c['n_buckets']}")
        lines.append(
            "  fit MAPE: "
            + (f"{fit:.2f}%" if isinstance(fit, (int, float)) else "-")
            + "   live MAPE: "
            + (f"{live:.2f}%" if isinstance(live, (int, float)) else "-")
            + f"   residuals: {c.get('n_residuals', 0)}")
        cal = c.get("calibration")
        if cal:
            within = cal.get("within_band_frac")
            lines.append(
                f"  calibration: p50 {cal['p50_ape_pct']:.2f}%  "
                f"p90 {cal['p90_ape_pct']:.2f}%"
                + (f"  within band {100 * within:.0f}%"
                   f" / 2x {100 * cal['within_2x_band_frac']:.0f}%"
                   if within is not None else ""))
        dec = c.get("decisions")
        if dec:
            mix = "  ".join(f"{k}={v}" for k, v in sorted(dec.items()))
            lines.append(f"  decisions: {mix}")
        gate = c.get("gate")
        if gate:
            lines.append(f"  gate: accept={gate['accept']} "
                         f"reject={gate['reject']} "
                         f"({100 * gate['accept_rate']:.0f}% accepted)")
    return lines
