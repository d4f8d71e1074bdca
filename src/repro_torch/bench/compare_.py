"""``bench compare``: diff two bench.json documents, flag regressions, the
port of ``repro.bench.compare_`` (documents of either package compare).

Comparison is deliberately *relative*: absolute wall seconds differ
between machines, so the regression signal is the stuff prediction is
supposed to buy — per-config geomean speedups, per-workload speedups,
and per-kernel model MAPE — plus coverage (a workload or config present
in the baseline must not vanish).  A regression list is returned (empty
means clean); the CLI exits nonzero when it is non-empty, which CI treats
as a non-blocking warning.
"""
from __future__ import annotations

SPEEDUP_KEYS = ("speedup_vs_worst", "speedup_vs_default")


def _top_bottleneck(doc: dict):
    """The document's dominant makespan bucket across every schema-5
    ``attribution`` block (workloads x configs + adaptive), or None."""
    buckets: dict = {}
    atts = [r.get("attribution")
            for w in doc.get("workloads", {}).values()
            if isinstance(w, dict)
            for r in (w.get("configs") or {}).values()
            if isinstance(r, dict)]
    atts.append((doc.get("adaptive") or {}).get("attribution"))
    for att in atts:
        if isinstance(att, dict):
            for b, v in (att.get("buckets") or {}).items():
                if isinstance(v, (int, float)):
                    buckets[b] = buckets.get(b, 0.0) + float(v)
    return max(buckets, key=buckets.get) if buckets else None


REAL_SLACK = 3.0        # real-hardware MAPE thresholds get this factor;
                        # sim configs are held tight


def compare_docs(baseline: dict, new: dict, rel_tol: float = 0.10,
                 mape_tol: float = 10.0, only_kind: str = None) -> tuple:
    """Return ``(regressions, notes)`` — lists of human-readable strings.

    ``rel_tol`` is the allowed relative drop in a geomean speedup (per-
    workload speedups get twice the slack: single-DAG numbers are
    noisier); ``mape_tol`` is the allowed absolute rise in per-kernel
    MAPE, in percentage points.

    Configs whose ``kind`` is ``"real"`` are checked for *coverage* and
    *model quality* (MAPE, at ``REAL_SLACK`` times the tolerance) only —
    their wall-clock speedup ratios depend on which variant each fresh
    tuning pass crowns predicted-worst, which swings by several x run to
    run on a shared host, so thresholding them would only produce alert
    fatigue.  Sim configs realize a deterministic schedule and their
    speedups are held to the stated tolerances.

    ``only_kind`` (``"sim"`` | ``"real"``) restricts the comparison to
    configs of that kind — how CI splits the gate: the deterministic sim
    half blocks, the host-noise real half only warns.  The ``adaptive``
    section (simulated by construction) is compared under ``"sim"``.
    """
    regressions, notes = [], []
    if only_kind not in (None, "sim", "real"):
        raise ValueError(f"only_kind must be None, 'sim' or 'real', "
                         f"got {only_kind!r}")

    def is_real(cfg: str) -> bool:
        return baseline.get("configs", {}).get(cfg, {}).get("kind") \
            == "real"

    def skip(cfg: str) -> bool:
        return only_kind is not None and \
            baseline.get("configs", {}).get(cfg, {}).get("kind") != only_kind

    for cfg, g in baseline.get("geomean", {}).items():
        if skip(cfg):
            continue
        ng = new.get("geomean", {}).get(cfg)
        if ng is None:
            regressions.append(f"geomean: config {cfg!r} missing from new")
            continue
        if is_real(cfg):
            notes.append(f"geomean[{cfg}]: wall-clock speedups not "
                         "thresholded (real-hardware config)")
            continue
        for key in SPEEDUP_KEYS:
            old_v, new_v = float(g[key]), float(ng[key])
            if new_v < old_v * (1.0 - rel_tol):
                regressions.append(
                    f"geomean[{cfg}].{key}: {old_v:.3f} -> {new_v:.3f} "
                    f"(drop > {100 * rel_tol:.0f}%)")
            elif new_v > old_v * (1.0 + rel_tol):
                notes.append(f"geomean[{cfg}].{key}: improved "
                             f"{old_v:.3f} -> {new_v:.3f}")

    for wname, w in baseline.get("workloads", {}).items():
        nw = new.get("workloads", {}).get(wname)
        if nw is None:
            regressions.append(f"workload {wname!r} missing from new")
            continue
        for cfg, r in w.get("configs", {}).items():
            if skip(cfg):
                continue
            nr = nw.get("configs", {}).get(cfg)
            if nr is None:
                regressions.append(
                    f"{wname}[{cfg}]: config missing from new")
                continue
            if not is_real(cfg):
                tol = 2.0 * rel_tol
                for key in SPEEDUP_KEYS:
                    old_v, new_v = float(r[key]), float(nr[key])
                    if new_v < old_v * (1.0 - tol):
                        regressions.append(
                            f"{wname}[{cfg}].{key}: "
                            f"{old_v:.3f} -> {new_v:.3f} "
                            f"(drop > {100 * tol:.0f}%)")
            m_tol = mape_tol * (REAL_SLACK if is_real(cfg) else 1.0)
            for kernel, old_m in r.get("mape", {}).items():
                new_m = nr.get("mape", {}).get(kernel)
                if new_m is None:
                    regressions.append(
                        f"{wname}[{cfg}].mape.{kernel}: missing from new")
                elif float(new_m) > float(old_m) + m_tol:
                    regressions.append(
                        f"{wname}[{cfg}].mape.{kernel}: "
                        f"{float(old_m):.1f}% -> {float(new_m):.1f}% "
                        f"(rise > {m_tol:.0f}pp)")

    if only_kind in (None, "sim"):
        old_ad, new_ad = baseline.get("adaptive"), new.get("adaptive")
        if old_ad and new_ad:
            key = "geomean_speedup_vs_static"
            # single-scenario number over few workloads: same 2x slack the
            # per-workload speedups get
            rel_tol = 2.0 * rel_tol
            old_v, new_v = float(old_ad[key]), float(new_ad[key])
            if new_v < old_v * (1.0 - rel_tol):
                regressions.append(
                    f"adaptive.{key}: {old_v:.3f} -> {new_v:.3f} "
                    f"(drop > {100 * rel_tol:.0f}%)")
            elif new_v > old_v * (1.0 + rel_tol):
                notes.append(f"adaptive.{key}: improved "
                             f"{old_v:.3f} -> {new_v:.3f}")
            broken = [n for n, w in new_ad.get("workloads", {}).items()
                      if not w.get("bit_exact", True)]
            if broken:
                regressions.append(
                    f"adaptive: bit-exactness lost on {sorted(broken)}")
        elif old_ad and not new_ad:
            regressions.append("adaptive section missing from new "
                               "(present in baseline)")
        elif new_ad and not old_ad:
            notes.append("adaptive section new (absent in baseline) — "
                         "not compared")

    # a shifted dominant bucket is a structural change worth a note (not a
    # regression: attribution shape has no better/worse ordering)
    old_tb, new_tb = _top_bottleneck(baseline), _top_bottleneck(new)
    if old_tb is not None and new_tb is not None and old_tb != new_tb:
        notes.append(f"top bottleneck shifted: {old_tb} -> {new_tb}")
    return regressions, notes


def format_compare(regressions: list, notes: list) -> list:
    lines = []
    if regressions:
        lines.append(f"REGRESSIONS ({len(regressions)}):")
        lines += [f"  - {r}" for r in regressions]
    else:
        lines.append("no regressions vs baseline")
    for n in notes:
        lines.append(f"  note: {n}")
    return lines
