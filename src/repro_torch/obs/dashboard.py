"""The standing HTML dashboard: one self-contained static file, the port of
``repro.obs.dashboard`` (the same page from the same documents).

``write_dashboard`` folds every observability artifact the stack leaves
behind — bench documents (``bench.history``), predictor model cards
(``obs.cards``), drift and memory gauge series plus SLO status from
saved telemetry — into a single ``dashboard.html`` with **zero external
requests**: inline CSS, inline SVG charts, one small inline tooltip
script.  It renders from a file:// open with no network at all, so CI
can attach it as an artifact and anyone can open it cold.

    PYTHONPATH=src python -m repro_torch.obs dashboard \\
        -o results/dashboard.html

Chart discipline follows the data-viz method: a validated categorical
palette applied in fixed slot order (never cycled — past the slots the
tail folds into "other"), one axis per chart, 2px lines with ring-backed
end markers, thin rounded-top columns, hairline solid gridlines, text in
ink tokens (never the series color), a legend whenever two or more
series share a plot, per-mark hover tooltips with oversized hit targets,
and a table view behind every chart.  Light and dark are both shipped as
selected steps of the same hues (``prefers-color-scheme``), not an
automatic flip.
"""
from __future__ import annotations

import html as _html
import math
import os
import time
from typing import Optional, Sequence

from repro_torch.bench.history import discover, load_row
from repro_torch.obs.cards import build_cards, load_telemetry_docs
from repro_torch.obs.slo import DEFAULT_SERVE_SLOS, evaluate_slos

# reference palette (validated; see the dataviz method): first slots of
# the categorical order, light / dark steps of the same hues
SERIES_LIGHT = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                "#e87ba4", "#008300", "#4a3aa7", "#e34948")
SERIES_DARK = ("#3987e5", "#d95926", "#199e70", "#c98500",
               "#d55181", "#008300", "#9085e9", "#e66767")
MAX_SERIES = len(SERIES_LIGHT)   # fold anything past this into "other"

_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: #f9f9f7; color: #0b0b0b;
  --surface: #fcfcfb; --ink: #0b0b0b; --ink2: #52514e;
  --muted: #898781; --grid: #e1e0d9; --axis: #c3c2b7;
  --ring: rgba(11,11,11,0.10);
  --good: #0ca30c; --warning: #fab219;
  --serious: #ec835a; --critical: #d03b3b;
"""
_CSS += "".join(f"  --s{i + 1}: {c};\n" for i, c in enumerate(SERIES_LIGHT))
_CSS += """}
@media (prefers-color-scheme: dark) {
  body {
    background: #0d0d0d; color: #ffffff;
    --surface: #1a1a19; --ink: #ffffff; --ink2: #c3c2b7;
    --muted: #898781; --grid: #2c2c2a; --axis: #383835;
    --ring: rgba(255,255,255,0.10);
"""
_CSS += "".join(f"    --s{i + 1}: {c};\n" for i, c in enumerate(SERIES_DARK))
_CSS += """  }
}
h1 { font-size: 20px; font-weight: 600; margin: 0 0 4px; }
h2 { font-size: 15px; font-weight: 600; margin: 0 0 10px; }
.sub { color: var(--ink2); font-size: 12px; margin: 0 0 20px; }
section {
  background: var(--surface); border: 1px solid var(--ring);
  border-radius: 8px; padding: 16px 18px; margin: 0 0 18px;
}
.legend { display: flex; flex-wrap: wrap; gap: 14px; margin: 0 0 8px;
          font-size: 12px; color: var(--ink2); }
.legend .key { display: inline-flex; align-items: center; gap: 6px; }
.swatch { width: 10px; height: 10px; border-radius: 3px;
          display: inline-block; }
svg text { font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
           font-variant-numeric: tabular-nums; }
.axis-label { fill: var(--muted); font-size: 10px; }
.empty { color: var(--muted); font-size: 13px; }
details { margin-top: 8px; font-size: 12px; }
summary { color: var(--muted); cursor: pointer; }
table { border-collapse: collapse; margin-top: 6px; font-size: 12px; }
th, td { text-align: left; padding: 3px 12px 3px 0;
         border-bottom: 1px solid var(--grid);
         font-variant-numeric: tabular-nums; }
th { color: var(--ink2); font-weight: 600; }
.chip { display: inline-flex; align-items: center; gap: 5px;
        font-size: 12px; }
.chip .dot { width: 8px; height: 8px; border-radius: 50%;
             display: inline-block; }
.cards { display: grid; gap: 12px;
         grid-template-columns: repeat(auto-fill, minmax(260px, 1fr)); }
.card { border: 1px solid var(--ring); border-radius: 6px;
        padding: 10px 12px; font-size: 12px; }
.card .kernel { font-weight: 600; font-size: 13px; }
.card .fp { color: var(--muted); font-size: 11px; margin-bottom: 6px;
            overflow-wrap: anywhere; }
.card dl { margin: 0; display: grid; grid-template-columns: auto 1fr;
           gap: 2px 10px; }
.card dt { color: var(--ink2); }
.card dd { margin: 0; font-variant-numeric: tabular-nums; }
#tip { position: absolute; display: none; pointer-events: none;
       background: var(--surface); color: var(--ink);
       border: 1px solid var(--ring); border-radius: 4px;
       padding: 4px 8px; font-size: 12px; white-space: pre;
       box-shadow: 0 1px 4px rgba(0,0,0,0.15); z-index: 9; }
"""

# the entire interaction layer: one floating tooltip fed by data-tip
# attributes on oversized invisible hit targets
_JS = """
(function () {
  var tip = document.getElementById('tip');
  document.addEventListener('mouseover', function (e) {
    var t = e.target.closest && e.target.closest('[data-tip]');
    if (!t) { tip.style.display = 'none'; return; }
    tip.textContent = t.getAttribute('data-tip');
    tip.style.display = 'block';
  });
  document.addEventListener('mousemove', function (e) {
    if (tip.style.display === 'none') return;
    tip.style.left = (e.pageX + 14) + 'px';
    tip.style.top = (e.pageY + 14) + 'px';
  });
})();
"""


def _esc(s: object) -> str:
    return _html.escape(str(s), quote=True)


def _fmt(v: object) -> str:
    """Compact human number (1,284 / 12.9K / 4.2M)."""
    if v is None:
        return "-"
    try:
        x = float(v)
    except (TypeError, ValueError):
        return str(v)
    for div, suf in ((1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(x) >= div:
            return f"{x / div:.3g}{suf}"
    if x == int(x) and abs(x) < 1e15:
        return f"{int(x):,}"
    return f"{x:.3g}"


def _fmt_bytes(v: object) -> str:
    try:
        x = float(v)
    except (TypeError, ValueError):
        return "-"
    for div, suf in ((2 ** 30, "GiB"), (2 ** 20, "MiB"), (2 ** 10, "KiB")):
        if abs(x) >= div:
            return f"{x / div:.3g} {suf}"
    return f"{int(x)} B"


def _ticks(lo: float, hi: float, n: int = 4) -> list:
    """Clean tick values covering [lo, hi] (1/2/2.5/5 x 10^k steps)."""
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / max(n, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next((m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw),
                10 * mag)
    t0 = step * math.floor(lo / step)
    out, t = [], t0
    while True:   # last tick always reaches hi, so data never overshoots
        out.append(0.0 if abs(t) < 1e-12 else t)
        if t >= hi - 1e-9 * step:
            return out
        t += step


# -- SVG chart builders ------------------------------------------------

_W, _H = 640, 220
_PAD_L, _PAD_R, _PAD_T, _PAD_B = 58, 14, 12, 26


def _frame(y_ticks, y_lo, y_hi, y_fmt) -> list:
    """Gridlines + y tick labels + baseline for the shared plot frame."""
    out = []
    span = (y_hi - y_lo) or 1.0
    for t in y_ticks:
        y = _PAD_T + (_H - _PAD_T - _PAD_B) * (1 - (t - y_lo) / span)
        out.append(f'<line x1="{_PAD_L}" y1="{y:.1f}" x2="{_W - _PAD_R}" '
                   f'y2="{y:.1f}" stroke="var(--grid)" stroke-width="1"/>')
        out.append(f'<text x="{_PAD_L - 6}" y="{y + 3:.1f}" '
                   f'text-anchor="end" class="axis-label">'
                   f'{_esc(y_fmt(t))}</text>')
    base = _H - _PAD_B
    out.append(f'<line x1="{_PAD_L}" y1="{base}" x2="{_W - _PAD_R}" '
               f'y2="{base}" stroke="var(--axis)" stroke-width="1"/>')
    return out


def _legend(labels: Sequence[str]) -> str:
    """Legend row — always present for >= 2 series, never for one."""
    if len(labels) < 2:
        return ""
    keys = "".join(
        f'<span class="key"><span class="swatch" '
        f'style="background:var(--s{i + 1})"></span>{_esc(lb)}</span>'
        for i, lb in enumerate(labels))
    return f'<div class="legend">{keys}</div>'


def _table(headers: Sequence[str], rows: Sequence[Sequence[object]]) -> str:
    """The table view behind every chart (accessibility channel)."""
    head = "".join(f"<th>{_esc(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in r) + "</tr>"
        for r in rows)
    return ("<details><summary>table view</summary><table>"
            f"<tr>{head}</tr>{body}</table></details>")


def _line_chart(series: Sequence[tuple], x_fmt=_fmt, y_fmt=_fmt,
                tip_fmt=None) -> str:
    """Multi-series line chart: ``series`` is [(label, [(x, y), ...])].

    2px round-capped lines, ring-backed end markers, invisible r=10
    hover targets per point, hairline solid grid, one y axis."""
    series = [(lb, [(float(x), float(y)) for x, y in pts])
              for lb, pts in series if pts][:MAX_SERIES]
    if not series:
        return '<p class="empty">no data</p>'
    xs = [x for _, pts in series for x, _ in pts]
    ys = [y for _, pts in series for _, y in pts]
    x_lo, x_hi = min(xs), max(xs)
    y_lo = min(0.0, min(ys))
    y_ticks = _ticks(y_lo, max(ys) or 1.0)
    y_lo, y_hi = min(y_ticks), max(y_ticks)
    x_span = (x_hi - x_lo) or 1.0
    y_span = (y_hi - y_lo) or 1.0

    def px(x):
        return _PAD_L + (_W - _PAD_L - _PAD_R) * (x - x_lo) / x_span

    def py(y):
        return _PAD_T + (_H - _PAD_T - _PAD_B) * (1 - (y - y_lo) / y_span)

    parts = _frame(y_ticks, y_lo, y_hi, y_fmt)
    for t in (x_lo, x_hi) if x_hi > x_lo else (x_lo,):
        anchor = "start" if t == x_lo and x_hi > x_lo else "end"
        parts.append(f'<text x="{px(t):.1f}" y="{_H - _PAD_B + 14}" '
                     f'text-anchor="{anchor}" class="axis-label">'
                     f'{_esc(x_fmt(t))}</text>')
    hits = []
    for i, (label, pts) in enumerate(series):
        color = f"var(--s{i + 1})"
        if len(pts) > 1:
            coords = " ".join(f"{px(x):.1f},{py(y):.1f}" for x, y in pts)
            parts.append(f'<polyline points="{coords}" fill="none" '
                         f'stroke="{color}" stroke-width="2" '
                         'stroke-linejoin="round" stroke-linecap="round"/>')
        ex, ey = pts[-1]
        parts.append(f'<circle cx="{px(ex):.1f}" cy="{py(ey):.1f}" r="4" '
                     f'fill="{color}" stroke="var(--surface)" '
                     'stroke-width="2"/>')
        for x, y in pts:
            tip = tip_fmt(label, x, y) if tip_fmt else \
                f"{label}\n{x_fmt(x)}: {y_fmt(y)}"
            hits.append(f'<circle cx="{px(x):.1f}" cy="{py(y):.1f}" '
                        f'r="10" fill="transparent" '
                        f'data-tip="{_esc(tip)}"/>')
    parts += hits   # hit layer on top so hover always wins
    return (f'<svg viewBox="0 0 {_W} {_H}" width="100%" '
            f'role="img">{"".join(parts)}</svg>')


def _bar_path(x: float, y: float, w: float, h: float, r: float = 4) -> str:
    """Column path: 4px rounded data-end (top), square at the baseline."""
    r = min(r, w / 2, h)
    return (f"M{x:.1f},{y + h:.1f} v{-(h - r):.1f} "
            f"q0,{-r:.1f} {r:.1f},{-r:.1f} h{w - 2 * r:.1f} "
            f"q{r:.1f},0 {r:.1f},{r:.1f} v{h - r:.1f} z")


def _grouped_columns(groups: Sequence[str], labels: Sequence[str],
                     values: Sequence[Sequence[Optional[float]]],
                     y_fmt=_fmt) -> str:
    """Grouped columns (one cluster per group, one column per label):
    <= 24px thick, 2px surface gaps, rounded tops, cap labels."""
    labels = list(labels)[:MAX_SERIES]
    flat = [v for row in values for v in row[:len(labels)] if v is not None]
    if not groups or not flat:
        return '<p class="empty">no data</p>'
    y_ticks = _ticks(0.0, max(flat) or 1.0)
    y_hi = max(y_ticks)
    base = _H - _PAD_B
    plot_w = _W - _PAD_L - _PAD_R
    slot = plot_w / len(groups)
    bar_w = min(24.0, max(6.0, (slot * 0.6 - 2 * (len(labels) - 1))
                          / len(labels)))
    cluster_w = bar_w * len(labels) + 2 * (len(labels) - 1)
    parts = _frame(y_ticks, 0.0, y_hi, y_fmt)
    for gi, group in enumerate(groups):
        x0 = _PAD_L + slot * gi + (slot - cluster_w) / 2
        parts.append(f'<text x="{x0 + cluster_w / 2:.1f}" '
                     f'y="{base + 14}" text-anchor="middle" '
                     f'class="axis-label">{_esc(group)}</text>')
        for si, label in enumerate(labels):
            v = values[gi][si] if si < len(values[gi]) else None
            if v is None:
                continue
            h = (base - _PAD_T) * (v / y_hi) if y_hi else 0.0
            x = x0 + si * (bar_w + 2)
            parts.append(
                f'<path d="{_bar_path(x, base - h, bar_w, h)}" '
                f'fill="var(--s{si + 1})" '
                f'data-tip="{_esc(f"{group} {label}: {y_fmt(v)}")}"/>')
            parts.append(f'<text x="{x + bar_w / 2:.1f}" '
                         f'y="{base - h - 4:.1f}" text-anchor="middle" '
                         f'class="axis-label">{_esc(y_fmt(v))}</text>')
    return (f'<svg viewBox="0 0 {_W} {_H}" width="100%" '
            f'role="img">{"".join(parts)}</svg>')


# -- sections ----------------------------------------------------------

def _section(title: str, body: str, note: str = "") -> str:
    sub = f'<p class="sub">{_esc(note)}</p>' if note else ""
    return f"<section><h2>{_esc(title)}</h2>{sub}{body}</section>"


def _bench_section(results_dir: str) -> str:
    patterns = (os.path.join(results_dir, "bench*.json"),
                "benchmarks/*bench*.json")
    rows = [load_row(p) for p in discover(patterns)]
    rows = [r for r in rows if "error" not in r]
    rows.sort(key=lambda r: (r.get("generated_unix") or 0, r["file"]))
    if not rows:
        return _section("Bench history",
                        '<p class="empty">no bench documents found</p>')
    configs = sorted({c for r in rows for c in r["geomean_vs_default"]})
    series = []
    for cfg in configs:
        pts = [(i, r["geomean_vs_default"][cfg]) for i, r in enumerate(rows)
               if isinstance(r["geomean_vs_default"].get(cfg),
                             (int, float))]
        if pts:
            series.append((cfg, pts))
    ad_pts = [(i, r["adaptive_geomean"]) for i, r in enumerate(rows)
              if isinstance(r.get("adaptive_geomean"), (int, float))]
    if ad_pts:
        series.append(("adaptive", ad_pts))

    def x_fmt(x):
        r = rows[int(round(x))] if 0 <= int(round(x)) < len(rows) else None
        g = r.get("generated_unix") if r else None
        return time.strftime("%m-%d %H:%M", time.localtime(g)) \
            if isinstance(g, (int, float)) else f"run {int(round(x))}"

    def tip_fmt(label, x, y):
        r = rows[int(round(x))]
        return (f"{label}: {y:.2f}x\n{os.path.basename(r['file'])}"
                + (f"\n{x_fmt(x)}" if r.get("generated_unix") else ""))

    chart = _line_chart(series, x_fmt=x_fmt, y_fmt=lambda v: f"{v:g}x",
                        tip_fmt=tip_fmt)
    table = _table(
        ["file", "schema", "quick", "workloads", "drift flags"]
        + configs + ["adaptive"],
        [[r["file"], r.get("schema"), "yes" if r.get("quick") else "no",
          r["n_workloads"], len(r["drift_flags"])]
         + [_fmt(r["geomean_vs_default"].get(c)) for c in configs]
         + [_fmt(r.get("adaptive_geomean"))] for r in rows])
    return _section(
        "Bench history", _legend([lb for lb, _ in series]) + chart + table,
        note="geomean speedup vs the default config, one point per saved "
             "bench document")


def _chip(kind: str, text: str) -> str:
    """Status chip: icon + label + color — never color alone."""
    icon = {"good": "&#10003;", "critical": "&#10007;"}.get(kind, "&#8211;")
    var = f"var(--{kind})" if kind in ("good", "warning", "serious",
                                       "critical") else "var(--muted)"
    return (f'<span class="chip"><span class="dot" '
            f'style="background:{var}"></span>{icon} {_esc(text)}</span>')


def _slo_section(slos, docs: dict) -> str:
    if not docs:
        return _section("SLO status",
                        '<p class="empty">no telemetry documents found</p>')
    rows, trs = [], []
    for path, doc in sorted(docs.items()):
        for r in evaluate_slos(slos, doc):
            status = ("no data", "muted") if r["met"] is None else \
                (("ok", "good") if r["met"] else ("BURNED", "critical"))
            rows.append([os.path.basename(path), r["slo"],
                         _fmt(r["target"]), _fmt(r["observed"]),
                         f"{r['burn_rate']:.2f}x" if r["burn_rate"]
                         is not None else "-", status[0]])
            trs.append(
                "<tr>" + "".join(
                    f"<td>{_esc(c)}</td>" for c in rows[-1][:-1])
                + f"<td>{_chip(status[1], status[0])}</td></tr>")
    head = "".join(f"<th>{h}</th>" for h in
                   ("telemetry", "slo", "target", "observed", "burn",
                    "status"))
    return _section(
        "SLO status", f"<table><tr>{head}</tr>{''.join(trs)}</table>",
        note="burn rate = observed / target; no-data rows never burn")


def _series_points(doc: dict, prefix: str) -> list:
    """[(suffix, [(t, v), ...])] for every gauge series under prefix."""
    out = []
    for name, pts in sorted((doc.get("series") or {}).items()):
        if name.startswith(prefix) and pts:
            out.append((name[len(prefix):],
                        [(float(t), float(v)) for t, v in pts]))
    return out


def _memory_section(docs: dict) -> str:
    # the freshest document that carries a memory ledger
    best = None
    for path, doc in sorted(docs.items()):
        if _series_points(doc, "mem.live_bytes."):
            best = (path, doc)
    if best is None:
        return _section("Memory ledger",
                        '<p class="empty">no mem.* gauge series in the '
                        'discovered telemetry</p>')
    path, doc = best
    live = _series_points(doc, "mem.live_bytes.")
    chart = _line_chart(live, x_fmt=lambda t: f"{t:.3g}s",
                        y_fmt=_fmt_bytes)
    peaks = dict(_series_points(doc, "mem.peak_bytes."))
    pred = dict(_series_points(doc, "mem.predicted_peak_bytes."))
    devices = sorted(set(peaks) | set(pred))
    bars = _grouped_columns(
        devices, ["predicted peak", "measured peak"],
        [[pred[d][-1][1] if d in pred else None,
          peaks[d][-1][1] if d in peaks else None] for d in devices],
        y_fmt=_fmt_bytes) if devices else ""
    table = _table(
        ["device", "predicted peak", "measured peak", "ratio"],
        [[d, _fmt_bytes(pred[d][-1][1]) if d in pred else "-",
          _fmt_bytes(peaks[d][-1][1]) if d in peaks else "-",
          f"{peaks[d][-1][1] / pred[d][-1][1]:.2f}x"
          if d in pred and d in peaks and pred[d][-1][1] else "-"]
         for d in devices])
    return _section(
        "Memory ledger",
        _legend([lb for lb, _ in live]) + chart
        + (_legend(["predicted peak", "measured peak"]) + bars + table
           if devices else ""),
        note=f"live bytes per device over the run clock, and compile-time "
             f"predicted vs measured peaks ({os.path.basename(path)})")


def _drift_section(docs: dict) -> str:
    # one timeline per kernel from the freshest doc that has any
    best = None
    for path, doc in sorted(docs.items()):
        if _series_points(doc, "drift.live_mape."):
            best = (path, doc)
    if best is None:
        return _section("Drift timelines",
                        '<p class="empty">no drift.live_mape.* series in '
                        'the discovered telemetry</p>')
    path, doc = best
    series = _series_points(doc, "drift.live_mape.")
    chart = _line_chart(series, x_fmt=lambda t: f"{t:.3g}s",
                        y_fmt=lambda v: f"{v:g}%")
    table = _table(
        ["kernel", "points", "last live MAPE"],
        [[k, len(pts), f"{pts[-1][1]:.2f}%"] for k, pts in series])
    return _section(
        "Drift timelines",
        _legend([lb for lb, _ in series]) + chart + table,
        note=f"rolling live MAPE per kernel over the run clock "
             f"({os.path.basename(path)})")


def _explain_section(results_dir: str) -> str:
    """Makespan attribution of the freshest saved execution trace:
    critical-path bucket columns, the misprediction ranking, and per-lane
    utilization — the ``obs.explain`` analysis rendered standing."""
    import glob as _glob
    import json as _json

    from repro_torch.obs.explain import analyze_chrome
    paths = sorted(_glob.glob(os.path.join(results_dir,
                                           "exec_trace*.json")),
                   key=lambda p: os.path.getmtime(p), reverse=True)
    analysis = path = None
    for p in paths:
        try:
            with open(p) as f:
                doc = analyze_chrome(_json.load(f))
        except (OSError, ValueError, KeyError):
            continue
        if not doc.get("empty"):
            analysis, path = doc, p
            break
    if analysis is None:
        return _section("Makespan attribution",
                        '<p class="empty">no analyzable execution trace '
                        'found</p>')
    buckets = analysis["buckets"]
    names = list(buckets)[:MAX_SERIES]
    bars = _grouped_columns(
        names, ["seconds"], [[buckets[b]] for b in names],
        y_fmt=lambda v: f"{v * 1e3:.3g}ms")
    cp = analysis["critical_path"]
    summary = (f'<p class="sub">makespan {analysis["makespan_s"] * 1e3:.2f}'
               f' ms over {analysis["n_tasks"]} tasks '
               f'({analysis["n_steals"]} steals) &middot; top bottleneck '
               f'<b>{_esc(analysis["top_bottleneck"])}</b> &middot; '
               f'critical path {len(cp)} links &middot; attribution '
               f'residual {100 * analysis["residual_frac"]:.3f}%</p>')
    mis_rows = [[g["kernel"], g["shape_bucket"],
                 f'{g["cost_s"] * 1e3:.2f} ms', f'{g["ape_pct"]:.1f}%',
                 f'{g["fit_band_pct"]:.1f}%'
                 if isinstance(g.get("fit_band_pct"), (int, float))
                 else "-",
                 ",".join(g["lanes"]),
                 "EXCEEDS" if g["exceeds_fit_band"] else "ok"]
                for g in analysis["mispredictions"]]
    mis = ""
    if mis_rows:
        head = "".join(f"<th>{h}</th>" for h in
                       ("kernel", "shape bucket", "makespan cost", "ape",
                        "fit band", "lanes", "band"))
        body = "".join("<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in r)
                       + "</tr>" for r in mis_rows)
        mis = ("<h2>misprediction attribution (critical chain)</h2>"
               f"<table><tr>{head}</tr>{body}</table>")
    lane_rows = [[lane, u["n_tasks"], f'{100 * u["busy_frac"]:.1f}%',
                  f'{100 * u["wait_frac"]:.1f}%',
                  f'{100 * u["idle_frac"]:.1f}%']
                 for lane, u in sorted(analysis["lanes"].items())]
    lanes = _table(["lane", "tasks", "busy", "wait", "idle"], lane_rows)
    return _section(
        "Makespan attribution",
        summary + bars
        + _table(["bucket", "seconds", "share"],
                 [[b, f"{v:.6f}",
                   f"{100 * v / max(analysis['makespan_s'], 1e-12):.1f}%"]
                  for b, v in buckets.items()])
        + mis + lanes,
        note=f"critical-path attribution of "
             f"{os.path.basename(path)} — where the realized makespan "
             f"went, and which mispredictions cost schedule time")


def _cards_section(cards: list) -> str:
    if not cards:
        return _section("Predictor model cards",
                        '<p class="empty">no tunecache entries found</p>')
    tiles = []
    for c in cards:
        fp = c.get("fingerprint", {})
        head = (f'<div class="kernel">{_esc(c["kernel"])}</div>'
                f'<div class="fp">{_esc(fp.get("key", "?"))}</div>')
        if "error" in c:
            tiles.append(f'<div class="card">{head}'
                         f'{_chip("critical", c["error"])}</div>')
            continue
        cal = c.get("calibration") or {}
        gate = c.get("gate") or {}
        dec = c.get("decisions") or {}
        rows = [
            ("model", c.get("model") or "unfitted"),
            ("rows / buckets", f'{c.get("n_rows", 0)} / '
                               f'{c.get("n_buckets", 0)}'),
            ("fit MAPE", f'{c["fit_mape_pct"]:.2f}%'
             if isinstance(c.get("fit_mape_pct"), (int, float)) else "-"),
            ("live MAPE", f'{c["live_mape_pct"]:.2f}%'
             if isinstance(c.get("live_mape_pct"), (int, float)) else "-"),
        ]
        if cal:
            rows.append(("calibration",
                         f'p50 {cal["p50_ape_pct"]:.1f}% / '
                         f'p90 {cal["p90_ape_pct"]:.1f}%'))
            if cal.get("within_band_frac") is not None:
                rows.append(("within band",
                             f'{100 * cal["within_band_frac"]:.0f}% (2x: '
                             f'{100 * cal["within_2x_band_frac"]:.0f}%)'))
        if dec:
            rows.append(("decisions", "  ".join(
                f"{k}={v}" for k, v in sorted(dec.items()))))
        if gate:
            total = gate["accept"] + gate["reject"]
            rows.append(("gate accept",
                         f'{100 * gate["accept_rate"]:.0f}% '
                         f'({gate["accept"]}/{total})'))
        dl = "".join(f"<dt>{_esc(k)}</dt><dd>{_esc(v)}</dd>"
                     for k, v in rows)
        tiles.append(f'<div class="card">{head}<dl>{dl}</dl></div>')
    return _section("Predictor model cards",
                    f'<div class="cards">{"".join(tiles)}</div>',
                    note="coverage, accuracy, calibration, and decision "
                         "mix per (kernel, fingerprint) — the warm-start "
                         "record for cross-hardware transfer")


# -- entry point -------------------------------------------------------

def render_dashboard(results_dir: str = "results",
                     slos: Optional[Sequence] = None) -> str:
    """The full HTML document as a string (no file I/O besides reads)."""
    tel_pattern = os.path.join(results_dir, "telemetry_*.json")
    docs = load_telemetry_docs((tel_pattern,))
    cards = build_cards(cache_root=os.path.join(results_dir, "tunecache"),
                        telemetry_patterns=(tel_pattern,))
    body = "".join([
        _slo_section(slos or DEFAULT_SERVE_SLOS, docs),
        _bench_section(results_dir),
        _memory_section(docs),
        _drift_section(docs),
        _explain_section(results_dir),
        _cards_section(cards),
    ])
    when = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
    return ("<!DOCTYPE html>\n"
            '<html lang="en"><head><meta charset="utf-8">\n'
            '<meta name="viewport" '
            'content="width=device-width, initial-scale=1">\n'
            "<title>repro observability dashboard</title>\n"
            f"<style>{_CSS}</style></head><body>\n"
            "<h1>repro observability dashboard</h1>\n"
            f'<p class="sub">generated {_esc(when)} from '
            f"{_esc(results_dir)}/ &middot; self-contained: no external "
            "requests</p>\n"
            f'{body}<div id="tip"></div>'
            f"<script>{_JS}</script></body></html>\n")


def write_dashboard(out_path: str, results_dir: str = "results",
                    slos: Optional[Sequence] = None) -> str:
    """Render and atomically write the dashboard; returns ``out_path``."""
    doc = render_dashboard(results_dir=results_dir, slos=slos)
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{out_path}.tmp"
    with open(tmp, "w") as f:
        f.write(doc)
    os.replace(tmp, out_path)
    return out_path
