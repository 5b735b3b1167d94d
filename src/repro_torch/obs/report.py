"""Self-contained static HTML run reports.

One ``.html`` file per run (or per sweep report), rendered from an event
log with inline SVG charts — zero new dependencies, no external assets, so
the file is a durable committed/CI artifact that opens anywhere.

Run reports show the manifest header (seed, spec hash, git SHA),
headline stat tiles, and three chart rows: per-pool clearing prices, the
rolling interruption intensity with detected storm bands, and per-pool
occupancy (the fleet-capacity view).  Sweep reports render the aggregate
mean ± CI table plus a bar chart per headline metric.

Entry points: :func:`render_report` / :func:`render_sweep_report` return
HTML strings; :func:`write_html_report` dispatches on the input (event log
vs sweep report dict) and writes the file.
"""
from __future__ import annotations

import html
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .analyze import (
    interruption_intensity,
    pool_risk_series,
    serve_series,
    storm_intervals,
)
from .eventlog import EventLog, load_event_log

_PALETTE = ("#2563eb", "#dc2626", "#16a34a", "#d97706", "#7c3aed",
            "#0891b2", "#be185d", "#4d7c0f")

_CSS = """
body{font-family:system-ui,sans-serif;margin:24px;color:#1f2937;
     max-width:1080px}
h1{font-size:20px;margin-bottom:4px} h2{font-size:15px;margin:24px 0 6px}
.manifest{font-size:12px;color:#6b7280;border-collapse:collapse}
.manifest td{padding:1px 12px 1px 0}
.tiles{display:flex;gap:12px;flex-wrap:wrap;margin:16px 0}
.tile{border:1px solid #e5e7eb;border-radius:8px;padding:8px 14px}
.tile .v{font-size:20px;font-weight:600}
.tile .k{font-size:11px;color:#6b7280;text-transform:uppercase}
table.agg{border-collapse:collapse;font-size:12px}
table.agg th,table.agg td{border:1px solid #e5e7eb;padding:3px 8px;
                          text-align:right}
table.agg th{background:#f9fafb}
.legend{font-size:11px;color:#6b7280;margin:2px 0 10px}
.legend span{margin-right:14px}
svg{background:#fcfcfd;border:1px solid #e5e7eb;border-radius:6px}
"""


def _esc(s) -> str:
    return html.escape(str(s))


def _axis_ticks(lo: float, hi: float, n: int = 4) -> List[float]:
    if hi <= lo:
        return [lo]
    return [lo + (hi - lo) * i / n for i in range(n + 1)]


def _svg_line_chart(series: Sequence[Tuple[str, np.ndarray, np.ndarray]],
                    width: int = 980, height: int = 220,
                    y_label: str = "", bands: Sequence[Tuple[float, float]]
                    = ()) -> str:
    """A multi-series SVG polyline chart.  ``series`` is ``(label, xs,
    ys)`` triples sharing one x/y scale; ``bands`` draws shaded x-axis
    intervals (storm windows) behind the lines."""
    pad_l, pad_r, pad_t, pad_b = 56, 12, 10, 26
    pw, ph = width - pad_l - pad_r, height - pad_t - pad_b
    xs_all = [xs for _, xs, _ in series if len(xs)]
    ys_all = [ys for _, _, ys in series if len(ys)]
    if not xs_all:
        return f'<svg width="{width}" height="{height}"><text x="12" ' \
               f'y="24" font-size="12">(no data)</text></svg>'
    x_lo = min(float(np.nanmin(x)) for x in xs_all)
    x_hi = max(float(np.nanmax(x)) for x in xs_all)
    y_lo = min(0.0, min(float(np.nanmin(y)) for y in ys_all))
    y_hi = max(float(np.nanmax(y)) for y in ys_all)
    if x_hi <= x_lo:
        x_hi = x_lo + 1.0
    if y_hi <= y_lo:
        y_hi = y_lo + 1.0

    def X(v):
        return pad_l + (v - x_lo) / (x_hi - x_lo) * pw

    def Y(v):
        return pad_t + ph - (v - y_lo) / (y_hi - y_lo) * ph

    parts = [f'<svg width="{width}" height="{height}" '
             f'viewBox="0 0 {width} {height}" '
             f'xmlns="http://www.w3.org/2000/svg">']
    for b0, b1 in bands:
        parts.append(
            f'<rect x="{X(b0):.1f}" y="{pad_t}" '
            f'width="{max(X(b1) - X(b0), 2.0):.1f}" height="{ph}" '
            f'fill="#fee2e2" opacity="0.8"/>')
    for tv in _axis_ticks(y_lo, y_hi):
        y = Y(tv)
        parts.append(f'<line x1="{pad_l}" y1="{y:.1f}" '
                     f'x2="{width - pad_r}" y2="{y:.1f}" '
                     f'stroke="#eef0f3"/>')
        parts.append(f'<text x="{pad_l - 6}" y="{y + 3:.1f}" '
                     f'font-size="10" fill="#6b7280" '
                     f'text-anchor="end">{tv:.3g}</text>')
    for tv in _axis_ticks(x_lo, x_hi, 6):
        x = X(tv)
        parts.append(f'<text x="{x:.1f}" y="{height - 8}" font-size="10" '
                     f'fill="#6b7280" text-anchor="middle">{tv:.4g}</text>')
    for i, (_label, xs, ys) in enumerate(series):
        xs = np.asarray(xs, float)
        ys = np.asarray(ys, float)
        keep = np.isfinite(xs) & np.isfinite(ys)
        xs, ys = xs[keep], ys[keep]
        if xs.size == 0:
            continue
        pts = " ".join(f"{X(x):.1f},{Y(y):.1f}" for x, y in zip(xs, ys))
        color = _PALETTE[i % len(_PALETTE)]
        parts.append(f'<polyline points="{pts}" fill="none" '
                     f'stroke="{color}" stroke-width="1.4"/>')
    if y_label:
        parts.append(f'<text x="4" y="{pad_t + 10}" font-size="10" '
                     f'fill="#6b7280">{_esc(y_label)}</text>')
    parts.append("</svg>")
    return "".join(parts)


def _legend(labels: Sequence[str]) -> str:
    spans = "".join(
        f'<span style="color:{_PALETTE[i % len(_PALETTE)]}">&#9632; '
        f'{_esc(lb)}</span>' for i, lb in enumerate(labels))
    return f'<div class="legend">{spans}</div>'


def _svg_bar_chart(labels: Sequence[str], means: Sequence[float],
                   errs: Sequence[float], width: int = 980,
                   height: int = 180) -> str:
    pad_l, pad_r, pad_t, pad_b = 56, 12, 10, 54
    pw, ph = width - pad_l - pad_r, height - pad_t - pad_b
    hi = max([m + e for m, e in zip(means, errs)] + [1e-9])
    parts = [f'<svg width="{width}" height="{height}" '
             f'viewBox="0 0 {width} {height}" '
             f'xmlns="http://www.w3.org/2000/svg">']
    n = max(len(labels), 1)
    bw = min(48.0, pw / n * 0.6)
    for i, (lb, m, e) in enumerate(zip(labels, means, errs)):
        cx = pad_l + pw * (i + 0.5) / n
        h = ph * m / hi
        y = pad_t + ph - h
        color = _PALETTE[i % len(_PALETTE)]
        parts.append(f'<rect x="{cx - bw / 2:.1f}" y="{y:.1f}" '
                     f'width="{bw:.1f}" height="{h:.1f}" '
                     f'fill="{color}" opacity="0.85"/>')
        if e > 0:
            e_px = ph * e / hi
            parts.append(f'<line x1="{cx:.1f}" y1="{y - e_px:.1f}" '
                         f'x2="{cx:.1f}" y2="{min(y + e_px, pad_t + ph):.1f}"'
                         f' stroke="#374151" stroke-width="1.2"/>')
        parts.append(f'<text x="{cx:.1f}" y="{y - 4 if h else y - 4:.1f}" '
                     f'font-size="10" text-anchor="middle">{m:.3g}</text>')
        parts.append(
            f'<text x="{cx:.1f}" y="{height - 40}" font-size="10" '
            f'fill="#6b7280" text-anchor="middle" '
            f'transform="rotate(18 {cx:.1f} {height - 40})">'
            f'{_esc(lb)}</text>')
    parts.append("</svg>")
    return "".join(parts)


def _manifest_table(manifest: Optional[dict]) -> str:
    if not manifest:
        return ""
    keys = ("seed", "spec_sha256", "git_sha", "created", "duration_s")
    rows = "".join(
        f"<tr><td>{_esc(k)}</td><td><code>{_esc(manifest[k])}</code></td>"
        f"</tr>" for k in keys if k in manifest)
    return f'<table class="manifest">{rows}</table>'


def _tiles(stats: Dict[str, object]) -> str:
    return '<div class="tiles">' + "".join(
        f'<div class="tile"><div class="v">{_esc(v)}</div>'
        f'<div class="k">{_esc(k)}</div></div>'
        for k, v in stats.items()) + "</div>"


# ---------------------------------------------------------------------------
# run report
# ---------------------------------------------------------------------------
def render_report(src: Union[EventLog, str],
                  manifest: Optional[dict] = None,
                  title: str = "Run report") -> str:
    """One run's HTML report from its event log: manifest header, stat
    tiles, price / interruption-intensity / occupancy charts."""
    log = load_event_log(src) if isinstance(src, str) else src
    arr = log.to_arrays()
    kinds = {str(k): log.kind_id(str(k)) for k in arr["kinds"]}

    def count(kind: str) -> int:
        return int((arr["kind"] == kinds[kind]).sum()) if kind in kinds \
            else 0

    pools = sorted(int(p) for p in np.unique(
        arr["pool"][arr["pool"] >= 0])) if len(log) else []
    stats = {
        "events": len(log),
        "interruptions": count("interrupt"),
        "waves": count("wave"),
        "migrations": count("migrate-start"),
        "fleet launches": count("fleet-launch"),
        "faults": count("fault"),
    }
    storms = storm_intervals(log)
    bands = [(s["t0"], s["t1"]) for s in storms]
    body = [f"<h1>{_esc(title)}</h1>", _manifest_table(manifest),
            _tiles(stats)]
    risk = {p: pool_risk_series(log, p) for p in pools}
    if any(r["t"].size for r in risk.values()):
        body.append("<h2>Clearing price per pool</h2>")
        body.append(_legend([f"pool {p}" for p in pools]))
        body.append(_svg_line_chart(
            [(f"pool {p}", risk[p]["t"], risk[p]["price"]) for p in pools],
            y_label="$/h", bands=bands))
        body.append("<h2>Bid danger margin per pool "
                    "(mean admitted bid &minus; price)</h2>")
        body.append(_svg_line_chart(
            [(f"pool {p}", risk[p]["t"], risk[p]["danger_margin"])
             for p in pools], y_label="$/h"))
    it, iv = interruption_intensity(log)
    body.append("<h2>Interruption intensity (rolling)"
                + (f" — {len(storms)} storm(s) shaded" if storms else "")
                + "</h2>")
    body.append(_svg_line_chart([("intensity", it, iv)],
                                y_label="events/s", bands=bands))
    if any(r["t"].size for r in risk.values()):
        body.append("<h2>Pool occupancy (resident VMs)</h2>")
        body.append(_legend([f"pool {p}" for p in pools]))
        body.append(_svg_line_chart(
            [(f"pool {p}", risk[p]["t"], risk[p]["occupancy"])
             for p in pools], y_label="VMs", bands=bands))
    # serving scenario: rendered only when the run emitted serve
    # events, so every non-serve report stays byte-identical
    sv = serve_series(log)
    if sv is not None:
        body.append("<h2>Serving: arrival rate</h2>")
        body.append(_svg_line_chart(
            [("rate", sv["rate_t"], sv["rate"])], y_label="req/s",
            bands=bands))
        body.append("<h2>Serving: queue depth</h2>")
        body.append(_svg_line_chart(
            [("depth", sv["t"], sv["depth"])], y_label="requests",
            bands=bands))
        body.append("<h2>Serving: p95 latency (trailing window)</h2>")
        body.append(_svg_line_chart(
            [("p95", sv["t"], sv["p95"])], y_label="s", bands=bands))
        body.append("<h2>Serving: capacity — autoscaler target vs live</h2>")
        body.append(_legend(["target units", "live units"]))
        body.append(_svg_line_chart(
            [("target units", sv["scale_t"], sv["scale_units"]),
             ("live units", sv["t"], sv["live"])], y_label="units",
            bands=bands))
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            f"<body>{''.join(body)}</body></html>")


# ---------------------------------------------------------------------------
# sweep report
# ---------------------------------------------------------------------------
_SWEEP_METRICS = ("interruptions", "max_interruption_time",
                  "realized_spot_cost", "time_below_target_s")


def _cell_label(cell: dict) -> str:
    parts = [str(cell.get("regime")), cell.get("policy", ""),
             cell.get("migration", "")]
    fl = cell.get("fleet")
    if "fleet" in cell:
        parts.append(fl["strategy"] if fl else "per-vm")
    return "/".join(p for p in parts if p)


def render_sweep_report(report: dict,
                        title: Optional[str] = None) -> str:
    """Sweep-report HTML: the aggregate mean ± CI table plus one bar chart
    (mean with CI whiskers) per headline metric present in the cells."""
    cells = report.get("cells", [])
    title = title or f"Sweep report: {report.get('name', '?')}"
    labels = [_cell_label(c) for c in cells]
    metric_keys: List[str] = []
    for m in _SWEEP_METRICS:
        if any(m in c.get("metrics", {}) for c in cells):
            metric_keys.append(m)
    body = [f"<h1>{_esc(title)}</h1>",
            _manifest_table(report.get("manifest")),
            _tiles({"cells": len(cells),
                    "runs": report.get("n_runs", "?"),
                    "horizon": report.get("horizon", "?")})]
    if cells:
        all_keys = sorted({k for c in cells for k in c.get("metrics", {})})
        head = "".join(f"<th>{_esc(k)}</th>" for k in all_keys)
        rows = []
        for lb, c in zip(labels, cells):
            tds = []
            for k in all_keys:
                mk = c["metrics"].get(k)
                tds.append(
                    f"<td>{mk['mean']:.3g}&#177;{mk['ci95']:.2g}</td>"
                    if mk else "<td>-</td>")
            rows.append(f"<tr><th>{_esc(lb)}</th>{''.join(tds)}</tr>")
        body.append("<h2>Aggregate metrics (mean &#177; 95% CI)</h2>")
        body.append(f'<table class="agg"><tr><th>cell</th>{head}</tr>'
                    f'{"".join(rows)}</table>')
    for m in metric_keys:
        means = [c["metrics"].get(m, {}).get("mean", 0.0) for c in cells]
        errs = [c["metrics"].get(m, {}).get("ci95", 0.0) for c in cells]
        body.append(f"<h2>{_esc(m)}</h2>")
        body.append(_svg_bar_chart(labels, means, errs))
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            f"<body>{''.join(body)}</body></html>")


def write_html_report(src, path: str, manifest: Optional[dict] = None,
                      title: Optional[str] = None) -> str:
    """Render + write a report: an :class:`EventLog` (or saved log path)
    produces a run report; a sweep-report dict (has ``"cells"``) produces
    the sweep variant."""
    if isinstance(src, dict) and "cells" in src:
        doc = render_sweep_report(src, title=title)
    else:
        doc = render_report(src, manifest=manifest,
                            title=title or "Run report")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(doc)
    return path


def _json_default(o):  # pragma: no cover - defensive
    return str(o)


def report_summary_json(src: Union[EventLog, str]) -> str:
    """The run report's headline numbers as JSON (storms + cohort tiles) —
    a machine-readable sidecar for CI assertions."""
    log = load_event_log(src) if isinstance(src, str) else src
    return json.dumps({"events": len(log),
                       "storms": storm_intervals(log)},
                      sort_keys=True, default=_json_default)
