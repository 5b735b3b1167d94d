"""Per-subsystem self/total wall-time profile from tracer span aggregates.

The profiling mode (``Tracer(profile=True)``) folds every span into a
``(cat, name) -> [count, total_s, self_s]`` dict online; this module turns
that into the sorted table that shows where per-event Python time goes.

*self* time is a span's duration minus its traced children, so rows sum to
(approximately) total traced wall time without double-counting nesting:
``dispatch/price-tick`` contains the tick phases, the tick phases contain
planner scoring, and each level reports only its own residue.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional


def profile_table(tracer) -> List[dict]:
    """Sorted (self-time descending) per-span-site rows."""
    prof = tracer.profile()
    total_self = sum(v[2] for v in prof.values()) or 1.0
    rows = []
    for (cat, name), (count, total, self_t) in prof.items():
        rows.append({
            "cat": cat,
            "name": name,
            "count": count,
            "total_ms": round(total * 1e3, 6),
            "self_ms": round(self_t * 1e3, 6),
            "self_pct": round(100.0 * self_t / total_self, 3),
            "self_us_per_call": round(self_t * 1e6 / max(count, 1), 3),
        })
    rows.sort(key=lambda r: (-r["self_ms"], r["cat"], r["name"]))
    return rows


def profile_report(tracer, manifest: Optional[dict] = None) -> dict:
    rows = profile_table(tracer)
    doc = {
        "total_self_ms": round(sum(r["self_ms"] for r in rows), 6),
        "wall_elapsed_ms": round(tracer.wall_elapsed() * 1e3, 6),
        "rows": rows,
    }
    if rows:
        doc["dominant"] = {"cat": rows[0]["cat"], "name": rows[0]["name"],
                           "self_pct": rows[0]["self_pct"]}
    if manifest is not None:
        doc["manifest"] = manifest
    return doc


def write_profile(tracer, path: str,
                  manifest: Optional[dict] = None) -> dict:
    doc = profile_report(tracer, manifest)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


def format_profile_table(tracer, top: int = 20) -> str:
    """Human-readable table for terminal output (``--profile``)."""
    rows = profile_table(tracer)
    lines = [f"{'subsystem':<42} {'count':>9} {'total ms':>11} "
             f"{'self ms':>11} {'self %':>7} {'self us/call':>13}"]
    for r in rows[:top]:
        site = f"{r['cat']}:{r['name']}"
        lines.append(f"{site:<42} {r['count']:>9} {r['total_ms']:>11.3f} "
                     f"{r['self_ms']:>11.3f} {r['self_pct']:>7.2f} "
                     f"{r['self_us_per_call']:>13.3f}")
    if len(rows) > top:
        lines.append(f"... ({len(rows) - top} more rows)")
    return "\n".join(lines)
