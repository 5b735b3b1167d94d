"""Chrome trace-event JSON export for :class:`repro_torch.obs.tracer.Tracer`.

Emits the Trace Event Format understood by ``chrome://tracing`` and
Perfetto (legacy JSON ingestion): a ``traceEvents`` array of ``"X"``
complete spans, ``"i"`` instants, ``"C"`` counter samples, and ``"M"``
metadata records naming the tracks.

Two clocks, two track groups: the same spans are emitted once under
**pid 1 ("wall-time")** with real wall-clock ``ts``/``dur`` (microseconds
since the tracer epoch) and once under **pid 2 ("sim-time")** with
``ts = sim_t * 1e6`` so the viewer's timeline doubles as the simulated
clock — on the sim-time track each span's wall duration is carried in
``args.wall_ms`` instead of ``dur`` (sim events are logically
instantaneous).  Within each group, one tid per span category keeps
subsystems on separate rows.

``validate_chrome_trace`` is the schema check the test-suite applies to
every emitted file; keeping it next to the writer means the two cannot
drift apart.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

PID_WALL = 1
PID_SIM = 2

_PROCESS_NAMES = {PID_WALL: "wall-time", PID_SIM: "sim-time"}


def _category_tids(tracer) -> Dict[str, int]:
    """Stable category -> tid assignment in first-seen order."""
    tids: Dict[str, int] = {}
    for rec in tracer.spans:
        tids.setdefault(rec[0], len(tids) + 1)
    for rec in tracer.instants:
        tids.setdefault(rec[0], len(tids) + 1)
    if tracer.counters.series:
        tids.setdefault("counters", len(tids) + 1)
    return tids


def chrome_trace(tracer, manifest: Optional[dict] = None) -> dict:
    """Render a Tracer's records as a Chrome trace-event document."""
    tids = _category_tids(tracer)
    events: List[dict] = []

    for pid, pname in _PROCESS_NAMES.items():
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": pname}})
        for cat, tid in tids.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": cat}})

    for cat, name, t0, dur, sim_t, self_dur, args in tracer.spans:
        tid = tids[cat]
        wall_args = dict(args) if args else {}
        wall_args["sim_t"] = round(sim_t, 6)
        wall_args["self_us"] = round(self_dur * 1e6, 3)
        events.append({"ph": "X", "pid": PID_WALL, "tid": tid, "cat": cat,
                       "name": name, "ts": round(t0 * 1e6, 3),
                       "dur": round(dur * 1e6, 3), "args": wall_args})
        sim_args = dict(args) if args else {}
        sim_args["wall_ms"] = round(dur * 1e3, 6)
        events.append({"ph": "X", "pid": PID_SIM, "tid": tid, "cat": cat,
                       "name": name, "ts": round(sim_t * 1e6, 3),
                       "dur": 0, "args": sim_args})

    for cat, name, wall, sim_t, args in tracer.instants:
        tid = tids[cat]
        base = {"ph": "i", "tid": tid, "cat": cat, "name": name,
                "s": "t", "args": dict(args) if args else {}}
        events.append({**base, "pid": PID_WALL, "ts": round(wall * 1e6, 3)})
        events.append({**base, "pid": PID_SIM, "ts": round(sim_t * 1e6, 3)})

    ctid = tids.get("counters", 0)
    for sim_t, wall, snap in tracer.counters.series:
        for key in sorted(snap):
            base = {"ph": "C", "tid": ctid, "name": key,
                    "args": {"value": snap[key]}}
            events.append({**base, "pid": PID_WALL,
                           "ts": round(wall * 1e6, 3)})
            events.append({**base, "pid": PID_SIM,
                           "ts": round(sim_t * 1e6, 3)})

    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if manifest is not None:
        doc["otherData"] = manifest
    return doc


def write_chrome_trace(tracer, path: str,
                       manifest: Optional[dict] = None) -> dict:
    doc = chrome_trace(tracer, manifest)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    return doc


_REQUIRED_BY_PH = {
    "X": ("pid", "tid", "name", "cat", "ts", "dur"),
    "i": ("pid", "tid", "name", "cat", "ts"),
    "C": ("pid", "tid", "name", "ts", "args"),
    "M": ("pid", "tid", "name", "args"),
}


def validate_chrome_trace(doc: dict) -> List[str]:
    """Return a list of schema problems (empty == valid).

    Checks the invariants chrome://tracing / Perfetto actually rely on:
    known phase types, required per-phase fields, numeric non-negative
    timestamps/durations, and that every (pid, tid) used by an event has
    metadata naming it.
    """
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    named_tracks = set()
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            named_tracks.add((ev.get("pid"), None))
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            named_tracks.add((ev.get("pid"), ev.get("tid")))
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        req = _REQUIRED_BY_PH.get(ph)
        if req is None:
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        for field in req:
            if field not in ev:
                problems.append(f"event {i} (ph={ph}): missing {field!r}")
        for field in ("ts", "dur"):
            if field in ev and ph != "M":
                val = ev[field]
                if not isinstance(val, (int, float)) or val < 0:
                    problems.append(
                        f"event {i} (ph={ph}): bad {field}={val!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                problems.append(f"event {i}: counter args not numeric")
        if ph in ("X", "i", "C"):
            pid = ev.get("pid")
            if (pid, None) not in named_tracks:
                problems.append(f"event {i}: pid {pid!r} has no "
                                "process_name metadata")
    return problems
