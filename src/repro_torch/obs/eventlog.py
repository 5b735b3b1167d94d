"""Structured event flight recorder (ISSUE 8).

An :class:`EventLog` is an append-only log of every lifecycle and market
event a run produces — submit / start / resume / interrupt / hibernate /
terminate / finish, migrate plan / start / complete, price ticks, waves,
faults, fleet fallback rungs, allocation flushes, host add/remove.  It is
the per-run substrate the paper's "market risk" analytics need (storm
timing, per-VM timelines, pool-level exposure) and the input to the
first-divergence diff that debugs bit-identity failures
(:mod:`repro.obs.diff`).

Storage is *columnar*: eight parallel columns (sim time, interned kind id,
vm / pool / host ids, two float payload slots, interned aux-string id), so
a multi-hundred-thousand-event run costs a few flat Python lists while
recording and exports to dense numpy arrays for the vectorized queries in
:mod:`repro.obs.analyze`.  Two interchangeable on-disk formats:

* **NDJSON** — a header record (schema, version, string tables, manifest)
  followed by one JSON object per event.  ``json`` float repr round-trips
  exactly, so NDJSON logs preserve bit-identity and two runs can be diffed
  line-by-line or streamed through :func:`repro.obs.diff.first_divergence`.
* **npz** — ``numpy.savez_compressed`` of the columns + string tables, the
  compact archival format for committed artifacts.

Overhead contract (the PR 7 pattern): :data:`NULL_RECORDER` is the default
``events`` attribute everywhere, every emit site guards on
``events.enabled`` (one attribute load + branch), and a log-off run takes
the untouched plain event loop.  Nothing here draws randomness or mutates
engine state — recording is observation-only, so logged and unlogged runs
of the same spec + seed produce byte-identical metrics (regression-tested
in ``tests/obs/test_eventlog.py``; perf half CI-gated via
``obs/eventlog_overhead``).
"""
from __future__ import annotations

import enum
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SCHEMA = "repro.eventlog"
SCHEMA_VERSION = 1


class LogEventKind(str, enum.Enum):
    """The full event vocabulary — the single source of truth.

    Validation (:func:`validate_event_log`), the detlint ``event-coverage``
    pass, and the analytics layer all derive their known-kind sets from
    this enum, so adding a kind here without wiring its emit site (or vice
    versa) fails closed instead of silently passing.
    """

    SUBMIT = "submit"
    START = "start"
    RESUME = "resume"
    FINISH = "finish"
    FAIL = "fail"
    INTERRUPT = "interrupt"
    HIBERNATE = "hibernate"
    TERMINATE = "terminate"
    MIGRATE_PLAN = "migrate-plan"
    MIGRATE_START = "migrate-start"
    MIGRATE_COMPLETE = "migrate-complete"
    PRICE_TICK = "price-tick"
    WAVE = "wave"
    FAULT = "fault"
    FLEET_RUNG = "fleet-rung"
    FLEET_LAUNCH = "fleet-launch"
    FLEET_RETIRE = "fleet-retire"
    ALLOC_FLUSH = "alloc-flush"
    HOST_ADD = "host-add"
    HOST_REMOVE = "host-remove"
    # -- serving layer (PR 10): request flow + autoscaler decisions ---------
    REQUEST_ARRIVE = "request-arrive"     # per serve tick: a=count, b=rate
    REQUEST_DONE = "request-done"         # per request: a=latency_s, b=tokens
    REQUEST_REQUEUE = "request-requeue"   # VM loss: a=in-flight, b=moved
    SERVE_SAMPLE = "serve-sample"         # per serve tick: a=depth, b=live
    AUTOSCALE = "autoscale"               # per decision: a=new, b=old units


#: kept as a tuple for existing callers; derived from the enum above
EVENT_KINDS = tuple(k.value for k in LogEventKind)

#: one normalized record: (t, kind, vm, pool, host, a, b, aux)
Record = Tuple[float, str, int, int, int, float, float, Optional[str]]

_FIELDS = ("t", "k", "vm", "pool", "host", "a", "b", "x")


class NullRecorder:
    """Inert event recorder: ``enabled`` is False and ``emit`` is a no-op.

    Every ``events`` attribute defaults to the :data:`NULL_RECORDER`
    singleton, so emit sites cost one attribute load + branch and never
    need a ``None`` check — the same contract as
    :class:`repro.obs.tracer.NullTracer`."""

    enabled = False

    def emit(self, t: float, kind: str, vm: int = -1, pool: int = -1,
             host: int = -1, a: float = 0.0, b: float = 0.0,
             aux: Optional[str] = None) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def records(self) -> Iterator[Record]:
        return iter(())


#: the default recorder everywhere an ``events`` attribute exists
NULL_RECORDER = NullRecorder()


class EventLog:
    """Columnar append-only event log with interned string tables.

    ``emit`` appends one row; kinds and aux strings are interned into
    per-log tables so the hot path stores only small ints.  An optional
    ``[t_min, t_max)`` window drops events outside it at emit time — the
    windowed-rerun mode :func:`repro.obs.diff.bisect_divergence` uses to
    keep divergence hunting at trace scale out of memory trouble."""

    enabled = True

    def __init__(self, t_min: Optional[float] = None,
                 t_max: Optional[float] = None) -> None:
        self.t_min = t_min
        self.t_max = t_max
        self._t: List[float] = []
        self._kind: List[int] = []
        self._vm: List[int] = []
        self._pool: List[int] = []
        self._host: List[int] = []
        self._a: List[float] = []
        self._b: List[float] = []
        self._aux: List[int] = []
        self._kind_ids: Dict[str, int] = {}
        self._kinds: List[str] = []
        self._aux_ids: Dict[str, int] = {}
        self._auxs: List[str] = []

    # -------------------------------------------------------------- emit
    def emit(self, t: float, kind: str, vm: int = -1, pool: int = -1,
             host: int = -1, a: float = 0.0, b: float = 0.0,
             aux: Optional[str] = None) -> None:
        if self.t_min is not None and t < self.t_min:
            return
        if self.t_max is not None and t >= self.t_max:
            return
        k = self._kind_ids.get(kind)
        if k is None:
            k = self._kind_ids[kind] = len(self._kinds)
            self._kinds.append(kind)
        if aux is None:
            x = -1
        else:
            x = self._aux_ids.get(aux)
            if x is None:
                x = self._aux_ids[aux] = len(self._auxs)
                self._auxs.append(aux)
        self._t.append(t)
        self._kind.append(k)
        self._vm.append(vm)
        self._pool.append(pool)
        self._host.append(host)
        self._a.append(a)
        self._b.append(b)
        self._aux.append(x)

    def __len__(self) -> int:
        return len(self._t)

    # ------------------------------------------------------------- views
    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Dense columns for vectorized queries: ``t`` / ``a`` / ``b`` as
        float64, ``kind`` / ``pool`` / ``host`` / ``aux`` as int32, ``vm``
        as int64, plus the ``kinds`` / ``auxs`` string tables."""
        return {
            "t": np.asarray(self._t, dtype=np.float64),
            "kind": np.asarray(self._kind, dtype=np.int32),
            "vm": np.asarray(self._vm, dtype=np.int64),
            "pool": np.asarray(self._pool, dtype=np.int32),
            "host": np.asarray(self._host, dtype=np.int32),
            "a": np.asarray(self._a, dtype=np.float64),
            "b": np.asarray(self._b, dtype=np.float64),
            "aux": np.asarray(self._aux, dtype=np.int32),
            "kinds": np.asarray(self._kinds, dtype=object),
            "auxs": np.asarray(self._auxs, dtype=object),
        }

    def kind_id(self, kind: str) -> int:
        """The interned id of ``kind`` in this log, or -1 if the run never
        emitted it (so ``arrays['kind'] == -1`` matches nothing)."""
        return self._kind_ids.get(kind, -1)

    def aux_id(self, aux: str) -> int:
        """The interned id of ``aux``, or -1 if never emitted (-1 is also
        the column value for records with no aux — match kinds first)."""
        return self._aux_ids.get(aux, -1)

    def records(self) -> Iterator[Record]:
        """Normalized record tuples in emit order — the diffable view."""
        kinds, auxs = self._kinds, self._auxs
        for i in range(len(self._t)):
            x = self._aux[i]
            yield (self._t[i], kinds[self._kind[i]], self._vm[i],
                   self._pool[i], self._host[i], self._a[i], self._b[i],
                   auxs[x] if x >= 0 else None)

    # ---------------------------------------------------------------- I/O
    def save(self, path: str, manifest: Optional[dict] = None) -> str:
        """Write the log to ``path`` — ``.npz`` selects the compact binary
        format, anything else NDJSON."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if path.endswith(".npz"):
            return self.save_npz(path, manifest=manifest)
        return self.write_ndjson(path, manifest=manifest)

    def write_ndjson(self, path: str,
                     manifest: Optional[dict] = None) -> str:
        header = {"type": "header", "schema": SCHEMA,
                  "version": SCHEMA_VERSION, "n": len(self._t),
                  "kinds": list(self._kinds), "auxs": list(self._auxs)}
        if manifest is not None:
            header["manifest"] = manifest
        with open(path, "w") as f:
            f.write(json.dumps(header, sort_keys=True) + "\n")
            for i in range(len(self._t)):
                x = self._aux[i]
                f.write(json.dumps(
                    {"t": self._t[i], "k": self._kinds[self._kind[i]],
                     "vm": self._vm[i], "pool": self._pool[i],
                     "host": self._host[i], "a": self._a[i],
                     "b": self._b[i],
                     "x": self._auxs[x] if x >= 0 else None}) + "\n")
        return path

    def save_npz(self, path: str, manifest: Optional[dict] = None) -> str:
        arrays = self.to_arrays()
        arrays["kinds"] = arrays["kinds"].astype(str)
        arrays["auxs"] = arrays["auxs"].astype(str)
        meta = {"schema": SCHEMA, "version": SCHEMA_VERSION}
        if manifest is not None:
            meta["manifest"] = manifest
        np.savez_compressed(path, meta=json.dumps(meta, sort_keys=True),
                            **arrays)
        return path


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------
def load_event_log(path: str) -> EventLog:
    """Rebuild an :class:`EventLog` from either on-disk format (the
    analytics / report entry point; for memory-bounded diffing of NDJSON
    logs stream :func:`iter_event_records` instead)."""
    log = EventLog()
    for t, kind, vm, pool, host, a, b, aux in iter_event_records(path):
        log.emit(t, kind, vm=vm, pool=pool, host=host, a=a, b=b, aux=aux)
    return log


def read_manifest(path: str) -> Optional[dict]:
    """The manifest block a log was saved with, or None."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return json.loads(str(z["meta"])).get("manifest")
    with open(path) as f:
        return json.loads(f.readline()).get("manifest")


def iter_event_records(path: str) -> Iterator[Record]:
    """Stream normalized records from an on-disk log.  NDJSON logs are read
    line-by-line (O(1) memory — the diff's streaming mode); npz logs load
    their columns once and iterate."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            cols = {k: z[k] for k in
                    ("t", "kind", "vm", "pool", "host", "a", "b", "aux")}
            kinds = [str(s) for s in z["kinds"]]
            auxs = [str(s) for s in z["auxs"]]
        for i in range(cols["t"].size):
            x = int(cols["aux"][i])
            yield (float(cols["t"][i]), kinds[int(cols["kind"][i])],
                   int(cols["vm"][i]), int(cols["pool"][i]),
                   int(cols["host"][i]), float(cols["a"][i]),
                   float(cols["b"][i]), auxs[x] if x >= 0 else None)
        return
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("schema") != SCHEMA:
            raise ValueError(f"{path}: not a {SCHEMA} NDJSON file "
                             f"(header schema {header.get('schema')!r})")
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            yield (d["t"], d["k"], d["vm"], d["pool"], d["host"],
                   d["a"], d["b"], d.get("x"))


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
def validate_event_log(src) -> List[str]:
    """Schema checks for a log (an :class:`EventLog` or a saved path);
    returns a list of problems — empty means valid (the
    :func:`repro.obs.export.validate_chrome_trace` idiom).

    Checks: header schema/version (paths), every kind in
    :data:`EVENT_KINDS`, non-decreasing sim time, well-typed ids, finite
    payloads."""
    problems: List[str] = []
    if isinstance(src, str):
        if src.endswith(".npz"):
            try:
                with np.load(src, allow_pickle=False) as z:
                    meta = json.loads(str(z["meta"]))
            except (OSError, KeyError, ValueError) as e:
                return [f"unreadable npz log: {e}"]
        else:
            try:
                with open(src) as f:
                    meta = json.loads(f.readline())
            except (OSError, ValueError) as e:
                return [f"unreadable NDJSON log: {e}"]
        if meta.get("schema") != SCHEMA:
            problems.append(f"header schema is {meta.get('schema')!r}, "
                            f"expected {SCHEMA!r}")
        if meta.get("version") != SCHEMA_VERSION:
            problems.append(f"header version is {meta.get('version')!r}, "
                            f"expected {SCHEMA_VERSION}")
        records = iter_event_records(src)
    else:
        records = src.records()
    known = {k.value for k in LogEventKind}
    last_t = float("-inf")
    bad_kinds = set()
    for i, (t, kind, vm, pool, host, a, b, aux) in enumerate(records):
        if kind not in known and kind not in bad_kinds:
            bad_kinds.add(kind)
            problems.append(f"record {i}: unknown event kind {kind!r}")
        if not isinstance(t, (int, float)) or not np.isfinite(t):
            problems.append(f"record {i}: non-finite time {t!r}")
        elif t < last_t:
            problems.append(f"record {i}: time goes backwards "
                            f"({t} < {last_t})")
        else:
            last_t = t
        for name, v in (("vm", vm), ("pool", pool), ("host", host)):
            if not isinstance(v, (int, np.integer)):
                problems.append(f"record {i}: {name} id {v!r} is not an int")
        for name, v in (("a", a), ("b", b)):
            if not isinstance(v, (int, float)) or not np.isfinite(v):
                problems.append(f"record {i}: payload {name}={v!r} "
                                f"is not finite")
        if aux is not None and not isinstance(aux, str):
            problems.append(f"record {i}: aux {aux!r} is not a string")
        if len(problems) >= 50:
            problems.append("... (validation stopped at 50 problems)")
            break
    return problems


def write_event_log(log: EventLog, path: str,
                    manifest: Optional[dict] = None) -> str:
    """Module-level alias of :meth:`EventLog.save` (CLI symmetry with
    ``write_chrome_trace`` / ``write_profile``)."""
    return log.save(path, manifest=manifest)
