"""First-divergence finder over two event logs.

The repo's correctness methodology compares end-of-run metrics JSONs —
which says *that* two runs diverged, never *where*.  This module answers
"where": stream two event logs (two seeds, two code paths, vectorized vs
scalar oracle) and report the first differing record with its sim time,
both payloads, and the shared context window preceding it.  The logs'
schema is shared with the JAX package, so either package's ``diff`` reads
either package's logs: the port's parity harness holds its runs against
the reference's event for event, and the first divergent event names the
subsystem and tick.

Two modes:

* :func:`first_divergence` — exact streaming comparison.  Accepts
  :class:`~repro_torch.obs.eventlog.EventLog` objects, saved log paths (NDJSON
  streams line-by-line, O(1) memory), or any record iterables.
* :func:`bisect_divergence` — windowed-rerun bisection for runs too big to
  log whole: the caller reruns both simulations with a windowed recorder
  (``EventLog(t_min, t_max)``) per probe, and the binary search narrows
  the divergence to a ``min_window``-sized interval.  Correctness rests on
  the bit-identity invariant itself: both runs are identical *before* the
  first divergence time T, so any window starting at or before T captures
  the same prefix from both runs and preserves the first divergent record.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Tuple, Union

from .eventlog import EventLog, Record, iter_event_records

LogSource = Union[EventLog, str, Iterable[Record]]


@dataclass
class Divergence:
    """The first point two event streams disagree.

    ``record_a`` / ``record_b`` are the differing records (None when one
    stream simply ended — the other side's record carries the sim time).
    ``context`` holds the last shared records before the divergence, newest
    last."""

    index: int
    record_a: Optional[Record]
    record_b: Optional[Record]
    context: List[Record] = field(default_factory=list)

    @property
    def time(self) -> Optional[float]:
        """Sim time of the divergence (the earlier side when both exist)."""
        ts = [r[0] for r in (self.record_a, self.record_b) if r is not None]
        return min(ts) if ts else None


def _records(src: LogSource):
    if isinstance(src, str):
        return iter_event_records(src)
    if isinstance(src, EventLog):
        return src.records()
    return iter(src)


def first_divergence(a: LogSource, b: LogSource,
                     context: int = 5) -> Optional[Divergence]:
    """The first record where streams ``a`` and ``b`` differ, or None when
    they are identical.  Comparison is exact tuple equality — NDJSON round-
    trips floats exactly, so "equal" here means bit-identical payloads."""
    it_a, it_b = _records(a), _records(b)
    ring: deque = deque(maxlen=context) if context > 0 else deque(maxlen=1)
    _END = object()
    i = 0
    while True:
        ra = next(it_a, _END)
        rb = next(it_b, _END)
        if ra is _END and rb is _END:
            return None
        if ra is _END or rb is _END or ra != rb:
            return Divergence(
                index=i,
                record_a=None if ra is _END else ra,
                record_b=None if rb is _END else rb,
                context=list(ring) if context > 0 else [])
        if context > 0:
            ring.append(ra)
        i += 1


def bisect_divergence(
    make_logs: Callable[[float, float], Tuple[LogSource, LogSource]],
    t_end: float, min_window: float = 600.0, context: int = 5,
) -> Tuple[Optional[Divergence], Tuple[float, float]]:
    """Locate a divergence by windowed reruns instead of one full log.

    ``make_logs(t0, t1)`` must rerun *both* simulations from scratch,
    recording only events in ``[t0, t1)`` (pass ``EventLog(t_min=t0,
    t_max=t1)`` as each run's recorder), and return the two logs.  The
    search keeps the invariant "the first divergence lies in ``[lo, hi)``":
    if the probe of the lower half diverges, the divergence (and therefore
    the *first* divergence, since prefixes are shared) is there; otherwise
    it is in the upper half — whose window then starts at ``mid <= T``, so
    the shared-prefix alignment still holds.  Returns the divergence found
    in the final window (with context) and the window itself; ``(None,
    window)`` means the runs never diverged in ``[0, t_end)``.

    Probe cost: O(log(t_end / min_window)) paired reruns, each holding at
    most one window of events in memory."""
    lo, hi = 0.0, float(t_end)
    while hi - lo > min_window:
        mid = 0.5 * (lo + hi)
        a, b = make_logs(lo, mid)
        if first_divergence(a, b, context=0) is not None:
            hi = mid
        else:
            lo = mid
    a, b = make_logs(lo, hi)
    return first_divergence(a, b, context=context), (lo, hi)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------
def _fmt_record(r: Optional[Record]) -> str:
    if r is None:
        return "<stream ended>"
    t, kind, vm, pool, host, a, b, aux = r
    parts = [f"t={t:.6g}", kind]
    if vm >= 0:
        parts.append(f"vm={vm}")
    if pool >= 0:
        parts.append(f"pool={pool}")
    if host >= 0:
        parts.append(f"host={host}")
    if a != 0.0:
        parts.append(f"a={a!r}")
    if b != 0.0:
        parts.append(f"b={b!r}")
    if aux is not None:
        parts.append(f"aux={aux}")
    return "  ".join(parts)


def format_divergence(div: Optional[Divergence],
                      label_a: str = "A", label_b: str = "B") -> str:
    """Human-readable divergence report (the ``--diff`` CLI's output)."""
    if div is None:
        return "event logs are identical (zero divergence)"
    lines = [f"first divergence at record #{div.index}"
             + (f" (sim t={div.time:.6g}s)" if div.time is not None else "")]
    if div.context:
        lines.append(f"  last {len(div.context)} shared event(s):")
        lines.extend(f"    {_fmt_record(r)}" for r in div.context)
    lines.append(f"  {label_a}: {_fmt_record(div.record_a)}")
    lines.append(f"  {label_b}: {_fmt_record(div.record_b)}")
    return "\n".join(lines)
