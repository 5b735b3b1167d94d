"""Runtime tracing primitives: spans, instants, and live counters.

The simulator's observability layer (ISSUE 7) is built on three record
kinds, all produced by one :class:`Tracer`:

* **spans** — a wall-clock interval around one unit of engine work (an
  event dispatch, a market-tick phase, a planner scoring pass), stamped
  with the simulation time at which it ran.  Spans nest: the tracer keeps
  a stack, so each record carries its *self* time (total minus children) —
  the per-subsystem profile table falls out of one dict aggregation.
* **instants** — zero-duration markers (an interruption wave landing, a
  fleet fallback rung firing).
* **counters** — monotonically growing named integers (events dispatched,
  interruptions by cause, waves, migrations, fallback-rung hits) plus
  sampled gauges (queue depth, registry size), snapshotted into a
  timeseries on a configurable sim-time cadence.

Overhead contract: the disabled path must cost (almost) nothing.  Every
instrumentation site in the engine guards on ``tracer.enabled`` — a single
attribute load + branch — and the simulator's hot event loop selects an
entirely *untraced* loop body when observability is off, so a disabled run
executes byte-for-byte the same per-event code as a build with no tracer
at all (regression-tested: metrics JSON equality, ``tests/obs``).  The
:data:`NULL_TRACER` singleton is the default everywhere; sites never need
a ``None`` check.

Nothing in this module draws randomness or mutates engine state: attaching
a (fully enabled) tracer is observation-only, so traced and untraced runs
of the same spec + seed produce identical metrics.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class Counters:
    """Low-overhead named counters + snapshot timeseries.

    ``inc``/``add`` are plain dict updates (no locks — the simulator is
    single-threaded); ``snapshot`` copies the live values, merges sampled
    gauges, and appends to :attr:`series` as ``(sim_t, wall_s, values)``.
    """

    __slots__ = ("values", "series")

    def __init__(self) -> None:
        self.values: Dict[str, float] = {}
        self.series: List[Tuple[float, float, Dict[str, float]]] = []

    def inc(self, key: str, n: int = 1) -> None:
        v = self.values
        v[key] = v.get(key, 0) + n

    def set(self, key: str, value: float) -> None:
        """Set a gauge-style value (last write wins)."""
        self.values[key] = value

    def get(self, key: str, default: float = 0) -> float:
        return self.values.get(key, default)

    def snapshot(self, sim_t: float, wall_s: float,
                 gauges: Optional[Dict[str, float]] = None
                 ) -> Dict[str, float]:
        snap = dict(self.values)
        if gauges:
            snap.update(gauges)
        self.series.append((sim_t, wall_s, snap))
        return snap


class NullTracer:
    """Inert tracer: ``enabled`` is False and every method is a no-op.

    Instrumentation sites hold a reference to this singleton by default, so
    the fast-path check is one attribute load (``tr.enabled``) with no
    ``None`` branch.  Kept deliberately method-complete: code may call any
    tracer method without checking ``enabled`` first on cold paths.
    """

    enabled = False
    counters = Counters()          # shared sink; never snapshotted
    on_snapshot: Optional[Callable] = None

    def begin(self, cat: str, name: str) -> None:
        pass

    def end(self, sim_t: float, args: Optional[dict] = None) -> None:
        pass

    def instant(self, cat: str, name: str, sim_t: float,
                args: Optional[dict] = None) -> None:
        pass

    def counters_due(self, sim_t: float) -> bool:
        return False

    def snapshot(self, sim_t: float,
                 gauges: Optional[Dict[str, float]] = None) -> dict:
        return {}

    def unwind(self, sim_t: float, args: Optional[dict] = None) -> int:
        return 0


#: the default tracer everywhere a ``tracer`` attribute exists
NULL_TRACER = NullTracer()


class Tracer:
    """Span/instant/counter recorder with nesting-aware self-time.

    ``keep_records=False`` (profile- or counters-only modes) still times
    spans but does not retain per-span records — memory stays O(distinct
    span names) even on multi-hundred-thousand-event runs, which is what
    lets the profiling mode run at trace scale.

    Record layouts (all tuples, exported by :mod:`repro.obs.export`):

    * ``spans``:    ``(cat, name, t0_s, dur_s, sim_t, self_s, args)`` with
      ``t0_s`` relative to the tracer epoch.
    * ``instants``: ``(cat, name, wall_s, sim_t, args)``.
    * ``counters.series``: ``(sim_t, wall_s, {key: value})``.
    """

    enabled = True

    def __init__(self, keep_records: bool = True, profile: bool = False,
                 counters_every: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        if counters_every is not None and not counters_every > 0:
            raise ValueError(
                f"counters_every must be > 0 or None (got {counters_every!r})")
        self.keep_records = bool(keep_records)
        self.profile_enabled = bool(profile)
        self.counters_every = counters_every
        self.clock = clock
        # the epoch is anchored on the real-time clock, which the CUDA
        # profiler's trace counts from: a real-time read bracketed by two
        # reads of ``clock``, the epoch their midpoint (``to_unix_ns``)
        before = clock()
        self.epoch_unix_ns = time.time_ns()
        after = clock()
        self.epoch = 0.5 * (before + after)
        #: width of the anchor's bracket (s): the mapping's own uncertainty
        self.anchor_s = after - before
        #: simulated time of the event being dispatched, set by the
        #: simulator's traced loop: the end stamp of spans opened by
        #: components that do not hold the simulation clock (the policy)
        self.sim_t = 0.0
        self.spans: List[tuple] = []
        self.instants: List[tuple] = []
        self.counters = Counters()
        #: optional live-progress hook: called as ``fn(sim_t, snapshot)``
        #: after every counter snapshot (the CLI's live line)
        self.on_snapshot: Optional[Callable[[float, dict], None]] = None
        self._stack: List[list] = []       # [cat, name, t0, child_dur]
        self._profile: Dict[Tuple[str, str], list] = {}  # -> [n, total, self]
        self._next_snap = 0.0 if counters_every is not None else None

    # ------------------------------------------------------------- spans
    def begin(self, cat: str, name: str) -> None:
        self._stack.append([cat, name, self.clock(), 0.0])

    def end(self, sim_t: float, args: Optional[dict] = None) -> None:
        t1 = self.clock()
        cat, name, t0, child = self._stack.pop()
        dur = t1 - t0
        if self._stack:
            self._stack[-1][3] += dur     # accumulate into the parent
        self_dur = dur - child
        if self.keep_records:
            self.spans.append(
                (cat, name, t0 - self.epoch, dur, sim_t, self_dur, args))
        if self.profile_enabled:
            p = self._profile.get((cat, name))
            if p is None:
                self._profile[(cat, name)] = [1, dur, self_dur]
            else:
                p[0] += 1
                p[1] += dur
                p[2] += self_dur

    def instant(self, cat: str, name: str, sim_t: float,
                args: Optional[dict] = None) -> None:
        if self.keep_records:
            self.instants.append(
                (cat, name, self.clock() - self.epoch, sim_t, args))

    def unwind(self, sim_t: float, args: Optional[dict] = None) -> int:
        """Close every open span (an exception propagated mid-span).

        Each open frame is ended normally — durations stay exact, child
        times still accumulate into parents — with ``args`` (default
        ``{"aborted": True}``) marking the abnormal close, so the span
        stack stays well-nested and a truncated trace still exports as
        schema-valid Chrome JSON.  Returns the number of spans closed."""
        if args is None:
            args = {"aborted": True}
        n = 0
        while self._stack:
            self.end(sim_t, args)
            n += 1
        return n

    # ----------------------------------------------------------- counters
    def counters_due(self, sim_t: float) -> bool:
        ns = self._next_snap
        return ns is not None and sim_t >= ns

    def snapshot(self, sim_t: float,
                 gauges: Optional[Dict[str, float]] = None) -> dict:
        snap = self.counters.snapshot(sim_t, self.clock() - self.epoch,
                                      gauges)
        if self._next_snap is not None:
            every = self.counters_every
            # cadence anchored at t=0: next boundary strictly after sim_t
            self._next_snap = (math.floor(sim_t / every) + 1.0) * every
        if self.on_snapshot is not None:
            self.on_snapshot(sim_t, snap)
        return snap

    # ---------------------------------------------------------- reporting
    def wall_elapsed(self) -> float:
        return self.clock() - self.epoch

    def to_unix_ns(self, t: float) -> int:
        """A time ``t`` (s from the epoch, as span records' ``t0_s``) on the
        real-time clock, in ns since the Unix epoch: the clock of the CUDA
        profiler's trace (``kineto_results.trace_start_ns()``).  Exact to
        ``anchor_s`` plus the two clocks' drift over ``t``."""
        return self.epoch_unix_ns + round(t * 1e9)

    def profile(self) -> Dict[Tuple[str, str], list]:
        """``(cat, name) -> [count, total_s, self_s]`` aggregate (live
        reference; copy before mutating)."""
        return self._profile

    def deterministic_view(self) -> dict:
        """The seed-reproducible portion of the trace: everything except
        wall-clock times.  Two runs of the same spec + seed must produce
        identical views (regression-tested)."""
        return {
            "spans": [(c, n, round(sim_t, 9), args)
                      for c, n, _t0, _dur, sim_t, _self, args in self.spans],
            "instants": [(c, n, round(sim_t, 9), args)
                         for c, n, _wall, sim_t, args in self.instants],
            "counter_series": [(round(sim_t, 9), snap)
                               for sim_t, _wall, snap in
                               self.counters.series],
            "counters": dict(self.counters.values),
        }
