"""Deterministic market fault injection (chaos layer for the fleet PR).

The resilience claims of the fleet manager ("the workload stays up") are
only testable if the market can be made to misbehave *on demand*.  This
module injects faults as scripted or stochastic (seeded, pre-drawn) event
sources that **compose with the existing PRICE_TICK machinery** instead of
bypassing it:

* ``capacity-crunch`` — a per-pool utilization bias added to the live
  demand signal *before* the price processes clear: prices rise through the
  normal clearing curve, waves fire through the normal registry comparison.
* ``price-spike``    — a per-pool additive bias on the tick's standard-
  normal shock vector (both the fused family step and the scalar oracle
  consume the biased shocks, so the two engine paths stay bit-identical).
* ``pool-outage``    — a transient whole-pool outage: every active host of
  the pool is deactivated at the window start (residents evicted through
  the ordinary interruption lifecycle, cause ``"fault-outage"``) and
  reactivated at the window end.
* ``storm``          — a correlated interruption storm: at the fault time a
  fraction of each affected pool's *resident running spot VMs* is reclaimed
  immediately (cause ``"fault-storm"``), lowest bids first — the provider
  reclaiming capacity across pools at once, ignoring price admission.

Every fault is a :class:`FaultEvent` with an absolute start time; stochastic
scenarios (``random-storms``) pre-draw their whole schedule from the seed at
construction, so two runs at the same seed are bit-identical (the chaos-
determinism contract, regression-tested in ``tests/market/test_faults``).

Scenario generators register in :data:`FAULT_REGISTRY`
(``@register_fault_scenario("name")``) and are resolved by ``FaultSpec`` /
the builder, in the registries' style.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.causes import InterruptionCause
from ..obs.eventlog import NULL_RECORDER
from ..core.registry import Registry, named

_EPS = 1e-9

#: fault kinds an event may carry (validated at injector construction)
FAULT_KINDS = ("capacity-crunch", "price-spike", "pool-outage", "storm")

#: string-keyed registry of fault *scenarios* — factories
#: ``(n_pools, horizon, tick_interval, seed, **params) -> Sequence[FaultEvent]``;
#: ``FaultSpec`` and the builder resolve against it
FAULT_REGISTRY = Registry("fault scenario")
register_fault_scenario = FAULT_REGISTRY.register


@dataclass(frozen=True)
class FaultEvent:
    """One injected fault.

    ``magnitude`` is kind-specific: utilization delta (``capacity-crunch``),
    additive standard-normal shock (``price-spike``), or the fraction of
    resident spot VMs reclaimed (``storm``); unused for ``pool-outage``.
    ``pools`` is a tuple of pool ids, or None for *all* pools (the
    correlated case)."""
    kind: str
    t0: float
    duration: float = 0.0
    pools: Optional[Tuple[int, ...]] = None
    magnitude: float = 0.0

    @property
    def t1(self) -> float:
        return self.t0 + self.duration


def _validate_event(ev: FaultEvent, n_pools: int) -> None:
    if ev.kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {ev.kind!r} "
                         f"(known: {', '.join(FAULT_KINDS)})")
    if not ev.t0 >= 0.0:
        raise ValueError(f"fault t0 must be >= 0 (got {ev.t0!r})")
    if not ev.duration >= 0.0:
        raise ValueError(f"fault duration must be >= 0 (got {ev.duration!r})")
    if ev.pools is not None:
        bad = [p for p in ev.pools
               if not (isinstance(p, (int, np.integer)) and 0 <= p < n_pools)]
        if bad:
            raise ValueError(
                f"fault names unknown pool(s) {bad} "
                f"(known pools: 0..{n_pools - 1})")
    if ev.kind == "storm" and not (0.0 < ev.magnitude <= 1.0):
        raise ValueError(f"storm fraction must be in (0, 1] "
                         f"(got {ev.magnitude!r})")
    if ev.kind == "capacity-crunch" and not ev.magnitude > 0.0:
        raise ValueError(f"capacity-crunch utilization bias must be > 0 "
                         f"(got {ev.magnitude!r})")


class FaultInjector:
    """Holds a compiled, time-sorted fault schedule and answers the
    simulator's per-tick queries.  Stateful across one run (fired/ended
    flags) — use a fresh injector per simulation, like the engine."""

    #: event recorder — fault activations feed the flight log
    events_log = NULL_RECORDER

    def __init__(self, events: Sequence[FaultEvent], n_pools: int):
        evs = []
        for ev in events:
            if isinstance(ev, dict):
                ev = FaultEvent(**ev)
            _validate_event(ev, n_pools)
            if ev.pools is not None:
                ev = FaultEvent(ev.kind, float(ev.t0), float(ev.duration),
                                tuple(int(p) for p in ev.pools),
                                float(ev.magnitude))
            evs.append(ev)
        # deterministic schedule order regardless of generator order
        evs.sort(key=lambda e: (e.t0, FAULT_KINDS.index(e.kind),
                                e.pools or (), e.magnitude))
        self.events: Tuple[FaultEvent, ...] = tuple(evs)
        self.n_pools = int(n_pools)
        self._started = [False] * len(self.events)
        self._ended = [False] * len(self.events)

    # ------------------------------------------------------------- tick API
    def _pool_ids(self, ev: FaultEvent) -> Tuple[int, ...]:
        return ev.pools if ev.pools is not None else tuple(
            range(self.n_pools))

    def begin_tick(self, now: float) -> Tuple[List[Tuple[int, FaultEvent]],
                                              List[int]]:
        """Advance the schedule to ``now``.  Returns ``(started, ended)``:
        events newly *starting* this tick (index + event — storms fire once,
        outages deactivate their pool, window records go to metrics) and the
        indices of ``pool-outage`` events newly *ending* (reactivate)."""
        started: List[Tuple[int, FaultEvent]] = []
        ended: List[int] = []
        for i, ev in enumerate(self.events):
            if not self._started[i] and ev.t0 <= now + _EPS:
                self._started[i] = True
                started.append((i, ev))
                if self.events_log.enabled:
                    for p in self._pool_ids(ev):
                        self.events_log.emit(
                            now, "fault", pool=int(p),
                            a=float(ev.magnitude), b=float(ev.t1),
                            aux=ev.kind)
            if (self._started[i] and not self._ended[i]
                    and ev.kind == "pool-outage"
                    and now >= ev.t1 - _EPS and ev.t1 > ev.t0):
                self._ended[i] = True
                ended.append(i)
        return started, ended

    def _bias(self, now: float, kind: str) -> Optional[np.ndarray]:
        out = None
        for ev in self.events:
            if ev.kind != kind:
                continue
            if ev.t0 <= now + _EPS < ev.t1 + _EPS and now < ev.t1 - _EPS:
                if out is None:
                    out = np.zeros(self.n_pools)
                for p in self._pool_ids(ev):
                    out[p] += ev.magnitude
        return out

    def util_bias(self, now: float) -> Optional[np.ndarray]:
        """(n_pools,) utilization delta of the active capacity crunches at
        ``now`` (None when none are active — the engine's fast path)."""
        return self._bias(now, "capacity-crunch")

    def shock_bias(self, now: float) -> Optional[np.ndarray]:
        """(n_pools,) additive standard-normal shock of the active price
        spikes at ``now`` (None when none are active)."""
        return self._bias(now, "price-spike")

    def victims(self, registry: Dict[str, np.ndarray],
                ev: FaultEvent) -> np.ndarray:
        """Victim vm ids of storm ``ev`` against the live registry (see
        :func:`storm_victims`); the method keeps the simulator decoupled
        from this module's function layout."""
        return storm_victims(registry, self._pool_ids(ev), ev.magnitude)

    def pending(self) -> bool:
        """Any event still to fire?  Keeps a bounded run's PRICE_TICK chain
        alive through quiet spells before a scheduled fault."""
        return not all(self._started)


def storm_victims(registry: Dict[str, np.ndarray],
                  pools: Sequence[int], fraction: float) -> np.ndarray:
    """Victim VM ids of a correlated interruption storm: per affected pool,
    ``ceil(fraction * residents)`` running spot VMs, lowest bids first (the
    provider reclaims the least-paying capacity; vid breaks ties so the
    selection is deterministic).  One lexsort over the dense registry."""
    m = registry["vid"].size
    if m == 0:
        return np.zeros(0, dtype=np.int64)
    pool_col = registry["pool"]
    vids: List[np.ndarray] = []
    for p in pools:
        rows = np.flatnonzero(pool_col == p)
        if rows.size == 0:
            continue
        k = int(np.ceil(fraction * rows.size))
        order = np.lexsort((registry["vid"][rows], registry["bid"][rows]))
        vids.append(registry["vid"][rows[order[:k]]])
    if not vids:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(vids)


# ---------------------------------------------------------------------------
# built-in fault scenarios
# ---------------------------------------------------------------------------
@named("scripted")
def _scripted(n_pools: int, horizon: float, tick_interval: float, seed: int,
              events: Sequence = ()) -> Tuple[FaultEvent, ...]:
    """Explicit event list (dicts or FaultEvents) — the fully scripted
    scenario; ``FaultSpec.events`` routes here."""
    return tuple(FaultEvent(**e) if isinstance(e, dict) else e
                 for e in events)


@named("storm")
def _storm(n_pools: int, horizon: float, tick_interval: float, seed: int,
           first: float = 3600.0, every: float = 2400.0, count: int = 3,
           fraction: float = 0.5,
           pools: Optional[Sequence[int]] = None) -> Tuple[FaultEvent, ...]:
    """Correlated interruption storms: ``count`` storms starting at
    ``first``, spaced ``every`` seconds, each reclaiming ``fraction`` of
    the resident spot VMs in every affected pool at once."""
    pl = tuple(int(p) for p in pools) if pools is not None else None
    return tuple(FaultEvent("storm", first + k * every, 0.0, pl, fraction)
                 for k in range(int(count)))


@named("random-storms")
def _random_storms(n_pools: int, horizon: float, tick_interval: float,
                   seed: int, rate_per_hour: float = 0.75,
                   fraction: float = 0.4) -> Tuple[FaultEvent, ...]:
    """Stochastic storms: Poisson arrivals over the horizon, whole schedule
    pre-drawn from the seed at construction (deterministic per seed)."""
    h = float(horizon) if horizon else 14400.0
    rng = np.random.default_rng([int(seed), 0xFA])
    n = int(rng.poisson(rate_per_hour * h / 3600.0))
    times = np.sort(rng.uniform(0.0, h, size=n))
    return tuple(FaultEvent("storm", float(t), 0.0, None, fraction)
                 for t in times)


@named("pool-outage")
def _pool_outage(n_pools: int, horizon: float, tick_interval: float,
                 seed: int, pool: int = 0, start: float = 3600.0,
                 duration: float = 900.0) -> Tuple[FaultEvent, ...]:
    """One transient whole-pool outage: hosts down at ``start``, back at
    ``start + duration``."""
    return (FaultEvent("pool-outage", start, duration, (int(pool),)),)


@named("price-spike")
def _price_spike(n_pools: int, horizon: float, tick_interval: float,
                 seed: int, start: float = 3600.0, duration: float = 600.0,
                 magnitude: float = 2.5,
                 pools: Optional[Sequence[int]] = None
                 ) -> Tuple[FaultEvent, ...]:
    """Shock-override price spike: ``magnitude`` standard deviations added
    to the affected pools' per-tick shocks for the window."""
    pl = tuple(int(p) for p in pools) if pools is not None else None
    return (FaultEvent("price-spike", start, duration, pl, magnitude),)


@named("capacity-crunch")
def _capacity_crunch(n_pools: int, horizon: float, tick_interval: float,
                     seed: int, start: float = 3600.0,
                     duration: float = 1200.0, magnitude: float = 0.25,
                     pools: Optional[Sequence[int]] = None
                     ) -> Tuple[FaultEvent, ...]:
    """Utilization-bias capacity crunch: the demand signal feeding the
    clearing curve rises by ``magnitude`` for the window."""
    pl = tuple(int(p) for p in pools) if pools is not None else None
    return (FaultEvent("capacity-crunch", start, duration, pl, magnitude),)


# Registered by each scenario's ``name`` attribute (see ``named``).
for _fn in (_scripted, _storm, _random_storms, _pool_outage, _price_spike,
            _capacity_crunch):
    FAULT_REGISTRY.register(_fn.name, _fn)
del _fn


def make_fault_injector(scenario: str, n_pools: int,
                        horizon: Optional[float], tick_interval: float,
                        seed: int, **params) -> FaultInjector:
    """Build an injector from a registered scenario name (``FaultSpec``'s
    builder entry point).  Unknown names fail fast with the known list."""
    events = FAULT_REGISTRY.get(scenario)(
        n_pools, horizon, tick_interval, seed, **params)
    return FaultInjector(events, n_pools)


#: causes the injector emits (re-exported for tests/docs)
FAULT_CAUSES = InterruptionCause.FAULT_CAUSES
