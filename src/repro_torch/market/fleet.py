"""Spot-fleet manager with fallback ladders (paper-motivated resilience layer).

The paper's resilience story is per-VM (hibernate, resume, re-bid); real
spot systems instead hold a *fleet* at a target capacity across diversified
pools and degrade gracefully when the market misbehaves.  This module adds
that layer:

* :class:`FleetConfig` — target capacity, per-pool weights, diversification
  strategy, and a configurable **fallback ladder** with per-rung retry
  budgets and exponential backoff.
* :class:`FleetManager` — a slot state machine driven once per PRICE_TICK:
  each slot of ``unit_cpu`` capacity is observed (the dense market registry
  answers "what is still running" in one vectorized pass), shortfall is
  detected, and dead slots are replenished — fresh slots through the
  strategy's residual-capacity apportionment, interrupted slots through the
  ladder: retry same pool → cheaper pool → on-demand fallback → queue work →
  scale down.
* :func:`plan_replenish` — the vectorized apportionment planner, with
  :func:`plan_replenish_ref` as the per-pool Python oracle it is
  regression-tested (and benchmarked) against; likewise
  :func:`fleet_pool_capacity` / :func:`fleet_pool_capacity_ref` for the
  registry liveness scan.

Strategies register in :data:`FLEET_STRATEGY_REGISTRY`
(``@register_fleet_strategy("name")``), so ``FleetSpec`` can sweep
fleet-vs-per-VM baselines by name, in the registries' style.

Everything is deterministic: no RNG anywhere in the manager — identical
ticks produce identical launches, which is what makes the chaos-determinism
tests (two-run bit-identity under injected faults) possible.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.registry import Registry, named
from ..core.types import (InterruptionBehavior, VmState, make_on_demand,
                          make_spot, resources)
from ..obs.eventlog import NULL_RECORDER
from ..obs.tracer import NULL_TRACER

_EPS = 1e-9

#: fallback-ladder rung names, in canonical escalation order; a rung may
#: also be ``"pool:<k>"`` — retry pinned to pool ``k``
LADDER_RUNGS = ("same-pool", "cheaper-pool", "on-demand", "queue",
                "scale-down")

#: string-keyed registry of diversification strategies — apportionment
#: functions ``(need, cur_units, cap_units, weights, prices) -> counts``
FLEET_STRATEGY_REGISTRY = Registry("fleet strategy")
register_fleet_strategy = FLEET_STRATEGY_REGISTRY.register

#: slot states a fleet VM counts as "up" in the capacity sample (INTERRUPTING
#: and MIGRATING VMs still hold and execute on their capacity)
_UP_STATES = (VmState.RUNNING, VmState.INTERRUPTING, VmState.MIGRATING)


@dataclass(frozen=True)
class FleetConfig:
    """Configuration of one spot fleet (the ``FleetSpec`` payload).

    ``target_capacity`` CPU units are held as ``ceil(target/unit_cpu)``
    slots of ``unit_cpu`` × ``unit_ram`` each.  Spot launches bid
    ``bid_fraction`` × the pool's on-demand rate.  ``pool_weights`` steers
    the diversification (None = uniform); the ladder's per-rung budgets and
    the exponential backoff (``base × mult^(k-1)``, capped) pace replacement
    attempts so storms don't thrash the allocator.  An on-demand fallback
    runs for ``od_lease`` seconds, then the slot returns to spot."""
    strategy: str = "diversified"
    target_capacity: float = 64.0
    unit_cpu: float = 2.0
    unit_ram: float = 2048.0
    bid_fraction: float = 0.6
    pool_weights: Optional[Tuple[float, ...]] = None
    ladder: Tuple[Tuple[str, int], ...] = (
        ("same-pool", 2), ("cheaper-pool", 2), ("on-demand", 1),
        ("queue", 2), ("scale-down", 1))
    backoff_base: float = 60.0
    backoff_mult: float = 2.0
    backoff_cap: float = 960.0
    od_lease: float = 1800.0


def _rung_pool(rung: str) -> Optional[int]:
    """The pinned pool id of a ``"pool:<k>"`` rung, else None."""
    if rung.startswith("pool:"):
        try:
            return int(rung[5:])
        except ValueError:
            return None
    return None


def validate_fleet_config(cfg: FleetConfig,
                          n_pools: Optional[int] = None) -> None:
    """Fail-fast validation (construction-time, fail-fast errors).  With
    ``n_pools`` known, also checks weight length and pinned-rung pool ids."""
    if not cfg.target_capacity > 0:
        raise ValueError(
            f"fleet target_capacity must be > 0 (got {cfg.target_capacity!r})")
    if not cfg.unit_cpu > 0:
        raise ValueError(f"fleet unit_cpu must be > 0 (got {cfg.unit_cpu!r})")
    if not cfg.bid_fraction > 0:
        raise ValueError(
            f"fleet bid_fraction must be > 0 (got {cfg.bid_fraction!r})")
    if cfg.pool_weights is not None:
        w = [float(x) for x in cfg.pool_weights]
        if any(x < 0 for x in w):
            raise ValueError(
                f"conflicting fleet pool_weights {tuple(w)}: negative weight")
        if not any(x > 0 for x in w):
            raise ValueError(
                f"conflicting fleet pool_weights {tuple(w)}: all zero — no "
                "pool can receive capacity")
        if n_pools is not None and len(w) != n_pools:
            raise ValueError(
                f"fleet pool_weights has {len(w)} entries for {n_pools} "
                "pools")
    if not cfg.ladder:
        raise ValueError("fleet fallback ladder must have at least one rung")
    for entry in cfg.ladder:
        rung, budget = entry
        pinned = _rung_pool(rung)
        if rung not in LADDER_RUNGS and pinned is None:
            raise ValueError(
                f"unknown fallback rung {rung!r} "
                f"(known: {', '.join(LADDER_RUNGS)}, or 'pool:<k>')")
        if pinned is not None and pinned < 0:
            raise ValueError(f"fallback rung {rung!r} names a negative pool")
        if pinned is not None and n_pools is not None and pinned >= n_pools:
            raise ValueError(
                f"fallback rung {rung!r} names unknown pool {pinned} "
                f"(known pools: 0..{n_pools - 1})")
        if int(budget) < 1:
            raise ValueError(
                f"fallback rung {rung!r} retry budget must be >= 1 "
                f"(got {budget!r})")
    if not cfg.backoff_base > 0:
        raise ValueError(
            f"fleet backoff_base must be > 0 (got {cfg.backoff_base!r})")
    if not cfg.backoff_mult >= 1.0:
        raise ValueError(
            f"fleet backoff_mult must be >= 1 (got {cfg.backoff_mult!r})")
    if not cfg.backoff_cap >= cfg.backoff_base:
        raise ValueError(
            f"fleet backoff_cap must be >= backoff_base "
            f"(got {cfg.backoff_cap!r} < {cfg.backoff_base!r})")
    if not cfg.od_lease > 0:
        raise ValueError(f"fleet od_lease must be > 0 (got {cfg.od_lease!r})")


# ---------------------------------------------------------------------------
# registry liveness scan (vectorized + Python oracle) — benchmarked pair
# ---------------------------------------------------------------------------
def fleet_pool_capacity(registry: Dict[str, np.ndarray],
                        fleet_vids: np.ndarray,
                        n_pools: int) -> Tuple[np.ndarray, np.ndarray]:
    """(units, cpu) per pool held by the fleet's rows of the dense RUNNING-
    spot registry: one sorted-membership test + two bincounts, no per-VM
    walk.  ``fleet_vids`` must be sorted unique (the manager's live slot
    ids)."""
    vids = registry["vid"]
    if vids.size == 0 or fleet_vids.size == 0:
        return np.zeros(n_pools, dtype=np.int64), np.zeros(n_pools)
    mask = np.isin(vids, fleet_vids, assume_unique=True)
    pools = registry["pool"][mask]
    units = np.bincount(pools, minlength=n_pools).astype(np.int64)
    cpu = np.bincount(pools, weights=registry["cpu"][mask],
                      minlength=n_pools)
    return units, cpu


def fleet_pool_capacity_ref(registry: Dict[str, np.ndarray],
                            fleet_vids: np.ndarray,
                            n_pools: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row Python oracle of :func:`fleet_pool_capacity` — accumulates in
    registry row order, matching ``bincount`` bit for bit."""
    fset = {int(v) for v in fleet_vids}
    units = [0] * n_pools
    cpu = [0.0] * n_pools
    for i in range(registry["vid"].size):
        if int(registry["vid"][i]) in fset:
            p = int(registry["pool"][i])
            units[p] += 1
            cpu[p] += float(registry["cpu"][i])
    return np.asarray(units, dtype=np.int64), np.asarray(cpu)


# ---------------------------------------------------------------------------
# replenish planning (vectorized + Python oracle) — benchmarked pair
# ---------------------------------------------------------------------------
def _admissible_caps(prices, bids, free_cpu, weights,
                     unit_cpu: float) -> np.ndarray:
    """(n_pools,) int64 units each pool can admit right now: price must
    clear the fleet's bid, free CPU bounds the count, zero-weight pools are
    excluded from planning entirely."""
    adm = ((prices <= bids + _EPS) & (free_cpu >= unit_cpu - _EPS)
           & (weights > 0.0))
    return np.where(adm, np.floor(free_cpu / unit_cpu).astype(np.int64), 0)


@named("diversified")
def _diversified(need: int, cur_units, cap_units, weights, prices):
    """Residual-capacity apportionment (clusterman-style): target the
    weight-proportional split of ``current + need`` units, allocate the
    positive residuals by largest remainder (price then pool id break
    ties), round-robin any cap-limited leftover."""
    n = weights.size
    counts = np.zeros(n, dtype=np.int64)
    if need <= 0 or not cap_units.any():
        return counts
    total = float(np.sum(cur_units)) + float(need)
    wsum = float(np.sum(weights))
    desired = weights * (total / wsum)
    residual = np.maximum(desired - cur_units, 0.0)
    residual = np.where(cap_units > 0, residual, 0.0)
    rsum = float(np.sum(residual))
    if rsum <= 0.0:
        # balanced already (or residual pools inadmissible): cheapest first
        return _fill_by_price(need, cap_units, prices)
    shares = residual * (float(need) / rsum)
    floors = np.floor(shares)
    counts[:] = np.minimum(floors.astype(np.int64), cap_units)
    frac = shares - floors
    order = np.lexsort((np.arange(n), prices, -frac))
    rem = need - int(counts.sum())
    while rem > 0:
        progress = False
        for p in order:
            if rem == 0:
                break
            if counts[p] < cap_units[p]:
                counts[p] += 1
                rem -= 1
                progress = True
        if not progress:
            break
    return counts


def _fill_by_price(need: int, cap_units, prices) -> np.ndarray:
    n = prices.size
    counts = np.zeros(n, dtype=np.int64)
    order = np.lexsort((np.arange(n), prices))
    rem = need
    for p in order:
        take = min(rem, int(cap_units[p]))
        counts[p] = take
        rem -= take
        if rem == 0:
            break
    return counts


@named("lowest-price")
def _lowest_price(need: int, cur_units, cap_units, weights, prices):
    """Fill the cheapest admissible pool first, spilling to the next by
    price (pool id breaks ties) — maximal savings, minimal diversification."""
    if need <= 0:
        return np.zeros(weights.size, dtype=np.int64)
    return _fill_by_price(need, cap_units, prices)


@named("single-pool")
def _single_pool(need: int, cur_units, cap_units, weights, prices):
    """Everything in the highest-weight pool (first on ties) — the
    undiversified baseline the resilience sweep compares against."""
    n = weights.size
    counts = np.zeros(n, dtype=np.int64)
    if need <= 0:
        return counts
    best = int(np.argmax(weights))
    counts[best] = min(need, int(cap_units[best]))
    return counts


# Registered by each strategy's ``name`` attribute (see ``named``).
for _fn in (_diversified, _lowest_price, _single_pool):
    FLEET_STRATEGY_REGISTRY.register(_fn.name, _fn)
del _fn


def plan_replenish(need: int, cur_units, weights, prices, bids, free_cpu,
                   unit_cpu: float, strategy: str = "diversified"
                   ) -> np.ndarray:
    """(n_pools,) int64 launch counts covering ``need`` replacement slots.
    Admissibility (price clears the bid, free CPU holds a unit, weight > 0)
    caps each pool; the registered ``strategy`` apportions within the caps.
    May total less than ``need`` when capacity is short — unserved slots
    retry next tick."""
    cur_units = np.asarray(cur_units, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float64)
    prices = np.asarray(prices, dtype=np.float64)
    bids = np.asarray(bids, dtype=np.float64)
    free_cpu = np.asarray(free_cpu, dtype=np.float64)
    cap_units = _admissible_caps(prices, bids, free_cpu, weights, unit_cpu)
    fn = FLEET_STRATEGY_REGISTRY.get(strategy)
    return fn(int(need), cur_units, cap_units, weights, prices)


def plan_replenish_ref(need: int, cur_units, weights, prices, bids,
                       free_cpu, unit_cpu: float,
                       strategy: str = "diversified") -> np.ndarray:
    """Per-pool Python oracle of :func:`plan_replenish`: identical decisions
    bit for bit.  Shared scalar reductions go through ``float(np.sum(...))``
    (pairwise summation differs from a sequential Python sum in the last
    ulp); the per-pool arithmetic is plain scalar IEEE, matching numpy's
    elementwise kernels exactly."""
    n = len(prices)
    need = int(need)
    cap_units = [0] * n
    for p in range(n):
        if (float(prices[p]) <= float(bids[p]) + _EPS
                and float(free_cpu[p]) >= unit_cpu - _EPS
                and float(weights[p]) > 0.0):
            cap_units[p] = int(math.floor(float(free_cpu[p]) / unit_cpu))
    counts = [0] * n

    def fill_by_price(rem):
        for p in sorted(range(n), key=lambda q: (float(prices[q]), q)):
            take = min(rem, cap_units[p])
            counts[p] = take
            rem -= take
            if rem == 0:
                break
        return counts

    if strategy == "single-pool":
        if need <= 0:
            return np.asarray(counts, dtype=np.int64)
        best = 0
        for p in range(1, n):
            if float(weights[p]) > float(weights[best]):
                best = p
        counts[best] = min(need, cap_units[best])
        return np.asarray(counts, dtype=np.int64)
    if strategy == "lowest-price":
        if need > 0:
            fill_by_price(need)
        return np.asarray(counts, dtype=np.int64)
    if strategy != "diversified":
        raise ValueError(f"no reference walk for strategy {strategy!r}")
    if need <= 0 or not any(cap_units):
        return np.asarray(counts, dtype=np.int64)
    total = float(np.sum(np.asarray(cur_units, dtype=np.int64))) + float(need)
    wsum = float(np.sum(np.asarray(weights, dtype=np.float64)))
    desired = [float(weights[p]) * (total / wsum) for p in range(n)]
    residual = [max(desired[p] - float(cur_units[p]), 0.0) if cap_units[p] > 0
                else 0.0 for p in range(n)]
    rsum = float(np.sum(np.asarray(residual, dtype=np.float64)))
    if rsum <= 0.0:
        fill_by_price(need)
        return np.asarray(counts, dtype=np.int64)
    shares = [residual[p] * (float(need) / rsum) for p in range(n)]
    floors = [math.floor(shares[p]) for p in range(n)]
    for p in range(n):
        counts[p] = min(int(floors[p]), cap_units[p])
    frac = [shares[p] - floors[p] for p in range(n)]
    order = sorted(range(n), key=lambda q: (-frac[q], float(prices[q]), q))
    rem = need - sum(counts)
    while rem > 0:
        progress = False
        for p in order:
            if rem == 0:
                break
            if counts[p] < cap_units[p]:
                counts[p] += 1
                rem -= 1
                progress = True
        if not progress:
            break
    return np.asarray(counts, dtype=np.int64)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------
class FleetManager:
    """Holds ``ceil(target/unit)`` capacity slots and keeps them filled.

    Driven once per PRICE_TICK by the simulator (post-wave, post-flush,
    post-planner).  Each slot is empty, or owns one VM (spot, or on-demand
    while riding the ``"on-demand"`` rung).  Slot lifecycle:

    * fresh (never ran / od lease ended) — batched through the strategy's
      apportionment, retried every tick while inadmissible (no backoff);
    * healthy — its VM reached RUNNING; ladder state is reset;
    * episode — its VM died after running: the slot walks the fallback
      ladder, one attempt per due tick, per-rung retry budgets, exponential
      backoff between attempts; an exhausted ladder (or the ``scale-down``
      rung) retires the slot and lowers the effective target.

    Fleet VMs are non-persistent TERMINATE spot requests: a failed placement
    FAILs immediately (observed next tick as a consumed attempt) and an
    interrupted slot is *replaced*, never hibernated — replacement is the
    fleet's whole job.  Stateful across one run; use a fresh manager per
    simulation, like the engine."""

    #: telemetry hook (``repro.obs``); the build layer swaps in the live
    #: tracer — rung hits and launches feed the counter registry
    tracer = NULL_TRACER
    #: event recorder — rung/launch/retire records for the flight log
    events = NULL_RECORDER

    def __init__(self, config: FleetConfig, n_pools: int):
        validate_fleet_config(config, n_pools)
        FLEET_STRATEGY_REGISTRY.get(config.strategy)   # fail fast
        self.config = config
        self.n_pools = int(n_pools)
        if config.pool_weights is not None:
            self.weights = np.asarray(config.pool_weights, dtype=np.float64)
        else:
            self.weights = np.ones(self.n_pools, dtype=np.float64)
        self.n_slots = int(math.ceil(config.target_capacity
                                     / config.unit_cpu))
        self._ladder = tuple((str(r), int(b)) for r, b in config.ladder)
        n = self.n_slots
        self.slot_vid = np.full(n, -1, dtype=np.int64)
        self.slot_pool = np.full(n, -1, dtype=np.int64)   # home pool
        self.slot_rung = np.full(n, -1, dtype=np.int64)   # -1 = fresh/healthy
        self.slot_tries = np.zeros(n, dtype=np.int64)     # used at this rung
        self.slot_fail = np.zeros(n, dtype=np.int64)      # backoff exponent
        self.slot_next = np.zeros(n)                      # earliest attempt
        self.slot_retired = np.zeros(n, dtype=bool)
        self.slot_od = np.zeros(n, dtype=bool)
        self.slot_ran = np.zeros(n, dtype=bool)           # incarnation ran?
        #: slots taken out of service by the autoscaler (scale-in); unlike
        #: ladder retirement they are reversible — scale-out reuses them
        self.slot_shed = np.zeros(n, dtype=bool)
        #: unit target the autoscaler last requested (the capacity
        #: interface); starts at the provisioned slot count
        self.target_units = n
        # retarget bookkeeping: None until set_target_units first runs, so
        # an autoscaler-less fleet keeps the original effective-target formula
        # (and its metrics) bit for bit
        self._units_override: Optional[int] = None
        self._retired_base = 0

    # ------------------------------------------------------------- queries
    def wants_tick(self) -> bool:
        """Any in-service (unretired, unshed) slot left?  Keeps a bounded
        run's PRICE_TICK chain alive through backoff waits when nothing
        else is running."""
        return bool(np.any(~self.slot_retired & ~self.slot_shed))

    def effective_target(self) -> float:
        """Target CPU after scale-down: retired slots lower the bar (the
        fleet *chose* to shrink; shortfall metrics measure against what it
        still promises).  Once the autoscaler has retargeted, the promise
        is its requested units minus any retirements since."""
        retired = float(np.count_nonzero(self.slot_retired))
        unit = self.config.unit_cpu
        if self._units_override is None:
            return self.config.target_capacity - retired * unit
        return (float(self._units_override) * unit
                - (retired - float(self._retired_base)) * unit)

    def _backoff(self, fails: int) -> float:
        cfg = self.config
        return min(cfg.backoff_cap,
                   cfg.backoff_base * cfg.backoff_mult ** (fails - 1))

    # ----------------------------------------- dynamic capacity (autoscale)
    def set_target_units(self, sim, n: int, now: float) -> None:
        """Retarget the fleet to ``n`` unit slots — the autoscaler's lever.

        Scale-out un-sheds parked slots first (they re-enter the fresh
        apportionment next tick), then grows the slot arrays.  Scale-in
        sheds empty slots first, then decommissions live RUNNING /
        INTERRUPTING VMs highest-index first (their work drains through the
        ordinary finish path); WAITING / MIGRATING slots are left alone —
        best effort, the next evaluation retries.  Ladder-retired slots
        never come back."""
        n = int(n)
        cur = int(np.count_nonzero(~self.slot_retired & ~self.slot_shed))
        self.target_units = n
        self._units_override = n
        self._retired_base = int(np.count_nonzero(self.slot_retired))
        if n > cur:
            need = n - cur
            parked = np.flatnonzero(self.slot_shed & ~self.slot_retired)
            for s in parked[:need]:
                self._reset_slot(int(s), now)
            need -= min(need, int(parked.size))
            if need > 0:
                self._grow_slots(need, now)
        elif n < cur:
            rem = cur - n
            in_service = [s for s in range(self.n_slots - 1, -1, -1)
                          if not self.slot_retired[s]
                          and not self.slot_shed[s]]
            empty = [s for s in in_service if self.slot_vid[s] < 0]
            live = [s for s in in_service if self.slot_vid[s] >= 0]
            for s in empty + live:
                if rem == 0:
                    break
                vid = int(self.slot_vid[s])
                if vid >= 0:
                    vm = sim.vms[vid]
                    if vm.state not in (VmState.RUNNING,
                                        VmState.INTERRUPTING):
                        continue    # in flight — not safely shedable now
                    sim.decommission(vm)
                self.slot_shed[s] = True
                self.slot_vid[s] = -1
                self.slot_od[s] = False
                self.slot_ran[s] = False
                self.slot_rung[s] = -1
                self.slot_tries[s] = 0
                self.slot_fail[s] = 0
                rem -= 1

    def _reset_slot(self, s: int, now: float) -> None:
        """Return a shed slot to service as a fresh spot slot."""
        self.slot_shed[s] = False
        self.slot_vid[s] = -1
        self.slot_pool[s] = -1
        self.slot_rung[s] = -1
        self.slot_tries[s] = 0
        self.slot_fail[s] = 0
        self.slot_next[s] = now
        self.slot_od[s] = False
        self.slot_ran[s] = False

    def _grow_slots(self, k: int, now: float) -> None:
        """Append ``k`` fresh in-service slots to every state array."""
        self.slot_vid = np.concatenate(
            [self.slot_vid, np.full(k, -1, dtype=np.int64)])
        self.slot_pool = np.concatenate(
            [self.slot_pool, np.full(k, -1, dtype=np.int64)])
        self.slot_rung = np.concatenate(
            [self.slot_rung, np.full(k, -1, dtype=np.int64)])
        self.slot_tries = np.concatenate(
            [self.slot_tries, np.zeros(k, dtype=np.int64)])
        self.slot_fail = np.concatenate(
            [self.slot_fail, np.zeros(k, dtype=np.int64)])
        self.slot_next = np.concatenate(
            [self.slot_next, np.full(k, float(now), dtype=np.float64)])
        self.slot_retired = np.concatenate(
            [self.slot_retired, np.zeros(k, dtype=bool)])
        self.slot_od = np.concatenate(
            [self.slot_od, np.zeros(k, dtype=bool)])
        self.slot_ran = np.concatenate(
            [self.slot_ran, np.zeros(k, dtype=bool)])
        self.slot_shed = np.concatenate(
            [self.slot_shed, np.zeros(k, dtype=bool)])
        self.n_slots += k

    # ---------------------------------------------------------------- tick
    def on_tick(self, sim, now: float) -> None:
        cfg = self.config
        m = sim.metrics
        vms = sim.vms
        # -- observe every slot; update the state machine ------------------
        up_cpu = 0.0
        for s in range(self.n_slots):
            if self.slot_retired[s] or self.slot_shed[s]:
                continue
            vid = int(self.slot_vid[s])
            if vid < 0:
                continue
            vm = vms[vid]
            st = vm.state
            if st in _UP_STATES:
                up_cpu += float(vm.demand[0])
                if not self.slot_ran[s] or self.slot_rung[s] >= 0:
                    # the attempt landed: healthy, ladder state resets
                    self.slot_ran[s] = True
                    self.slot_rung[s] = -1
                    self.slot_tries[s] = 0
                    self.slot_fail[s] = 0
                continue
            if st is VmState.WAITING:
                continue    # in flight — neither up nor dead yet
            # dead: FINISHED / TERMINATED / FAILED
            if st is VmState.FINISHED and self.slot_od[s]:
                # on-demand lease ran its course: back to a fresh spot slot
                self.slot_vid[s] = -1
                self.slot_od[s] = False
                self.slot_ran[s] = False
                self.slot_rung[s] = -1
                self.slot_tries[s] = 0
                self.slot_fail[s] = 0
                self.slot_next[s] = now
                continue
            if self.slot_ran[s]:
                # was up, got reclaimed → open a fallback episode
                if vm.pool >= 0:
                    self.slot_pool[s] = int(vm.pool)
                self.slot_vid[s] = -1
                self.slot_od[s] = False
                self.slot_ran[s] = False
                self.slot_rung[s] = 0
                self.slot_tries[s] = 0
                self.slot_fail[s] = 0
                self.slot_next[s] = now
            else:
                # the launch attempt failed at placement; the try was
                # consumed at launch — wait out its backoff
                self.slot_vid[s] = -1
                self.slot_od[s] = False
        m.fleet_samples.append((now, up_cpu, self.effective_target()))
        # -- market snapshot for this tick's planning ----------------------
        eng = sim.engine
        prices = eng.prices
        bids = cfg.bid_fraction * eng.od_rates
        free_cpu = sim.pool.pool_free_cpu().astype(np.float64).copy()
        live_spot = self.slot_vid[(self.slot_vid >= 0) & ~self.slot_od]
        cur_units, _ = fleet_pool_capacity(
            sim.pool.market_registry(), np.sort(live_spot), self.n_pools)
        # -- fresh slots: batched strategy apportionment -------------------
        due = [s for s in range(self.n_slots)
               if not self.slot_retired[s] and not self.slot_shed[s]
               and self.slot_vid[s] < 0 and self.slot_next[s] <= now + _EPS]
        fresh = [s for s in due if self.slot_rung[s] < 0]
        if fresh:
            counts = plan_replenish(len(fresh), cur_units, self.weights,
                                    prices, bids, free_cpu, cfg.unit_cpu,
                                    cfg.strategy)
            targets = [p for p in range(self.n_pools)
                       for _ in range(int(counts[p]))]
            # zip truncates: slots beyond admissible capacity stay fresh
            # and re-enter the apportionment next tick
            for s, p in zip(fresh, targets):
                m.fallback_counts["launch"] = (
                    m.fallback_counts.get("launch", 0) + 1)
                if self.tracer.enabled:
                    self.tracer.counters.inc("fleet/rung/launch")
                if self.events.enabled:
                    self.events.emit(now, "fleet-rung", pool=int(p),
                                     a=float(s), aux="launch")
                self._launch_spot(sim, s, p, now, bids, free_cpu)
        # -- episode slots: one ladder attempt each ------------------------
        for s in due:
            if self.slot_rung[s] < 0 or self.slot_vid[s] >= 0:
                continue
            while (self.slot_rung[s] < len(self._ladder)
                   and self.slot_tries[s]
                   >= self._ladder[int(self.slot_rung[s])][1]):
                self.slot_rung[s] += 1
                self.slot_tries[s] = 0
            if self.slot_rung[s] >= len(self._ladder):
                self._retire(sim, s, now)
                continue
            self._attempt(sim, s, now, prices, bids, free_cpu)

    # ------------------------------------------------------------- actions
    def _attempt(self, sim, s: int, now: float, prices, bids,
                 free_cpu) -> None:
        """One fallback-ladder attempt for episode slot ``s``; always
        consumes a try and arms the backoff (success is only known next
        tick, when the slot's VM is observed RUNNING)."""
        cfg = self.config
        m = sim.metrics
        rung = self._ladder[int(self.slot_rung[s])][0]
        m.fallback_counts[rung] = m.fallback_counts.get(rung, 0) + 1
        if self.tracer.enabled:
            self.tracer.counters.inc("fleet/rung/" + rung)
            self.tracer.instant("fleet", "rung/" + rung, now,
                                {"slot": int(s)})
        if self.events.enabled:
            self.events.emit(now, "fleet-rung", a=float(s), aux=rung)
        if rung == "scale-down":
            self._retire(sim, s, now)
            return
        if rung != "queue":
            pinned = _rung_pool(rung)
            if rung == "on-demand":
                p = self._od_pool(free_cpu)
                if p >= 0:
                    self._launch_od(sim, s, p, now, free_cpu)
            else:
                home = int(self.slot_pool[s])
                if rung == "same-pool":
                    p = home if home >= 0 else 0
                    if not self._admissible(p, prices, bids, free_cpu):
                        p = -1
                elif pinned is not None:
                    p = pinned
                    if not self._admissible(p, prices, bids, free_cpu):
                        p = -1
                else:   # cheaper-pool
                    p = self._cheapest_other(home, prices, bids, free_cpu)
                if p >= 0:
                    self._launch_spot(sim, s, p, now, bids, free_cpu)
            # an inadmissible rung submits nothing — the try still counts
        self.slot_tries[s] += 1
        self.slot_fail[s] += 1
        self.slot_next[s] = now + self._backoff(int(self.slot_fail[s]))

    def _admissible(self, p: int, prices, bids, free_cpu) -> bool:
        return (float(prices[p]) <= float(bids[p]) + _EPS
                and float(free_cpu[p]) >= self.config.unit_cpu - _EPS)

    def _cheapest_other(self, home: int, prices, bids, free_cpu) -> int:
        best = -1
        for p in range(self.n_pools):
            if p == home or not self._admissible(p, prices, bids, free_cpu):
                continue
            if best < 0 or float(prices[p]) < float(prices[best]) - _EPS:
                best = p
        return best

    def _od_pool(self, free_cpu) -> int:
        """On-demand fallback pool: most free CPU (lowest id on ties) that
        can hold a unit — on-demand ignores price admission by definition."""
        best = -1
        for p in range(self.n_pools):
            if float(free_cpu[p]) < self.config.unit_cpu - _EPS:
                continue
            if best < 0 or float(free_cpu[p]) > float(free_cpu[best]) + _EPS:
                best = p
        return best

    def _launch_spot(self, sim, s: int, p: int, now: float, bids,
                     free_cpu) -> None:
        cfg = self.config
        vid = sim.new_vm_id()
        vm = make_spot(
            vid, resources(cfg.unit_cpu, cfg.unit_ram, 10.0, 1024.0),
            duration=float("inf"),
            behavior=InterruptionBehavior.TERMINATE, persistent=False,
            submit_time=now, bid=float(bids[p]), pool=int(p))
        sim.submit(vm)
        self.slot_vid[s] = vid
        self.slot_pool[s] = int(p)
        self.slot_od[s] = False
        self.slot_ran[s] = False
        free_cpu[p] -= cfg.unit_cpu     # same-tick launches share the budget
        sim.metrics.fleet_launches += 1
        sim.metrics.fleet_spot_ids.append(vid)
        if self.events.enabled:
            self.events.emit(now, "fleet-launch", vm=vid, pool=int(p),
                             a=float(bids[p]), b=float(s), aux="spot")

    def _launch_od(self, sim, s: int, p: int, now: float,
                   free_cpu) -> None:
        cfg = self.config
        vid = sim.new_vm_id()
        vm = make_on_demand(
            vid, resources(cfg.unit_cpu, cfg.unit_ram, 10.0, 1024.0),
            duration=cfg.od_lease, persistent=False,
            submit_time=now, pool=int(p))
        sim.submit(vm)
        self.slot_vid[s] = vid
        self.slot_pool[s] = int(p)
        self.slot_od[s] = True
        self.slot_ran[s] = False
        free_cpu[p] -= cfg.unit_cpu
        sim.metrics.od_spill_launches += 1
        sim.metrics.fleet_od_ids.append(vid)
        if self.events.enabled:
            self.events.emit(now, "fleet-launch", vm=vid, pool=int(p),
                             b=float(s), aux="od")

    def _retire(self, sim, s: int, now: float) -> None:
        """Scale down: give the slot up for good and lower the effective
        target — graceful degradation instead of thrash."""
        self.slot_retired[s] = True
        self.slot_vid[s] = -1
        sim.metrics.fleet_slots_retired += 1
        if self.events.enabled:
            self.events.emit(now, "fleet-retire", a=float(s))


def make_fleet_manager(n_pools: int, config: Optional[FleetConfig] = None,
                       **kwargs) -> FleetManager:
    """Build a manager from a config (or config kwargs); unknown strategy
    names fail fast with the known list, in the registries' style."""
    cfg = config if config is not None else FleetConfig(**kwargs)
    return FleetManager(cfg, n_pools)
