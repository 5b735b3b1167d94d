"""Proactive cross-pool migration & rebalancing (beyond-paper subsystem).

The paper's finding is that allocation policy choice reduces spot
interruption counts and maximum interruption duration — but a reactive
simulator only moves victims *after* a price wave hits.  This planner runs
on every PRICE_TICK and moves resident spot VMs *ahead* of price spikes
(Voorsluys & Buyya: proactive movement dominates reactive fault tolerance):

1. Every RUNNING spot VM is scored in **one dense masked numpy pass over the
   host pool's market registry** (no per-VM Python walk): for each candidate
   destination pool, ``net = (p̂_src − p̂_dst) · W − downtime · delay_cost``
   where ``p̂`` is the policy's price basis, ``W = min(remaining_work,
   horizon)`` is the savings window, and the downtime term monetizes the
   stop-and-copy delay.
2. Hysteresis: a move needs a price gap above ``hysteresis`` *and* a
   positive net score; an arrived VM is blacked out for ``cooldown`` seconds
   (stamped into the registry), so an oscillating price cannot flap a VM
   A→B→A between consecutive ticks.
3. The selected moves are emitted as :class:`MigrationPlan`s; the simulator
   executes each through a MIGRATE_START → MIGRATE_COMPLETE event pair with
   destination capacity *reserved* for the flight and downtime accounted in
   :class:`repro.core.metrics.Metrics`.

Policies:

* ``none``            — planner inert; the simulation is bit-identical to a
                        run without a planner attached.
* ``greedy-cheapest`` — score against *current* clearing prices and chase
                        any pool that is cheaper right now (pure cost
                        chaser; churny under noisy prices).
* ``gradient-aware``  — score against regression-projected prices
                        (:func:`repro.market.risk.projected_prices`) and
                        move only *at-risk* VMs — those whose projected
                        source price comes within ``danger_margin`` of the
                        bid.  Safe VMs stay put: every migration raises the
                        destination's utilization (and hence its clearing
                        price), so churning safe VMs manufactures the very
                        waves the planner exists to dodge.  Destinations are
                        assigned *price-impact-aware* (each committed
                        arrival shifts the destination's effective price by
                        the clearing curve's slope — evacuation is
                        self-limiting) and throttled per tick.
* ``risk-budgeted``   — gradient-aware scoring plus a per-pool cap on
                        concurrent arrivals (in-flight + newly planned), so
                        the planner's own herd cannot drive a destination
                        pool's utilization — and hence its clearing price —
                        into a spike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from . import risk
from ..core.registry import Registry
from ..obs.eventlog import NULL_RECORDER
from ..obs.tracer import NULL_TRACER
from .price_process import supply_curve_slope

MIGRATION_POLICIES = ("none", "greedy-cheapest", "gradient-aware",
                      "risk-budgeted")

#: string-keyed registry of migration policies; ``make_migration_planner``
#: and ``MigrationSpec`` resolve against it.  The four built-ins map to
#: :class:`MigrationPlanner` configured with the matching
#: :class:`MigrationConfig` policy; custom entries may register any factory
#: returning a planner-shaped object (``.config.policy``,
#: ``.plan(pool, engine, now, inflight)``):
#: ``@register_migration_policy("my-policy")``.
MIGRATION_REGISTRY = Registry("migration policy")
register_migration_policy = MIGRATION_REGISTRY.register


@dataclass
class MigrationConfig:
    policy: str = "gradient-aware"
    #: stop-and-copy downtime per migration (s); no progress accrues in flight
    downtime: float = 30.0
    #: per-VM blackout after an arrival — the flap guard
    cooldown: float = 300.0
    #: required price gap (price units) in the policy's basis before a move
    #: is even considered — the hysteresis margin
    hysteresis: float = 0.08
    #: savings window cap (s): price projections are not trusted further out
    horizon: float = 600.0
    #: VMs with less remaining work than this never move (the downtime would
    #: eat the savings; also keeps nearly-done VMs off the wire)
    min_remaining: float = 60.0
    #: price-units-per-second monetization of migration delay
    delay_cost_rate: float = 0.5
    #: gradient-aware / risk-budgeted only: a VM is migration-eligible when
    #: its projected source price comes within this margin of its bid (or
    #: exceeds it) — the defensive trigger; greedy-cheapest ignores it
    danger_margin: float = 0.15
    #: ticks of history feeding the gradient estimate
    gradient_window: int = 5
    #: arrivals are only planned into pools below this CPU utilization: the
    #: clearing curve is convex in utilization, so landing migrants on a
    #: busy pool raises the price for every resident there (the externality
    #: the net score cannot see)
    dest_util_ceiling: float = 0.65
    #: gradient-aware / risk-budgeted: global throttle on plans per tick —
    #: evacuation trickles over several ticks instead of moving a whole
    #: pool's population in one thundering herd
    max_plans_per_tick: int = 32
    #: risk-budgeted only: max concurrent arrivals per destination pool
    pool_budget: int = 4

    def __post_init__(self) -> None:
        assert self.policy in MIGRATION_POLICIES, (
            f"unknown migration policy {self.policy!r} "
            f"(want {MIGRATION_POLICIES})")


@dataclass
class MigrationPlan:
    """One planned move: VM → destination pool.  The simulator picks the
    concrete destination host at MIGRATE_START (capacity may shift between
    planning and execution within the same timestamp)."""
    vm_id: int
    dst_pool: int
    predicted_saving: float     # net score, price·seconds


class MigrationPlanner:
    """Scores the market registry each tick and emits batched plans."""

    #: telemetry hooks (``repro.obs``); the build layer swaps in the live
    #: tracer/recorder — class attributes so planner construction stays
    #: untouched
    tracer = NULL_TRACER
    events = NULL_RECORDER

    def __init__(self, config: MigrationConfig | None = None):
        self.config = config or MigrationConfig()

    # ------------------------------------------------------------------ plan
    def _price_basis(self, engine) -> np.ndarray:
        cfg = self.config
        if cfg.policy == "greedy-cheapest":
            return engine.prices.copy()
        # gradient-aware / risk-budgeted: project to the arrival time of a
        # migration started this tick.  The regression fit reads the
        # engine's packed price-history arrays directly (zero-copy views —
        # see risk.recent_prices), so this stays cheap on the tick path.
        lead = cfg.downtime + engine.tick_interval
        return risk.projected_prices(engine, lead, cfg.gradient_window)

    def plan(self, host_pool, engine, now: float,
             inflight_per_pool: np.ndarray) -> List[MigrationPlan]:
        """One dense masked scoring pass over the registry screens the
        at-risk candidates; a short commit loop (selected candidates only)
        assigns destinations *price-impact-aware*: every committed arrival
        shifts the destination's effective price by the clearing curve's
        slope, so the planner's own herd prices itself out of a destination
        before it can spike it.  Fully deterministic, no RNG."""
        tr = self.tracer
        if not (tr.enabled or self.events.enabled):
            return self._plan_impl(host_pool, engine, now, inflight_per_pool)
        if tr.enabled:
            tr.begin("migration", "plan/" + self.config.policy)
        plans = self._plan_impl(host_pool, engine, now, inflight_per_pool)
        if tr.enabled:
            if plans:
                tr.counters.inc("migrations/planned", len(plans))
            tr.end(now, {"plans": len(plans)})
        if self.events.enabled:
            for p in plans:
                self.events.emit(now, "migrate-plan", vm=p.vm_id,
                                 pool=p.dst_pool, a=p.predicted_saving)
        return plans

    def _plan_impl(self, host_pool, engine, now: float,
                   inflight_per_pool: np.ndarray) -> List[MigrationPlan]:
        cfg = self.config
        if cfg.policy == "none":
            return []
        reg = host_pool.market_registry()
        m = reg["vid"].size
        if m == 0:
            return []
        n_pools = engine.n_pools
        prices = engine.prices
        p_hat = self._price_basis(engine)
        free_cpu = host_pool.pool_free_cpu()
        util = host_pool.pool_cpu_utilization()

        rem_now = reg["rem0"] - (now - reg["t0"])
        elig = (reg["pin"] < 0)                   # pool-pinned VMs never move
        elig &= reg["cooldown"] <= now            # flap guard
        elig &= reg["ready"] <= now               # respect min running time
        elig &= rem_now > cfg.min_remaining
        if cfg.policy != "greedy-cheapest":
            # defensive trigger: only evacuate VMs whose projected source
            # price approaches their bid
            elig &= p_hat[reg["pool"]] > reg["bid"] - cfg.danger_margin
        if not elig.any():
            return []

        # compress the registry to the eligible rows, then build the
        # (m_elig, n_pools) static net score in the policy's price basis —
        # the screening pass (impact-free; the commit loop re-prices).
        # At fleet scale the danger trigger eliminates most rows, so the
        # dense matrices only span the candidates.
        rows = np.flatnonzero(elig)
        src = reg["pool"][rows]
        bid = reg["bid"][rows]
        cpu = reg["cpu"][rows]
        vid = reg["vid"][rows]
        gap = p_hat[src][:, None] - p_hat[None, :]
        W = np.minimum(rem_now[rows], cfg.horizon)
        net = gap * W[:, None] - cfg.downtime * cfg.delay_cost_rate

        ok = gap > cfg.hysteresis                          # margin on the gap
        ok &= prices[None, :] <= bid[:, None] - cfg.hysteresis
        ok &= p_hat[None, :] <= bid[:, None] - cfg.hysteresis
        # destination headroom: the pool must have free CPU for this VM now
        # and sit below the utilization ceiling (price-impact guard)
        ok &= free_cpu[None, :] >= cpu[:, None]
        ok &= (util <= cfg.dest_util_ceiling)[None, :]
        ok &= np.arange(n_pools)[None, :] != src[:, None]  # actually move
        net = np.where(ok, net, -np.inf)

        best0 = net.max(axis=1)
        sel = np.flatnonzero(best0 > 0.0)
        if sel.size == 0:
            return []
        # deterministic commit order: biggest static saving first
        order = sel[np.lexsort((vid[sel], -best0[sel]))]

        if cfg.policy == "greedy-cheapest":
            # the naive chaser: commits every screened move at face value
            # (no impact model, no throttle) — the herding baseline
            best_q = np.argmax(net, axis=1)
            return [MigrationPlan(int(vid[i]), int(best_q[i]),
                                  float(best0[i]))
                    for i in order]
        return self._commit_with_impact(host_pool, engine, order,
                                        src, bid, cpu, vid, W,
                                        prices, p_hat, free_cpu, util,
                                        inflight_per_pool)

    def _commit_with_impact(self, host_pool, engine, order,
                            src_a, bid_a, cpu_a, vid_a, W, prices,
                            p_hat, free_cpu, util, inflight_per_pool):
        """Assign destinations with the arrivals committed so far priced in:
        ``p_eff = p̂ + (∂price/∂cpu) · committed Δcpu`` per pool, where the
        slope comes from the clearing curve (d/du of od·(0.1+0.9u³)).
        Departures lower the source's effective price the same way, so
        evacuation is self-limiting.  O(selected × n_pools) — the registry
        itself is never walked."""
        cfg = self.config
        n_pools = engine.n_pools
        # ∂price/∂cpu at current utilization (convex curve: busy pools are
        # expensive to land on, idle pools nearly free)
        pool_cpu = np.maximum(host_pool.pool_total_cpu(), 1e-9)
        impact = supply_curve_slope(util, engine.od_rates) / pool_cpu
        delta_cpu = np.zeros(n_pools)
        free = free_cpu.astype(np.float64).copy()
        util_eff = util.copy()
        budget = None
        if cfg.policy == "risk-budgeted":
            budget = cfg.pool_budget - np.asarray(
                inflight_per_pool, dtype=np.int64).copy()
        plans: List[MigrationPlan] = []
        pool_ids = np.arange(n_pools)
        # hard work bound for the tick hot path: candidates arrive in
        # descending static-saving order, so if the head can't commit the
        # tail won't either — never scan more than 4x the plan cap
        scan_budget = 4 * cfg.max_plans_per_tick
        for i in order:
            if len(plans) >= cfg.max_plans_per_tick or scan_budget <= 0:
                break
            if budget is not None and not (budget > 0).any():
                break  # every destination's arrival budget is exhausted
            scan_budget -= 1
            s = int(src_a[i])
            bid = float(bid_a[i])
            cpu = float(cpu_a[i])
            p_eff = p_hat + impact * delta_cpu
            gap = p_eff[s] - p_eff
            net = gap * float(W[i]) - cfg.downtime * cfg.delay_cost_rate
            ok = gap > cfg.hysteresis
            ok &= prices <= bid - cfg.hysteresis
            ok &= p_eff <= bid - cfg.hysteresis
            ok &= free >= cpu
            ok &= util_eff <= cfg.dest_util_ceiling
            ok &= pool_ids != s
            if budget is not None:
                ok &= budget > 0
            net = np.where(ok, net, -np.inf)
            q = int(np.argmax(net))
            if net[q] <= 0.0:
                continue
            plans.append(MigrationPlan(int(vid_a[i]), q,
                                       float(net[q])))
            delta_cpu[q] += cpu
            delta_cpu[s] -= cpu
            free[q] -= cpu
            free[s] += cpu
            # plain division, matching plan_reference bit-for-bit (a
            # reciprocal-multiply differs in the last ULP and could flip
            # the util-ceiling comparison between planner and oracle)
            util_eff[q] += cpu / pool_cpu[q]
            util_eff[s] -= cpu / pool_cpu[s]
            if budget is not None:
                budget[q] -= 1
        return plans


# ---------------------------------------------------------------------------
# per-VM reference oracle (tests + benchmark: the planner must match this
# while never walking the registry in Python on the tick path)
# ---------------------------------------------------------------------------
def plan_reference(planner: MigrationPlanner, host_pool, engine, now: float,
                   inflight_per_pool: np.ndarray) -> List[MigrationPlan]:
    """Decision-identical per-VM Python reimplementation of
    :meth:`MigrationPlanner.plan` (scalar screening + scalar commit loop)."""
    cfg = planner.config
    if cfg.policy == "none":
        return []
    reg = host_pool.market_registry()
    m = reg["vid"].size
    n_pools = engine.n_pools
    prices = engine.prices
    p_hat = planner._price_basis(engine)
    free_cpu = host_pool.pool_free_cpu()
    util = host_pool.pool_cpu_utilization()

    def static_screen(i):
        """(best static net, best pool) for VM i, or (None, -1)."""
        rem_now = float(reg["rem0"][i]) - (now - float(reg["t0"][i]))
        if (reg["pin"][i] >= 0 or reg["cooldown"][i] > now
                or reg["ready"][i] > now or rem_now <= cfg.min_remaining):
            return None, -1, 0.0
        src = int(reg["pool"][i])
        bid = float(reg["bid"][i])
        if (cfg.policy != "greedy-cheapest"
                and not p_hat[src] > bid - cfg.danger_margin):
            return None, -1, 0.0
        w = min(rem_now, cfg.horizon)
        best_q, best = -1, -np.inf
        for q in range(n_pools):
            if q == src:
                continue
            gap = float(p_hat[src] - p_hat[q])
            if gap <= cfg.hysteresis:
                continue
            if prices[q] > bid - cfg.hysteresis or p_hat[q] > bid - cfg.hysteresis:
                continue
            if free_cpu[q] < reg["cpu"][i] or util[q] > cfg.dest_util_ceiling:
                continue
            net = gap * w - cfg.downtime * cfg.delay_cost_rate
            if net > best:
                best_q, best = q, net
        if best_q < 0 or best <= 0.0:
            return None, -1, 0.0
        return best, best_q, w

    scored = []
    for i in range(m):
        best, best_q, w = static_screen(i)
        if best is not None:
            scored.append((best, int(reg["vid"][i]), i, best_q, w))
    scored.sort(key=lambda s: (-s[0], s[1]))

    if cfg.policy == "greedy-cheapest":
        return [MigrationPlan(vid, q, float(net))
                for net, vid, _i, q, _w in scored]

    pool_cpu = np.maximum(host_pool.pool_total_cpu(), 1e-9)
    impact = supply_curve_slope(util, engine.od_rates) / pool_cpu
    delta_cpu = np.zeros(n_pools)
    free = free_cpu.astype(np.float64).copy()
    util_eff = util.copy()
    budget = ({q: cfg.pool_budget - int(inflight_per_pool[q])
               for q in range(n_pools)}
              if cfg.policy == "risk-budgeted" else None)
    plans = []
    scan_budget = 4 * cfg.max_plans_per_tick
    for _net0, vid, i, _q0, w in scored:
        if len(plans) >= cfg.max_plans_per_tick or scan_budget <= 0:
            break
        if budget is not None and not any(b > 0 for b in budget.values()):
            break
        scan_budget -= 1
        src = int(reg["pool"][i])
        bid = float(reg["bid"][i])
        cpu = float(reg["cpu"][i])
        p_eff = p_hat + impact * delta_cpu
        best_q, best = -1, -np.inf
        for q in range(n_pools):
            if q == src:
                continue
            gap = float(p_eff[src] - p_eff[q])
            if gap <= cfg.hysteresis:
                continue
            if prices[q] > bid - cfg.hysteresis or p_eff[q] > bid - cfg.hysteresis:
                continue
            if free[q] < cpu or util_eff[q] > cfg.dest_util_ceiling:
                continue
            if budget is not None and budget[q] <= 0:
                continue
            net = gap * w - cfg.downtime * cfg.delay_cost_rate
            if net > best:
                best_q, best = q, net
        if best_q < 0 or best <= 0.0:
            continue
        plans.append(MigrationPlan(vid, best_q, float(best)))
        delta_cpu[best_q] += cpu
        delta_cpu[src] -= cpu
        free[best_q] -= cpu
        free[src] += cpu
        util_eff[best_q] += cpu / pool_cpu[best_q]
        util_eff[src] -= cpu / pool_cpu[src]
        if budget is not None:
            budget[best_q] -= 1
    return plans


def _builtin_planner(policy: str):
    def _factory(**kwargs) -> MigrationPlanner:
        return MigrationPlanner(MigrationConfig(policy=policy, **kwargs))
    _factory.__name__ = f"planner_{policy}"
    _factory.policy = policy
    return _factory


# Registered by each factory's ``policy`` attribute rather than by a loop
# over the name tuple: the determinism lint resolves such loops to literal
# names across the whole source tree, and the JAX package registers these.
for _factory in map(_builtin_planner, MIGRATION_POLICIES):
    MIGRATION_REGISTRY.register(_factory.policy, _factory)
del _factory


def make_migration_planner(policy: str, **kwargs) -> MigrationPlanner:
    """Build a planner by policy name (including ``"none"``, which attaches
    but never plans — the bit-identity baseline)."""
    return MIGRATION_REGISTRY.build(policy, **kwargs)
