"""Materialize specs into fresh simulators — the one way to construct runs.

Engines, planners, and policies are *stateful* (price-process RNGs, cost
integrals, planner cooldowns): reusing one across runs silently corrupts
results.  The builder therefore constructs every component fresh from the
spec's names + params on each call; a :class:`~repro_torch.api.specs.RunSpec` can
be built any number of times and every build is independent.

``build(spec, seed)`` returns a populated, ready-to-``run()`` simulator;
``run_one(spec, seed)`` additionally runs it to the spec's horizon and
collects the standard metrics row (the sweep runner's per-seed unit).  Rows
and event streams (:func:`event_streams`) equal the JAX reference's
``repro.api.run_one`` at fixed seed (held in ``tests/test_torch_api.py``).
"""
from __future__ import annotations

from typing import Optional

from ..core.simulator import MarketSimulator, SimConfig
from ..core.allocation import make_policy
from ..market.bids import RebidOnResume
from ..market.engine import MarketEngine
from ..market.faults import make_fault_injector
from ..market.fleet import make_fleet_manager
from ..market.migration import make_migration_planner
from ..market.pools import make_market
from ..market.pricing import realized_cost_stats
from ..obs.eventlog import EventLog
from ..obs.tracer import Tracer
from ..serve.autoscale import make_autoscaler
from ..serve.service import make_serve_manager
from ..serve.slo import serve_stats
from .specs import ObsSpec, RunSpec, ScenarioSpec
from .workloads import WORKLOAD_REGISTRY


def build_tracer(obs: Optional[ObsSpec]) -> Optional[Tracer]:
    """A fresh :class:`~repro_torch.obs.tracer.Tracer` for an :class:`ObsSpec`,
    or None when none of the tracer switches are on (the simulator then
    runs the plain untraced loop — an events-only spec records the flight
    log without ever building a tracer).  ``keep_records`` follows
    ``trace`` — profile- or counters-only modes still time spans but retain
    no per-span records, so memory stays bounded at trace scale."""
    if obs is None or not (obs.trace or obs.profile
                           or obs.counters_every is not None):
        return None
    return Tracer(keep_records=obs.trace, profile=obs.profile,
                  counters_every=obs.counters_every)


def build_event_log(obs: Optional[ObsSpec]) -> Optional[EventLog]:
    """A fresh :class:`~repro_torch.obs.eventlog.EventLog` flight recorder when
    the spec asks for one (``obs.events``), else None — emit sites then
    keep their inert ``NULL_RECORDER`` default."""
    if obs is None or not obs.events:
        return None
    return EventLog()


def build_engine(scenario: ScenarioSpec, seed: int) -> Optional[MarketEngine]:
    """A fresh market engine for the scenario's regime (None when the
    scenario has no market)."""
    if scenario.regime is None:
        return None
    return MarketEngine(make_market(
        scenario.regime, n_pools=scenario.n_pools, seed=seed,
        tick_interval=scenario.tick_interval,
        from_advisor=scenario.from_advisor))


def build(spec: RunSpec, seed: int) -> MarketSimulator:
    """Materialize a :class:`RunSpec` into a populated simulator.

    Every stateful component (engine, planner, rebid hook, policy) is
    constructed fresh; hosts and VMs come from the scenario's registered
    workload.  Call ``sim.run(until=...)`` (or use :func:`run_one`) to
    execute."""
    scenario = spec.scenario
    engine = build_engine(scenario, seed)
    # mirror the historical wiring exactly: with an engine a planner is
    # always attached ("none" never plans — the bit-identity baseline);
    # without one the simulator runs planner-less
    migration = (make_migration_planner(spec.migration.policy,
                                        **dict(spec.migration.params))
                 if engine is not None else None)
    rebid = None
    if spec.rebid is not None:
        rebid = RebidOnResume(
            bump_lo=spec.rebid.bump_lo, bump_hi=spec.rebid.bump_hi,
            on_demand_rate=engine.config.pools[0].on_demand_rate, seed=seed)
    # fleet managers and fault injectors are stateful (slot arrays, fired
    # flags, pre-drawn stochastic schedules) — always fresh per build
    fleet = None
    if spec.fleet is not None:
        fleet = make_fleet_manager(scenario.n_pools,
                                   spec.fleet.config(scenario.n_pools))
    faults = None
    if spec.faults is not None:
        faults = make_fault_injector(
            spec.faults.scenario, scenario.n_pools,
            resolve_horizon(scenario), scenario.tick_interval, seed,
            **dict(spec.faults.params))
    # serve managers carry the request queue + per-VM scheduler map (and
    # the autoscaler its cooldown clock) — always fresh per build
    serve = None
    if spec.serve is not None:
        autoscaler = None
        if spec.autoscale is not None:
            autoscaler = make_autoscaler(spec.autoscale.policy,
                                         spec.autoscale.config())
        serve = make_serve_manager(spec.serve.config(),
                                   autoscaler=autoscaler, seed=seed)
    obs = build_tracer(spec.obs)
    events = build_event_log(spec.obs)
    sim = MarketSimulator(
        policy=make_policy(spec.policy.name, **dict(spec.policy.params)),
        config=SimConfig(record_timeline=False, **dict(scenario.sim_params)),
        engine=engine, migration=migration, rebid=rebid,
        fleet=fleet, faults=faults, serve=serve, obs=obs, events=events)
    if obs is not None:
        # one tracer per run, shared by every subsystem so spans nest and
        # counters land in a single registry; components are fresh per
        # build, so instance-level attachment cannot leak across runs
        sim.policy.tracer = obs
        if engine is not None:
            engine.tracer = obs
        if migration is not None:
            migration.tracer = obs
        if fleet is not None:
            fleet.tracer = obs
        if serve is not None:
            serve.tracer = obs
    if events is not None:
        # one flight recorder per run, shared by every emit site — the
        # same attach pattern as the tracer (fresh components, no leaks)
        if engine is not None:
            engine.events = events
        if migration is not None:
            migration.events = events
        if fleet is not None:
            fleet.events = events
        if faults is not None:
            faults.events_log = events
        if serve is not None:
            serve.events = events
    tr = sim.obs
    if tr.enabled:
        tr.begin("build", "build/populate")
    WORKLOAD_REGISTRY.get(scenario.workload)(sim, scenario, seed)
    if tr.enabled:
        tr.end(sim.now)
    return sim


def resolve_horizon(scenario: ScenarioSpec) -> Optional[float]:
    """The spec's horizon, falling back to the workload's default (None =
    run to completion)."""
    if scenario.horizon is not None:
        return scenario.horizon
    return WORKLOAD_REGISTRY.get(scenario.workload).default_horizon


def run_one(spec: RunSpec, seed: int,
            until: Optional[float] = None) -> dict:
    """Build + run one spec at one seed and collect the metrics row.

    The row is wall-clock-free and deterministic at fixed (spec, seed) —
    sweep reports built from it are reproducible artifacts."""
    sim = build(spec, seed)
    horizon = until if until is not None else resolve_horizon(spec.scenario)
    metrics = sim.run(until=horizon)
    return collect_row(sim, metrics, spec, seed)


def collect_row(sim: MarketSimulator, metrics, spec: RunSpec,
                seed: int) -> dict:
    """The standard per-run metrics row (identical key set to the historical
    ``market_sim.run_market`` rows for engine runs)."""
    s = metrics.spot_stats(sim.vms)
    row = {
        "policy": spec.policy.name,
        "regime": spec.scenario.regime,
        "migration": spec.migration.policy,
        "seed": seed,
    }
    if sim.engine is None:
        row.update(s)
        row.update(allocations=metrics.allocations,
                   resubmissions=metrics.resubmissions)
        return row
    ms = metrics.market_stats()
    migs = metrics.migration_stats(sim.vms, sim.engine)
    cost = realized_cost_stats(sim.vms.values(), sim.engine, sim.pool)
    row.update({
        "interruptions": s["interruptions"],
        "price_interruptions": ms["price_interruptions"],
        "waves": ms["waves"],
        "max_wave_size": ms["max_wave_size"],
        "avg_interruption_time": s["avg_interruption_time"],
        "max_interruption_time": s["max_interruption_time"],
        "spot_finished": s["spot_finished"],
        "spot_terminated": s["spot_terminated"],
        "migrations": migs["completed"],
        "migrations_failed": migs["failed"],
        "migration_downtime_s": migs["downtime_s"],
        "predicted_saving": round(migs["predicted_saving"], 2),
        "realized_saving": round(migs["realized_saving"], 2),
        "realized_spot_cost": round(cost["spot_cost"], 4),
        "savings_pct": round(cost["savings_pct"], 1),
        "wasted_cost": round(cost["wasted_cost"], 4),
        "allocations": metrics.allocations,
    })
    rs = None
    if sim.fleet is not None:
        rs = metrics.resilience_stats(sim.vms, sim.engine, sim.pool)
        row.update({
            "time_below_target_s": round(rs["time_below_target"], 1),
            "time_below_frac": round(rs["time_below_frac"], 4),
            "shortfall_area": round(rs["shortfall_area"], 1),
            "mean_recovery_s": round(rs["mean_recovery_s"], 1),
            "max_recovery_s": round(rs["max_recovery_s"], 1),
            "faults_fired": rs["faults_fired"],
            "fleet_launches": rs["fleet_launches"],
            "od_spill_launches": rs["od_spill_launches"],
            "fleet_slots_retired": rs["slots_retired"],
            "fleet_spot_cost": round(rs["fleet_spot_cost"], 4),
            "od_spill_cost": round(rs["od_spill_cost"], 4),
        })
    if sim.serve is not None:
        scfg = sim.serve.config
        horizon = resolve_horizon(spec.scenario)
        cost = (rs["fleet_spot_cost"] + rs["od_spill_cost"]
                if rs is not None else None)
        ss = serve_stats(metrics, slo_latency=scfg.slo_latency_s,
                         slo_objective=scfg.slo_objective,
                         window=scfg.window_s,
                         horizon=horizon if horizon is not None else sim.now,
                         cost=cost)
        row.update({k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in ss.items()})
    return row


def event_streams(metrics) -> dict:
    """A run's interruption, wave and migration event streams and its price
    series, as plain tuples and lists: what two runs of one spec must share
    event for event (two backends of the HLEM scorer, or this package and
    the JAX reference)."""
    return {
        "interruptions": [(e.vm_id, e.time, e.host, e.kind, str(e.cause))
                          for e in metrics.interruption_events],
        "waves": [(w.time, w.pool, w.price, w.size)
                  for w in metrics.wave_events],
        "migrations": [tuple(vars(m).values())
                       for m in metrics.migration_events],
        "prices": metrics.price_series,
    }
