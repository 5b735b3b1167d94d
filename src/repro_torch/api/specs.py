"""The declarative spec tree — one serializable description of "a run".

Frozen dataclasses describing everything a simulation run needs, validated
at *construction* (unknown names, bad pool counts, migration-without-engine
all fail before any event loop starts), with lossless ``to_dict`` /
``from_dict`` / JSON round-trips so scenarios are shareable files and
CI-gateable artifacts:

* :class:`BidSpec`        — bid strategy name + params (``BID_REGISTRY``).
* :class:`PolicySpec`     — allocation policy name + params
  (``POLICY_REGISTRY``).
* :class:`MigrationSpec`  — migration policy name + params
  (``MIGRATION_REGISTRY``).
* :class:`RebidSpec`      — adaptive re-bid bump range (RebidOnResume).
* :class:`ScenarioSpec`   — workload + market regime + pools + tick +
  horizon (``WORKLOAD_REGISTRY``; ``regime=None`` = no market engine).
* :class:`FleetSpec`      — spot-fleet strategy + FleetConfig params
  (``FLEET_STRATEGY_REGISTRY``).
* :class:`FaultSpec`      — fault-injection scenario name + params
  (``FAULT_REGISTRY``).
* :class:`ObsSpec`        — observability switches (tracing / profiling /
  counter snapshots, ``repro_torch.obs``).
* :class:`RunSpec`        — scenario × policy × migration × rebid × fleet ×
  faults × obs: the unit :func:`repro_torch.api.build` materializes.
* :class:`ExperimentSpec` — scenario + policy/migration/regime/fleet grid +
  seed list: the unit :func:`repro_torch.api.sweep.run_experiment` fans out.

Specs carry *names and parameters*, never live objects — stateful
components (engines, planners, policies) are materialized fresh per run by
the builder, so two runs can never accidentally share state.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
from collections import abc
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from ..core.allocation import POLICY_REGISTRY
from ..core.simulator import SimConfig
from ..market.bids import BID_REGISTRY
from ..market.migration import (
    MIGRATION_POLICIES,
    MIGRATION_REGISTRY,
    MigrationConfig,
)
from ..market.faults import FAULT_REGISTRY, make_fault_injector
from ..market.fleet import (
    FLEET_STRATEGY_REGISTRY,
    FleetConfig,
    validate_fleet_config,
)
from ..market.pools import REGIMES
from ..serve.autoscale import (
    AUTOSCALE_REGISTRY,
    AutoscaleConfig,
    validate_autoscale_config,
)
from ..serve.service import ServeConfig, validate_serve_config
from .workloads import WORKLOAD_REGISTRY


def _spec_error(msg: str) -> ValueError:
    return ValueError(f"invalid spec: {msg}")


def _check_param_keys(params: Mapping[str, Any], allowed, what: str) -> None:
    unknown = sorted(set(params) - set(allowed))
    if unknown:
        raise _spec_error(
            f"unknown {what} parameter(s) {unknown} "
            f"(known: {', '.join(sorted(allowed))})")


def _factory_param_names(factory) -> Optional[Tuple[str, ...]]:
    """Keyword-parameter names a factory accepts, or None when it takes
    ``**kwargs`` (then key validation is deferred to build time)."""
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):  # builtins / C callables
        return None
    names = []
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            return None
        if p.name != "self" and p.kind in (
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.KEYWORD_ONLY):
            names.append(p.name)
    return tuple(names)


def _set(obj, name: str, value) -> None:
    object.__setattr__(obj, name, value)  # frozen-dataclass field fixup


class _SpecBase:
    """Shared JSON plumbing for every spec dataclass."""

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str):
        return cls.from_dict(json.loads(text))

    def replace(self, **changes):
        """``dataclasses.replace`` shorthand (re-runs validation)."""
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BidSpec(_SpecBase):
    """Bid strategy for the workload's spot VMs (engine runs only)."""

    strategy: str = "randomized"
    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        factory = BID_REGISTRY.get(self.strategy)  # raises on unknown name
        _set(self, "params", dict(self.params))
        allowed = _factory_param_names(factory)
        if allowed is not None:
            # pool_cfg-derived defaults the builder may inject are implicit
            _check_param_keys(self.params, set(allowed),
                              f"bid strategy {self.strategy!r}")

    def to_dict(self) -> dict:
        return {"strategy": self.strategy, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "BidSpec":
        return cls(strategy=d.get("strategy", "randomized"),
                   params=d.get("params", {}))


@dataclass(frozen=True)
class PolicySpec(_SpecBase):
    """Allocation policy by registry name."""

    name: str
    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        factory = POLICY_REGISTRY.get(self.name)
        _set(self, "params", dict(self.params))
        allowed = _factory_param_names(factory)
        if allowed is not None:
            _check_param_keys(self.params, set(allowed),
                              f"allocation policy {self.name!r}")

    def to_dict(self) -> dict:
        return {"name": self.name, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PolicySpec":
        return cls(name=d["name"], params=d.get("params", {}))


@dataclass(frozen=True)
class MigrationSpec(_SpecBase):
    """Proactive migration policy by registry name (``"none"`` = off)."""

    policy: str = "none"
    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        MIGRATION_REGISTRY.get(self.policy)
        _set(self, "params", dict(self.params))
        if self.policy in MIGRATION_POLICIES:
            allowed = {f.name for f in dataclasses.fields(MigrationConfig)
                       } - {"policy"}
            _check_param_keys(self.params, allowed,
                              f"migration policy {self.policy!r}")

    @property
    def enabled(self) -> bool:
        return self.policy != "none"

    def to_dict(self) -> dict:
        return {"policy": self.policy, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MigrationSpec":
        return cls(policy=d.get("policy", "none"), params=d.get("params", {}))


@dataclass(frozen=True)
class RebidSpec(_SpecBase):
    """Adaptive re-bidding on hibernation (RebidOnResume); the builder
    supplies the on-demand cap and seed."""

    bump_lo: float = 1.05
    bump_hi: float = 1.30

    def __post_init__(self):
        if not (0.0 < self.bump_lo <= self.bump_hi):
            raise _spec_error(
                f"rebid bump range needs 0 < bump_lo <= bump_hi "
                f"(got [{self.bump_lo}, {self.bump_hi}])")

    def to_dict(self) -> dict:
        return {"bump_lo": self.bump_lo, "bump_hi": self.bump_hi}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RebidSpec":
        return cls(bump_lo=d.get("bump_lo", 1.05),
                   bump_hi=d.get("bump_hi", 1.30))


@dataclass(frozen=True)
class FleetSpec(_SpecBase):
    """Spot-fleet manager: diversification strategy by registry name +
    :class:`~repro_torch.market.fleet.FleetConfig` parameters (target capacity,
    pool weights, fallback ladder, backoff).  Validated at construction;
    pool-count-dependent checks (weight length, ``pool:<k>`` rungs) re-run
    inside :class:`RunSpec`, where ``n_pools`` is known."""

    strategy: str = "diversified"
    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        FLEET_STRATEGY_REGISTRY.get(self.strategy)  # raises on unknown name
        _set(self, "params", dict(self.params))
        allowed = {f.name for f in dataclasses.fields(FleetConfig)
                   } - {"strategy"}
        _check_param_keys(self.params, allowed,
                          f"fleet strategy {self.strategy!r}")
        try:
            self.config()
        except ValueError as e:
            raise _spec_error(str(e)) from None

    def config(self, n_pools: Optional[int] = None) -> FleetConfig:
        """Materialize (and validate) the FleetConfig; with ``n_pools`` the
        pool-dependent checks run too."""
        p = dict(self.params)
        if "ladder" in p:
            p["ladder"] = tuple((str(r), int(b)) for r, b in p["ladder"])
        if p.get("pool_weights") is not None:
            p["pool_weights"] = tuple(float(x) for x in p["pool_weights"])
        cfg = FleetConfig(strategy=self.strategy, **p)
        validate_fleet_config(cfg, n_pools)
        return cfg

    def to_dict(self) -> dict:
        return {"strategy": self.strategy, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FleetSpec":
        return cls(strategy=d.get("strategy", "diversified"),
                   params=d.get("params", {}))


@dataclass(frozen=True)
class FaultSpec(_SpecBase):
    """Market fault injection: scenario by registry name + generator
    parameters.  The builder compiles it into a fresh seeded
    :class:`~repro_torch.market.faults.FaultInjector` per run."""

    scenario: str = "storm"
    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        factory = FAULT_REGISTRY.get(self.scenario)  # raises on unknown name
        _set(self, "params", dict(self.params))
        allowed = _factory_param_names(factory)
        if allowed is not None:
            _check_param_keys(
                self.params,
                set(allowed) - {"n_pools", "horizon", "tick_interval",
                                "seed"},
                f"fault scenario {self.scenario!r}")

    def validate_events(self, n_pools: int, horizon: Optional[float],
                        tick_interval: float) -> None:
        """Compile the schedule once (seed 0) so bad events — unknown pools,
        negative times, out-of-range magnitudes — fail at spec construction,
        not mid-sweep in a worker."""
        try:
            make_fault_injector(self.scenario, n_pools, horizon,
                                tick_interval, 0, **self.params)
        except (ValueError, TypeError) as e:
            raise _spec_error(str(e)) from None

    def to_dict(self) -> dict:
        return {"scenario": self.scenario, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultSpec":
        return cls(scenario=d.get("scenario", "storm"),
                   params=d.get("params", {}))


@dataclass(frozen=True)
class ServeSpec(_SpecBase):
    """Traffic-driven serving layer:
    :class:`~repro_torch.serve.service.ServeConfig` parameters (tick cadence,
    per-VM slots, decode throughput, SLO latency/objective).  The demand
    curve itself comes from the scenario's workload (``serve-diurnal`` /
    ``serve-bursty``), so the same ServeSpec composes with any demand
    shape."""

    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        _set(self, "params", dict(self.params))
        allowed = {f.name for f in dataclasses.fields(ServeConfig)}
        _check_param_keys(self.params, allowed, "serve")
        try:
            self.config()
        except ValueError as e:
            raise _spec_error(str(e)) from None

    def config(self) -> ServeConfig:
        cfg = ServeConfig(**dict(self.params))
        validate_serve_config(cfg)
        return cfg

    def to_dict(self) -> dict:
        return {"params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ServeSpec":
        return cls(params=d.get("params", {}))


@dataclass(frozen=True)
class AutoscaleSpec(_SpecBase):
    """Closed-loop autoscaler: policy by registry name
    (:data:`~repro_torch.serve.autoscale.AUTOSCALE_REGISTRY`) +
    :class:`~repro_torch.serve.autoscale.AutoscaleConfig` parameters (cadence,
    unit bounds, hysteresis, cooldown).  Drives
    ``FleetManager.set_target_units`` — requires both a serve spec (the
    signals) and a fleet spec (the lever)."""

    policy: str = "target-tracking"
    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        AUTOSCALE_REGISTRY.get(self.policy)  # raises on unknown name
        _set(self, "params", dict(self.params))
        allowed = {f.name for f in dataclasses.fields(AutoscaleConfig)}
        _check_param_keys(self.params, allowed,
                          f"autoscale policy {self.policy!r}")
        try:
            self.config()
        except ValueError as e:
            raise _spec_error(str(e)) from None

    def config(self) -> AutoscaleConfig:
        cfg = AutoscaleConfig(**dict(self.params))
        validate_autoscale_config(cfg)
        return cfg

    def to_dict(self) -> dict:
        return {"policy": self.policy, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AutoscaleSpec":
        return cls(policy=d.get("policy", "target-tracking"),
                   params=d.get("params", {}))


@dataclass(frozen=True)
class ObsSpec(_SpecBase):
    """Observability: tracing / profiling / counter snapshots
    (``repro_torch.obs``).  All three are independent switches on one
    :class:`~repro_torch.obs.tracer.Tracer`: ``trace`` retains span/instant
    records for Chrome-trace export, ``profile`` aggregates span wall-times
    into the per-subsystem self/total table, and ``counters_every``
    snapshots the counter registry every N simulated seconds.  The default
    spec is fully off and builds no tracer at all — byte-identical metrics
    to a pre-observability run.

    ``events`` is a fourth, independent switch: it attaches an
    :class:`~repro_torch.obs.eventlog.EventLog` flight recorder (structured
    lifecycle/market event log) without building a tracer — an events-only
    spec still runs the plain untraced event loop."""

    trace: bool = False
    profile: bool = False
    #: counter-snapshot cadence in simulated seconds; None = off
    counters_every: Optional[float] = None
    #: record the structured event log (``repro_torch.obs.eventlog``)
    events: bool = False

    def __post_init__(self):
        _set(self, "trace", bool(self.trace))
        _set(self, "profile", bool(self.profile))
        _set(self, "events", bool(self.events))
        if self.counters_every is not None:
            try:
                _set(self, "counters_every", float(self.counters_every))
            except (TypeError, ValueError):
                raise _spec_error(
                    f"counters_every must be a number or None "
                    f"(got {self.counters_every!r})") from None
            if not self.counters_every > 0:
                raise _spec_error(
                    f"counters_every must be > 0 or None "
                    f"(got {self.counters_every!r})")

    @property
    def enabled(self) -> bool:
        return (self.trace or self.profile
                or self.counters_every is not None or self.events)

    def to_dict(self) -> dict:
        return {"trace": self.trace, "profile": self.profile,
                "counters_every": self.counters_every,
                "events": self.events}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ObsSpec":
        return cls(trace=d.get("trace", False),
                   profile=d.get("profile", False),
                   counters_every=d.get("counters_every"),
                   events=d.get("events", False))


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ScenarioSpec(_SpecBase):
    """Workload + market regime + pools + tick + horizon — everything about
    the *world* a policy runs in (nothing about which policy runs)."""

    workload: str = "market"
    workload_params: Mapping[str, Any] = field(default_factory=dict)
    #: price regime (``repro_torch.market.pools.REGIMES``); None = no market engine
    regime: Optional[str] = None
    n_pools: int = 4
    tick_interval: float = 60.0
    #: derive per-pool volatility from the synthetic Spot-Advisor dataset
    from_advisor: bool = True
    #: bid strategy for spot VMs (engine runs only)
    bid: Optional[BidSpec] = None
    #: extra :class:`~repro_torch.core.simulator.SimConfig` fields
    #: (e.g. ``interruption_selector``)
    sim_params: Mapping[str, Any] = field(default_factory=dict)
    #: simulated horizon (s); None = the workload's default
    horizon: Optional[float] = None

    def __post_init__(self):
        entry = WORKLOAD_REGISTRY.get(self.workload)  # raises on unknown
        _set(self, "workload_params", dict(self.workload_params))
        _set(self, "sim_params", dict(self.sim_params))
        if isinstance(self.bid, Mapping):
            _set(self, "bid", BidSpec.from_dict(self.bid))
        if self.regime is not None and self.regime not in REGIMES:
            raise _spec_error(
                f"unknown regime {self.regime!r} (known: {', '.join(REGIMES)};"
                f" None disables the market engine)")
        if not (isinstance(self.n_pools, int) and self.n_pools >= 1):
            raise _spec_error(f"n_pools must be an int >= 1 "
                              f"(got {self.n_pools!r})")
        if not self.tick_interval > 0:
            raise _spec_error(f"tick_interval must be > 0 "
                              f"(got {self.tick_interval!r})")
        if self.horizon is not None and not self.horizon > 0:
            raise _spec_error(f"horizon must be > 0 or None "
                              f"(got {self.horizon!r})")
        reserved = set(getattr(entry, "reserved_params", ()) or ())
        overlap = sorted(reserved & set(self.workload_params))
        if overlap:
            raise _spec_error(
                f"workload_params {overlap} are supplied by the builder "
                f"(per-run seed / scenario fields) — remove them")
        cfg_cls = getattr(entry, "config_cls", None)
        if cfg_cls is not None and dataclasses.is_dataclass(cfg_cls):
            allowed = {f.name for f in dataclasses.fields(cfg_cls)} - reserved
            _check_param_keys(self.workload_params, allowed,
                              f"workload {self.workload!r}")
        _check_param_keys(
            self.sim_params,
            {f.name for f in dataclasses.fields(SimConfig)}
            - {"record_timeline"},
            "sim")
        if getattr(entry, "requires_market", False) and self.regime is None:
            raise _spec_error(
                f"workload {self.workload!r} requires a market regime "
                f"(set regime to one of {', '.join(REGIMES)})")
        if self.bid is not None:
            if self.regime is None:
                raise _spec_error(
                    "a bid strategy needs a market engine — set regime, or "
                    "drop the bid spec")
            if not getattr(entry, "supports_bids", True):
                raise _spec_error(
                    f"workload {self.workload!r} does not support bid "
                    f"assignment (VMs carry their own bids)")

    @property
    def has_market(self) -> bool:
        return self.regime is not None

    def to_dict(self) -> dict:
        return {
            "workload": self.workload,
            "workload_params": dict(self.workload_params),
            "regime": self.regime,
            "n_pools": self.n_pools,
            "tick_interval": self.tick_interval,
            "from_advisor": self.from_advisor,
            "bid": self.bid.to_dict() if self.bid is not None else None,
            "sim_params": dict(self.sim_params),
            "horizon": self.horizon,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ScenarioSpec":
        bid = d.get("bid")
        return cls(
            workload=d.get("workload", "market"),
            workload_params=d.get("workload_params", {}),
            regime=d.get("regime"),
            n_pools=d.get("n_pools", 4),
            tick_interval=d.get("tick_interval", 60.0),
            from_advisor=d.get("from_advisor", True),
            bid=BidSpec.from_dict(bid) if bid is not None else None,
            sim_params=d.get("sim_params", {}),
            horizon=d.get("horizon"),
        )


@dataclass(frozen=True)
class RunSpec(_SpecBase):
    """One concrete run: scenario × allocation policy × migration × rebid.
    :func:`repro_torch.api.build` materializes it into a fresh simulator."""

    scenario: ScenarioSpec
    policy: PolicySpec
    migration: MigrationSpec = field(default_factory=MigrationSpec)
    rebid: Optional[RebidSpec] = None
    fleet: Optional[FleetSpec] = None
    faults: Optional[FaultSpec] = None
    #: traffic-driven serving layer; None = no request traffic
    serve: Optional[ServeSpec] = None
    #: closed-loop autoscaler (needs serve + fleet); None = fixed capacity
    autoscale: Optional[AutoscaleSpec] = None
    #: observability (tracing/profiling/counters); None = fully off
    obs: Optional[ObsSpec] = None

    def __post_init__(self):
        for name, typ in (("scenario", ScenarioSpec), ("policy", PolicySpec),
                          ("migration", MigrationSpec)):
            val = getattr(self, name)
            if isinstance(val, Mapping):
                _set(self, name, typ.from_dict(val))
            elif not isinstance(getattr(self, name), typ):
                raise _spec_error(f"{name} must be a {typ.__name__}")
        for name, typ in (("rebid", RebidSpec), ("fleet", FleetSpec),
                          ("faults", FaultSpec), ("serve", ServeSpec),
                          ("autoscale", AutoscaleSpec), ("obs", ObsSpec)):
            val = getattr(self, name)
            if isinstance(val, Mapping):
                _set(self, name, typ.from_dict(val))
            elif val is not None and not isinstance(val, typ):
                raise _spec_error(f"{name} must be a {typ.__name__} or None")
        if self.migration.enabled and not self.scenario.has_market:
            raise _spec_error(
                f"migration policy {self.migration.policy!r} requires a "
                f"market engine (prices drive the scoring) — set "
                f"scenario.regime, or use migration 'none'")
        if self.rebid is not None and not self.scenario.has_market:
            raise _spec_error(
                "adaptive re-bidding requires a market engine — set "
                "scenario.regime, or drop the rebid spec")
        if self.fleet is not None:
            if not self.scenario.has_market:
                raise _spec_error(
                    "a fleet manager requires a market engine — set "
                    "scenario.regime, or drop the fleet spec")
            try:
                # pool-count-dependent checks: weight length, pool:<k> rungs
                self.fleet.config(self.scenario.n_pools)
            except ValueError as e:
                raise _spec_error(str(e)) from None
        if self.faults is not None:
            if not self.scenario.has_market:
                raise _spec_error(
                    "fault injection requires a market engine — set "
                    "scenario.regime, or drop the faults spec")
            self.faults.validate_events(self.scenario.n_pools,
                                        self.scenario.horizon,
                                        self.scenario.tick_interval)
        wl = WORKLOAD_REGISTRY.get(self.scenario.workload)
        if self.serve is not None:
            if not getattr(wl, "provides_demand", False):
                raise _spec_error(
                    f"a serve spec needs a demand-providing workload "
                    f"(workload {self.scenario.workload!r} installs no "
                    f"request-rate curve — use serve-diurnal/serve-bursty)")
        elif getattr(wl, "provides_demand", False):
            raise _spec_error(
                f"workload {self.scenario.workload!r} generates request "
                f"demand — add a serve spec to consume it")
        if self.autoscale is not None:
            if self.serve is None:
                raise _spec_error(
                    "an autoscaler needs a serve spec — its signals are the "
                    "serving layer's demand/queue/latency estimates")
            if self.fleet is None:
                raise _spec_error(
                    "an autoscaler needs a fleet spec — "
                    "FleetManager.set_target_units is its actuation lever")

    def to_dict(self) -> dict:
        return {
            "scenario": self.scenario.to_dict(),
            "policy": self.policy.to_dict(),
            "migration": self.migration.to_dict(),
            "rebid": self.rebid.to_dict() if self.rebid is not None else None,
            "fleet": self.fleet.to_dict() if self.fleet is not None else None,
            "faults": (self.faults.to_dict()
                       if self.faults is not None else None),
            "serve": (self.serve.to_dict()
                      if self.serve is not None else None),
            "autoscale": (self.autoscale.to_dict()
                          if self.autoscale is not None else None),
            "obs": self.obs.to_dict() if self.obs is not None else None,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunSpec":
        rebid = d.get("rebid")
        fleet = d.get("fleet")
        faults = d.get("faults")
        serve = d.get("serve")
        autoscale = d.get("autoscale")
        obs = d.get("obs")
        return cls(
            scenario=ScenarioSpec.from_dict(d["scenario"]),
            policy=PolicySpec.from_dict(d["policy"]),
            migration=MigrationSpec.from_dict(d.get("migration", {})),
            rebid=RebidSpec.from_dict(rebid) if rebid is not None else None,
            fleet=FleetSpec.from_dict(fleet) if fleet is not None else None,
            faults=(FaultSpec.from_dict(faults)
                    if faults is not None else None),
            serve=(ServeSpec.from_dict(serve)
                   if serve is not None else None),
            autoscale=(AutoscaleSpec.from_dict(autoscale)
                       if autoscale is not None else None),
            obs=ObsSpec.from_dict(obs) if obs is not None else None,
        )


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExperimentSpec(_SpecBase):
    """A scenario × (regime × policy × migration × bid × workload-param)
    grid swept over seeds — the sweep runner's input, and the one file that
    describes a whole comparison experiment.

    ``bids`` and ``workload_grid`` are optional extra grid axes: ``bids``
    fans the scenario over bid strategies (engine scenarios only), and
    ``workload_grid`` fans named workload parameters over value ladders
    (e.g. ``{"fleet_scale": [1.0, 1.7, 3.4]}`` for a scaling study).  Both
    default to inert (one cell per regime × policy × migration, exactly the
    original grid)."""

    scenario: ScenarioSpec
    policies: Tuple[PolicySpec, ...]
    seeds: Tuple[int, ...]
    migrations: Tuple[MigrationSpec, ...] = (MigrationSpec(),)
    #: fan the scenario over these regimes (None = use ``scenario.regime``)
    regimes: Optional[Tuple[str, ...]] = None
    #: fan the scenario over these bid strategies (None = ``scenario.bid``)
    bids: Optional[Tuple[BidSpec, ...]] = None
    #: fan named workload parameters over value ladders; the cross product
    #: of all listed values joins the grid
    workload_grid: Mapping[str, Tuple] = field(default_factory=dict)
    rebid: Optional[RebidSpec] = None
    #: fan the grid over fleet managers; entries may be None (the per-VM
    #: baseline cell).  None (the default) = no fleet axis at all (inert)
    fleets: Optional[Tuple[Optional["FleetSpec"], ...]] = None
    #: fault injection applied to *every* cell (same seeded schedule per
    #: seed, so cells stay comparable); None = no faults
    faults: Optional[FaultSpec] = None
    #: serving layer applied to *every* cell (the demand curve comes from
    #: the scenario's workload); None = no request traffic
    serve: Optional["ServeSpec"] = None
    #: fan the grid over autoscalers; entries may be None (the fixed-
    #: capacity baseline cell).  None (the default) = no autoscale axis
    autoscales: Optional[Tuple[Optional["AutoscaleSpec"], ...]] = None
    name: str = "experiment"

    def __post_init__(self):
        _set(self, "policies", tuple(
            PolicySpec.from_dict(p) if isinstance(p, Mapping) else p
            for p in self.policies))
        _set(self, "migrations", tuple(
            MigrationSpec.from_dict(m) if isinstance(m, Mapping) else m
            for m in self.migrations))
        _set(self, "seeds", tuple(self.seeds))
        if isinstance(self.scenario, Mapping):
            _set(self, "scenario", ScenarioSpec.from_dict(self.scenario))
        if isinstance(self.rebid, Mapping):
            _set(self, "rebid", RebidSpec.from_dict(self.rebid))
        if isinstance(self.faults, Mapping):
            _set(self, "faults", FaultSpec.from_dict(self.faults))
        if self.faults is not None and not isinstance(self.faults, FaultSpec):
            raise _spec_error("faults must be a FaultSpec or None")
        if isinstance(self.serve, Mapping):
            _set(self, "serve", ServeSpec.from_dict(self.serve))
        if self.serve is not None and not isinstance(self.serve, ServeSpec):
            raise _spec_error("serve must be a ServeSpec or None")
        if self.autoscales is not None:
            _set(self, "autoscales", tuple(
                AutoscaleSpec.from_dict(a) if isinstance(a, Mapping) else a
                for a in self.autoscales))
            if not self.autoscales:
                raise _spec_error("autoscales cannot be empty — use None "
                                  "for no autoscale axis, or include a None "
                                  "entry for the fixed-capacity baseline")
            if not all(a is None or isinstance(a, AutoscaleSpec)
                       for a in self.autoscales):
                raise _spec_error(
                    "autoscales must all be AutoscaleSpec or None")
        if self.fleets is not None:
            _set(self, "fleets", tuple(
                FleetSpec.from_dict(f) if isinstance(f, Mapping) else f
                for f in self.fleets))
            if not self.fleets:
                raise _spec_error("fleets cannot be empty — use None for no "
                                  "fleet axis, or include a None entry for "
                                  "the per-VM baseline")
            if not all(f is None or isinstance(f, FleetSpec)
                       for f in self.fleets):
                raise _spec_error("fleets must all be FleetSpec or None")
        if not isinstance(self.scenario, ScenarioSpec):
            raise _spec_error("scenario must be a ScenarioSpec")
        if not all(isinstance(p, PolicySpec) for p in self.policies):
            raise _spec_error("policies must all be PolicySpec")
        if not all(isinstance(m, MigrationSpec) for m in self.migrations):
            raise _spec_error("migrations must all be MigrationSpec")
        if self.rebid is not None and not isinstance(self.rebid, RebidSpec):
            raise _spec_error("rebid must be a RebidSpec or None")
        if self.regimes is not None:
            _set(self, "regimes", tuple(self.regimes))
        if self.bids is not None:
            _set(self, "bids", tuple(
                BidSpec.from_dict(b) if isinstance(b, Mapping) else b
                for b in self.bids))
            if not self.bids:
                raise _spec_error("bids cannot be empty — use None to "
                                  "inherit scenario.bid")
            if not all(isinstance(b, BidSpec) for b in self.bids):
                raise _spec_error("bids must all be BidSpec")
        grid = {}
        for key, vals in dict(self.workload_grid).items():
            if isinstance(vals, (str, bytes)) or not isinstance(
                    vals, abc.Sequence):
                raise _spec_error(
                    f"workload_grid[{key!r}] must be a list/tuple of values "
                    f"(got {vals!r})")
            grid[str(key)] = tuple(vals)
        _set(self, "workload_grid", grid)
        for key, vals in self.workload_grid.items():
            if not vals:
                raise _spec_error(
                    f"workload_grid[{key!r}] cannot be empty")
            if key in self.scenario.workload_params:
                raise _spec_error(
                    f"workload_grid key {key!r} also appears in "
                    f"scenario.workload_params — list it in exactly one "
                    f"place")
        if not self.policies:
            raise _spec_error("an experiment needs at least one policy")
        if not self.migrations:
            raise _spec_error("migrations cannot be empty — use the default "
                              "(MigrationSpec('none'),)")
        if not self.seeds:
            raise _spec_error("an experiment needs at least one seed")
        if len(set(self.seeds)) != len(self.seeds):
            raise _spec_error(f"duplicate seeds: {list(self.seeds)}")
        if not all(isinstance(s, int) for s in self.seeds):
            raise _spec_error(f"seeds must be ints (got {list(self.seeds)})")
        if self.regimes is not None:
            if not self.regimes:
                raise _spec_error("regimes cannot be empty — use None to "
                                  "inherit scenario.regime")
            for r in self.regimes:
                if r is not None and r not in REGIMES:
                    raise _spec_error(f"unknown regime {r!r} in regimes "
                                      f"(known: {', '.join(REGIMES)})")
        # every grid cell is validated eagerly: a bad combination (e.g.
        # migration over a regime-less scenario, a bid axis without an
        # engine, an unknown workload_grid key) fails at construction,
        # not in a worker process mid-sweep
        self.cells()

    # -- grid ---------------------------------------------------------------
    def workload_combos(self) -> Tuple[Mapping[str, Any], ...]:
        """The cross product of ``workload_grid`` value ladders as parameter
        dicts, in axis-declaration order (``({},)`` when the grid is
        inert)."""
        if not self.workload_grid:
            return ({},)
        keys = list(self.workload_grid)
        combos: list = [{}]
        for key in keys:
            combos = [{**c, key: v} for c in combos
                      for v in self.workload_grid[key]]
        return tuple(combos)

    def cells(self) -> Tuple[RunSpec, ...]:
        """The (regime × policy × migration × bid × workload-combo × fleet)
        grid as RunSpecs, in report order (new axes nest innermost, so the
        original ordering is preserved when they are inert)."""
        regimes = (self.regimes if self.regimes is not None
                   else (self.scenario.regime,))
        bid_axis = self.bids if self.bids is not None else (None,)
        fleet_axis = self.fleets if self.fleets is not None else (None,)
        autoscale_axis = (self.autoscales if self.autoscales is not None
                          else (None,))
        combos = self.workload_combos()
        out = []
        for regime in regimes:
            base = (self.scenario if regime == self.scenario.regime
                    else self.scenario.replace(regime=regime))
            for policy in self.policies:
                for migration in self.migrations:
                    for bid in bid_axis:
                        s_bid = base if bid is None else base.replace(bid=bid)
                        for combo in combos:
                            scenario = (s_bid if not combo else s_bid.replace(
                                workload_params={**s_bid.workload_params,
                                                 **combo}))
                            for fleet in fleet_axis:
                                for autoscale in autoscale_axis:
                                    out.append(RunSpec(
                                        scenario=scenario, policy=policy,
                                        migration=migration,
                                        rebid=self.rebid, fleet=fleet,
                                        faults=self.faults,
                                        serve=self.serve,
                                        autoscale=autoscale))
        return tuple(out)

    def runs(self):
        """Yields ``(cell_index, run_spec, seed)`` for the full grid × seed
        fan-out."""
        for i, cell in enumerate(self.cells()):
            for seed in self.seeds:
                yield i, cell, seed

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "scenario": self.scenario.to_dict(),
            "policies": [p.to_dict() for p in self.policies],
            "migrations": [m.to_dict() for m in self.migrations],
            "regimes": list(self.regimes) if self.regimes is not None
            else None,
            "bids": ([b.to_dict() for b in self.bids]
                     if self.bids is not None else None),
            "workload_grid": {k: list(v)
                              for k, v in self.workload_grid.items()},
            "seeds": list(self.seeds),
            "rebid": self.rebid.to_dict() if self.rebid is not None else None,
            "fleets": ([f.to_dict() if f is not None else None
                        for f in self.fleets]
                       if self.fleets is not None else None),
            "faults": (self.faults.to_dict()
                       if self.faults is not None else None),
            "serve": (self.serve.to_dict()
                      if self.serve is not None else None),
            "autoscales": ([a.to_dict() if a is not None else None
                            for a in self.autoscales]
                           if self.autoscales is not None else None),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        rebid = d.get("rebid")
        regimes = d.get("regimes")
        bids = d.get("bids")
        fleets = d.get("fleets")
        faults = d.get("faults")
        serve = d.get("serve")
        autoscales = d.get("autoscales")
        return cls(
            name=d.get("name", "experiment"),
            scenario=ScenarioSpec.from_dict(d["scenario"]),
            policies=tuple(PolicySpec.from_dict(p) for p in d["policies"]),
            migrations=tuple(MigrationSpec.from_dict(m)
                             for m in d.get("migrations", [{}])),
            regimes=tuple(regimes) if regimes is not None else None,
            bids=(tuple(BidSpec.from_dict(b) for b in bids)
                  if bids is not None else None),
            workload_grid=d.get("workload_grid", {}),
            seeds=tuple(int(s) for s in d["seeds"]),
            rebid=RebidSpec.from_dict(rebid) if rebid is not None else None,
            fleets=(tuple(FleetSpec.from_dict(f) if f is not None else None
                          for f in fleets)
                    if fleets is not None else None),
            faults=(FaultSpec.from_dict(faults)
                    if faults is not None else None),
            serve=(ServeSpec.from_dict(serve)
                   if serve is not None else None),
            autoscales=(tuple(AutoscaleSpec.from_dict(a)
                              if a is not None else None
                              for a in autoscales)
                        if autoscales is not None else None),
        )

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=1) + "\n")
