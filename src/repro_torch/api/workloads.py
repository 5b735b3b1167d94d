"""Workload generators as scenario-API plugins.

Each entry in :data:`WORKLOAD_REGISTRY` is a :class:`WorkloadDef`: a
``populate(sim, scenario, seed)`` function that fills an empty
:class:`~repro_torch.core.simulator.MarketSimulator` (hosts + submitted VMs +
bid assignment), plus the metadata the spec layer validates against
(``config_cls`` for ``workload_params`` key checking, bid/market support,
the workload's default horizon).

Built-ins:

* ``synthetic`` — the paper's §VII-E comparison scenario
  (:func:`repro_torch.core.workload.synthetic_scenario`); hosts are striped over
  the market's pools when an engine is attached.
* ``market``    — the regional-demand-hump market scenario
  (:func:`repro_torch.core.workload.market_scenario`); requires a market regime.
* ``trace``     — Google-Cluster-Trace-style machine/task events
  (:func:`repro_torch.market.trace.generate_trace` + ``wire_trace``).

Custom workloads register a plain populate function:

    @register_workload("my-workload")
    def _populate(sim, scenario, seed):
        sim.add_host(...); sim.submit(...)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..core.registry import Registry, named
from ..core.types import resources
from ..core.workload import (
    MarketScenarioConfig,
    ScenarioConfig,
    market_scenario,
    synthetic_scenario,
)
from ..market.bids import assign_bids, make_bid_strategy
from ..market.trace import TraceConfig, generate_trace, wire_trace
from ..serve.demand import make_bursty, make_diurnal

WORKLOAD_REGISTRY = Registry("workload")


@dataclass
class WorkloadDef:
    """One pluggable workload: the populate function plus spec-validation
    metadata."""

    populate: Callable  # (sim, scenario_spec, seed) -> None
    #: config dataclass the workload's ``workload_params`` feed (None skips
    #: the unknown-key check for custom workloads)
    config_cls: Optional[type] = None
    #: horizon used when the spec leaves ``horizon=None`` (None = run to
    #: completion)
    default_horizon: Optional[float] = None
    #: whether ``ScenarioSpec.bid`` applies (trace VMs keep bid = inf)
    supports_bids: bool = True
    #: whether the workload only makes sense under a market regime
    requires_market: bool = False
    #: config keys the builder supplies itself — rejected in
    #: ``workload_params`` at spec construction
    reserved_params: tuple = ("seed",)
    #: whether the workload installs a request-demand curve on
    #: ``sim.serve`` (serving scenarios require one of these)
    provides_demand: bool = False

    def __call__(self, sim, scenario, seed: int) -> None:
        self.populate(sim, scenario, seed)


def register_workload(name: str, config_cls: Optional[type] = None,
                      default_horizon: Optional[float] = None,
                      supports_bids: bool = True,
                      requires_market: bool = False,
                      reserved_params: tuple = ("seed",),
                      provides_demand: bool = False) -> Callable:
    """Decorator registering a populate function as a workload."""
    def _wrap(fn: Callable) -> Callable:
        WORKLOAD_REGISTRY.register(name, WorkloadDef(
            populate=fn, config_cls=config_cls,
            default_horizon=default_horizon, supports_bids=supports_bids,
            requires_market=requires_market, reserved_params=reserved_params,
            provides_demand=provides_demand))
        return fn
    return _wrap


def _builtin(name: str, **meta) -> Callable:
    """Stamps a built-in populate function with its registry name (see
    :func:`~repro_torch.core.registry.named`) and its :class:`WorkloadDef`
    metadata; the built-ins are registered by those attributes below."""
    def _tag(fn: Callable) -> Callable:
        fn.meta = meta
        return named(name)(fn)
    return _tag


def _assign_spec_bids(sim, scenario, vms, seed: int) -> None:
    """Stamp bids per the scenario's BidSpec (engine runs only; identical
    draws to the hand-wired ``assign_bids`` path)."""
    if scenario.bid is None or sim.engine is None:
        return
    strat = make_bid_strategy(
        scenario.bid.strategy, pool_cfg=sim.engine.config.pools[0],
        seed=seed, **dict(scenario.bid.params))
    assign_bids(vms, strat, seed=seed)


@_builtin("synthetic", config_cls=ScenarioConfig,
          default_horizon=3000.0)
def _populate_synthetic(sim, scenario, seed: int) -> None:
    cfg = ScenarioConfig(seed=seed, **dict(scenario.workload_params))
    hosts, vms = synthetic_scenario(cfg)
    _assign_spec_bids(sim, scenario, vms, seed)
    stripe = sim.engine is not None
    for i, cap in enumerate(hosts):
        sim.add_host(cap, pool=(i % scenario.n_pools) if stripe else 0)
    for v in vms:
        sim.submit(v)


@_builtin("market", config_cls=MarketScenarioConfig,
          default_horizon=14400.0, requires_market=True,
          reserved_params=("seed", "n_pools"))
def _populate_market(sim, scenario, seed: int) -> None:
    cfg = MarketScenarioConfig(seed=seed, n_pools=scenario.n_pools,
                               **dict(scenario.workload_params))
    hosts, pool_ids, vms = market_scenario(cfg)
    _assign_spec_bids(sim, scenario, vms, seed)
    for cap, pid in zip(hosts, pool_ids):
        sim.add_host(cap, pool=pid)
    for v in vms:
        sim.submit(v)


@_builtin("trace", config_cls=TraceConfig, supports_bids=False)
def _populate_trace(sim, scenario, seed: int) -> None:
    cfg = TraceConfig(seed=seed, **dict(scenario.workload_params))
    wire_trace(sim, generate_trace(cfg), cfg)


# ---------------------------------------------------------------------------
# traffic-driven serving workloads: hosts + a demand curve, no VMs — the
# fleet supplies capacity, the serve layer turns the curve into requests
# ---------------------------------------------------------------------------
@dataclass
class DiurnalDemandConfig:
    """Serving scenario infrastructure + diurnal request-rate curve."""

    n_hosts: int = 12
    host_cpu: float = 16.0
    host_ram: float = 65536.0
    base_rate: float = 0.2       # requests/s at the mean
    amplitude: float = 0.15      # sinusoidal swing (requests/s)
    period: float = 86400.0      # one day
    phase: float = 0.0
    seed: int = 0


@dataclass
class BurstyDemandConfig:
    """Serving scenario infrastructure + self-similar bursty curve."""

    n_hosts: int = 12
    host_cpu: float = 16.0
    host_ram: float = 65536.0
    base_rate: float = 0.15
    spike_every: float = 1800.0  # mean inter-spike gap (s)
    spike_mag: float = 0.5       # Pareto magnitude scale (requests/s)
    spike_alpha: float = 1.6     # Pareto tail index (heavy tail < 2)
    spike_duration: float = 300.0
    seed: int = 0


def _serve_hosts(sim, scenario, n_hosts: int, cpu: float, ram: float) -> None:
    for i in range(int(n_hosts)):
        sim.add_host(resources(cpu, ram, 1000.0, 1 << 20),
                     pool=i % scenario.n_pools)


@_builtin("serve-diurnal", config_cls=DiurnalDemandConfig,
          default_horizon=86400.0, supports_bids=False,
          requires_market=True, provides_demand=True)
def _populate_serve_diurnal(sim, scenario, seed: int) -> None:
    cfg = DiurnalDemandConfig(seed=seed, **dict(scenario.workload_params))
    _serve_hosts(sim, scenario, cfg.n_hosts, cfg.host_cpu, cfg.host_ram)
    if sim.serve is not None:
        sim.serve.set_demand(make_diurnal(
            base_rate=cfg.base_rate, amplitude=cfg.amplitude,
            period=cfg.period, phase=cfg.phase))


@_builtin("serve-bursty", config_cls=BurstyDemandConfig,
          default_horizon=86400.0, supports_bids=False,
          requires_market=True, provides_demand=True)
def _populate_serve_bursty(sim, scenario, seed: int) -> None:
    cfg = BurstyDemandConfig(seed=seed, **dict(scenario.workload_params))
    _serve_hosts(sim, scenario, cfg.n_hosts, cfg.host_cpu, cfg.host_ram)
    if sim.serve is not None:
        horizon = scenario.horizon if scenario.horizon is not None else 86400.0
        sim.serve.set_demand(make_bursty(
            base_rate=cfg.base_rate, spike_every=cfg.spike_every,
            spike_mag=cfg.spike_mag, spike_alpha=cfg.spike_alpha,
            spike_duration=cfg.spike_duration, horizon=horizon,
            seed=cfg.seed))


# Registered by each function's ``name`` attribute rather than by a decorator
# with a string literal: the determinism lint keys plugin names by literal
# across the whole source tree, and the JAX package registers these names.
for _fn in (_populate_synthetic, _populate_market, _populate_trace,
            _populate_serve_diurnal, _populate_serve_bursty):
    register_workload(_fn.name, **_fn.meta)(_fn)
del _fn
