"""Workload and infrastructure generators.

``synthetic_scenario`` reproduces the paper's §VII-E evaluation setup exactly:
Table II host fleet (20/30/30/20 small..x-large), Table III VM profiles with
the per-profile spot / on-demand counts, 400 spot + 600 on-demand submitted at
t=0 and the remaining 1 000 with randomized delays.  All randomized draws come
from a seeded generator so different allocation policies see *identical*
workloads ("the same randomized values were reused across all simulation
runs", §VII-E2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from .types import (
    InterruptionBehavior,
    Vm,
    make_on_demand,
    make_spot,
    resources,
)

# --- paper Table II ---------------------------------------------------------
HOST_TYPES = {
    "small": resources(8, 16_384, 5_000, 200_000),
    "medium": resources(16, 32_768, 10_000, 400_000),
    "large": resources(32, 65_536, 20_000, 800_000),
    "x-large": resources(64, 131_072, 40_000, 1_600_000),
}
HOST_COUNTS = {"small": 20, "medium": 30, "large": 30, "x-large": 20}

# --- paper Table III --------------------------------------------------------
# (cpu, ram, bw, storage, #spot, #on-demand)
VM_PROFILES: List[Tuple[float, float, float, float, int, int]] = [
    (1, 1_024, 100, 10_000, 31, 160),
    (2, 1_024, 100, 10_000, 42, 175),
    (1, 2_048, 200, 20_000, 36, 168),
    (2, 2_048, 200, 20_000, 44, 146),
    (4, 2_048, 200, 20_000, 40, 158),
    (4, 4_096, 500, 50_000, 40, 145),
    (6, 4_096, 500, 50_000, 36, 170),
    (6, 8_192, 1_000, 80_000, 51, 155),
    (8, 8_192, 1_000, 80_000, 33, 162),
    (10, 8_192, 1_000, 80_000, 47, 168),
]


@dataclass
class ScenarioConfig:
    seed: int = 0
    # workload timing (paper leaves the ranges unspecified; these are
    # calibrated so interruption counts land in the paper's range — a few
    # hundred total, ~2 max per VM — then held fixed across policies)
    duration_range: Tuple[float, float] = (50.0, 200.0)
    delay_range: Tuple[float, float] = (0.0, 900.0)
    immediate_on_demand: int = 600
    # spot lifecycle parameters (§V-C time-based parameters)
    spot_behavior: InterruptionBehavior = InterruptionBehavior.HIBERNATE
    min_running_time: float = 5.0
    hibernation_timeout: float = 600.0
    waiting_timeout: float = 600.0
    warning_time: float = 0.0


def build_hosts() -> List[np.ndarray]:
    hosts = []
    for name, count in HOST_COUNTS.items():
        hosts.extend([HOST_TYPES[name].copy() for _ in range(count)])
    return hosts


def synthetic_scenario(cfg: ScenarioConfig | None = None):
    """Returns (host_capacities, vms) for the §VII-E comparison."""
    cfg = cfg or ScenarioConfig()
    rng = np.random.default_rng(cfg.seed)
    hosts = build_hosts()

    vms: List[Vm] = []
    vm_id = 0
    spot_vms: List[Vm] = []
    od_vms: List[Vm] = []
    for cpu, ram, bw, st, n_spot, n_od in VM_PROFILES:
        demand = resources(cpu, ram, bw, st)
        for _ in range(n_spot):
            dur = rng.uniform(*cfg.duration_range)
            spot_vms.append(make_spot(
                vm_id, demand.copy(), dur,
                behavior=cfg.spot_behavior,
                min_running_time=cfg.min_running_time,
                hibernation_timeout=cfg.hibernation_timeout,
                waiting_timeout=cfg.waiting_timeout,
            ))
            vm_id += 1
        for _ in range(n_od):
            dur = rng.uniform(*cfg.duration_range)
            od_vms.append(make_on_demand(
                vm_id, demand.copy(), dur,
                waiting_timeout=cfg.waiting_timeout,
            ))
            vm_id += 1

    # 400 spot + 600 on-demand immediately; remaining on-demand delayed
    rng.shuffle(od_vms)
    for v in od_vms[cfg.immediate_on_demand:]:
        v.submit_time = float(rng.uniform(*cfg.delay_range))
    vms = spot_vms + od_vms
    vms.sort(key=lambda v: (v.submit_time, v.id))
    return hosts, vms


@dataclass
class MarketScenarioConfig:
    """Workload for the dynamic-market / migration experiments (beyond-paper).

    The §VII-E scenario's 50–200 s VMs are too short-lived relative to a
    60 s price tick for market dynamics to matter.  This scenario keeps the
    Table III profile mix but models a *regional spot market day*: long-
    running spot VMs (pool-flexible, submitted up front) ride out staggered
    regional on-demand demand humps (pool-pinned, diurnal-style arrival
    waves per §VII trace Fig. 9) that push each capacity pool's utilization
    — and hence its clearing price — up and back down in sequence.  Rolling,
    *predictable* per-pool price ramps are exactly the regime where
    proactive cross-pool migration is supposed to earn its keep."""

    seed: int = 0
    n_pools: int = 4
    #: host fleet = Table II fleet tiled and cut to 100 × fleet_scale hosts
    fleet_scale: float = 1.7
    spot_duration_range: Tuple[float, float] = (7_200.0, 10_800.0)
    spot_submit_window: float = 600.0
    min_running_time: float = 300.0
    hibernation_timeout: float = 3_600.0
    od_duration_range: Tuple[float, float] = (1_200.0, 4_800.0)
    #: pool p's on-demand wave arrives in
    #: [hump_start + p·hump_spacing, … + hump_width]
    od_hump_start: float = 600.0
    od_hump_spacing: float = 2_400.0
    od_hump_width: float = 2_400.0
    spot_behavior: InterruptionBehavior = InterruptionBehavior.HIBERNATE


def market_scenario(cfg: MarketScenarioConfig | None = None):
    """Returns (host_capacities, host_pool_ids, vms) for the market-regime
    comparison (``market_sim --market``).  All draws are seeded: every
    (allocation policy × migration policy) combination sees the identical
    workload."""
    cfg = cfg or MarketScenarioConfig()
    rng = np.random.default_rng(cfg.seed)
    base = build_hosts()
    n_hosts = int(round(len(base) * cfg.fleet_scale))
    tiles = -(-n_hosts // len(base))  # ceil
    hosts = (base * tiles)[:n_hosts]
    pool_ids = [i % cfg.n_pools for i in range(n_hosts)]

    vms: List[Vm] = []
    vid = 0
    for cpu, ram, bw, st, n_spot, n_od in VM_PROFILES:
        demand = resources(cpu, ram, bw, st)
        for _ in range(n_spot):
            vms.append(make_spot(
                vid, demand.copy(),
                float(rng.uniform(*cfg.spot_duration_range)),
                behavior=cfg.spot_behavior,
                min_running_time=cfg.min_running_time,
                hibernation_timeout=cfg.hibernation_timeout,
                submit_time=float(rng.uniform(0.0, cfg.spot_submit_window)),
            ))
            vid += 1
        for _ in range(n_od):
            p = vid % cfg.n_pools
            t0 = (cfg.od_hump_start + p * cfg.od_hump_spacing
                  + float(rng.uniform(0.0, cfg.od_hump_width)))
            vms.append(make_on_demand(
                vid, demand.copy(),
                float(rng.uniform(*cfg.od_duration_range)),
                submit_time=t0, pool=p,
            ))
            vid += 1
    vms.sort(key=lambda v: (v.submit_time, v.id))
    return hosts, pool_ids, vms


def random_fleet(n_hosts: int, seed: int = 0) -> List[np.ndarray]:
    """Uniform random fleet drawn from the Table II types (for property tests
    and throughput benchmarks)."""
    rng = np.random.default_rng(seed)
    types = list(HOST_TYPES.values())
    return [types[rng.integers(len(types))].copy() for _ in range(n_hosts)]


def random_vms(n_vms: int, seed: int = 0, spot_fraction: float = 0.4,
               t_max: float = 300.0,
               behavior: InterruptionBehavior = InterruptionBehavior.HIBERNATE,
               ) -> List[Vm]:
    rng = np.random.default_rng(seed)
    out: List[Vm] = []
    for i in range(n_vms):
        cpu, ram, bw, st, _, _ = VM_PROFILES[rng.integers(len(VM_PROFILES))]
        demand = resources(cpu, ram, bw, st)
        dur = float(rng.uniform(20.0, 300.0))
        t0 = float(rng.uniform(0.0, t_max))
        if rng.random() < spot_fraction:
            out.append(make_spot(i, demand, dur, behavior=behavior,
                                 min_running_time=2.0,
                                 hibernation_timeout=300.0,
                                 waiting_timeout=300.0, submit_time=t0))
        else:
            out.append(make_on_demand(i, demand, dur, waiting_timeout=300.0,
                                      submit_time=t0))
    return out
