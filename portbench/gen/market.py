"""Frozen dynamic-market scenario generator: the benchmark's own copy.

A copy of the program's ``core/workload.py`` ``market_scenario`` (the
paper's Table II fleet tiled to ``fleet_scale`` x 100 hosts over the pools,
Table III VM profiles: long-lived pool-flexible spot VMs submitted up
front, pool-pinned on-demand demand humps) and of the randomized bids the
``--market`` scenario stamps on its spot VMs (``market/bids.py``
``RandomizedBid`` through ``assign_bids``), as they stood when the
benchmark was written.  Same draws in the same order: at a fixed seed the
hosts, VMs and bids equal the program's.

Hosts are ``(capacity (4,), pool)``; VMs are dicts with ``id``, ``kind``
("spot" | "od"), ``demand`` (4,), ``duration``, ``submit``, ``pool`` (-1 =
any), ``bid``, ``min_running_time``, ``hibernation_timeout``, sorted by
(submit time, id).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# paper Table II: (cpu, ram, bw, storage) x count, small .. x-large
HOST_TYPES = (
    ((8.0, 16_384.0, 5_000.0, 200_000.0), 20),
    ((16.0, 32_768.0, 10_000.0, 400_000.0), 30),
    ((32.0, 65_536.0, 20_000.0, 800_000.0), 30),
    ((64.0, 131_072.0, 40_000.0, 1_600_000.0), 20),
)
# paper Table III: (cpu, ram, bw, storage, #spot, #on-demand)
VM_PROFILES = (
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
)


def generate(seed: int, n_pools: int, fleet_scale: float,
             spot_duration_range: Tuple[float, float],
             spot_submit_window: float, min_running_time: float,
             hibernation_timeout: float,
             od_duration_range: Tuple[float, float], od_hump_start: float,
             od_hump_spacing: float, od_hump_width: float,
             bid_lo: float, bid_hi: float, on_demand_rate: float
             ) -> Tuple[List[Tuple[np.ndarray, int]], List[Dict]]:
    """(hosts, vms) of one seeded market scenario, bids stamped."""
    rng = np.random.default_rng(seed)
    base = [np.array(cap) for cap, count in HOST_TYPES for _ in range(count)]
    n_hosts = int(round(len(base) * fleet_scale))
    tiles = -(-n_hosts // len(base))
    hosts = [(cap.copy(), i % n_pools)
             for i, cap in enumerate((base * tiles)[:n_hosts])]

    vms: List[Dict] = []
    vid = 0
    for cpu, ram, bw, st, n_spot, n_od in VM_PROFILES:
        demand = np.array([cpu, ram, bw, st], dtype=np.float64)
        for _ in range(n_spot):
            dur = float(rng.uniform(*spot_duration_range))
            vms.append({
                "id": vid, "kind": "spot", "demand": demand.copy(),
                "duration": dur, "pool": -1, "bid": np.inf,
                "min_running_time": min_running_time,
                "hibernation_timeout": hibernation_timeout,
                "submit": float(rng.uniform(0.0, spot_submit_window))})
            vid += 1
        for _ in range(n_od):
            p = vid % n_pools
            t0 = (od_hump_start + p * od_hump_spacing
                  + float(rng.uniform(0.0, od_hump_width)))
            vms.append({
                "id": vid, "kind": "od", "demand": demand.copy(),
                "duration": float(rng.uniform(*od_duration_range)),
                "pool": p, "bid": np.inf, "min_running_time": 0.0,
                "hibernation_timeout": np.inf, "submit": t0})
            vid += 1
    vms.sort(key=lambda v: (v["submit"], v["id"]))
    spot = [v for v in vms if v["kind"] == "spot"]
    bids = np.random.default_rng(seed).uniform(bid_lo, bid_hi, len(spot)) \
        * on_demand_rate
    for v, b in zip(spot, bids):
        v["bid"] = float(b)
    return hosts, vms
