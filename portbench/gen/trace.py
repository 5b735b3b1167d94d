"""Frozen Google-cluster-trace generator: the benchmark's own copy.

A copy of the program's ``market/trace.py`` ``generate_trace`` as it stood
when the benchmark was written, kept here so that later changes to the
program cannot change the traffic it is measured on.  Same draws in the
same order: at a fixed seed the events equal the program's.

Machine events are ``(time_s, machine_id, "add" | "remove", cpu, ram, bw,
storage)``; task events ``(time_s, vm_id, cpu, ram, bw, storage,
duration_s, "od" | "spot")``, sorted by time.  Parameters come from the
configuration file (deployment) and the traffic file (horizon).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

#: the trace's machine platform mix (share, capacity cpu/ram/bw/storage)
MACHINE_TYPES = (
    (0.50, (16.0, 24_576.0, 10_000.0, 400_000.0)),
    (0.31, (32.0, 49_152.0, 10_000.0, 400_000.0)),
    (0.19, (64.0, 98_304.0, 20_000.0, 800_000.0)),
)
MEAN_DURATION_S = 3600.0


def _diurnal_rate(t_s: float, base: float) -> float:
    hour = (t_s / 3600.0) % 24.0
    return base * (1.0 + 0.35 * np.sin((hour - 6.0) / 24.0 * 2 * np.pi))


def generate(seed: int, n_machines: int, sim_days: float,
             load_per_machine: float, machine_churn_per_day: float,
             n_spot: int, spot_durations_h: Tuple[float, float]
             ) -> Tuple[List[tuple], List[tuple]]:
    """(machine_events, task_events) of one seeded trace."""
    rng = np.random.default_rng(seed)
    horizon = sim_days * 86_400.0
    machine_events: List[tuple] = []
    task_events: List[tuple] = []

    probs = np.array([p for p, _ in MACHINE_TYPES])
    caps = [c for _, c in MACHINE_TYPES]
    for mid in range(n_machines):
        cap = caps[rng.choice(len(caps), p=probs)]
        machine_events.append((0.0, mid, "add", *cap))
    n_churn = int(machine_churn_per_day * n_machines * sim_days)
    for _ in range(n_churn):
        mid = int(rng.integers(n_machines))
        t_rm = float(rng.uniform(0.1, 0.8) * horizon)
        t_re = t_rm + float(rng.uniform(600.0, 7200.0))
        machine_events.append((t_rm, mid, "remove", 0, 0, 0, 0))
        cap = caps[rng.choice(len(caps), p=probs)]
        if t_re < horizon:
            machine_events.append((t_re, mid, "add", *cap))

    base_rate = load_per_machine * n_machines / MEAN_DURATION_S
    t, vm_id = 0.0, 0
    while t < horizon:
        rate = _diurnal_rate(t, base_rate)
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        if t >= horizon:
            break
        cpu = float(rng.choice([0.5, 1, 2, 4, 8],
                               p=[0.35, 0.3, 0.2, 0.1, 0.05]))
        ram = cpu * float(rng.uniform(1_024, 2_048))
        dur = float(rng.lognormal(mean=np.log(MEAN_DURATION_S) - 0.5,
                                  sigma=1.0))
        dur = min(max(dur, 30.0), horizon)
        task_events.append((t, vm_id, cpu, ram, 10.0, 1_000.0, dur, "od"))
        vm_id += 1

    for k in range(n_spot):
        t0 = float(rng.uniform(0.0, 0.25 * horizon))
        dur_h = spot_durations_h[k % 2]
        cpu = float(rng.choice([1, 2, 4]))
        task_events.append(
            (t0, vm_id, cpu, cpu * 1_536.0, 10.0, 1_000.0, dur_h * 3600.0,
             "spot"))
        vm_id += 1

    task_events.sort(key=lambda e: e[0])
    return machine_events, task_events
