"""Google-Cluster-Trace-style workloads (paper §VII-C/D).

The 2011 Google trace has MACHINE EVENTS (add/remove/update) and TASK EVENTS;
the paper groups tasks into synthetic VMs by (user, machine) and injects
200 k spot instances with fixed 20/40 h durations on top of the trace load.

We provide:
* ``generate_trace``  — a scaled synthetic trace with the structural features
  the paper relies on: a machine fleet with heterogeneous capacity, machine
  add/remove churn, diurnal task arrival (paper Figs. 7–9), and task resource
  requests; fully seeded.
* ``write_trace_csv`` / ``load_trace`` — the CSV interchange format
  (machine_events.csv, task_events.csv) so real trace extracts can be fed in.
* ``simulate_trace``  — drives a :class:`MarketSimulator` from a trace plus
  injected spot instances, reproducing the §VII-D experiment at configurable
  scale.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.allocation import AllocationPolicy, FirstFit
from ..core.simulator import MarketSimulator, SimConfig
from ..core.types import InterruptionBehavior, make_on_demand, make_spot, resources


@dataclass
class TraceConfig:
    seed: int = 0
    n_machines: int = 400
    sim_days: float = 1.0
    # mean concurrently-active VMs per machine (trace: ~100k active / 12.6k mach)
    load_per_machine: float = 16.0
    machine_churn_per_day: float = 0.02   # fraction removed/re-added per day
    n_spot: int = 2_000                   # paper: 200k at full scale
    spot_durations_h: Tuple[float, float] = (20.0, 40.0)
    hibernation_timeout_s: float = 4 * 3600.0
    min_running_time_s: float = 60.0
    spot_behavior: InterruptionBehavior = InterruptionBehavior.HIBERNATE


@dataclass
class Trace:
    # (time_s, machine_id, event['add'|'remove'|'update'], cpu, ram, bw, storage)
    machine_events: List[tuple] = field(default_factory=list)
    # (time_s, vm_id, cpu, ram, bw, storage, duration_s, kind['od'|'spot'])
    task_events: List[tuple] = field(default_factory=list)


# Machine platform mix loosely following the trace's capacity distribution
# (normalized units; the trace normalizes CPU/RAM to the largest machine).
_MACHINE_TYPES = [
    (0.50, resources(16, 24_576, 10_000, 400_000)),
    (0.31, resources(32, 49_152, 10_000, 400_000)),
    (0.19, resources(64, 98_304, 20_000, 800_000)),
]


def _diurnal_rate(t_s: float, base: float) -> float:
    """Arrival intensity with the trace's day/night swing (paper Fig. 9)."""
    hour = (t_s / 3600.0) % 24.0
    return base * (1.0 + 0.35 * np.sin((hour - 6.0) / 24.0 * 2 * np.pi))


def generate_trace(cfg: TraceConfig | None = None) -> Trace:
    cfg = cfg or TraceConfig()
    rng = np.random.default_rng(cfg.seed)
    horizon = cfg.sim_days * 86_400.0
    tr = Trace()

    probs = np.array([p for p, _ in _MACHINE_TYPES])
    caps = [c for _, c in _MACHINE_TYPES]
    for mid in range(cfg.n_machines):
        cap = caps[rng.choice(len(caps), p=probs)]
        tr.machine_events.append((0.0, mid, "add", *cap))
    # churn: remove + re-add a fraction of machines at random times
    n_churn = int(cfg.machine_churn_per_day * cfg.n_machines * cfg.sim_days)
    for _ in range(n_churn):
        mid = int(rng.integers(cfg.n_machines))
        t_rm = float(rng.uniform(0.1, 0.8) * horizon)
        t_re = t_rm + float(rng.uniform(600.0, 7200.0))
        tr.machine_events.append((t_rm, mid, "remove", 0, 0, 0, 0))
        cap = caps[rng.choice(len(caps), p=probs)]
        if t_re < horizon:
            tr.machine_events.append((t_re, mid, "add", *cap))

    # --- VM (grouped-task) arrivals: Poisson with diurnal modulation --------
    # target: load_per_machine concurrent VMs/machine; mean duration ~1h ->
    # arrival rate = target_active / mean_duration
    mean_dur = 3600.0
    target_active = cfg.load_per_machine * cfg.n_machines
    base_rate = target_active / mean_dur  # arrivals per second
    t, vm_id = 0.0, 0
    while t < horizon:
        rate = _diurnal_rate(t, base_rate)
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        if t >= horizon:
            break
        cpu = float(rng.choice([0.5, 1, 2, 4, 8], p=[0.35, 0.3, 0.2, 0.1, 0.05]))
        ram = cpu * float(rng.uniform(1_024, 2_048))
        dur = float(rng.lognormal(mean=np.log(mean_dur) - 0.5, sigma=1.0))
        dur = min(max(dur, 30.0), horizon)
        tr.task_events.append((t, vm_id, cpu, ram, 10.0, 1_000.0, dur, "od"))
        vm_id += 1

    # --- injected spot instances (paper §VII-D: 200k @ 20/40 h) -------------
    for k in range(cfg.n_spot):
        t0 = float(rng.uniform(0.0, 0.25 * horizon))
        dur_h = cfg.spot_durations_h[k % 2]
        cpu = float(rng.choice([1, 2, 4]))
        tr.task_events.append(
            (t0, vm_id, cpu, cpu * 1_536.0, 10.0, 1_000.0, dur_h * 3600.0, "spot"))
        vm_id += 1

    tr.task_events.sort(key=lambda e: e[0])
    return tr


# -- CSV interchange ----------------------------------------------------------
def write_trace_csv(tr: Trace, directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "machine_events.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["time", "machine_id", "event", "cpu", "ram", "bw", "storage"])
        w.writerows(tr.machine_events)
    with open(os.path.join(directory, "task_events.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["time", "vm_id", "cpu", "ram", "bw", "storage",
                    "duration", "kind"])
        w.writerows(tr.task_events)


def load_trace(directory: str) -> Trace:
    tr = Trace()
    with open(os.path.join(directory, "machine_events.csv")) as f:
        for row in csv.DictReader(f):
            tr.machine_events.append((
                float(row["time"]), int(row["machine_id"]), row["event"],
                float(row["cpu"]), float(row["ram"]), float(row["bw"]),
                float(row["storage"])))
    with open(os.path.join(directory, "task_events.csv")) as f:
        for row in csv.DictReader(f):
            tr.task_events.append((
                float(row["time"]), int(row["vm_id"]), float(row["cpu"]),
                float(row["ram"]), float(row["bw"]), float(row["storage"]),
                float(row["duration"]), row["kind"]))
    tr.task_events.sort(key=lambda e: e[0])
    return tr


# -- trace-driven simulation --------------------------------------------------
def wire_trace(sim: MarketSimulator, tr: Trace,
               cfg: TraceConfig | None = None) -> MarketSimulator:
    """Populate an (empty) simulator from a trace: t=0 machines become hosts,
    later machine events become scheduled host add/remove/update, task events
    become submitted VMs.  Shared by :func:`simulate_trace` and the scenario
    API's ``trace`` workload, so both wire bit-identically."""
    cfg = cfg or TraceConfig()
    obs = sim.obs
    if obs.enabled:
        obs.begin("build", "build/wire_trace")
    # machine id -> host id mapping (machines can be re-added)
    m2h: Dict[int, int] = {}
    for (t, mid, event, cpu, ram, bw, st) in sorted(tr.machine_events):
        if event == "add":
            if t == 0.0 and mid not in m2h:
                m2h[mid] = sim.add_host(resources(cpu, ram, bw, st))
            else:
                # re-adds map to fresh host slots (trace semantics: new machine)
                sim.schedule_host_add(t, resources(cpu, ram, bw, st))
        elif event == "remove" and mid in m2h:
            sim.schedule_host_remove(t, m2h[mid])
        elif event == "update" and mid in m2h:
            sim.schedule_host_update(t, m2h[mid], resources(cpu, ram, bw, st))

    for (t, vid, cpu, ram, bw, st, dur, kind) in tr.task_events:
        demand = resources(cpu, ram, bw, st)
        if kind == "spot":
            vm = make_spot(
                vid, demand, dur, behavior=cfg.spot_behavior,
                min_running_time=cfg.min_running_time_s,
                hibernation_timeout=cfg.hibernation_timeout_s,
                waiting_timeout=float("inf"), submit_time=t)
        else:
            vm = make_on_demand(vid, demand, dur, waiting_timeout=3600.0,
                                submit_time=t)
        sim.submit(vm)
    if obs.enabled:
        obs.end(sim.now)
    return sim


def simulate_trace(
    tr: Trace,
    policy: Optional[AllocationPolicy] = None,
    cfg: TraceConfig | None = None,
    sim_config: Optional[SimConfig] = None,
    until: Optional[float] = None,
    engine=None,
    migration=None,
    rebid=None,
    obs=None,
    events=None,
):
    """Run the market simulator on a trace. Returns (simulator, metrics).
    ``engine`` / ``migration`` / ``rebid`` / ``obs`` / ``events`` pass
    through to :class:`MarketSimulator` (all default off — the paper's
    §VII-D setup)."""
    cfg = cfg or TraceConfig()
    sim = MarketSimulator(
        policy=policy or FirstFit(),
        config=sim_config or SimConfig(record_timeline=False),
        engine=engine, migration=migration, rebid=rebid, obs=obs,
        events=events,
    )
    if obs is not None and obs.enabled:
        sim.policy.tracer = obs
        if engine is not None:
            engine.tracer = obs
        if migration is not None:
            migration.tracer = obs
    if events is not None and events.enabled:
        if engine is not None:
            engine.events = events
        if migration is not None:
            migration.events = events
    wire_trace(sim, tr, cfg)
    metrics = sim.run(until=until)
    return sim, metrics
