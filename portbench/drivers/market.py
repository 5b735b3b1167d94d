"""Cells of the dynamic spot market (the ``--market`` scenario).

Inputs (hosts in pools, VMs, bids) come from the benchmark's frozen market
generator; each replay's simulator is assembled by the program's own
``api/build.py`` (price engine, migration planner, policy) around them,
handed in through a workload registered with the program's
``register_workload``; correctness is judged by the plain reference
``refs/market.py``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..gen import market as gen
from ..refs import market as ref

WORKLOAD = "portbench-market"


class _Populate:
    """The registered workload: wires the current replay's inputs."""

    def __init__(self):
        self.inputs: Optional[Dict] = None

    def __call__(self, sim, scenario, seed: int) -> None:
        from repro_torch.core.types import (InterruptionBehavior,
                                            make_on_demand, make_spot)
        inputs = self.inputs
        for cap, pool in inputs["hosts"]:
            sim.add_host(cap.copy(), pool=pool)
        for v in inputs["vms"]:
            if v["kind"] == "spot":
                vm = make_spot(
                    v["id"], v["demand"].copy(), v["duration"],
                    behavior=InterruptionBehavior.HIBERNATE,
                    min_running_time=v["min_running_time"],
                    hibernation_timeout=v["hibernation_timeout"],
                    submit_time=v["submit"])
                vm.bid = v["bid"]
            else:
                vm = make_on_demand(v["id"], v["demand"].copy(),
                                    v["duration"], submit_time=v["submit"],
                                    pool=v["pool"])
            sim.submit(vm)


_POPULATE = _Populate()


def _register() -> None:
    from repro_torch.api import WORKLOAD_REGISTRY, register_workload
    if WORKLOAD not in WORKLOAD_REGISTRY.entries:
        register_workload(WORKLOAD, requires_market=True,
                          supports_bids=False)(_POPULATE)


def horizon(cell) -> float:
    return float(cell.traffic["horizon_s"])


def prepare(cell, replay_seed: int) -> Dict:
    """One replay's inputs (made in set-up, outside the window)."""
    c = cell.config
    hosts, vms = gen.generate(
        replay_seed, int(cell.config["market"]["n_pools"]),
        float(c["fleet_scale"]), tuple(c["spot_duration_range"]),
        float(c["spot_submit_window"]), float(c["min_running_time"]),
        float(c["hibernation_timeout"]), tuple(c["od_duration_range"]),
        float(c["od_hump_start"]), float(c["od_hump_spacing"]),
        float(c["od_hump_width"]), float(c["bid_lo"]), float(c["bid_hi"]),
        float(c["on_demand_rate"]))
    return {"seed": replay_seed, "hosts": hosts, "vms": vms}


def build(inputs: Dict, cell, device: str, traced: bool):
    """A fresh simulator for one replay, assembled by the program's
    ``api.build`` (inside the window); ``traced`` asks the spec for the
    program's tracer in its profiling mode."""
    from repro_torch.api import (MigrationSpec, ObsSpec, PolicySpec, RunSpec,
                                 ScenarioSpec, build as api_build)
    _register()
    mk, pol, tr = cell.config["market"], cell.config["policy"], cell.traffic
    spec = RunSpec(
        scenario=ScenarioSpec(
            workload=WORKLOAD, regime=tr["regime"],
            n_pools=int(mk["n_pools"]),
            tick_interval=float(mk["tick_interval"]),
            from_advisor=bool(mk["from_advisor"]),
            sim_params=dict(cell.config["sim"]), horizon=horizon(cell)),
        policy=PolicySpec(pol["name"], {**pol["params"], "device": device}),
        migration=MigrationSpec(tr["migration"],
                                dict(tr.get("migration_params", {}))),
        obs=ObsSpec(profile=True) if traced else None)
    _POPULATE.inputs = inputs
    try:
        return api_build(spec, inputs["seed"])
    finally:
        _POPULATE.inputs = None


def observe(sim) -> Dict:
    """The program's interruptions (vm, time, cause) in order, its price
    ticks (time, per-pool prices) and its migrations (vm, start, source
    host, destination host, source pool, destination pool)."""
    m = sim.metrics
    n = sim.engine.n_pools
    series = m.price_series
    ticks = [(series[i][0], np.array([p for _, _, p in series[i:i + n]]))
             for i in range(0, len(series), n)]
    return {"interruptions": [(int(e.vm_id), float(e.time), str(e.cause))
                              for e in m.interruption_events],
            "price_log": ticks,
            "migrations": [(int(e.vm_id), float(e.t_start), int(e.src_host),
                            int(e.dst_host), int(e.src_pool),
                            int(e.dst_pool)) for e in m.migration_events]}


def program_counts(sim) -> Dict:
    """The lifecycle counts of a finished replay, read from the program."""
    m = sim.metrics
    stats = m.spot_stats(sim.vms)
    return {
        "allocations": m.allocations,
        "interruptions": stats["interruptions"],
        "hibernations": sum(1 for e in m.interruption_events
                            if e.kind == "hibernate"),
        "redeployed": stats["resumed_gaps"],
        "max_interruption_s": stats["max_interruption_time"],
        "finished": sum(1 for v in sim.vms.values()
                        if v.state.name == "FINISHED"),
        "waves": len(m.wave_events),
        "migrations": m.migrations_completed,
        "migrations_failed": m.migrations_failed,
    }


def _market(cell) -> Dict:
    return {**cell.config["market"],
            "correlation": float(cell.traffic["correlation"])}


def _migration(cell) -> Optional[Dict]:
    """The migration policy and its parameters, or None without one."""
    tr = cell.traffic
    if tr["migration"] == "none":
        return None
    return {"policy": tr["migration"], **tr["migration_params"]}


def judge(inputs: Dict, replay: Dict, cell, score_at, limits: Dict) -> Dict:
    """The reference's readings of one replay (``gap_max``,
    ``price_gap_max``, ``mismatches``), the decisions judged wrong, and its
    own counts."""
    obs = replay["observed"]
    j = ref.judge(inputs["hosts"], inputs["vms"], _market(cell),
                  cell.config["policy"]["params"], inputs["seed"],
                  replay["reached"], replay["placements"],
                  obs["interruptions"], obs["price_log"], obs["migrations"],
                  score_at, float(limits["gap_max"]), _migration(cell))
    return {"readings": {k: j[k] for k in ("gap_max", "price_gap_max",
                                           "mismatches")},
            "failed": j["over"] + j["mismatches"], "judged": j["judged"],
            "counts": j["counts"]}


def control(inputs: Dict, until: float, cell, dtype=np.float32) -> Dict:
    """A replay's record made by the reference itself at ``dtype``: put in
    the program's place at float32, the control."""
    out = ref.decide(inputs["hosts"], inputs["vms"], _market(cell),
                     cell.config["policy"]["params"], inputs["seed"], until,
                     dtype, _migration(cell))
    return {"placements": out.pop("placements"), "observed": out}
