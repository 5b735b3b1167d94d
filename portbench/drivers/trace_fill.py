"""Cells that replay a cluster trace onto an empty fleet.

Inputs come from the benchmark's frozen trace generator; each replay's
simulator is built as the program's ``market/trace.py`` ``simulate_trace``
builds one (a fresh ``MarketSimulator`` with the configured policy, wired
by ``wire_trace``); correctness is judged by the plain reference
``refs/trace_fill.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..gen import trace as gen
from ..refs import trace_fill as ref


def horizon(cell) -> float:
    return float(cell.traffic["sim_days"]) * 86_400.0


def prepare(cell, replay_seed: int) -> Dict:
    """One replay's inputs (made in set-up, outside the window)."""
    c = cell.config
    machines, tasks = gen.generate(
        replay_seed, int(c["n_machines"]), float(cell.traffic["sim_days"]),
        float(c["load_per_machine"]), float(c["machine_churn_per_day"]),
        int(c["n_spot"]), tuple(c["spot_durations_h"]))
    return {"seed": replay_seed, "machines": machines, "tasks": tasks}


def build(inputs: Dict, cell, device: str, traced: bool):
    """A fresh, populated simulator for one replay (inside the window);
    ``traced`` attaches the program's tracer in its profiling mode."""
    from repro_torch.core.allocation import make_policy
    from repro_torch.core.simulator import MarketSimulator, SimConfig
    from repro_torch.core.types import InterruptionBehavior
    from repro_torch.market.trace import Trace, TraceConfig, wire_trace
    from repro_torch.obs.tracer import Tracer

    c, pol = cell.config, cell.config["policy"]
    tracer = Tracer(keep_records=False, profile=True) if traced else None
    policy = make_policy(pol["name"], **{**pol["params"], "device": device})
    sim = MarketSimulator(
        policy=policy,
        config=SimConfig(record_timeline=False, **cell.config["sim"]),
        obs=tracer)
    if tracer is not None:
        sim.policy.tracer = tracer
    cfg = TraceConfig(
        seed=inputs["seed"], n_machines=int(c["n_machines"]),
        spot_behavior=InterruptionBehavior(c["spot_behavior"]),
        hibernation_timeout_s=float(c["hibernation_timeout_s"]),
        min_running_time_s=float(c["min_running_time_s"]))
    wire_trace(sim, Trace(machine_events=list(inputs["machines"]),
                          task_events=list(inputs["tasks"])), cfg)
    return sim


def observe(sim) -> Dict:
    """What the check reads of a replay besides its placements: nothing."""
    return {}


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
    }


def judge(inputs: Dict, replay: Dict, cell, score_at, limits: Dict) -> Dict:
    """The reference's readings of one replay: ``gap_max`` and
    ``mismatches``, the decisions judged wrong, and its own counts."""
    j = ref.judge(inputs["machines"], inputs["tasks"], replay["reached"],
                  cell.config["policy"]["params"], replay["placements"],
                  score_at, float(limits["gap_max"]))
    return {"readings": {"gap_max": j["gap_max"],
                         "mismatches": j["mismatches"]},
            "failed": j["over"] + j["mismatches"], "judged": j["judged"],
            "counts": j["counts"]}


def control(inputs: Dict, until: float, cell, dtype=np.float32) -> Dict:
    """A replay's record with the reference's own placements at ``dtype``:
    put in the program's place at float32, the control."""
    return {"placements": ref.decide(inputs["machines"], inputs["tasks"],
                                     until, cell.config["policy"]["params"],
                                     dtype),
            "observed": {}}
