"""HLEM-VMP as the launcher's job→slice placement policy.

The paper's allocation algorithm, applied at cluster level: training/serving
jobs (with HBM, chip, ICI-bandwidth and host-RAM demands) are placed onto pod
slices exactly like VMs onto hosts — including spot-job preemption when a
reserved (on-demand) job needs capacity, entropy-weighted load balancing
across slices, and the adjusted variant's spot-load spreading that reduces
how many preemptible jobs a single slice loss can kill.

A port of the reference package's ``elastic/placement.py``.  Placement
scores through the port's ``HlemVmpAdjusted`` on ``device`` (default
``"cuda"``: the HLEM kernel; ``"cpu"``: its plain PyTorch version).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..core import (
    HlemVmpAdjusted,
    InterruptionBehavior,
    MarketSimulator,
    SimConfig,
    Vm,
    make_on_demand,
    make_spot,
    resources,
)

# resource dims reinterpreted at cluster level:
#   cpu -> chips, ram -> HBM GB, bw -> ICI GB/s, storage -> host RAM GB
SLICE_V5E_256 = resources(256, 256 * 16, 256 * 100, 256 * 48)


@dataclass
class JobSpec:
    name: str
    chips: int
    hbm_gb: float
    ici_gbps: float
    host_ram_gb: float
    duration_h: float
    preemptible: bool = True

    def demand(self) -> np.ndarray:
        return resources(self.chips, self.hbm_gb, self.ici_gbps,
                         self.host_ram_gb)


class ClusterScheduler:
    """Thin adapter: jobs as VMs, pod slices as hosts, HLEM-VMP placement."""

    def __init__(self, n_slices: int, slice_capacity: np.ndarray = SLICE_V5E_256,
                 alpha: float = -0.5, warning_s: float = 120.0,
                 device="cuda"):
        self.sim = MarketSimulator(
            policy=HlemVmpAdjusted(alpha=alpha, device=device),
            config=SimConfig(warning_time=warning_s,
                             interruption_selector="best_fit_remaining"))
        self.slice_ids = [self.sim.add_host(slice_capacity.copy())
                          for _ in range(n_slices)]
        self._jobs: Dict[str, Vm] = {}
        self._next = 0

    def submit(self, job: JobSpec, at: float = 0.0) -> int:
        vid = self._next
        self._next += 1
        if job.preemptible:
            vm = make_spot(vid, job.demand(), job.duration_h * 3600,
                           behavior=InterruptionBehavior.HIBERNATE,
                           min_running_time=600.0,
                           hibernation_timeout=24 * 3600.0,
                           waiting_timeout=24 * 3600.0, submit_time=at)
        else:
            vm = make_on_demand(vid, job.demand(), job.duration_h * 3600,
                                waiting_timeout=24 * 3600.0, submit_time=at)
        self._jobs[job.name] = vm
        self.sim.submit(vm)
        return vid

    def run(self, until_h: float):
        return self.sim.run(until=until_h * 3600.0)

    def placement(self) -> Dict[str, int]:
        return {name: vm.host for name, vm in self._jobs.items()}

    def states(self) -> Dict[str, str]:
        return {name: vm.state.value for name, vm in self._jobs.items()}
