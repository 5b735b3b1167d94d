"""Core datatypes for the dynamic cloud marketspace simulator.

Mirrors the entity model of the paper's CloudSim Plus extension (§V-E):
``DynamicVm`` (abstract) -> ``OnDemandInstance`` / ``SpotInstance``, hosts with
4 resource dimensions (CPU, RAM, BW, Storage), and the extended VM lifecycle
states of Fig. 4.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# Resource dimension order, fixed everywhere (D = 4), as in the paper
# (CPU cores, memory MB, bandwidth Mbps, storage MB).
RESOURCE_DIMS: Tuple[str, ...] = ("cpu", "ram", "bw", "storage")
N_DIMS = len(RESOURCE_DIMS)


def resources(cpu: float, ram: float, bw: float, storage: float) -> np.ndarray:
    """Build a resource vector in canonical dimension order."""
    return np.array([cpu, ram, bw, storage], dtype=np.float64)


class VmType(enum.Enum):
    ON_DEMAND = "on-demand"
    SPOT = "spot"


class InterruptionBehavior(enum.Enum):
    """What happens to a spot VM when the provider reclaims capacity (§V-C)."""

    TERMINATE = "terminate"
    HIBERNATE = "hibernate"


class VmState(enum.Enum):
    """Extended VM lifecycle states (paper Fig. 4; MIGRATING is the
    beyond-paper proactive cross-pool migration extension)."""

    CREATED = "created"          # defined, not yet submitted
    WAITING = "waiting"          # persistent request, waiting for capacity
    RUNNING = "running"          # allocated to a host, executing
    INTERRUPTING = "interrupting"  # received interruption warning, still running
    HIBERNATED = "hibernated"    # interrupted w/ HIBERNATE, awaiting resubmission
    MIGRATING = "migrating"      # in flight between hosts (stop-and-copy window)
    FINISHED = "finished"        # workload completed
    TERMINATED = "terminated"    # interrupted w/ TERMINATE or hibernation expired
    FAILED = "failed"            # request never fulfilled (waiting timed out)


@dataclass
class ExecutionInterval:
    """One contiguous period of execution on a host (§V-E ExecutionHistory).

    ``via`` records what started the interval: ``"start"`` (fresh allocation
    or resubmission after an interruption) or ``"migrate"`` (arrival of a
    proactive migration) — interruption-gap statistics must not count the
    voluntary migration downtime as interruption time."""

    host: int
    start: float
    stop: Optional[float] = None
    via: str = "start"


@dataclass
class Vm:
    """A dynamic VM request (on-demand or spot).

    ``duration`` is the total required execution time of the attached cloudlet;
    progress only accrues while RUNNING/INTERRUPTING, so hibernation pauses the
    workload exactly as in the paper's extension.
    """

    id: int
    demand: np.ndarray                      # (4,) resource request
    vm_type: VmType
    duration: float
    submit_time: float = 0.0
    # Spot-specific configuration (ignored for on-demand):
    behavior: InterruptionBehavior = InterruptionBehavior.TERMINATE
    min_running_time: float = 0.0           # cannot be interrupted before this
    hibernation_timeout: float = float("inf")
    # Persistent-request configuration (both types may be persistent, §V-D):
    persistent: bool = True
    waiting_timeout: float = float("inf")
    # Market configuration (price-driven engine; ignored when no engine runs):
    #   bid  — max clearing price this spot VM pays; the engine interrupts it
    #          whenever its pool's price exceeds the bid, and admission masks
    #          only open hosts whose pool currently clears at <= bid.  The
    #          inf default means "pay whatever" (never price-interrupted).
    #   pool — capacity-pool constraint: >= 0 pins the VM to that pool
    #          (region-bound); -1 lets it run in any pool whose price clears.
    bid: float = float("inf")
    pool: int = -1
    # --- runtime state ---
    state: VmState = VmState.CREATED
    host: int = -1
    remaining: float = field(default=-1.0)  # initialized to duration on submit
    run_start: float = -1.0                 # start of the current running interval
    waiting_since: float = -1.0
    hibernated_at: float = -1.0
    interruptions: int = 0
    migrations: int = 0                     # completed proactive migrations
    #: migration hysteresis: the planner may not select this VM again before
    #: this simulation time (stamped on arrival of a completed migration)
    migrate_cooldown_until: float = 0.0
    history: List[ExecutionInterval] = field(default_factory=list)
    generation: int = 0                     # invalidates stale scheduled events
    finish_time: float = -1.0

    def __post_init__(self) -> None:
        self.demand = np.asarray(self.demand, dtype=np.float64)
        if self.remaining < 0:
            self.remaining = float(self.duration)

    # -- convenience -------------------------------------------------------
    @property
    def is_spot(self) -> bool:
        return self.vm_type is VmType.SPOT

    def runtime_so_far(self, now: float) -> float:
        """Time accrued in the current running interval."""
        if self.state in (VmState.RUNNING, VmState.INTERRUPTING) and self.run_start >= 0:
            return now - self.run_start
        return 0.0

    def interruptible(self, now: float) -> bool:
        """Spot VM may be reclaimed only after its minimum running time (§IV-B)."""
        return (
            self.is_spot
            and self.state is VmState.RUNNING
            and self.runtime_so_far(now) >= self.min_running_time
        )

    def interruption_gaps(self) -> List[float]:
        """Durations between consecutive execution intervals (resumed gaps).

        Gaps closed by a proactive migration arrival (``via == "migrate"``)
        are voluntary downtime, accounted separately in the migration metrics
        — they are not interruption time."""
        gaps = []
        for prev, nxt in zip(self.history, self.history[1:]):
            if prev.stop is not None and nxt.via != "migrate":
                gaps.append(nxt.start - prev.stop)
        return gaps

    def average_interruption_time(self) -> float:
        gaps = self.interruption_gaps()
        return float(np.mean(gaps)) if gaps else 0.0


def make_spot(
    vm_id: int,
    demand: np.ndarray,
    duration: float,
    *,
    behavior: InterruptionBehavior = InterruptionBehavior.HIBERNATE,
    min_running_time: float = 0.0,
    hibernation_timeout: float = float("inf"),
    persistent: bool = True,
    waiting_timeout: float = float("inf"),
    submit_time: float = 0.0,
    bid: float = float("inf"),
    pool: int = -1,
) -> Vm:
    return Vm(
        id=vm_id, demand=demand, vm_type=VmType.SPOT, duration=duration,
        behavior=behavior, min_running_time=min_running_time,
        hibernation_timeout=hibernation_timeout, persistent=persistent,
        waiting_timeout=waiting_timeout, submit_time=submit_time,
        bid=bid, pool=pool,
    )


def make_on_demand(
    vm_id: int,
    demand: np.ndarray,
    duration: float,
    *,
    persistent: bool = True,
    waiting_timeout: float = float("inf"),
    submit_time: float = 0.0,
    pool: int = -1,
) -> Vm:
    return Vm(
        id=vm_id, demand=demand, vm_type=VmType.ON_DEMAND, duration=duration,
        persistent=persistent, waiting_timeout=waiting_timeout,
        submit_time=submit_time, pool=pool,
    )
