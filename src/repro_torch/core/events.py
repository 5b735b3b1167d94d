"""Discrete-event machinery (paper §II-C, Fig. 1; CloudSim's future event queue).

Events carry a (time, priority, seq) ordering key: ties at the same timestamp
are broken first by priority (deallocation before allocation, so capacity freed
at time t is visible to requests arriving at t) and then FIFO by sequence
number — deterministic replay is a hard requirement for the paper's
"same randomized values reused across all simulation runs" methodology (§VII-E2).
"""
from __future__ import annotations

import enum
import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional


class EventKind(enum.Enum):
    VM_SUBMIT = "vm-submit"
    VM_FINISH = "vm-finish"
    WAIT_EXPIRE = "wait-expire"
    HIBERNATION_EXPIRE = "hibernation-expire"
    INTERRUPT_COMMIT = "interrupt-commit"   # end of the warning period
    PRICE_TICK = "price-tick"               # market engine reprice + wave scan
    MIGRATE_START = "migrate-start"         # planner-chosen VM leaves its host
    MIGRATE_COMPLETE = "migrate-complete"   # end of the stop-and-copy window
    HOST_ADD = "host-add"
    HOST_REMOVE = "host-remove"
    HOST_UPDATE = "host-update"
    SERVE_TICK = "serve-tick"               # serving loop: arrivals + decode
    AUTOSCALE = "autoscale"                 # autoscaler control cadence


# lower = processed earlier at equal timestamps
PRIORITY = {
    EventKind.HOST_ADD: 0,
    EventKind.HOST_UPDATE: 0,
    EventKind.VM_FINISH: 1,
    EventKind.INTERRUPT_COMMIT: 2,
    # a migration arrival is an allocation: process after same-time finishes
    # and wave commits so it sees settled capacity
    EventKind.MIGRATE_COMPLETE: 2,
    EventKind.HOST_REMOVE: 3,
    EventKind.HIBERNATION_EXPIRE: 4,
    EventKind.WAIT_EXPIRE: 5,
    # reprice after deallocations/expiries at t, before new submissions at t
    # see the fresh price (ties with WAIT_EXPIRE break FIFO by seq)
    EventKind.PRICE_TICK: 5,
    EventKind.VM_SUBMIT: 6,
    # migrations are opportunistic: same-time fresh submissions claim
    # capacity first, the start handler re-validates its reservation target
    EventKind.MIGRATE_START: 7,
    # the serving loop observes fully settled same-time state (post-wave,
    # post-flush, post-fleet); the autoscaler reads the serve tick's fresh
    # signals, so it sorts after SERVE_TICK at coincident timestamps
    EventKind.SERVE_TICK: 8,
    EventKind.AUTOSCALE: 9,
}


@dataclass(order=True)
class Event:
    time: float
    priority: int
    seq: int
    kind: EventKind = field(compare=False)
    payload: Any = field(compare=False, default=None)
    #: generation stamp — stale events (VM re-allocated since scheduling) are
    #: dropped at dispatch; mirrors CloudSim's event cancellation.
    generation: int = field(compare=False, default=-1)


class EventQueue:
    """Future event queue ordered by (time, priority, seq).

    The heap holds plain key tuples (C-speed comparisons; the unique ``seq``
    guarantees the Event itself is never compared) — at trace scale heap
    sifting is a measurable slice of the event loop."""

    def __init__(self) -> None:
        self._heap: list[tuple] = []
        self._seq = itertools.count()

    def push(self, time: float, kind: EventKind, payload: Any = None,
             generation: int = -1) -> Event:
        ev = Event(time, PRIORITY[kind], next(self._seq), kind, payload, generation)
        heapq.heappush(self._heap, (ev.time, ev.priority, ev.seq, ev))
        return ev

    def pop(self) -> Optional[Event]:
        return heapq.heappop(self._heap)[3] if self._heap else None

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)
