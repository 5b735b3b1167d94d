"""Interruption-aware request scheduling (ties serving to the spot market).

Pure-Python request lifecycle, a copy of the reference package's
``serve/scheduler.py``; it imports nothing of the model stack in
``repro_torch.serve.engine``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Request:
    id: int
    prompt_len: int
    target_tokens: int
    generated: float = 0
    state: str = "queued"     # queued | running | hibernated | done | dropped
    interruptions: int = 0


@dataclass
class SpotServingScheduler:
    """Schedules decode batches over capacity that can be reclaimed.

    When the market simulator interrupts the serving instance, in-flight
    requests are either *hibernated* (their decode state checkpointed and
    resumed later — like the paper's HIBERNATE behavior) or requeued from
    scratch (TERMINATE).  Mirrors the VM lifecycle at request granularity.
    """
    batch_size: int
    hibernate: bool = True
    queue: List[Request] = field(default_factory=list)
    running: List[Request] = field(default_factory=list)
    hibernated: List[Request] = field(default_factory=list)
    done: List[Request] = field(default_factory=list)

    def add(self, req: Request) -> None:
        self.queue.append(req)

    def fill_batch(self) -> List[Request]:
        # resume hibernated requests first (paper's resubmission order)
        while self.hibernated and len(self.running) < self.batch_size:
            r = self.hibernated.pop(0)
            r.state = "running"
            self.running.append(r)
        while self.queue and len(self.running) < self.batch_size:
            r = self.queue.pop(0)
            r.state = "running"
            self.running.append(r)
        return self.running

    def step(self, n: float = 1) -> None:
        finished = []
        for r in self.running:
            r.generated += n
            if r.generated >= r.target_tokens:
                r.state = "done"
                finished.append(r)
        for r in finished:
            self.running.remove(r)
            self.done.append(r)

    def interrupt(self) -> None:
        """Capacity reclaimed: hibernate or requeue all running requests."""
        for r in self.running:
            r.interruptions += 1
            if self.hibernate:
                r.state = "hibernated"
                self.hibernated.append(r)
            else:
                r.state = "queued"
                r.generated = 0
                self.queue.append(r)
        self.running = []

    def stats(self) -> Dict[str, int]:
        return {
            "done": len(self.done),
            "queued": len(self.queue),
            "hibernated": len(self.hibernated),
            "running": len(self.running),
            "interruptions": sum(
                r.interruptions for r in
                self.done + self.queue + self.hibernated + self.running),
        }
