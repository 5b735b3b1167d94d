"""Straggler mitigation.

At multi-pod scale the slowest replica sets step time.  Two mechanisms:

1. **Deadline-masked gradient combine**: each data-parallel replica
   contributes its microbatch gradient with an ``arrived`` mask; the global
   gradient is the weighted mean over arrived replicas only (missing
   contributions are dropped and the mean re-scaled — "backup-worker"
   semantics without the backups).  The host runtime decides the mask from
   per-replica heartbeats/deadlines.

2. **Straggler detection** (host-side): an EWMA of per-host step times flags
   hosts slower than ``threshold`` x the fleet median; the elastic layer then
   treats a persistent straggler exactly like a spot interruption — the
   market simulator's HIBERNATE path — and re-meshes without it.

A port of the reference package's ``elastic/straggler.py``: the combine on
tensors (a dict or list tree with a leading replica axis), the detector
as it is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from .compression import _map

Params = Any


def masked_grad_mean(stacked_grads: Params, arrived: torch.Tensor) -> Params:
    """stacked_grads: tree with leading replica axis R; arrived: (R,) bool.
    Mean over arrived replicas (weight 0 for missing, rescaled)."""
    w = arrived.to(torch.float32)
    denom = torch.clamp(w.sum(), min=1.0)

    def one(g):
        wshape = (g.shape[0],) + (1,) * (g.dim() - 1)
        return (g.to(torch.float32) * w.to(g.device).reshape(wshape)).sum(0) / denom

    return _map(one, stacked_grads)


@dataclass
class StragglerDetector:
    """EWMA step-time tracker; flags hosts persistently above threshold x
    median."""
    alpha: float = 0.3
    threshold: float = 1.8
    patience: int = 3
    ewma: Dict[int, float] = field(default_factory=dict)
    strikes: Dict[int, int] = field(default_factory=dict)

    def observe(self, host: int, step_time: float) -> None:
        prev = self.ewma.get(host)
        self.ewma[host] = (step_time if prev is None
                           else self.alpha * step_time + (1 - self.alpha) * prev)

    def stragglers(self) -> List[int]:
        if len(self.ewma) < 2:
            return []
        med = float(np.median(list(self.ewma.values())))
        out = []
        for host, t in self.ewma.items():
            if t > self.threshold * med:
                self.strikes[host] = self.strikes.get(host, 0) + 1
            else:
                self.strikes[host] = 0
            if self.strikes.get(host, 0) >= self.patience:
                out.append(host)
        return out
