"""Plain NumPy reference for trace replays onto an empty fleet.

An independent statement of what the simulator does in the fill regime of
a cluster trace: VMs arrive at their submit times and run for their
durations on hosts chosen by HLEM-VMP (arXiv 2511.18137 §VI: RsDiff filter,
Eqs. 1-2; entropy weights and host scores, Eqs. 3-9; the spot-load
adjustment, Eqs. 10-11).  It imports nothing of the program.

It runs in two modes over one replay's inputs:

* ``judge``: teacher-forced on the program's placements.  At each arrival
  it scores the candidates from its own host state and reads how far the
  score of the host the program chose lies below its best (the widest such
  gap is the number compared), then applies the program's choice, so that
  every later decision is judged from the state the program was in.
* ``decide``: makes the decisions itself, at a given precision.  Run at
  float32 in place of the program it is the control.

The fill regime has no spot clearing, queueing, hibernation or host churn:
an arrival that fits no host, or a trace with machine events after t = 0,
raises ``Unsupported`` and the run is not correct.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

FIT_SLACK = 1e-9      # a host fits when free >= demand - FIT_SLACK, each dim
SPAN_EPS = 1e-12      # a dimension whose candidate span is below is degenerate
TOT_EPS_RS = 1e-12    # RsDiff's clamp of the host's total cpu (Eq. 1)
TOT_EPS_SPOT = 1e-9   # the spot fraction's clamp of each host total (Eq. 10)
FINISH, SUBMIT = 1, 6  # same-time order: departures before arrivals


class Unsupported(RuntimeError):
    """The replay left the fill regime this reference states."""


def hlem_scores(free: np.ndarray, spot_frac: np.ndarray, cand: np.ndarray,
                alpha: float, dtype=np.float64) -> np.ndarray:
    """Scores of the candidate hosts ``cand`` (Eqs. 3-11) at ``dtype``.
    ``free`` and ``spot_frac`` are (d, n): one row per resource dimension."""
    d, m = free.shape[0], cand.size
    if m == 1:
        return np.ones(1, dtype=dtype)
    x = np.stack([free[k, cand] for k in range(d)]).astype(dtype)
    lo, hi = x.min(axis=1), x.max(axis=1)
    span = hi - lo
    c = np.ones_like(x)
    for k in range(d):                          # Eq. 3
        if span[k] > SPAN_EPS:
            np.subtract(x[k], lo[k], out=c[k])
            c[k] /= span[k]
    p = c / c.sum(axis=1, keepdims=True)        # Eq. 4
    plogp = p * np.log(np.maximum(p, dtype(SPAN_EPS)))
    plogp[p <= SPAN_EPS] = 0                    # Eqs. 5-6
    e = -(1 / np.log(dtype(m))) * plogp.sum(axis=1)
    g = (1 - e).astype(dtype)                   # Eq. 7
    gsum = g.sum()
    w = g / gsum if gsum > SPAN_EPS else np.full(d, 1 / d, dtype=dtype)
    hs = w @ c                                  # Eqs. 8-9
    if alpha != 0.0:                            # Eqs. 10-11
        sl = np.stack([spot_frac[k, cand] for k in range(d)]).astype(dtype)
        hs = hs * (1 + dtype(alpha) * (w @ sl))
    return hs


class _Fleet:
    """Host state, one row per resource dimension: (d, n)."""

    def __init__(self, capacity: np.ndarray):
        self.total = np.ascontiguousarray(np.asarray(capacity, np.float64).T)
        self.used = np.zeros_like(self.total)
        self.spot_used = np.zeros_like(self.total)
        self.tot_cpu = np.maximum(self.total[0], TOT_EPS_RS)
        self.tot_spot = np.maximum(self.total, TOT_EPS_SPOT)

    def free(self) -> np.ndarray:
        return self.total - self.used

    def spot_frac(self) -> np.ndarray:
        return self.spot_used / self.tot_spot

    def candidates(self, demand: np.ndarray, rc: float,
                   threshold: float) -> Tuple[np.ndarray, np.ndarray]:
        """(feasible host ids, HLEM candidate ids: feasible and above the
        RsDiff threshold, or all feasible when none is)."""
        free = self.free()
        fits = free[0] >= demand[0] - FIT_SLACK
        for k in range(1, free.shape[0]):
            fits &= free[k] >= demand[k] - FIT_SLACK
        feasible = np.flatnonzero(fits)
        tot = self.tot_cpu[feasible]
        rs = demand[0] / tot - self.used[0, feasible] / tot * rc   # Eq. 1
        primary = feasible[rs > threshold]                         # Eq. 2
        return feasible, (primary if primary.size else feasible)

    def place(self, host: int, demand: np.ndarray, spot: bool) -> None:
        self.used[:, host] += demand
        if spot:
            self.spot_used[:, host] += demand

    def release(self, host: int, demand: np.ndarray, spot: bool) -> None:
        self.used[:, host] = np.maximum(self.used[:, host] - demand, 0.0)
        if spot:
            self.spot_used[:, host] = np.maximum(
                self.spot_used[:, host] - demand, 0.0)


def _replay(machines: Sequence[tuple], tasks: Sequence[tuple], until: float,
            choose: Callable) -> Dict:
    """Run the replay to ``until``; ``choose(k, vm_id, t, demand, fleet,
    spot)`` returns the host of the k-th placement (or None to stop).
    Returns the lifecycle counts."""
    if any(ev[0] != 0.0 or ev[2] != "add" for ev in machines):
        raise Unsupported("machine events after t = 0 (host churn)")
    order = sorted(machines, key=lambda ev: ev[1])
    fleet = _Fleet(np.array([ev[3:7] for ev in order], dtype=np.float64))
    heap: List[tuple] = []
    seq = 0
    for ev in tasks:
        heap.append((ev[0], SUBMIT, seq, ev))
        seq += 1
    heapq.heapify(heap)
    counts = {"allocations": 0, "interruptions": 0, "hibernations": 0,
              "redeployed": 0, "max_interruption_s": 0.0, "finished": 0}
    while heap and heap[0][0] <= until:
        t, kind, _, ev = heapq.heappop(heap)
        if kind == FINISH:
            host, demand, spot = ev
            fleet.release(host, demand, spot)
            counts["finished"] += 1
            continue
        _t, vm_id, cpu, ram, bw, st, dur, vm_kind = ev
        demand = np.array([cpu, ram, bw, st], dtype=np.float64)
        spot = vm_kind == "spot"
        host = choose(counts["allocations"], vm_id, t, demand, fleet, spot)
        if host is None:
            break
        fleet.place(host, demand, spot)
        counts["allocations"] += 1
        heapq.heappush(heap, (t + dur, FINISH, seq, (host, demand, spot)))
        seq += 1
    return counts


def _scored(fleet: _Fleet, demand: np.ndarray, spot: bool, policy: Dict,
            vm_id: int, t: float, dtype=np.float64):
    """(HLEM candidate ids, their scores) of one arrival."""
    feasible, cand = fleet.candidates(demand, float(policy["rc"]),
                                      float(policy["threshold"]))
    if feasible.size == 0:
        raise Unsupported(f"vm {vm_id} fits no host at t={t}")
    alpha = float(policy["alpha"]) if spot else 0.0
    return cand, hlem_scores(fleet.free(), fleet.spot_frac(), cand, alpha,
                             dtype)


def judge(machines, tasks, until: float, policy: Dict,
          placements: Sequence[Tuple[int, int, float]],
          score_at: Sequence[int], gap_limit: float = np.inf) -> Dict:
    """Teacher-forced check of the program's ``placements`` ((vm_id, host,
    time) in the order made) over the replay up to ``until``.

    Every placement is checked to be the arrival the reference expects
    next, at its time, on a host that fits; the placements whose indices
    are in ``score_at`` are also scored.  Returns the widest relative score
    gap of a chosen host below the reference's best (``gap_max``; a host
    outside the RsDiff candidates counts as infinitely far), the number of
    placements that failed the first check (``mismatches``, counting every
    placement from the first such one on, since the states part there),
    how many were scored and how many of those lie above ``gap_limit``
    (``over``), and the reference's lifecycle counts."""
    out = {"gap_max": 0.0, "mismatches": 0, "judged": 0, "over": 0}
    scored = set(int(i) for i in score_at)

    def choose(k, vm_id, t, demand, fleet, spot):
        if k >= len(placements):
            out["mismatches"] += 1
            return None
        p_vm, p_host, p_t = placements[k]
        if (p_vm != vm_id or p_t != t or not 0 <= p_host < fleet.total.shape[1]
                or not (fleet.free()[:, p_host] >= demand - FIT_SLACK).all()):
            out["mismatches"] += len(placements) - k
            return None
        if k in scored:
            out["judged"] += 1
            cand, hs = _scored(fleet, demand, spot, policy, vm_id, t)
            pos = np.searchsorted(cand, p_host)
            if pos >= cand.size or cand[pos] != p_host:
                gap = np.inf
            else:
                best = hs.max()
                gap = float((best - hs[pos]) / max(abs(best), 1e-300))
            out["gap_max"] = max(out["gap_max"], gap)
            out["over"] += int(gap > gap_limit)
        return p_host

    counts = _replay(machines, tasks, until, choose)
    if out["mismatches"] == 0 and counts["allocations"] < len(placements):
        out["mismatches"] = len(placements) - counts["allocations"]
    out["counts"] = counts
    return out


def decide(machines, tasks, until: float, policy: Dict,
           dtype=np.float64) -> List[Tuple[int, int, float]]:
    """The reference's own placements, scoring at ``dtype``."""
    made: List[Tuple[int, int, float]] = []

    def choose(k, vm_id, t, demand, fleet, spot):
        cand, hs = _scored(fleet, demand, spot, policy, vm_id, t, dtype)
        host = int(cand[int(np.argmax(hs))])
        made.append((vm_id, host, t))
        return host

    _replay(machines, tasks, until, choose)
    return made
