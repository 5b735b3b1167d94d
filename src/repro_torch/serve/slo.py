"""SLO and cost metrics for the serving scenario.

Per-request latency distribution (p50/p95/p99), SLO attainment with
windowed error-budget burn (SRE-style: burn rate 1.0 = exactly spending
the budget the objective allows), and cost-effectiveness on the
batched realized-billing path — cost per served request and a linear
end-of-horizon cost forecast.  Everything here is pure aggregation over
the run's :class:`~repro_torch.core.metrics.Metrics`; the realized fleet cost
itself comes from ``Metrics.resilience_stats`` (one batched
``price_integrals`` call) and is passed in, never recomputed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def latency_percentiles(latencies: Sequence[float],
                        qs: Sequence[float] = (50.0, 95.0, 99.0)
                        ) -> Dict[str, float]:
    """``{"p50": ..., "p95": ...}`` over the sample (0.0 when empty —
    aggregate rows must stay numeric for the sweep's mean ± CI pass)."""
    if not len(latencies):
        return {f"p{g:g}": 0.0 for g in qs}
    arr = np.asarray(latencies, dtype=np.float64)
    vals = np.percentile(arr, qs)
    return {f"p{g:g}": float(v) for g, v in zip(qs, vals)}


def slo_attainment(latencies: Sequence[float], threshold: float) -> float:
    """Fraction of served requests at or under ``threshold`` seconds
    (1.0 when nothing was served — an empty run violates nothing)."""
    if not len(latencies):
        return 1.0
    arr = np.asarray(latencies, dtype=np.float64)
    return float(np.count_nonzero(arr <= threshold)) / arr.size


def error_budget_burn(done_times: Sequence[float],
                      latencies: Sequence[float], threshold: float,
                      objective: float, window: float,
                      horizon: float) -> Dict[str, float]:
    """Windowed error-budget burn over the run.

    The objective grants a violation budget of ``1 - objective`` per
    window; the burn rate of a window is its observed violation fraction
    over that budget (1.0 = spending the budget exactly, >1 = on track to
    exhaust it).  Returns the overall burn plus the worst window."""
    budget = max(1.0 - objective, 1e-12)
    out = {"burn_rate": 0.0, "max_window_burn": 0.0}
    if not len(done_times):
        return out
    t = np.asarray(done_times, dtype=np.float64)
    bad = (np.asarray(latencies, dtype=np.float64) > threshold)
    out["burn_rate"] = float(np.count_nonzero(bad)) / t.size / budget
    edges = np.arange(0.0, horizon + window, window, dtype=np.float64)
    idx = np.clip(np.searchsorted(edges, t, side="right") - 1, 0,
                  len(edges) - 2)
    n_win = len(edges) - 1
    total = np.bincount(idx, minlength=n_win).astype(np.float64)
    viol = np.bincount(idx, weights=bad.astype(np.float64),
                       minlength=n_win)
    with np.errstate(invalid="ignore"):
        burns = np.where(total > 0, viol / np.maximum(total, 1.0) / budget,
                         0.0)
    out["max_window_burn"] = float(np.max(burns)) if burns.size else 0.0
    return out


def cost_per_request(cost: float, n_done: int) -> float:
    """Realized price·hours per served request (0.0 when nothing served)."""
    return cost / n_done if n_done > 0 else 0.0


def cost_forecast(cost: float, elapsed: float, horizon: float) -> float:
    """Linear end-of-horizon projection of the realized cost so far."""
    if elapsed <= 0:
        return 0.0
    return cost * (horizon / elapsed)


def serve_stats(metrics, slo_latency: float, slo_objective: float,
                window: float, horizon: float,
                cost: Optional[float] = None) -> dict:
    """Aggregate serving row for :func:`repro_torch.api.build.collect_row`.

    ``cost`` is the run's realized fleet cost (spot + on-demand spill,
    price·hours) from ``resilience_stats``; ``None`` (no fleet billing
    available) zeroes the cost-effectiveness keys."""
    lat = metrics.request_latencies
    pct = latency_percentiles(lat)
    burn = error_budget_burn(metrics.request_done_times, lat, slo_latency,
                             slo_objective, window, horizon)
    samples = metrics.serve_samples
    depth: List[float] = [s[3] for s in samples]
    live: List[float] = [s[4] for s in samples]
    out = {
        "requests_arrived": metrics.requests_arrived,
        "requests_done": metrics.requests_done,
        "requests_requeued": metrics.requests_requeued,
        "requests_outstanding": (metrics.requests_arrived
                                 - metrics.requests_done),
        "p50_latency_s": pct["p50"],
        "p95_latency_s": pct["p95"],
        "p99_latency_s": pct["p99"],
        "slo_attainment": slo_attainment(lat, slo_latency),
        "error_budget_burn": burn["burn_rate"],
        "max_window_burn": burn["max_window_burn"],
        "throughput_rps": (metrics.requests_done / horizon
                           if horizon > 0 else 0.0),
        "mean_queue_depth": float(np.mean(depth)) if depth else 0.0,
        "max_queue_depth": float(np.max(depth)) if depth else 0.0,
        "mean_live_units": float(np.mean(live)) if live else 0.0,
        "autoscale_actions": sum(
            1 for (_, old, new) in metrics.autoscale_decisions
            if old != new),
        "cost_per_request": 0.0,
        "cost_forecast": 0.0,
    }
    if cost is not None:
        elapsed = samples[-1][0] if samples else horizon
        out["cost_per_request"] = cost_per_request(cost,
                                                   metrics.requests_done)
        out["cost_forecast"] = cost_forecast(cost, elapsed, horizon)
    return out
