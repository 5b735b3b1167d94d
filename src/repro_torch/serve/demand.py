"""Deterministic request-rate curves for serving scenarios.

A demand curve is a plain callable ``rate(t) -> requests/second``.  Two
families back the serve workloads:

* :func:`make_diurnal` — a sinusoidal day/night cycle (the classic
  capacity-planning shape: base load plus a smooth daily swing);
* :func:`make_bursty` — base load plus pre-drawn spike episodes whose
  magnitudes follow a heavy-tailed Pareto draw (a cheap stand-in for
  self-similar traffic: a few spikes dominate the aggregate).

Both are *pure* after construction: the bursty curve draws its whole spike
schedule from a seeded generator up front, so evaluating ``rate(t)`` during
the run never touches an RNG — identical (spec, seed) pairs replay the same
demand bit for bit, which the chaos-determinism tests rely on.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np

DemandCurve = Callable[[float], float]


def make_diurnal(base_rate: float = 0.2, amplitude: float = 0.15,
                 period: float = 86400.0, phase: float = 0.0) -> DemandCurve:
    """Sinusoidal diurnal demand: ``base + amplitude·sin(2π(t−phase)/period)``,
    clamped at zero.  ``amplitude > base_rate`` yields dead-of-night troughs
    where demand is exactly zero."""
    if base_rate < 0:
        raise ValueError(f"base_rate must be >= 0 (got {base_rate!r})")
    if amplitude < 0:
        raise ValueError(f"amplitude must be >= 0 (got {amplitude!r})")
    if not period > 0:
        raise ValueError(f"period must be > 0 (got {period!r})")
    two_pi = 2.0 * math.pi

    def rate(t: float) -> float:
        return max(0.0, base_rate
                   + amplitude * math.sin(two_pi * (t - phase) / period))

    return rate


def make_bursty(base_rate: float = 0.15, spike_every: float = 1800.0,
                spike_mag: float = 0.5, spike_alpha: float = 1.6,
                spike_duration: float = 300.0, horizon: float = 86400.0,
                seed: int = 0) -> DemandCurve:
    """Base load plus Pareto-magnitude spike episodes.

    ``horizon/spike_every`` spike starts are drawn uniformly over
    ``[0, horizon)``; each runs for an exponential duration (mean
    ``spike_duration``) and adds ``spike_mag·(1 + Pareto(spike_alpha))``
    requests/s while active.  ``spike_alpha`` near 1 gives rare giant
    spikes (heavier tail); larger values tame them.
    """
    if base_rate < 0:
        raise ValueError(f"base_rate must be >= 0 (got {base_rate!r})")
    if not spike_every > 0:
        raise ValueError(f"spike_every must be > 0 (got {spike_every!r})")
    if not spike_alpha > 0:
        raise ValueError(f"spike_alpha must be > 0 (got {spike_alpha!r})")
    if not spike_duration > 0:
        raise ValueError(
            f"spike_duration must be > 0 (got {spike_duration!r})")
    if not horizon > 0:
        raise ValueError(f"horizon must be > 0 (got {horizon!r})")
    rng = np.random.default_rng(seed)
    n = max(1, int(horizon / spike_every))
    starts = np.sort(rng.uniform(0.0, horizon, size=n))
    ends = starts + rng.exponential(spike_duration, size=n)
    mags = spike_mag * (1.0 + rng.pareto(spike_alpha, size=n))

    def rate(t: float) -> float:
        active = (starts <= t) & (t < ends)
        return base_rate + float(np.sum(mags[active]))

    return rate
