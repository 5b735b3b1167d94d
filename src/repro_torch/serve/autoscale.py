"""Autoscaler: demand signals → fleet target-capacity decisions.

Closes the serving loop around the spot-fleet manager: on a control
cadence the :class:`Autoscaler` reads :class:`DemandSignals` (arrival-rate
EWMA, queue depth, windowed latency percentile) assembled by the serve
manager, asks a registered policy for a desired unit count, and — after
hysteresis/cooldown damping — retargets the fleet through
``FleetManager.set_target_units``.  The damping is what lets the
autoscaler *compose* with the fleet's fallback ladder instead of fighting
it: the ladder replaces individual dead slots on backoff timescales, the
autoscaler moves the whole target on slower, rate-limited timescales.

Policies register by name in :data:`AUTOSCALE_REGISTRY`
(``register_autoscale_policy(name, fn)``), so ``AutoscaleSpec`` can sweep
policies by name.  A policy is a pure function
``(signals, cfg) -> desired_units`` — all pacing state (cooldown stamps)
lives in the Autoscaler, so policies stay trivially testable.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from ..core.registry import Registry, named

#: string-keyed registry of autoscale policies — pure functions
#: ``(signals: DemandSignals, cfg: AutoscaleConfig) -> int`` desired units
AUTOSCALE_REGISTRY = Registry("autoscale policy")
register_autoscale_policy = AUTOSCALE_REGISTRY.register


@dataclass(frozen=True)
class AutoscaleConfig:
    """Configuration of one autoscaler (the ``AutoscaleSpec`` payload).

    ``cadence`` paces decisions; ``hysteresis`` (minimum fractional change)
    and ``cooldown`` (minimum seconds between applied changes) damp them.
    ``headroom`` is the capacity safety factor over measured demand,
    ``queue_drain`` the target horizon (seconds) for working off queued
    backlog, ``lead`` the look-ahead of the predictive policy, and
    ``step_units``/``queue_hi``/``queue_lo`` parameterize the step policy
    (thresholds are queued requests *per live unit*)."""
    cadence: float = 300.0
    min_units: int = 1
    max_units: int = 512
    hysteresis: float = 0.1
    cooldown: float = 600.0
    headroom: float = 1.2
    ewma_alpha: float = 0.3
    latency_window: float = 1800.0
    queue_drain: float = 600.0
    lead: float = 900.0
    step_units: int = 2
    queue_hi: float = 4.0
    queue_lo: float = 0.5


def validate_autoscale_config(cfg: AutoscaleConfig) -> None:
    """Fail-fast validation (construction-time, fail-fast errors)."""
    if not cfg.cadence > 0:
        raise ValueError(
            f"autoscale cadence must be > 0 (got {cfg.cadence!r})")
    if int(cfg.min_units) < 0:
        raise ValueError(
            f"autoscale min_units must be >= 0 (got {cfg.min_units!r})")
    if int(cfg.max_units) < int(cfg.min_units):
        raise ValueError(
            f"autoscale max_units must be >= min_units "
            f"(got {cfg.max_units!r} < {cfg.min_units!r})")
    if not 0.0 <= cfg.hysteresis < 1.0:
        raise ValueError(
            f"autoscale hysteresis must be in [0, 1) (got {cfg.hysteresis!r})")
    if cfg.cooldown < 0:
        raise ValueError(
            f"autoscale cooldown must be >= 0 (got {cfg.cooldown!r})")
    if not cfg.headroom > 0:
        raise ValueError(
            f"autoscale headroom must be > 0 (got {cfg.headroom!r})")
    if not 0.0 < cfg.ewma_alpha <= 1.0:
        raise ValueError(
            f"autoscale ewma_alpha must be in (0, 1] (got {cfg.ewma_alpha!r})")
    if not cfg.latency_window > 0:
        raise ValueError(
            f"autoscale latency_window must be > 0 "
            f"(got {cfg.latency_window!r})")
    if not cfg.queue_drain > 0:
        raise ValueError(
            f"autoscale queue_drain must be > 0 (got {cfg.queue_drain!r})")
    if cfg.lead < 0:
        raise ValueError(f"autoscale lead must be >= 0 (got {cfg.lead!r})")
    if int(cfg.step_units) < 1:
        raise ValueError(
            f"autoscale step_units must be >= 1 (got {cfg.step_units!r})")
    if not cfg.queue_hi > cfg.queue_lo >= 0:
        raise ValueError(
            f"autoscale thresholds need queue_hi > queue_lo >= 0 "
            f"(got hi={cfg.queue_hi!r}, lo={cfg.queue_lo!r})")


@dataclass(frozen=True)
class DemandSignals:
    """One decision's input snapshot, assembled by the serve manager.

    ``unit_throughput`` is the requests/s one live unit sustains at the
    configured decode speed and batch width; ``rate_ahead`` is the demand
    curve evaluated ``lead`` seconds ahead (the predictive policy's input —
    the curve is *known* to the operator who deployed the workload)."""
    t: float
    rate_ewma: float          # smoothed observed arrivals (requests/s)
    queue_depth: int          # requests waiting (queued + hibernated)
    p95_latency: float        # windowed p95 latency (s); nan if no samples
    live_units: int           # serving-capable fleet VMs right now
    target_units: int         # the fleet's current unit target
    unit_throughput: float    # requests/s per unit
    rate_ahead: float         # curve(t + lead), requests/s


def _units_for_rate(rate: float, signals: DemandSignals,
                    cfg: AutoscaleConfig) -> int:
    """Units needed to sustain ``rate`` with headroom, plus enough surplus
    to drain the current backlog within ``queue_drain`` seconds."""
    per_unit = max(signals.unit_throughput, 1e-12)
    steady = (rate * cfg.headroom) / per_unit
    drain = signals.queue_depth / (per_unit * cfg.queue_drain)
    return int(math.ceil(steady + drain))


@named("static")
def _static(signals: DemandSignals, cfg: AutoscaleConfig) -> int:
    """Hold whatever the fleet was provisioned with — the fixed-capacity
    baseline the sweep compares against."""
    return signals.target_units


@named("target-tracking")
def _target_tracking(signals: DemandSignals, cfg: AutoscaleConfig) -> int:
    """Track measured demand: capacity for the arrival-rate EWMA with
    headroom, plus backlog-drain surplus."""
    return _units_for_rate(signals.rate_ewma, signals, cfg)


@named("step")
def _step(signals: DemandSignals, cfg: AutoscaleConfig) -> int:
    """Threshold stepping: queue pressure above ``queue_hi`` per unit adds
    ``step_units``; a drained queue (below ``queue_lo`` per unit) removes
    them.  No demand model — the classic ops-alarm autoscaler."""
    units = max(signals.live_units, 1)
    per_unit = signals.queue_depth / units
    if per_unit > cfg.queue_hi:
        return signals.target_units + int(cfg.step_units)
    if per_unit < cfg.queue_lo:
        return signals.target_units - int(cfg.step_units)
    return signals.target_units


@named("predictive-from-curve")
def _predictive(signals: DemandSignals, cfg: AutoscaleConfig) -> int:
    """Provision for the *known* demand curve ``lead`` seconds ahead (plus
    backlog drain) — capacity is in place before the ramp arrives, at the
    price of trusting the forecast."""
    rate = max(signals.rate_ahead, signals.rate_ewma)
    return _units_for_rate(rate, signals, cfg)


# Registered by each policy's ``name`` attribute rather than by a decorator
# with a string literal: the determinism lint keys plugin names by literal
# across the whole source tree, and the JAX package registers these names.
for _fn in (_static, _target_tracking, _step, _predictive):
    AUTOSCALE_REGISTRY.register(_fn.name, _fn)
del _fn


class Autoscaler:
    """Policy + damping state.  :meth:`decide` returns the new unit target
    when a change should be applied, else ``None``."""

    def __init__(self, policy: str, config: Optional[AutoscaleConfig] = None):
        self.policy_name = str(policy)
        self.policy = AUTOSCALE_REGISTRY.get(self.policy_name)  # fail fast
        self.config = config if config is not None else AutoscaleConfig()
        validate_autoscale_config(self.config)
        self._last_change = -float("inf")

    def decide(self, signals: DemandSignals) -> Optional[int]:
        cfg = self.config
        desired = int(self.policy(signals, cfg))
        desired = min(max(desired, int(cfg.min_units)), int(cfg.max_units))
        cur = int(signals.target_units)
        if desired == cur:
            return None
        if abs(desired - cur) / max(cur, 1) < cfg.hysteresis:
            return None
        if signals.t - self._last_change < cfg.cooldown:
            return None
        self._last_change = signals.t
        return desired


def make_autoscaler(policy: str,
                    config: Optional[AutoscaleConfig] = None,
                    **kwargs) -> Autoscaler:
    """Build an autoscaler from a config (or config kwargs); unknown policy
    names fail fast with the known list, in the registries' style."""
    cfg = config if config is not None else AutoscaleConfig(**kwargs)
    return Autoscaler(policy, cfg)
