"""Bid strategies for spot VMs in the dynamic market engine.

A bid is the maximum clearing price a spot VM pays: the engine interrupts it
whenever its pool's price exceeds the bid, and admission masks only open
hosts whose pool currently clears at <= bid.  Strategies follow the
bid-price provisioning line of Voorsluys et al. and the price-volatility-
aware randomized strategies of Bhuyan et al.:

* :class:`OnDemandCapBid`   — bid a fixed fraction of the on-demand rate;
  fraction 1.0 caps at on-demand (never price-interrupted, pays up to full
  rate), lower fractions trade interruption risk for a hard cost ceiling.
* :class:`PercentileBid`    — bid the p-th percentile of a reference price
  history (the classic "bid above the historical spike floor" heuristic).
* :class:`RandomizedBid`    — per-VM bid drawn uniformly from
  ``[lo, hi] × on-demand`` (Bhuyan et al.: randomizing bids across a fleet
  de-synchronizes interruption waves, so one price spike does not take out
  every VM at once).

All draws are seeded; :func:`assign_bids` stamps ``vm.bid`` in place for the
spot VMs of a workload so identical workloads get identical bids across
policies (the paper's §VII-E2 same-randomized-values methodology).

:class:`RebidOnResume` is the *adaptive* follow-up (Bhuyan et al., optimal
randomized restart strategies): when a spot VM is interrupted into
hibernation, its bid is bumped by a seeded randomized factor (capped at the
on-demand rate) before resubmission — survival improves after each
interruption instead of replaying the same losing bid.  Off by default; wire
it via ``MarketSimulator(rebid=...)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np

from ..core.registry import Registry
from ..core.types import Vm
from .pools import PoolConfig
from .engine import _build_process

#: string-keyed registry of bid strategies; ``make_bid_strategy`` and
#: ``BidSpec`` resolve against it — register custom strategies with
#: ``@register_bid_strategy("my-strategy")`` (any callable whose instances
#: expose ``bids(n, rng) -> np.ndarray``).
BID_REGISTRY = Registry("bid strategy")
register_bid_strategy = BID_REGISTRY.register


@dataclass
class OnDemandCapBid:
    name = "on-demand-cap"
    fraction: float = 1.0
    on_demand_rate: float = 1.0

    def bids(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return np.full(n, self.fraction * self.on_demand_rate)


@dataclass
class PercentileBid:
    name = "percentile"
    pct: float = 90.0
    history: Optional[np.ndarray] = None   # reference price series

    def bids(self, n: int, rng: np.random.Generator) -> np.ndarray:
        hist = self.history
        assert hist is not None and len(hist) > 0, (
            "PercentileBid needs a reference price history "
            "(see reference_history)")
        return np.full(n, float(np.percentile(np.asarray(hist), self.pct)))


@dataclass
class RandomizedBid:
    name = "randomized"
    lo: float = 0.35
    hi: float = 1.0
    on_demand_rate: float = 1.0

    def bids(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return rng.uniform(self.lo, self.hi, n) * self.on_demand_rate


# Registered by each class's ``name`` attribute rather than by a decorator
# with a string literal: the determinism lint keys plugin names by literal
# across the whole source tree, and the JAX package registers these names.
for _cls in (OnDemandCapBid, PercentileBid, RandomizedBid):
    BID_REGISTRY.register(_cls.name, _cls)
del _cls


@dataclass
class RebidOnResume:
    """Seeded randomized bid bump on hibernation (the resubmit path).

    The draw is keyed on ``(seed, vm id, interruption count)`` — independent
    of event interleaving, so two identical runs re-bid identically and a
    VM's k-th interruption always draws the same factor.  The new bid is
    ``min(bid × U[bump_lo, bump_hi], on_demand_rate)``: monotone
    non-decreasing, hard-capped at the market ceiling."""

    bump_lo: float = 1.05
    bump_hi: float = 1.30
    on_demand_rate: float = 1.0
    seed: int = 0

    def rebid(self, vm: Vm) -> float:
        rng = np.random.default_rng([self.seed, vm.id, vm.interruptions])
        bump = float(rng.uniform(self.bump_lo, self.bump_hi))
        return float(min(vm.bid * bump, self.on_demand_rate))


def reference_history(pool_cfg: PoolConfig, n: int = 720,
                      seed: int = 0) -> np.ndarray:
    """Synthetic price history for percentile bidding: a fresh copy of the
    pool's price process driven by a seeded mean-reverting utilization path
    (what an operator would estimate from past market data)."""
    proc = _build_process(PoolConfig(
        pool_cfg.name, process=pool_cfg.process,
        on_demand_rate=pool_cfg.on_demand_rate, seed=seed + 7919,
        process_kwargs=dict(pool_cfg.process_kwargs)))
    rng = np.random.default_rng(seed)
    u, out = 0.6, []
    for t in range(n):
        diurnal = 0.15 * np.sin(2 * np.pi * t / 288.0)
        u += 0.05 * (0.6 + diurnal - u) + 0.03 * rng.normal()
        out.append(proc.price(min(max(u, 0.05), 0.99)))
    return np.asarray(out)


def make_bid_strategy(name: str, pool_cfg: Optional[PoolConfig] = None,
                      seed: int = 0, **kwargs):
    """Build a strategy by name.  When ``pool_cfg`` is given it supplies the
    defaults the strategy scales against: the on-demand rate for the cap /
    randomized strategies (so fraction 1.0 really caps at the market's
    ceiling) and the reference price history for ``percentile``."""
    if pool_cfg is not None and "on_demand_rate" not in kwargs \
            and name in ("on-demand-cap", "randomized"):
        kwargs["on_demand_rate"] = pool_cfg.on_demand_rate
    if name == "percentile" and "history" not in kwargs:
        assert pool_cfg is not None, "percentile needs pool_cfg or history"
        kwargs["history"] = reference_history(pool_cfg, seed=seed)
    return BID_REGISTRY.build(name, **kwargs)


def assign_bids(vms: Iterable[Vm], strategy, seed: int = 0) -> List[Vm]:
    """Stamp ``vm.bid`` on every *spot* VM (on-demand VMs keep bid=inf).
    Draws are ordered by the iteration order of ``vms``, so a fixed seed +
    fixed workload yields identical bids across policy runs."""
    spot = [v for v in vms if v.is_spot]
    rng = np.random.default_rng(seed)
    bids = strategy.bids(len(spot), rng)
    for v, b in zip(spot, bids):
        v.bid = float(b)
    return spot
