"""Capacity-pool and market-regime configuration for the dynamic market
engine (paper §II-B spot marketspaces; Voorsluys et al. bid-price
provisioning).

A *capacity pool* models one (region, instance-class) spot market: it owns a
price process (``AuctionPrice`` pre-2017 / ``SmoothedPrice`` post-2017) that
clears against the pool's live utilization.  A :class:`MarketConfig` bundles
the pools with the engine's tick interval and an optional cross-pool demand
correlation (a shared utilization shock, so prices of correlated pools spike
together — the "correlated multi-pool" regime of the market-risk analysis).

:func:`make_market` builds the three standard regimes benchmarked in
``launch/market_sim.py --market``:

* ``calm``       — smoothed processes, no shocks: post-2017-style stability.
* ``volatile``   — auction processes with heavy-tailed shocks per pool.
* ``correlated`` — volatile pools driven by a shared demand shock on top of
  their own: diversification across pools stops helping.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

REGIMES = ("calm", "volatile", "correlated")


@dataclass
class PoolConfig:
    """One spot capacity pool (region / instance class)."""

    name: str
    process: str = "smoothed"            # "auction" | "smoothed"
    on_demand_rate: float = 1.0          # price ceiling; prices are fractions
    seed: int = 0
    process_kwargs: Dict[str, float] = field(default_factory=dict)


@dataclass
class MarketConfig:
    pools: List[PoolConfig]
    tick_interval: float = 60.0
    #: weight of the shared demand shock mixed into every pool's utilization
    #: signal (0 = independent pools); drives the correlated regime
    correlation: float = 0.0
    #: std-dev of the shared shock (only used when correlation > 0)
    shock_sigma: float = 0.15
    #: AR(1) persistence of the shared shock: market-wide demand squeezes
    #: span several ticks (0 = the original i.i.d. redraw per tick)
    shock_rho: float = 0.75
    seed: int = 0
    #: fused array-native price tick (default) vs the per-pool scalar
    #: oracle walk — both consume identical shocks and kernels, so full
    #: runs are bit-identical (the oracle exists for cross-validation)
    vectorized: bool = True


def make_market(regime: str, n_pools: int = 2, seed: int = 0,
                tick_interval: float = 60.0,
                on_demand_rate: float = 1.0,
                pool_volatility: Optional[Sequence[float]] = None,
                from_advisor: bool = False) -> MarketConfig:
    """Build a :class:`MarketConfig` for one of the standard regimes.

    Per-pool volatility defaults to the regime's hand-set constant; pass
    ``pool_volatility`` (one sigma per pool) to override it, or set
    ``from_advisor=True`` to derive it from the synthetic Spot-Instance-
    Advisor dataset's interruption-frequency bands
    (:func:`repro.market.risk.advisor_pool_volatility`, same ``seed``) —
    pools inherit the volatility their instance families exhibit in the
    advisor data instead of all sharing one constant."""
    assert regime in REGIMES, f"unknown regime {regime!r} (want {REGIMES})"
    if from_advisor:
        assert pool_volatility is None, (
            "pass either pool_volatility or from_advisor, not both")
        from .risk import advisor_pool_volatility
        pool_volatility = advisor_pool_volatility(n_pools, seed=seed)
    if pool_volatility is not None:
        assert len(pool_volatility) == n_pools, (
            f"pool_volatility needs one entry per pool "
            f"({len(pool_volatility)} != {n_pools})")
    if regime == "calm":
        # smoothed processes: volatility bounds the per-tick step size
        # (the hand-set 0.05 corresponds to the volatile sigma scale / 9)
        def calm_kwargs(i: int) -> Dict[str, float]:
            if pool_volatility is None:
                return {"alpha": 0.2, "max_step": 0.05}
            return {"alpha": 0.2, "max_step": float(pool_volatility[i]) / 9.0}

        pools = [PoolConfig(f"pool{i}", process="smoothed",
                            on_demand_rate=on_demand_rate, seed=seed + i,
                            process_kwargs=calm_kwargs(i))
                 for i in range(n_pools)]
        return MarketConfig(pools, tick_interval=tick_interval, seed=seed)
    # persistent shocks (AR(1) log-shock): pre-2017 price excursions spanned
    # many samples — waves build and decay over several ticks
    pools = [PoolConfig(f"pool{i}", process="auction",
                        on_demand_rate=on_demand_rate, seed=seed + i,
                        process_kwargs={"shock_sigma": 0.45
                                        if pool_volatility is None
                                        else float(pool_volatility[i]),
                                        "shock_rho": 0.75})
             for i in range(n_pools)]
    corr = 0.8 if regime == "correlated" else 0.0
    return MarketConfig(pools, tick_interval=tick_interval,
                        correlation=corr, shock_sigma=0.2, seed=seed)
