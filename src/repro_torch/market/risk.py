"""Pool-level risk signals for proactive spot migration.

Two consumers:

* The :class:`repro.market.migration.MigrationPlanner` projects near-future
  clearing prices from the engine's tick history via
  :func:`projected_prices` (Voorsluys & Buyya: acting ahead of a price
  spike dominates purely reactive fault tolerance).
  :func:`price_gradients`, :func:`price_volatility`, and
  :func:`bid_crossing_risk` expose the underlying signals for risk-aware
  extensions (e.g. a probabilistic danger trigger, or risk-aware admission
  — see the ROADMAP follow-up).
* :func:`advisor_pool_volatility` derives per-pool price-process volatility
  from the synthetic Spot-Instance-Advisor dataset (§VII-F interruption-
  frequency bands), so ``pools.make_market`` regimes can be grounded in the
  advisor data instead of hand-set constants.

Everything here is a dense vectorized computation over the engine's price
history — these functions run inside the PRICE_TICK hot path.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .advisor import FREQ_BANDS, generate_advisor_dataset

# ---------------------------------------------------------------------------
# price history signals (engine = repro.market.engine.MarketEngine)
# ---------------------------------------------------------------------------


def recent_prices(engine, window: int) -> np.ndarray:
    """(n_pools, k) matrix of the last ``k <= window`` tick prices (k >= 1;
    a single zero column before the first tick).  A read-only view into the
    engine's packed price-history arrays — no per-call copy."""
    n = engine.n_ticks
    if n == 0:
        return np.zeros((engine.n_pools, 1))
    k = min(window, n)
    return engine.price_history()[:, n - k:]


def _price_fit(engine, window: int):
    """Shared least-squares machinery: (slopes, window means, centered-time
    offset of the last tick).  Slopes are zero before two ticks exist."""
    ts = engine.tick_times()
    k = min(window, ts.size)
    if k < 2:
        p = recent_prices(engine, max(k, 1))
        return np.zeros(engine.n_pools), p.mean(axis=1), 0.0
    t = ts[-k:]
    p = recent_prices(engine, k)                 # (n_pools, k)
    t_mean = t.mean()
    tc = t - t_mean
    var = float(np.dot(tc, tc))
    means = p.mean(axis=1)
    if var <= 0.0:
        return np.zeros(engine.n_pools), means, 0.0
    slopes = (p - means[:, None]) @ tc / var
    return slopes, means, float(ts[-1] - t_mean)


def price_gradients(engine, window: int = 5) -> np.ndarray:
    """(n_pools,) least-squares slope (price per second) of each pool's
    clearing price over the last ``window`` ticks — one vectorized solve
    across all pools.  Zero before two ticks exist."""
    return _price_fit(engine, window)[0]


def price_volatility(engine, window: int = 12) -> np.ndarray:
    """(n_pools,) standard deviation of the last ``window`` tick prices —
    the planner's noise scale for bid-crossing risk."""
    return recent_prices(engine, window).std(axis=1)


def projected_prices(engine, lead: float, window: int = 5) -> np.ndarray:
    """(n_pools,) clearing prices ``lead`` seconds past the last tick, read
    off each pool's least-squares regression line (value *and* slope from
    the fit — evaluating the line rather than extrapolating from the last
    sample filters the heavy-tailed per-tick shock the auction regime
    draws), clipped to [0, on-demand rate]."""
    slopes, means, dt_last = _price_fit(engine, window)
    proj = means + slopes * (dt_last + lead)
    return np.clip(proj, 0.0, engine.od_rates)


def bid_crossing_risk(projected: np.ndarray, sigma: np.ndarray,
                      bids: np.ndarray, pools: np.ndarray) -> np.ndarray:
    """Per-VM probability-like score that the VM's pool price crosses its bid
    around the projection point: a logistic squash of
    ``(projected_price - bid) / sigma``.  Vectorized over the registry
    (``bids``/``pools`` are per-VM, ``projected``/``sigma`` per-pool)."""
    s = np.maximum(sigma[pools], 1e-6)
    z = (projected[pools] - bids) / s
    return 1.0 / (1.0 + np.exp(-np.clip(z, -30.0, 30.0)))


def simulated_price_fan(engine, n_ticks: int, n_paths: int = 64,
                        seed: int = 0, quantiles=(0.1, 0.5, 0.9),
                        util=None, backend: str = "numpy",
                        device="cuda") -> np.ndarray:
    """Monte-Carlo price fan: simulate ``n_paths`` shock trajectories
    ``n_ticks`` forward from the engine's *current* packed price state and
    return per-pool price quantiles — a distributional complement to the
    point projection of :func:`projected_prices`.

    Returns ``(len(quantiles), n_ticks, n_pools)``.  The demand signal is
    held at ``util`` (default: the engine's last observed pool utilization);
    shocks are drawn from a fresh ``default_rng(seed)`` (the engine's own
    streams are not disturbed).  ``backend="torch"`` runs each family's
    simulation as one float64 loop on ``device`` (see
    :func:`~repro_torch.market.price_process.simulate_price_paths`); the
    quantiles are taken on the host either way.  Pools of adapter-wrapped
    legacy processes are excluded from the fan (their column holds the
    last clearing price — their draws are private to the live objects).
    """
    from .price_process import simulate_price_paths

    assert n_ticks >= 1 and n_paths >= 1
    util = np.asarray(engine.last_util if util is None else util,
                      dtype=np.float64)
    rng = np.random.default_rng(seed)
    paths = np.broadcast_to(
        engine.prices[None, None, :],
        (n_ticks, n_paths, engine.n_pools)).copy()
    for fam, idx, state in engine.price_state():
        if not getattr(fam, "vectorized", False):
            continue
        shocks = rng.standard_normal((n_ticks, n_paths, idx.size))
        prices, _ = simulate_price_paths(
            fam, state, np.broadcast_to(util[idx], (n_ticks, idx.size)),
            shocks, backend=backend, device=device)
        paths[:, :, idx] = prices
    return np.quantile(paths, np.asarray(quantiles), axis=1)


# ---------------------------------------------------------------------------
# Spot-Advisor interruption-frequency bands -> pool volatility
# ---------------------------------------------------------------------------

#: midpoint interruption frequency of each advisor band (the ">20%" band is
#: open-ended; 0.25 is the conventional working point)
BAND_RATES: Dict[str, float] = {
    "<5%": 0.025, "5-10%": 0.075, "10-15%": 0.125, "15-20%": 0.175,
    ">20%": 0.25,
}
assert set(BAND_RATES) == set(FREQ_BANDS), "advisor band set drifted"

#: calibration anchors mapping mean interruption frequency to the price
#: process' shock sigma: the calmest band maps near the smoothed-regime
#: noise floor, the most volatile band past the volatile preset's 0.45
_FREQ_ANCHORS = (0.025, 0.25)
_SIGMA_ANCHORS = (0.12, 0.60)


def frequency_to_sigma(freq: np.ndarray) -> np.ndarray:
    """Map mean interruption frequency (0..1) to a price-process shock sigma
    by linear interpolation between the calibration anchors."""
    return np.interp(np.asarray(freq, dtype=np.float64),
                     _FREQ_ANCHORS, _SIGMA_ANCHORS)


def advisor_pool_volatility(n_pools: int, seed: int = 0,
                            n_rows: int = 1200) -> np.ndarray:
    """(n_pools,) per-pool shock sigmas derived from the synthetic advisor
    dataset.

    The paper's §VII-F association analysis finds *instance family* among
    the strongest predictors of interruption frequency, so a capacity pool
    (one instance class) inherits its families' volatility: families are
    ranked by their mean interruption-band frequency and partitioned into
    ``n_pools`` contiguous groups — pool 0 gets the calmest families, pool
    ``n_pools-1`` the spikiest — then each pool's mean frequency maps
    through :func:`frequency_to_sigma`.  This preserves the heterogeneity
    the advisor data actually shows (round-robin mixing would average it
    away).  Fully seeded — identical across runs."""
    assert n_pools >= 1
    data = generate_advisor_dataset(n_rows=n_rows, seed=seed)
    rates = np.array([BAND_RATES[b] for b in data["interruption_band"]])
    fam_rate: Dict[str, list] = {}
    for f, r in zip(data["family"], rates):
        fam_rate.setdefault(f, []).append(r)
    # rank families calm -> spiky (name tiebreak keeps this deterministic)
    ranked = sorted(fam_rate, key=lambda f: (float(np.mean(fam_rate[f])), f))
    groups = np.array_split(np.arange(len(ranked)), n_pools)
    fam_pool = {ranked[i]: p for p, g in enumerate(groups) for i in g}
    pools = np.array([fam_pool[f] for f in data["family"]], dtype=np.int64)
    sums = np.bincount(pools, weights=rates, minlength=n_pools)
    counts = np.bincount(pools, minlength=n_pools)
    overall = rates.mean()
    mean_rate = np.where(counts > 0, sums / np.maximum(counts, 1), overall)
    return frequency_to_sigma(mean_rate)
