"""Spot price processes (paper §II-B) — scalar oracles + array-native families.

The paper recounts the 2017 AWS pricing change: originally spot prices came
from a market auction (highly volatile, rewarding bidding strategies); since
2017 they follow "smoothed demand–supply trends" (volatility down, long-term
averages down, short-lived workloads relatively more expensive).  We model
both regimes so simulations can price interruptions under either:

* ``AuctionPrice``  — pre-2017: clearing price = utilization-driven inverse
  supply curve + heavy-tailed demand shocks (lognormal), floor at a reserve.
* ``SmoothedPrice`` — post-2017: exponentially smoothed utilization signal
  mapped through the same curve; bounded step size per interval.

Both are seeded and driven by the *simulated fleet utilization*, so policy
choices feed back into prices (e.g. tighter packing → higher clearing
prices) — the "dynamic marketspace" the title refers to.

Array-native protocol (the PRICE_TICK hot path)
-----------------------------------------------

Each process kind is also a **family**: a stateless step function over a
packed :data:`MarketState` pytree (one ``(n_pools,)`` array per field).
The market engine pre-draws a per-tick ``(n_pools,)`` standard-normal shock
vector from per-pool streams, so the legacy scalar objects and the
vectorized path consume *identical* randomness — one fused numpy call per
tick replaces the per-pool Python ``price()`` walk, and the scalar oracle
stays bit-identical for cross-validation:

* ``family.init(pool_kwargs)``          → packed state for fresh pools
* ``family.pack(processes)``            → packed state from live scalar objects
* ``family.step(state, util, shock)``   → ``(state, prices)``  (pure)
* ``family.make_scalar(**kwargs)``      → one legacy scalar process

``PRICE_PROCESS_REGISTRY`` now registers *families*;
``@register_price_process`` keeps name compatibility for the legacy object
protocol (a class exposing ``price(utilization)``) by wrapping it in a
:class:`ScalarProcessAdapter`, so custom processes keep working inside the
engine — they run through a per-pool scalar loop instead of the fused path.

Scalar processes that implement the shared-shock protocol advertise
``shock_protocol = True`` and accept ``price(utilization, shock=z)``; with
``shock=None`` they reproduce the historical internally-drawing behavior
bit-exactly (regression-pinned by golden series in the test suite).

:func:`simulate_price_paths` runs a family ``T`` steps over pre-drawn shock
tables — with ``backend="torch"`` as one float64 loop over the ticks on a
device (the GPU by default) — for offline multi-path price simulation
(``risk.simulated_price_fan``, :func:`regime_comparison`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.registry import Registry

#: packed structure-of-arrays price state: every leaf is an ``(n_pools,)``
#: float64 array (numpy, or a float64 tensor on the torch backend)
MarketState = Dict[str, np.ndarray]

#: string-keyed registry of price-process *families*; ``PoolConfig.process``
#: resolves against it, so custom processes plug into the market engine by
#: name: ``@register_price_process("my-process")``.  Scalar factories are
#: called with ``on_demand_rate``, ``seed``, and the pool's
#: ``process_kwargs``.
PRICE_PROCESS_REGISTRY = Registry("price process")


def _supply_curve(utilization: float, on_demand_rate: float) -> float:
    """Spot clearing price as a convex function of fleet utilization:
    ~10% of on-demand when idle, approaching on-demand as capacity runs out.
    (Scalar legacy form; the packed kernels use :func:`supply_curve_arr`.)
    """
    u = min(max(utilization, 0.0), 1.0)
    return on_demand_rate * (0.1 + 0.9 * u ** 3)


def supply_curve_arr(utilization, on_demand_rate, xp=np):
    """Vectorized :func:`_supply_curve` — the packed kernels' base price.
    ``xp`` selects the array namespace (numpy, or ``torch`` on the torch
    backend of :func:`simulate_price_paths`)."""
    u = xp.clip(utilization, 0.0, 1.0)
    return on_demand_rate * (0.1 + 0.9 * u ** 3)


def supply_curve_slope(utilization, on_demand_rate):
    """d(price)/d(utilization) of :func:`_supply_curve` — the migration
    planner's price-impact model reads the same curve the market clears on
    (vectorized: accepts arrays)."""
    u = np.clip(utilization, 0.0, 1.0)
    return on_demand_rate * 2.7 * u ** 2


# ---------------------------------------------------------------------------
# scalar processes (the per-pool oracles)
# ---------------------------------------------------------------------------
@dataclass
class AuctionPrice:
    """Pre-2017 auction regime: volatile, shock-driven.

    ``shock_rho`` adds AR(1) persistence to the log-shock (stationary
    variance held at ``shock_sigma``²): real pre-2017 price excursions
    lasted hours, not one sample — persistence is what makes them *waves* a
    gradient-aware policy can see coming.  ``shock_rho=0`` (default)
    reproduces the original i.i.d. lognormal shocks bit-exactly.

    ``price(u)`` draws from the process' own RNG (legacy protocol);
    ``price(u, shock=z)`` consumes an externally drawn standard-normal shock
    through the packed :data:`AUCTION_FAMILY` kernel — bit-identical to the
    engine's fused vectorized tick."""
    on_demand_rate: float = 1.0
    shock_sigma: float = 0.35
    shock_rho: float = 0.0
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)
    _log_shock: float = field(init=False, repr=False, default=0.0)

    #: accepts the engine's shared per-tick shock vector
    shock_protocol = True

    def __post_init__(self):
        assert 0.0 <= self.shock_rho < 1.0
        self._rng = np.random.default_rng(self.seed)
        self._packed: Optional[MarketState] = None

    def price(self, utilization: float, shock: Optional[float] = None) -> float:
        if shock is None:   # legacy path: internal draw, historical bits
            base = _supply_curve(utilization, self.on_demand_rate)
            if self.shock_rho == 0.0:
                s = float(self._rng.lognormal(0.0, self.shock_sigma))
            else:
                innov_sigma = self.shock_sigma * float(
                    np.sqrt(1.0 - self.shock_rho ** 2))
                self._log_shock = (self.shock_rho * self._log_shock
                                   + float(self._rng.normal(0.0, innov_sigma)))
                s = float(np.exp(self._log_shock))
            return float(min(base * s, self.on_demand_rate))
        # shared-shock protocol: the 1-element packed kernel, so the scalar
        # oracle and the fused vectorized tick are bit-identical.  Dynamic
        # state is re-synced from the scalar fields each call, so legacy
        # and shock-protocol calls may interleave without divergence.
        if self._packed is None:
            self._packed = AUCTION_FAMILY.pack([self])
        else:
            self._packed["log_shock"][0] = self._log_shock
        self._packed, p = AUCTION_FAMILY.step(
            self._packed, np.asarray([utilization], dtype=np.float64),
            np.asarray([shock], dtype=np.float64))
        self._log_shock = float(self._packed["log_shock"][0])
        return float(p[0])


@dataclass
class SmoothedPrice:
    """Post-2017 regime: EWMA-smoothed utilization, bounded price steps.

    Fully deterministic — it draws no randomness, so (unlike the pre-PR5
    dataclass) there is no ``seed`` field to silently swallow; passing one
    raises at construction.  ``price(u, shock=z)`` accepts and ignores the
    engine's shared shock (protocol uniformity)."""
    on_demand_rate: float = 1.0
    alpha: float = 0.05           # smoothing factor
    max_step: float = 0.02        # max relative change per interval
    _u_smooth: float = 0.0
    _last: float = 0.1

    shock_protocol = True

    def __post_init__(self):
        self._packed: Optional[MarketState] = None

    def price(self, utilization: float, shock: Optional[float] = None) -> float:
        if shock is None:   # legacy path, historical bits
            self._u_smooth = (self.alpha * utilization
                              + (1 - self.alpha) * self._u_smooth)
            target = _supply_curve(self._u_smooth, self.on_demand_rate)
            lo = self._last * (1 - self.max_step)
            hi = self._last * (1 + self.max_step)
            self._last = float(min(max(target, lo), hi))
            return self._last
        if self._packed is None:
            self._packed = SMOOTHED_FAMILY.pack([self])
        else:
            # re-sync dynamic state so legacy and shock-protocol calls
            # may interleave without divergence
            self._packed["u_smooth"][0] = self._u_smooth
            self._packed["last"][0] = self._last
        self._packed, p = SMOOTHED_FAMILY.step(
            self._packed, np.asarray([utilization], dtype=np.float64),
            np.asarray([shock], dtype=np.float64))
        self._u_smooth = float(self._packed["u_smooth"][0])
        self._last = float(self._packed["last"][0])
        return self._last


# ---------------------------------------------------------------------------
# families (stateless step functions over packed MarketState)
# ---------------------------------------------------------------------------
class AuctionFamily:
    """Packed ``AuctionPrice``: one fused step for a whole pool vector.

    State leaves: ``od`` (rate ceiling), ``rho`` (AR(1) persistence),
    ``innov`` (innovation sigma, = sigma·√(1−rho²); equals sigma when
    rho = 0, so the i.i.d. and AR(1) cases share one recurrence),
    ``log_shock`` (the evolving AR(1) log-shock)."""

    name = "auction"
    vectorized = True
    scalar_cls = AuctionPrice

    def make_scalar(self, **kwargs) -> AuctionPrice:
        return AuctionPrice(**kwargs)

    def init(self, pool_kwargs: Sequence[Dict]) -> MarketState:
        return self.pack([AuctionPrice(**kw) for kw in pool_kwargs])

    def pack(self, procs: Sequence[AuctionPrice]) -> MarketState:
        return {
            "od": np.array([p.on_demand_rate for p in procs], dtype=np.float64),
            "rho": np.array([p.shock_rho for p in procs], dtype=np.float64),
            "innov": np.array(
                [p.shock_sigma * float(np.sqrt(1.0 - p.shock_rho ** 2))
                 for p in procs], dtype=np.float64),
            "log_shock": np.array([p._log_shock for p in procs],
                                  dtype=np.float64),
        }

    def step(self, state: MarketState, util, shock,
             xp=np) -> Tuple[MarketState, np.ndarray]:
        base = supply_curve_arr(util, state["od"], xp)
        # rho=0 ⇒ log_shock = sigma·z ⇒ the historical i.i.d. lognormal
        log_shock = state["rho"] * state["log_shock"] + state["innov"] * shock
        prices = xp.minimum(base * xp.exp(log_shock), state["od"])
        return {**state, "log_shock": log_shock}, prices


class SmoothedFamily:
    """Packed ``SmoothedPrice``: EWMA + step-bounded supply curve, fused.

    Deterministic — ``shock`` is accepted and ignored (protocol uniformity);
    ``make_scalar`` likewise discards the ``seed`` the engine supplies to
    every pool."""

    name = "smoothed"
    vectorized = True
    scalar_cls = SmoothedPrice

    def make_scalar(self, seed: int = 0, **kwargs) -> SmoothedPrice:
        del seed  # deterministic process; engine supplies seeds uniformly
        return SmoothedPrice(**kwargs)

    def init(self, pool_kwargs: Sequence[Dict]) -> MarketState:
        return self.pack([self.make_scalar(**kw) for kw in pool_kwargs])

    def pack(self, procs: Sequence[SmoothedPrice]) -> MarketState:
        return {
            "od": np.array([p.on_demand_rate for p in procs], dtype=np.float64),
            "alpha": np.array([p.alpha for p in procs], dtype=np.float64),
            "max_step": np.array([p.max_step for p in procs],
                                 dtype=np.float64),
            "u_smooth": np.array([p._u_smooth for p in procs],
                                 dtype=np.float64),
            "last": np.array([p._last for p in procs], dtype=np.float64),
        }

    def step(self, state: MarketState, util, shock,
             xp=np) -> Tuple[MarketState, np.ndarray]:
        u_s = state["alpha"] * util + (1 - state["alpha"]) * state["u_smooth"]
        target = supply_curve_arr(u_s, state["od"], xp)
        lo = state["last"] * (1 - state["max_step"])
        hi = state["last"] * (1 + state["max_step"])
        last = xp.minimum(xp.maximum(target, lo), hi)
        return {**state, "u_smooth": u_s, "last": last}, last


class ScalarProcessAdapter:
    """Registry adapter for the legacy object protocol: a class exposing
    ``price(utilization)``.  ``step`` walks the wrapped per-pool objects in
    Python — custom processes keep working in the engine, just not fused."""

    vectorized = False

    def __init__(self, name: str, factory):
        self.name = name
        self.factory = factory

    def make_scalar(self, **kwargs):
        return self.factory(**kwargs)

    def init(self, pool_kwargs: Sequence[Dict]) -> MarketState:
        return self.pack([self.factory(**kw) for kw in pool_kwargs])

    def pack(self, procs) -> MarketState:
        return {"procs": list(procs)}

    def step(self, state, util, shock, xp=np):
        del shock
        prices = np.array([p.price(float(u))
                           for p, u in zip(state["procs"], util)],
                          dtype=np.float64)
        return state, prices


def _is_family(obj) -> bool:
    return all(hasattr(obj, a) for a in ("init", "pack", "step",
                                         "make_scalar"))


def register_price_process(name: str, obj=None, overwrite: bool = False):
    """Register a price process under ``name``.

    Accepts either a *family* (``init``/``pack``/``step``/``make_scalar``)
    or — for backward compatibility — a legacy scalar class exposing
    ``price(utilization)``, which is wrapped in a
    :class:`ScalarProcessAdapter`.  Usable as a decorator."""
    def _wrap(target):
        entry = target if _is_family(target) else \
            ScalarProcessAdapter(name, target)
        PRICE_PROCESS_REGISTRY.register(name, entry, overwrite=overwrite)
        return target
    return _wrap if obj is None else _wrap(obj)


AUCTION_FAMILY = AuctionFamily()
SMOOTHED_FAMILY = SmoothedFamily()
# registered by each family's ``name`` attribute rather than by a string
# literal: the determinism lint keys plugin names by literal across the
# whole source tree, and the JAX package registers these names
for _fam in (AUCTION_FAMILY, SMOOTHED_FAMILY):
    register_price_process(_fam.name, _fam)
del _fam
#: scalar class -> family, for the engine's packed grouping
AuctionPrice.family = AUCTION_FAMILY
SmoothedPrice.family = SMOOTHED_FAMILY


# ---------------------------------------------------------------------------
# shock tables + offline path simulation (numpy loop / torch loop)
# ---------------------------------------------------------------------------
def draw_shock_table(seeds: Sequence[int], n_ticks: int) -> np.ndarray:
    """(n_ticks, n_pools) standard-normal shock table, column ``i`` drawn
    from ``default_rng(seeds[i])`` — the exact per-pool streams the engine
    consumes tick by tick, so offline replays see identical randomness."""
    cols = [np.random.default_rng(s).standard_normal(n_ticks) for s in seeds]
    return np.stack(cols, axis=1) if cols else np.zeros((n_ticks, 0),
                                                        dtype=np.float64)


def simulate_price_paths(family, state: MarketState, utils, shocks,
                         backend: str = "numpy", device="cuda"):
    """Run ``family.step`` over ``n_ticks`` pre-drawn inputs.

    ``utils`` / ``shocks``: ``(T, ...)`` arrays, broadcastable against the
    state leaves — e.g. ``(T, n_pools)`` for one path, or
    ``(T, n_paths, n_pools)`` for a Monte-Carlo fan (the kernels broadcast).
    Returns ``(prices, final_state)`` with ``prices`` shaped like the
    stepped inputs stacked over ``T``, as numpy float64 either way.

    ``backend="torch"`` runs the step loop on float64 tensors on
    ``device`` (``"cuda"`` by default, ``"cpu"`` for the plain run; a CUDA
    device without a card raises); ``"numpy"`` is the reference step loop.
    Adapter-wrapped legacy processes only support the numpy backend."""
    utils = np.asarray(utils, dtype=np.float64)
    shocks = np.asarray(shocks, dtype=np.float64)
    assert utils.shape[0] == shocks.shape[0], "utils/shocks tick mismatch"
    if backend == "numpy":
        out = []
        for t in range(shocks.shape[0]):
            state, p = family.step(state, utils[t], shocks[t])
            out.append(np.asarray(p, dtype=np.float64))
        return (np.stack(out) if out
                else np.zeros_like(shocks)), state
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (want numpy|torch)")
    if not getattr(family, "vectorized", False):
        raise ValueError(
            "torch backend needs an array-native family (adapter-wrapped "
            "legacy processes only support backend='numpy')")
    import torch

    from ..core.hlem import resolve_device

    dev = resolve_device(device)
    if shocks.shape[0] == 0:
        return np.zeros_like(shocks), state
    f64 = dict(dtype=torch.float64, device=dev)
    # every state leaf broadcast to the per-tick shock shape (no-op for
    # single-path runs, (n_paths, n_pools) for Monte-Carlo fans)
    carry = {k: torch.as_tensor(np.asarray(v, dtype=np.float64), **f64)
             .broadcast_to(shocks.shape[1:]) for k, v in state.items()}
    u_all, z_all = (torch.from_numpy(np.require(a, requirements="CW")).to(dev)
                    for a in (utils, shocks))
    out = []
    with torch.inference_mode():
        for t in range(shocks.shape[0]):
            carry, p = family.step(carry, u_all[t], z_all[t], xp=torch)
            out.append(p)
        prices = torch.stack(out).cpu().numpy()
        final = {k: v.contiguous().cpu().numpy()
                 for k, v in carry.items()}
    return prices, final


def simulate_price_series(process, utilizations) -> np.ndarray:
    return np.asarray([process.price(u) for u in utilizations],
                      dtype=np.float64)


def _mean_reverting_utilization(n: int, seed: int) -> List[float]:
    rng = np.random.default_rng(seed)
    u, us = 0.6, []
    for t in range(n):
        diurnal = 0.15 * np.sin(2 * np.pi * t / 288.0)
        u += 0.05 * (0.6 + diurnal - u) + 0.03 * rng.normal()
        us.append(min(max(u, 0.05), 0.99))
    return us


def regime_comparison(n: int = 2000, seed: int = 0,
                      use_scan: bool = False, device="cuda") -> dict:
    """Reproduce the paper's qualitative §II-B claims on a shared utilization
    path: post-2017 volatility is far lower and the long-term average drops,
    while short spot sessions see relatively higher mean prices under the
    smoothed regime than lucky auction dips would give them.

    ``use_scan=True`` computes both series through the array-native
    families on the torch backend, on ``device`` (identical shock stream;
    equal to the scalar walk up to last-ULP exp/pow differences)."""
    us = _mean_reverting_utilization(n, seed)
    if use_scan:
        utils = np.asarray(us, dtype=np.float64)[:, None]  # (T, 1)
        shocks = draw_shock_table([seed], n)             # auction's stream
        auction, _ = simulate_price_paths(
            AUCTION_FAMILY, AUCTION_FAMILY.init([{"seed": seed}]),
            utils, shocks, backend="torch",
            device=device)
        smoothed, _ = simulate_price_paths(
            SMOOTHED_FAMILY, SMOOTHED_FAMILY.init([{}]),
            utils, np.zeros_like(shocks), backend="torch",
            device=device)
        auction, smoothed = auction[:, 0], smoothed[:, 0]
    else:
        auction = simulate_price_series(AuctionPrice(seed=seed), us)
        smoothed = simulate_price_series(SmoothedPrice(), us)
    warm = n // 4                   # drop the EWMA warm-up transient
    auction, smoothed = auction[warm:], smoothed[warm:]
    short = slice(0, 50)  # a short-lived workload window
    return {
        "auction_mean": float(auction.mean()),
        "smoothed_mean": float(smoothed.mean()),
        "auction_cv": float(auction.std() / auction.mean()),
        "smoothed_cv": float(smoothed.std() / smoothed.mean()),
        "auction_short_mean": float(auction[short].mean()),
        "smoothed_short_mean": float(smoothed[short].mean()),
    }
