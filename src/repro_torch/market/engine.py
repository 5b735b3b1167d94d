"""Dynamic market engine: price-clearing over multi-pool spot markets.

This is the layer the paper's title promises — a *marketspace* where spot
prices move with supply/demand and trigger interruption, hibernation, and
reallocation — wired into :class:`repro.core.MarketSimulator` through
periodic PRICE_TICK events:

1. Each tick, every capacity pool's clearing price advances one step of its
   price process (``AuctionPrice`` / ``SmoothedPrice``, §II-B) fed with the
   pool's *live* CPU utilization (one ``bincount`` over the host arrays),
   optionally mixed with a shared demand shock (correlated-pool regime).
   Policy choices feed back into prices: tighter packing → higher clearing
   prices.
2. Prices are pushed into the host pool (``set_pool_prices``): feasibility
   masks then require ``pool price <= vm.bid`` for spot admission, and price
   *drops* re-open queued spot VMs via the gain-log memo.
3. The simulator asks for the *interruption wave*: one masked comparison
   over the pool's dense spot registry (``market_victims``) selects every
   resident spot VM whose bid the new price crossed; victims route through
   the ordinary TERMINATE/HIBERNATE/resubmit lifecycle, so a hibernated
   victim can reallocate into a cheaper pool at a later flush.

Array-native tick: the engine pre-draws each pool's per-tick
standard-normal shock from per-pool streams (block-buffered, stream-exact)
and advances all pools of a process family in **one fused step call** over a
packed :data:`~repro.market.price_process.MarketState`
(``family.step(state, util_vec, shock_vec)``).  The per-pool scalar walk is
retained as the cross-validation oracle (``use_vectorized = False``, or
``MarketConfig.vectorized=False``): both paths consume the identical shock
vector and the identical kernels, so full-simulation metrics are
bit-identical — regression-tested in ``tests/market/test_price_vectorized``.

Price history lives in preallocated arrays (``tick_times()`` /
``price_history()`` views), so realized spot cost is a vectorized
``searchsorted`` + segment-sum: :meth:`MarketEngine.price_integrals` bills
an entire fleet of ``(pool, t0, t1, bid-cap)`` spans in one call (see
:func:`repro.market.pricing.realized_cost_stats`); the scalar
:meth:`price_integral` delegates to it, and the historical per-segment
``bisect`` walk survives as :func:`price_integral_ref` for the tests and
benchmarks.

Engines are stateful (seeded shock streams, price history) — use a fresh
engine per simulation run.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np

from .pools import MarketConfig, PoolConfig
from .price_process import (
    PRICE_PROCESS_REGISTRY,
    MarketState,
    ScalarProcessAdapter,
)
from ..obs.eventlog import NULL_RECORDER
from ..obs.tracer import NULL_TRACER

#: per-pool shock streams are drawn in blocks of this many ticks (one
#: ``standard_normal(block)`` call per pool per block — stream-identical to
#: per-tick scalar draws, amortizing the per-pool Python call overhead)
_SHOCK_BLOCK = 64

#: flat-element chunk of the batched capped-integral gather: bounds the
#: per-chunk scratch (a handful of `chunk`-sized temporaries) while keeping
#: numpy call overhead amortized at trace-scale batch sizes
_INTEGRAL_CHUNK_ELEMS = 1 << 20


def _build_process(cfg: PoolConfig):
    """Build the pool's *scalar* price process by name against
    :data:`~repro.market.price_process.PRICE_PROCESS_REGISTRY` (fails fast
    with the known names on a typo)."""
    return PRICE_PROCESS_REGISTRY.get(cfg.process).make_scalar(
        on_demand_rate=cfg.on_demand_rate, seed=cfg.seed,
        **dict(cfg.process_kwargs))


class MarketEngine:
    """Multi-pool price clearing + vectorized interruption waves."""

    def __init__(self, config: MarketConfig):
        self.config = config
        #: telemetry hooks (``repro.obs``); the build layer swaps in the
        #: live tracer / event recorder, instrumentation guards on
        #: ``tracer.enabled`` / ``events.enabled``
        self.tracer = NULL_TRACER
        self.events = NULL_RECORDER
        self.n_pools = len(config.pools)
        assert self.n_pools >= 1, "market needs at least one pool"
        self.tick_interval = float(config.tick_interval)
        self.processes = [_build_process(p) for p in config.pools]
        self.od_rates = np.array([p.on_demand_rate for p in config.pools],
                                 dtype=np.float64)
        self._rng = np.random.default_rng(config.seed)
        #: per-pool shock streams (identical seeds to the scalar processes,
        #: so oracle and vectorized paths consume the same randomness)
        self._pool_rngs = [np.random.default_rng(p.seed)
                           for p in config.pools]
        self._shock_block = np.zeros((0, self.n_pools), dtype=np.float64)
        self._shock_pos = 0
        #: fused family step (default) vs per-pool scalar oracle walk
        self.use_vectorized = bool(getattr(config, "vectorized", True))
        #: packed (family, pool-index, state) groups; built lazily at the
        #: first tick so tests may swap ``self.processes`` beforehand
        self._groups: Optional[List[list]] = None
        #: AR(1) state of the shared demand shock (correlated regime):
        #: market-wide squeezes build and decay over several ticks instead
        #: of redrawing independently each tick
        self._shared_shock = 0.0
        self.prices = np.zeros(self.n_pools, dtype=np.float64)
        #: last pool-utilization vector fed to the processes (risk fans
        #: project forward holding this demand signal)
        self.last_util = np.zeros(self.n_pools, dtype=np.float64)
        # piecewise-constant price history, preallocated: at tick k (time
        # tick_times()[k]) pool i clears at price_history()[i, k];
        # _cum_buf[i, k] = ∫_0^{ts[k]} price_i dt
        self._hist_cap = 256
        self._ts_buf = np.zeros(self._hist_cap, dtype=np.float64)
        self._ph_buf = np.zeros((self.n_pools, self._hist_cap), dtype=np.float64)
        self._cum_buf = np.zeros((self.n_pools, self._hist_cap), dtype=np.float64)
        self._n_ticks = 0

    # -------------------------------------------------------- packed groups
    def _build_groups(self) -> None:
        """Group ``self.processes`` by family and pack each group's state.
        Processes without an attached family (custom legacy processes,
        scripted test stubs) fall into per-group scalar-walk adapters."""
        order: List[Tuple[object, List[int]]] = []
        by_key = {}
        for i, proc in enumerate(self.processes):
            fam = getattr(type(proc), "family", None)
            if fam is not None:
                cls = getattr(fam, "scalar_cls", None)
                if (not getattr(fam, "vectorized", False)
                        or (cls is not None and type(proc) is not cls)):
                    # subclasses inherit the `family` attribute but may
                    # override price() — only the exact scalar class is
                    # guaranteed to match the packed kernel; anything else
                    # walks scalar so overrides are honored
                    fam = None
            key = id(fam) if fam is not None else None
            if key in by_key:
                by_key[key][1].append(i)
            else:
                ent = (fam, [i])
                by_key[key] = ent
                order.append(ent)
        self._groups = []
        for fam, idx in order:
            procs = [self.processes[i] for i in idx]
            if fam is None:
                # reuse the registry's legacy-protocol adapter as the
                # fallback walk (factory unused — the group wraps the
                # already-built live objects)
                fam = ScalarProcessAdapter("scalar-walk", None)
            state = fam.pack(procs)
            self._groups.append([fam, np.asarray(idx, dtype=np.int64),
                                 state])

    def price_state(self):
        """Snapshot of the packed per-family price state:
        ``[(family, pool_indices, state), ...]`` with copied leaves — the
        input for offline projections (``risk.simulated_price_fan``)."""
        if self._groups is None or not self.use_vectorized:
            # scalar-oracle mode evolves the per-pool objects, not the
            # packed group state — re-pack from the live processes so the
            # snapshot reflects the current tick in either mode
            self._build_groups()
        out = []
        for fam, idx, state in self._groups:
            leaves = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                      for k, v in state.items()}
            out.append((fam, idx.copy(), leaves))
        return out

    # ------------------------------------------------------------------ tick
    def _draw_shocks(self) -> np.ndarray:
        """(n_pools,) standard-normal shock vector, one per pool per tick,
        from the per-pool streams (block-buffered; stream-exact)."""
        if self._shock_pos >= self._shock_block.shape[0]:
            self._shock_block = np.stack(
                [g.standard_normal(_SHOCK_BLOCK) for g in self._pool_rngs],
                axis=1) if self.n_pools else np.zeros((_SHOCK_BLOCK, 0),
                                                      dtype=np.float64)
            self._shock_pos = 0
        z = self._shock_block[self._shock_pos]
        self._shock_pos += 1
        return z

    def tick(self, host_pool, now: float, util_bias=None,
             shock_bias=None) -> np.ndarray:
        """Advance every pool's price process one step against live pool
        utilization; returns the new (n_pools,) clearing-price vector.  The
        caller (simulator) pushes the prices into the host pool and collects
        the wave.

        ``util_bias`` / ``shock_bias`` are optional (n_pools,) additive
        biases from the fault-injection layer (``market/faults``): a
        capacity crunch raises the demand signal *before* the clearing
        curve, a price spike raises the tick's standard-normal shocks —
        either way the faults flow through the normal price processes.
        ``None`` (the default) is bit-identical to the unbiased tick."""
        util = host_pool.pool_cpu_utilization()
        if util.size < self.n_pools:
            util = np.concatenate(
                [util, np.zeros(self.n_pools - util.size, dtype=np.float64)])
        if self.config.correlation > 0.0:
            rho = self.config.shock_rho
            innov = float(self._rng.normal(
                0.0, self.config.shock_sigma * np.sqrt(1.0 - rho ** 2)))
            self._shared_shock = rho * self._shared_shock + innov
            util = np.clip(
                util + self.config.correlation * self._shared_shock, 0.0, 1.0)
        if util_bias is not None:
            util = np.clip(util + util_bias, 0.0, 1.0)
        self.last_util = util
        z = self._draw_shocks()
        if shock_bias is not None:
            z = z + shock_bias
        # close the previous price segment in the integrals
        k = self._n_ticks
        if k + 1 > self._hist_cap:
            self._grow_history(k + 1)
        if k:
            dt = now - self._ts_buf[k - 1]
            np.multiply(self._ph_buf[:, k - 1], dt, out=self._cum_buf[:, k])
            self._cum_buf[:, k] += self._cum_buf[:, k - 1]
        else:
            self._cum_buf[:, 0] = 0.0
        self._ts_buf[k] = now
        if self._groups is None:
            self._build_groups()
        tr = self.tracer
        traced = tr.enabled
        if traced:
            tr.begin("market-engine",
                     "engine/families" if self.use_vectorized
                     else "engine/scalar-walk")
        if self.use_vectorized:
            for g in self._groups:
                fam, idx, state = g
                state, p = fam.step(state, util[idx], z[idx])
                g[2] = state
                self.prices[idx] = p
        else:
            # scalar oracle walk: identical shocks, identical kernels
            for i, proc in enumerate(self.processes):
                if getattr(proc, "shock_protocol", False):
                    p = proc.price(float(util[i]), shock=float(z[i]))
                else:
                    p = proc.price(float(util[i]))
                self.prices[i] = p
        if traced:
            tr.end(now, None)
        self._ph_buf[:, k] = self.prices
        self._n_ticks = k + 1
        if self.events.enabled:
            # one flight-recorder record per pool per tick — the price
            # series the post-hoc risk analytics reconstruct from the log
            for pid in range(self.n_pools):
                self.events.emit(now, "price-tick", pool=pid,
                                 a=float(self.prices[pid]))
        return self.prices

    def _grow_history(self, need: int) -> None:
        cap = max(need, self._hist_cap * 2)
        ts = np.zeros(cap, dtype=np.float64)
        ts[: self._n_ticks] = self._ts_buf[: self._n_ticks]
        ph = np.zeros((self.n_pools, cap), dtype=np.float64)
        ph[:, : self._n_ticks] = self._ph_buf[:, : self._n_ticks]
        cum = np.zeros((self.n_pools, cap), dtype=np.float64)
        cum[:, : self._n_ticks] = self._cum_buf[:, : self._n_ticks]
        self._ts_buf, self._ph_buf, self._cum_buf = ts, ph, cum
        self._hist_cap = cap

    def price_of(self, pid: int) -> float:
        return float(self.prices[pid])

    # ------------------------------------------------------- history views
    @property
    def n_ticks(self) -> int:
        return self._n_ticks

    def tick_times(self) -> np.ndarray:
        """(n_ticks,) tick timestamps (read-only view)."""
        v = self._ts_buf[: self._n_ticks]
        v.flags.writeable = False    # the buffer backs billing — no writes
        return v

    def price_history(self) -> np.ndarray:
        """(n_pools, n_ticks) clearing prices (read-only view)."""
        v = self._ph_buf[:, : self._n_ticks]
        v.flags.writeable = False
        return v

    # ------------------------------------------------------- realized pricing
    def price_integrals(self, pids, t0s, t1s, caps=None) -> np.ndarray:
        """Batched ∫_{t0}^{t1} min(price_pid(t), cap) dt over the
        piecewise-constant clearing prices — the whole fleet's billing in
        one vectorized call (0 before the first tick; the last price
        extends past the final tick).

        ``caps`` implements the bid contract — a spot VM never pays above
        its bid even while it rides out a price spike (minimum running
        time, or the interruption-warning window); ``None`` = uncapped."""
        pids = np.asarray(pids, dtype=np.int64)
        t0s = np.asarray(t0s, dtype=np.float64)
        t1s = np.asarray(t1s, dtype=np.float64)
        b = pids.size
        if self.tracer.enabled:
            self.tracer.counters.inc("billing/calls")
            self.tracer.counters.inc("billing/spans", int(b))
        out = np.zeros(b, dtype=np.float64)
        k = self._n_ticks
        if b == 0 or k == 0:
            return out
        caps = (np.full(b, np.inf, dtype=np.float64) if caps is None
                else np.asarray(caps, dtype=np.float64))
        ts = self._ts_buf[:k]
        finite = np.isfinite(caps)
        if not finite.all():
            sel = np.flatnonzero(~finite)
            out[sel] = self._uncapped(pids[sel], t0s[sel], t1s[sel])
        if finite.any():
            sel = np.flatnonzero(finite)
            ph = self._ph_buf
            ts_next = np.empty(k, dtype=np.float64)
            ts_next[:-1] = ts[1:]
            ts_next[-1] = np.inf
            # each query only touches the segments its span overlaps
            # (segment j runs [ts[j], ts[j+1]); the last extends to ∞, and
            # t < ts[0] prices at 0 by construction) — gather exactly
            # those (query, segment) pairs CSR-style, so work and memory
            # scale with Σ touched segments, not queries × n_ticks, and
            # each row's reduction is independent of the rest of the batch
            # (scalar B=1 billing stays exactly equal to fleet-batched)
            j0 = np.maximum(
                np.searchsorted(ts, t0s[sel], side="right") - 1, 0)
            j1 = np.minimum(np.searchsorted(ts, t1s[sel], side="left"), k)
            lens = np.maximum(j1 - j0, 0)
            starts = np.zeros(sel.size + 1, dtype=np.int64)
            np.cumsum(lens, out=starts[1:])
            # chunk over queries so the flat gather stays memory-bounded
            lo = 0
            while lo < sel.size:
                hi = int(np.searchsorted(
                    starts, starts[lo] + _INTEGRAL_CHUNK_ELEMS,
                    side="left"))
                hi = min(max(hi, lo + 1), sel.size)
                total = int(starts[hi] - starts[lo])
                if total == 0:
                    lo = hi
                    continue
                lens_c = lens[lo:hi]
                base = starts[lo:hi] - starts[lo]
                rows = np.repeat(np.arange(lo, hi, dtype=np.int64), lens_c)
                col = (np.repeat(j0[lo:hi], lens_c)
                       + np.arange(total, dtype=np.int64)
                       - np.repeat(base, lens_c))
                q = sel[rows]
                p = np.minimum(ph[pids[q], col], caps[q])
                over = (np.minimum(ts_next[col], t1s[q])
                        - np.maximum(ts[col], t0s[q]))
                np.clip(over, 0.0, None, out=over)
                p *= over
                nz = np.flatnonzero(lens_c)
                out[sel[lo + nz]] = np.add.reduceat(p, base[nz])
                lo = hi
        return out

    def _uncapped(self, pids, t0s, t1s) -> np.ndarray:
        """Uncapped batched integrals via searchsorted + the cumulative
        per-pool price integral (O(log k) per query)."""
        k = self._n_ticks
        ts = self._ts_buf[:k]

        def at(t):
            idx = np.searchsorted(ts, t, side="right") - 1
            safe = np.maximum(idx, 0)
            val = (self._cum_buf[pids, safe]
                   + self._ph_buf[pids, safe] * (t - ts[safe]))
            return np.where(idx >= 0, val, 0.0)

        return np.where(t1s > t0s, at(t1s) - at(t0s), 0.0)

    def price_integral(self, pid: int, t0: float, t1: float,
                       cap: float = float("inf")) -> float:
        """Scalar ∫ min(price, cap) dt — delegates to the batched kernel,
        so scalar and fleet-batched billing agree exactly."""
        if t1 <= t0 or self._n_ticks == 0:
            return 0.0
        return float(self.price_integrals(
            np.asarray([pid], dtype=np.int64),
            np.asarray([t0], dtype=np.float64),
            np.asarray([t1], dtype=np.float64),
            np.asarray([cap], dtype=np.float64))[0])

    def discount_integrals(self, pids, t0s, t1s, caps=None) -> np.ndarray:
        """Batched ∫ min(price, cap)/on_demand_rate dt — the fleet's
        time-integrated discount factors in one call."""
        pids = np.asarray(pids, dtype=np.int64)
        return self.price_integrals(pids, t0s, t1s, caps) / np.maximum(
            self.od_rates[pids], 1e-12)

    def discount_integral(self, pid: int, t0: float, t1: float,
                          cap: float = float("inf")) -> float:
        """∫ min(price, cap)/on_demand_rate dt — the time-integrated discount
        factor a spot VM realized while running in pool ``pid``."""
        return self.price_integral(pid, t0, t1, cap) / max(
            float(self.od_rates[pid]), 1e-12)

    # ------------------------------------------------------------- reporting
    def price_series(self, pid: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tick times, clearing prices) of one pool."""
        return (self.tick_times().copy(), self.price_history()[pid].copy())


def price_integral_ref(engine: MarketEngine, pid: int, t0: float, t1: float,
                       cap: float = float("inf")) -> float:
    """The historical per-segment ``bisect`` integral — retained verbatim as
    the reference the vectorized :meth:`MarketEngine.price_integrals` is
    regression-tested (and benchmarked) against."""
    if t1 <= t0 or engine.n_ticks == 0:
        return 0.0
    ts = engine.tick_times().tolist()
    ph = engine.price_history()[pid].tolist()
    cum = engine._cum_buf[pid, : engine.n_ticks].tolist()
    if cap == float("inf"):
        def integral_to(t: float) -> float:
            k = bisect.bisect_right(ts, t) - 1
            if k < 0:
                return 0.0
            return cum[k] + ph[k] * (t - ts[k])
        return integral_to(t1) - integral_to(t0)
    i1 = bisect.bisect_right(ts, t1) - 1
    if i1 < 0:
        return 0.0
    i0 = bisect.bisect_right(ts, t0) - 1
    if i0 < 0:       # the span before the first tick prices at 0
        t0, i0 = ts[0], 0
        if t1 <= t0:
            return 0.0
    if i0 == i1:
        return min(ph[i0], cap) * (t1 - t0)
    total = min(ph[i0], cap) * (ts[i0 + 1] - t0)
    for k in range(i0 + 1, i1):
        total += min(ph[k], cap) * (ts[k + 1] - ts[k])
    total += min(ph[i1], cap) * (t1 - ts[i1])
    return total
