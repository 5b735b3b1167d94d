"""The port's ``market`` package (``repro_torch.market``) against the JAX
package's (``repro.market``) module by module, on the same seeded inputs.

The host-side modules are carried over from the reference, so their results
are held bit for bit (``==`` / ``np.array_equal``).  The one new piece, the
float64 torch backend of ``simulate_price_paths`` (plain PyTorch on the CPU
here), is held against the numpy step loop at ``rtol=1e-12, atol=0``, the
tolerance the reference holds its own scan to: ``exp`` and ``pow`` may
differ from numpy's in the last ulp.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.market as rm
import repro.market.migration as rmig
import repro.market.risk as rrisk
import repro_torch.core as tc
import repro_torch.market as tm
import repro_torch.market.migration as tmig
import repro_torch.market.risk as trisk

RTOL = 1e-12   # torch float64 backend vs the numpy step loop, atol 0
REGISTRIES = ["BID_REGISTRY", "FAULT_REGISTRY", "FLEET_STRATEGY_REGISTRY",
              "MIGRATION_REGISTRY", "PRICE_PROCESS_REGISTRY"]
FAMILY_CASES = [
    ("AUCTION_FAMILY", dict(shock_sigma=0.4, shock_rho=0.6, seed=3)),
    ("AUCTION_FAMILY", dict(shock_sigma=0.3, seed=5)),
    ("SMOOTHED_FAMILY", dict(alpha=0.15, max_step=0.04)),
]


def test_exports_equal_reference():
    assert tm.__all__ == rm.__all__


@pytest.mark.parametrize("registry", REGISTRIES)
def test_registry_names_equal_reference(registry):
    assert getattr(tm, registry).names() == getattr(rm, registry).names()


# ---------------------------------------------------------------------------
# configuration, advisor data, association measures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("from_advisor", [False, True])
@pytest.mark.parametrize("regime", ["calm", "volatile", "correlated"])
def test_make_market_equals_reference(regime, from_advisor):
    for n_pools, seed in ((2, 0), (4, 0), (5, 11)):
        kw = dict(n_pools=n_pools, seed=seed, tick_interval=60.0,
                  from_advisor=from_advisor)
        assert dataclasses.asdict(tm.make_market(regime, **kw)) == \
            dataclasses.asdict(rm.make_market(regime, **kw))


@pytest.mark.parametrize("seed", [0, 3])
def test_advisor_dataset_and_pool_volatility_equal(seed):
    a = rm.generate_advisor_dataset(n_rows=600, seed=seed)
    b = tm.generate_advisor_dataset(n_rows=600, seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    for n_pools in (1, 4, 7):
        assert np.array_equal(rm.advisor_pool_volatility(n_pools, seed=seed),
                              tm.advisor_pool_volatility(n_pools, seed=seed))


def test_correlation_measures_equal():
    data = rm.generate_advisor_dataset(n_rows=400, seed=1)
    from repro.market.advisor import KINDS as R_KINDS
    from repro_torch.market.advisor import KINDS as T_KINDS
    assert T_KINDS == R_KINDS
    assert tm.association_matrix(data, T_KINDS) == \
        rm.association_matrix(data, R_KINDS)
    band, fam = data["interruption_band"], data["family"]
    assert tm.theils_u(band, fam) == rm.theils_u(band, fam)
    assert tm.correlation_ratio(fam, data["vcpu"]) == \
        rm.correlation_ratio(fam, data["vcpu"])
    assert tm.pearson(data["vcpu"], data["memory_gb"]) == \
        rm.pearson(data["vcpu"], data["memory_gb"])


# ---------------------------------------------------------------------------
# price processes: legacy scalar series and the fused family step
# ---------------------------------------------------------------------------
_UTILS = np.random.default_rng(5).uniform(0.0, 1.0, 300).tolist()


@pytest.mark.parametrize("cls,kw", [
    ("AuctionPrice", dict(on_demand_rate=1.5, shock_sigma=0.35, seed=11)),
    ("AuctionPrice", dict(on_demand_rate=1.5, shock_sigma=0.35,
                          shock_rho=0.75, seed=11)),
    ("SmoothedPrice", dict(on_demand_rate=1.5, alpha=0.2, max_step=0.05)),
])
def test_legacy_scalar_series_bit_equal(cls, kw):
    ref = rm.simulate_price_series(getattr(rm, cls)(**kw), _UTILS)
    port = tm.simulate_price_series(getattr(tm, cls)(**kw), _UTILS)
    assert np.array_equal(port, ref)
    # the shared-shock protocol (one-pool family step) as well
    z = np.random.default_rng(6).standard_normal(len(_UTILS))
    pr, pt = getattr(rm, cls)(**kw), getattr(tm, cls)(**kw)
    assert [pt.price(u, shock=s) for u, s in zip(_UTILS, z)] == \
        [pr.price(u, shock=s) for u, s in zip(_UTILS, z)]


def test_shock_table_and_regime_comparison_equal():
    assert np.array_equal(tm.draw_shock_table([0, 4, 9], 100),
                          rm.draw_shock_table([0, 4, 9], 100))
    assert tm.regime_comparison(n=600, seed=2) == \
        rm.regime_comparison(n=600, seed=2)


# ---------------------------------------------------------------------------
# bids
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy,params", [
    ("on-demand-cap", {"fraction": 0.8}),
    ("percentile", {"pct": 85.0}),
    ("randomized", {"lo": 0.45}),
])
def test_bids_equal_reference(strategy, params):
    bids = []
    for core, market in ((rc, rm), (tc, tm)):
        _, _, vms = core.market_scenario(core.MarketScenarioConfig(seed=4))
        pools = market.make_market("volatile", n_pools=4, seed=4,
                                   from_advisor=True).pools
        strat = market.make_bid_strategy(strategy, pool_cfg=pools[0], seed=4,
                                         **params)
        market.assign_bids(vms, strat, seed=4)
        rebid = market.RebidOnResume(seed=4)
        for v in vms[:50]:
            v.interruptions = v.id % 3
        bids.append(([v.bid for v in vms],
                     [rebid.rebid(v) for v in vms[:50] if v.is_spot]))
    assert bids[1] == bids[0]
    assert any(np.isfinite(b) for b in bids[0][0])


# ---------------------------------------------------------------------------
# the engine over a seeded host pool: tick, history, billing
# ---------------------------------------------------------------------------
def _engine_run(core, market, regime, n_ticks=300, seed=0):
    """Tick an engine over a 4-pool host pool whose residents change every
    tick (seeded), with a crunch and a spike bias in a window."""
    rng = np.random.default_rng(seed)
    pool = core.HostPool()
    pool.enable_market(4)
    for h in range(24):
        pool.add_host(core.resources(32, 65_536, 10_000, 1e6), pool=h % 4)
    eng = market.MarketEngine(market.make_market(
        regime, n_pools=4, seed=seed, tick_interval=60.0, from_advisor=True))
    resident, vid, prices = [], 0, []
    for k in range(n_ticks):
        for _ in range(int(rng.integers(0, 6))):
            vm = core.make_spot(vid, core.resources(
                float(rng.choice([1, 2, 4])), 1024, 10, 100), 600.0)
            vid += 1
            hid = int(rng.integers(0, 24))
            if pool.fits(hid, vm.demand):
                pool.place(vm, hid, now=60.0 * k)
                resident.append(vm)
        while resident and rng.random() < 0.4:
            pool.release(resident.pop(int(rng.integers(0, len(resident)))))
        window = 100 <= k < 120
        prices.append(eng.tick(
            pool, 60.0 * k,
            util_bias=np.array([0.2, 0, 0, 0.1]) if window else None,
            shock_bias=np.array([0, 1.5, 0, 0]) if window else None).copy())
        pool.set_pool_prices(eng.prices)
    return eng, np.array(prices)


@pytest.mark.parametrize("regime", ["calm", "volatile", "correlated"])
def test_engine_tick_history_and_billing_equal(regime):
    (re, rp), (te, tp) = (_engine_run(rc, rm, regime),
                          _engine_run(tc, tm, regime))
    assert np.array_equal(tp, rp)
    assert np.array_equal(te.tick_times(), re.tick_times())
    assert np.array_equal(te.price_history(), re.price_history())
    assert np.array_equal(te.last_util, re.last_util)
    rng = np.random.default_rng(1)
    b = 500
    pids = rng.integers(0, 4, b)
    t0 = rng.uniform(-100.0, 18_000.0, b)
    t1 = t0 + rng.uniform(0.0, 3_000.0, b)
    caps = np.where(rng.random(b) < 0.5, np.inf, rng.uniform(0.1, 1.0, b))
    for c in (None, caps):
        assert np.array_equal(te.price_integrals(pids, t0, t1, c),
                              re.price_integrals(pids, t0, t1, c))
        assert np.array_equal(te.discount_integrals(pids, t0, t1, c),
                              re.discount_integrals(pids, t0, t1, c))
    for i in range(40):
        args = (int(pids[i]), float(t0[i]), float(t1[i]), float(caps[i]))
        assert tm.price_integral_ref(te, *args) == \
            rm.price_integral_ref(re, *args)
        assert te.price_integral(*args) == re.price_integral(*args)
    for (_, ri, rs), (_, ti, ts) in zip(re.price_state(), te.price_state()):
        assert np.array_equal(ti, ri)
        assert all(np.array_equal(ts[k], rs[k]) for k in rs)


def test_risk_signals_equal():
    (re, _), (te, _) = (_engine_run(rc, rm, "volatile", n_ticks=80),
                        _engine_run(tc, tm, "volatile", n_ticks=80))
    for w in (1, 2, 5, 12, 200):
        assert np.array_equal(trisk.recent_prices(te, w),
                              rrisk.recent_prices(re, w))
        assert np.array_equal(tm.price_gradients(te, w),
                              rm.price_gradients(re, w))
        assert np.array_equal(tm.price_volatility(te, w),
                              rm.price_volatility(re, w))
        assert np.array_equal(tm.projected_prices(te, 90.0, w),
                              rm.projected_prices(re, 90.0, w))
    rng = np.random.default_rng(2)
    proj, sigma = rng.uniform(0, 1, 4), rng.uniform(0, 0.2, 4)
    bids, pools = rng.uniform(0.3, 1.0, 64), rng.integers(0, 4, 64)
    assert np.array_equal(tm.bid_crossing_risk(proj, sigma, bids, pools),
                          rm.bid_crossing_risk(proj, sigma, bids, pools))
    assert np.array_equal(trisk.frequency_to_sigma([0.0, 0.1, 0.3]),
                          rrisk.frequency_to_sigma([0.0, 0.1, 0.3]))
    assert np.array_equal(
        tm.simulated_price_fan(te, n_ticks=12, n_paths=32, seed=3),
        rm.simulated_price_fan(re, n_ticks=12, n_paths=32, seed=3))


# ---------------------------------------------------------------------------
# realized billing over a market run
# ---------------------------------------------------------------------------
def test_cost_stats_equal_after_a_market_run():
    out = []
    for core, market in ((rc, rm), (tc, tm)):
        hosts, pool_ids, vms = core.market_scenario(
            core.MarketScenarioConfig(seed=2))
        eng = market.MarketEngine(market.make_market(
            "volatile", n_pools=4, seed=2, from_advisor=True))
        market.assign_bids(vms, market.RandomizedBid(lo=0.45), seed=2)
        sim = core.MarketSimulator(
            policy=core.make_policy("first-fit"),
            config=core.SimConfig(record_timeline=False), engine=eng)
        for cap, pid in zip(hosts, pool_ids):
            sim.add_host(cap, pool=pid)
        for v in vms:
            sim.submit(v)
        sim.run(until=1800.0)
        out.append((market.realized_cost_stats(sim.vms.values(), eng, sim.pool),
                    market.cost_stats(sim.vms.values()),
                    market.cost_stats(sim.vms.values(),
                                      market.PriceModel(spot_discount=0.2))))
    assert out[1] == out[0]
    assert out[0][0]["spot_cost"] > 0


# ---------------------------------------------------------------------------
# migration: the planner against its oracle and against the reference
# ---------------------------------------------------------------------------
def _registry_fixture(core, market, m=300, n_pools=4, seed=0):
    """The reference migration tests' fixture (``tests/market/
    test_migration.py``), built from either package."""
    pool = core.HostPool()
    pool.enable_market(n_pools)
    rng = np.random.default_rng(seed)
    n_hosts = 24
    for h in range(n_hosts):
        util_target = 0.5 + 0.1 * (h % n_pools)
        pool.add_host(core.resources((m / n_hosts) / util_target, 1e9, 1e9,
                                     1e9), pool=h % n_pools)
    for i in range(m):
        vm = core.make_spot(i, core.resources(1, 64, 1, 1),
                            float(rng.uniform(100, 5000)),
                            bid=float(rng.uniform(0.1, 1.0)),
                            min_running_time=float(rng.choice([0.0, 200.0])),
                            pool=int(rng.choice([-1, -1, -1, 0])))
        vm.migrate_cooldown_until = float(rng.choice([0.0, 1e6]))
        pool.place(vm, i % n_hosts, now=0.0)
        vm.state = core.VmState.RUNNING
        vm.run_start = 0.0
    eng = market.MarketEngine(market.make_market(
        "volatile", n_pools=n_pools, seed=seed, tick_interval=60.0))
    for k in range(6):
        pool.set_pool_prices(eng.tick(pool, 60.0 * k))
    return pool, eng


def _plans(plans):
    return [(p.vm_id, p.dst_pool, p.predicted_saving) for p in plans]


@pytest.mark.parametrize("policy", ["none", "greedy-cheapest",
                                    "gradient-aware", "risk-budgeted"])
def test_planner_matches_oracle_and_reference(policy):
    rpool, reng = _registry_fixture(rc, rm)
    tpool, teng = _registry_fixture(tc, tm)
    for inflight in (np.zeros(4, dtype=np.int64),
                     np.array([3, 0, 4, 1], dtype=np.int64)):
        rplan = rmig.MigrationPlanner(rmig.MigrationConfig(
            policy=policy, min_remaining=50.0))
        tplan = tmig.MigrationPlanner(tmig.MigrationConfig(
            policy=policy, min_remaining=50.0))
        vec = _plans(tplan.plan(tpool, teng, 360.0, inflight))
        ref_vec = _plans(rplan.plan(rpool, reng, 360.0, inflight))
        oracle = _plans(tm.plan_reference(tplan, tpool, teng, 360.0, inflight))
        assert vec == ref_vec
        assert [p[:2] for p in vec] == [p[:2] for p in oracle]
        assert [p[2] for p in vec] == pytest.approx([p[2] for p in oracle])
        assert oracle == _plans(rm.plan_reference(rplan, rpool, reng, 360.0,
                                                  inflight))
        if policy != "none":
            assert vec, "the fixture must produce plans"
    built = tm.make_migration_planner(policy, downtime=10.0)
    assert built.config == tmig.MigrationConfig(policy=policy, downtime=10.0)


# ---------------------------------------------------------------------------
# faults and fleet
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario,params", [
    ("storm", {}),
    ("storm", {"first": 600.0, "count": 5, "pools": (1, 3)}),
    ("random-storms", {}),
    ("pool-outage", {"pool": 2}),
    ("price-spike", {"pools": (0,)}),
    ("capacity-crunch", {}),
    ("scripted", {"events": [{"kind": "storm", "t0": 120.0, "magnitude": 0.5},
                             {"kind": "pool-outage", "t0": 60.0,
                              "duration": 30.0, "pools": (1,)}]}),
])
def test_fault_schedules_equal(scenario, params):
    for seed in (0, 3):
        a = rm.make_fault_injector(scenario, 4, 14400.0, 60.0, seed, **params)
        b = tm.make_fault_injector(scenario, 4, 14400.0, 60.0, seed, **params)
        assert [dataclasses.astuple(e) for e in b.events] == \
            [dataclasses.astuple(e) for e in a.events]
        for now in np.arange(0.0, 14400.0, 300.0):
            sa, ea = a.begin_tick(now)
            sb, eb = b.begin_tick(now)
            assert [(i, dataclasses.astuple(e)) for i, e in sb] == \
                [(i, dataclasses.astuple(e)) for i, e in sa]
            assert eb == ea
            for fa, fb in ((a.util_bias, b.util_bias),
                           (a.shock_bias, b.shock_bias)):
                x, y = fa(now), fb(now)
                assert (x is None and y is None) or np.array_equal(x, y)
        assert a.pending() == b.pending()


def test_storm_victims_equal():
    rng = np.random.default_rng(4)
    m = 500
    registry = {"vid": rng.permutation(10_000)[:m].astype(np.int64),
                "pool": rng.integers(0, 4, m),
                "bid": np.round(rng.uniform(0.3, 1.0, m), 2)}   # bid ties
    for pools in ((0,), (1, 3), (0, 1, 2, 3)):
        for frac in (0.0001, 0.3, 0.5, 1.0):
            assert np.array_equal(tm.storm_victims(registry, pools, frac),
                                  rm.storm_victims(registry, pools, frac))
    empty = {k: a[:0] for k, a in registry.items()}
    assert tm.storm_victims(empty, (0,), 0.5).size == 0


@pytest.mark.parametrize("strategy",
                         ["diversified", "lowest-price", "single-pool"])
def test_plan_replenish_equals_oracle_and_reference(strategy):
    rng = np.random.default_rng(0)
    for trial in range(60):
        n = int(rng.integers(1, 7))
        need = int(rng.integers(0, 24))
        cur = rng.integers(0, 6, size=n)
        weights = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(0.1, 3.0, n))
        if not weights.any():
            weights[0] = 1.0
        prices = np.round(rng.uniform(0.05, 1.2, n), 2)   # engineered ties
        bids = np.full(n, 0.6)
        free = np.round(rng.uniform(0.0, 30.0, n), 1)
        args = (need, cur, weights, prices, bids, free, 2.0, strategy)
        got = tm.plan_replenish(*args)
        assert np.array_equal(got, tm.plan_replenish_ref(*args)), trial
        assert np.array_equal(got, rm.plan_replenish(*args)), trial


def test_fleet_pool_capacity_equals_oracle_and_reference():
    rng = np.random.default_rng(1)
    for _ in range(20):
        m = int(rng.integers(0, 400))
        registry = {"vid": rng.permutation(10_000)[:m].astype(np.int64),
                    "pool": rng.integers(0, 5, size=m),
                    "cpu": rng.uniform(1.0, 4.0, size=m)}
        fleet_vids = np.sort(rng.choice(10_000, size=200, replace=False))
        got = tm.fleet_pool_capacity(registry, fleet_vids, 5)
        for want in (tm.fleet_pool_capacity_ref(registry, fleet_vids, 5),
                     rm.fleet_pool_capacity(registry, fleet_vids, 5)):
            assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_fleet_config_validation_equal():
    assert tm.LADDER_RUNGS == rm.LADDER_RUNGS
    cfg = dict(strategy="diversified", target_capacity=64.0)
    assert dataclasses.asdict(tm.FleetConfig(**cfg)) == \
        dataclasses.asdict(rm.FleetConfig(**cfg))
    for bad in (dict(target_capacity=-1.0), dict(backoff_mult=0.5),
                dict(ladder=(("pool:9", 1),)), dict(pool_weights=(0.0,) * 4)):
        with pytest.raises(ValueError) as want:
            rm.validate_fleet_config(rm.FleetConfig(**bad), 4)
        with pytest.raises(ValueError) as got:
            tm.validate_fleet_config(tm.FleetConfig(**bad), 4)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="teleport.*diversified"):
        tm.make_fleet_manager(2, strategy="teleport")


# ---------------------------------------------------------------------------
# price paths: the float64 torch backend (CPU) against the numpy step loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family,kwargs", FAMILY_CASES)
def test_price_paths_torch_equal_numpy(family, kwargs):
    fam = getattr(tm, family)
    rng = np.random.default_rng(2)
    n, t = 4, 50
    utils = rng.uniform(0.0, 1.0, (t, n))
    shocks = rng.standard_normal((t, n))
    p_np, s_np = tm.simulate_price_paths(fam, fam.init([kwargs] * n), utils,
                                         shocks, backend="numpy")
    p_t, s_t = tm.simulate_price_paths(fam, fam.init([kwargs] * n), utils,
                                       shocks, backend="torch", device="cpu")
    assert p_t.dtype == np.float64 and p_t.shape == p_np.shape == (t, n)
    np.testing.assert_allclose(p_t, p_np, rtol=RTOL, atol=0)
    for k in s_np:
        np.testing.assert_allclose(s_t[k], s_np[k], rtol=RTOL, atol=0)
    # and the numpy loop is the reference's own, bit for bit
    rfam = getattr(rm, family)
    p_ref, _ = rm.simulate_price_paths(rfam, rfam.init([kwargs] * n), utils,
                                       shocks, backend="numpy")
    assert np.array_equal(p_np, p_ref)


@pytest.mark.parametrize("family,kwargs", FAMILY_CASES)
def test_price_paths_torch_fan_equal_numpy(family, kwargs):
    """A (T, n_paths, n_pools) fan: state leaves broadcast to the shocks.
    The numpy loop keeps the smoothed family's shock-free state at
    (n_pools,), so its paths come back once; the torch backend gives every
    path the same prices."""
    fam = getattr(tm, family)
    rng = np.random.default_rng(7)
    t, paths, n = 30, 64, 3
    utils = np.broadcast_to(rng.uniform(0.0, 1.0, n), (t, n))
    shocks = rng.standard_normal((t, paths, n))
    p_np, s_np = tm.simulate_price_paths(fam, fam.init([kwargs] * n), utils,
                                         shocks)
    p_t, s_t = tm.simulate_price_paths(fam, fam.init([kwargs] * n), utils,
                                       shocks, backend="torch", device="cpu")
    assert p_t.shape == (t, paths, n)
    if p_np.ndim == 2:   # the smoothed family's single path
        p_np = np.broadcast_to(p_np[:, None], (t, paths, n))
    np.testing.assert_allclose(p_t, p_np, rtol=RTOL, atol=0)
    for k in s_t:   # every leaf comes back at the fan's shape
        assert s_t[k].shape == (paths, n)
        np.testing.assert_allclose(s_t[k], np.broadcast_to(s_np[k], (paths, n)),
                                   rtol=RTOL, atol=0)


def test_simulated_price_fan_torch_equal_numpy():
    te, _ = _engine_run(tc, tm, "volatile", n_ticks=40)
    for n_paths in (1, 64, 500):
        fan_np = tm.simulated_price_fan(te, n_ticks=24, n_paths=n_paths,
                                        seed=9)
        fan_t = tm.simulated_price_fan(te, n_ticks=24, n_paths=n_paths,
                                       seed=9, backend="torch", device="cpu")
        assert fan_t.shape == (3, 24, 4)
        np.testing.assert_allclose(fan_t, fan_np, rtol=RTOL, atol=0)
    # smoothed (calm) pools draw no shocks, so every quantile is the one
    # numpy path (the numpy fan itself cannot hold it: see ROADMAP Queue 3)
    calm, _ = _engine_run(tc, tm, "calm", n_ticks=40)
    (fam, idx, state), = calm.price_state()
    one, _ = tm.simulate_price_paths(
        fam, state, np.broadcast_to(calm.last_util, (24, 4)), np.zeros((24, 4)))
    fan_t = tm.simulated_price_fan(calm, 24, 64, backend="torch", device="cpu")
    np.testing.assert_allclose(fan_t, np.broadcast_to(one, (3, 24, 4)),
                               rtol=RTOL, atol=0)


def test_regime_comparison_torch_matches_scalar_claims():
    r = tm.regime_comparison(n=600, seed=0)
    rs = tm.regime_comparison(n=600, seed=0, use_scan=True, device="cpu")
    assert rs.keys() == r.keys()
    for k in r:
        assert rs[k] == pytest.approx(r[k], rel=1e-9)
    assert r == rm.regime_comparison(n=600, seed=0)


def test_price_paths_backend_errors(monkeypatch):
    fam = tm.AUCTION_FAMILY
    z = np.zeros((3, 2))
    with pytest.raises(ValueError, match="numpy|torch"):
        tm.simulate_price_paths(fam, fam.init([{}] * 2), z, z, backend="jax")
    adapter = tm.ScalarProcessAdapter("legacy", tm.AuctionPrice)
    with pytest.raises(ValueError, match="array-native"):
        tm.simulate_price_paths(adapter, adapter.init([{}] * 2), z, z,
                                backend="torch", device="cpu")
    # a CUDA device without a card raises; nothing falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.simulate_price_paths(fam, fam.init([{}] * 2), z, z,
                                backend="torch")
