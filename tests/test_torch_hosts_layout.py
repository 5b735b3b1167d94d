"""The port's ``HostPool`` feasibility masks read a dimension-major mirror of
the free-capacity cache (``_free_t``, ``(N_DIMS, capacity)``).  Every mask
must stay the same boolean array as the host-major computation it replaced.

Mask equality: a seeded stream of pool operations (spot and on-demand place
and release, host remove / reactivate / update, growth past the capacity
hint, market prices with finite and infinite bids and pool pins) is applied
to the port's pool and to the reference's ``repro.core.hosts.HostPool``.
After every step the port's ``direct_mask_into``, ``direct_idx_into``,
``clearing_mask_into`` and ``direct_mask_batch`` (B = 1 and B > 1) must
equal, bit for bit, a from-scratch ``(n, 4)`` computation and the
reference's masks, and ``check_invariants`` (which holds the mirror equal to
the cache) must pass.

Whole-run equality: a short replay of the benchmark's frozen trace
generator at a few hundred hosts places every VM on the same host, at the
same time, with the pool's masks as they are and with the masks replaced by
the from-scratch computation."""
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core.hosts as rhosts
import repro.core.types as rtypes
import repro_torch.core.hosts as thosts
import repro_torch.core.types as ttypes

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

EPS = 1e-9
N_POOLS = 4
BASE = np.array([1.0, 2048.0, 250.0, 25_000.0])


# -- the from-scratch (n, 4) masks -------------------------------------------
def _scratch_free(pool):
    n = pool.n
    return np.where(pool.active[:n, None], pool.total[:n] - pool.used[:n], 0.0)


def _admit(pool, ok, bid, pid, prices):
    """AND the market terms into ``ok``, from the prices the test pushed."""
    n = pool.n
    if pool.market_on and np.isfinite(bid):
        ok &= prices[pool.pool_of[:n]] <= bid + EPS
    if pid >= 0:
        ok &= pool.pool_of[:n] == pid
    return ok


def scratch_direct(pool, demand, bid=np.inf, pid=-1, prices=None):
    ok = np.all(_scratch_free(pool) >= demand - EPS, axis=1)
    ok &= pool.active[:pool.n]
    return _admit(pool, ok, bid, pid, prices)


def scratch_clearing(pool, demand, bid, pid, prices):
    have = _scratch_free(pool) + pool.reclaim_ready_view()
    ok = np.all(have >= demand - EPS, axis=1) & pool.active[:pool.n]
    return _admit(pool, ok, bid, pid, prices)


# -- the operation stream ----------------------------------------------------
class _Twin:
    """The port's pool and the reference's, driven by one seeded stream."""

    def __init__(self, seed, market, hint):
        self.rng = np.random.default_rng(seed)
        kw = {} if hint is None else {"capacity_hint": hint}
        self.port = thosts.HostPool(**kw)
        self.ref = rhosts.HostPool(**kw)
        self.market = market
        self.prices = np.zeros(N_POOLS)
        self.vms = {}          # vm id -> (port vm, reference vm)
        self.next_id = 0
        self.now = 0.0
        self.removed = []

    def add_hosts(self, k):
        for _ in range(k):
            cap = float(self.rng.choice([8.0, 16.0, 32.0, 64.0])) * BASE
            pool = int(self.rng.integers(N_POOLS))
            assert self.port.add_host(cap, pool) == self.ref.add_host(cap, pool)

    def enable_market(self):
        self.port.enable_market(N_POOLS)
        self.ref.enable_market(N_POOLS)

    def query(self):
        """A demand, bid and pin; a third of demands sit on a host's free
        row, within or just beyond the feasibility slack."""
        rng = self.rng
        if rng.random() < 0.33 and self.port.n:
            hid = int(rng.integers(self.port.n))
            edge = rng.choice([0.0, 0.5e-9, 2e-9, -2e-9])
            demand = np.maximum(self.port.free()[hid] + edge, 0.0)
        else:
            demand = float(rng.uniform(0.5, 12.0)) * BASE * \
                rng.uniform(0.6, 1.4, 4)
        bid = np.inf if rng.random() < 0.4 else float(rng.uniform(0.1, 1.0))
        pid = -1 if rng.random() < 0.6 else int(rng.integers(N_POOLS))
        return demand, bid, pid

    def place(self):
        rng = self.rng
        demand = float(rng.uniform(0.5, 8.0)) * BASE * rng.uniform(0.6, 1.4, 4)
        spot = rng.random() < 0.5
        bid = np.inf if rng.random() < 0.4 else float(rng.uniform(0.1, 1.0))
        pid = -1 if rng.random() < 0.7 else int(rng.integers(N_POOLS))
        mrt = float(rng.choice([0.0, 30.0]))
        vid = self.next_id
        self.next_id += 1
        pair = []
        for mod in (ttypes, rtypes):
            if spot:
                vm = mod.make_spot(vid, demand, 100.0, bid=bid, pool=pid,
                                   min_running_time=mrt)
            else:
                vm = mod.make_on_demand(vid, demand, 100.0, pool=pid)
            pair.append(vm)
        mask = self.port.direct_mask_into(demand, pair[0].bid, pid)
        cand = np.flatnonzero(mask)
        if cand.size == 0:
            return
        hid = int(rng.choice(cand))
        for pool, vm, mod in zip((self.port, self.ref), pair,
                                 (ttypes, rtypes)):
            pool.place(vm, hid, now=self.now)
            vm.state = mod.VmState.RUNNING
            vm.run_start = self.now
        self.vms[vid] = tuple(pair)

    def release(self, vid=None):
        if not self.vms:
            return
        if vid is None:
            vid = int(self.rng.choice(sorted(self.vms)))
        pv, rv = self.vms.pop(vid)
        self.port.release(pv)
        self.ref.release(rv)

    def remove_host(self):
        active = np.flatnonzero(self.port.active_view())
        if active.size < 2:
            return
        hid = int(self.rng.choice(active))
        victims = self.port.remove_host(hid)
        self.ref.remove_host(hid)
        for vm in victims:
            self.release(vm.id)
        self.removed.append(hid)

    def reactivate_host(self):
        if not self.removed:
            return
        hid = self.removed.pop(int(self.rng.integers(len(self.removed))))
        self.port.reactivate_host(hid)
        self.ref.reactivate_host(hid)

    def update_host(self):
        hid = int(self.rng.integers(self.port.n))
        cap = np.maximum(self.port.total[hid] * self.rng.uniform(0.5, 1.5),
                         self.port.used[hid])
        self.port.update_host(hid, cap)
        self.ref.update_host(hid, cap.copy())

    def set_prices(self):
        self.prices = self.rng.uniform(0.1, 1.0, N_POOLS)
        self.port.set_pool_prices(self.prices)
        self.ref.set_pool_prices(self.prices.copy())

    def step(self):
        ops = [self.place] * 5 + [self.release] * 3 + [
            self.remove_host, self.reactivate_host, self.update_host,
            lambda: self.add_hosts(int(self.rng.integers(1, 3)))]
        if self.market:
            ops.append(self.set_prices)
        ops[int(self.rng.integers(len(ops)))]()
        self.now += float(self.rng.uniform(0.0, 20.0))
        self.port.refresh_reclaim(self.now)
        self.ref.refresh_reclaim(self.now)

    def check(self):
        port, ref = self.port, self.ref
        port.check_invariants(self.now)
        assert np.array_equal(port._free_t[:, :port.n], ref.free().T)
        for _ in range(3):
            demand, bid, pid = self.query()
            want = scratch_direct(port, demand, bid, pid, self.prices)
            direct = port.direct_mask_into(demand, bid, pid)
            assert direct.dtype == bool and direct.shape == (port.n,)
            assert np.array_equal(direct, want)
            assert np.array_equal(direct, ref.direct_mask_into(demand, bid,
                                                               pid))
            # the clearing mask has a buffer of its own: the direct mask
            # stays valid beside it
            clearing = port.clearing_mask_into(demand, bid, pid)
            assert np.array_equal(direct, want)
            assert np.array_equal(
                clearing, scratch_clearing(port, demand, bid, pid,
                                           self.prices))
            assert np.array_equal(clearing,
                                  ref.clearing_mask_into(demand, bid, pid))
            idx = port.direct_idx_into(demand, bid, pid)
            assert np.array_equal(idx, np.flatnonzero(want))
            assert np.array_equal(idx, ref.direct_idx_into(demand, bid, pid))
        for b in (1, int(self.rng.integers(2, 9))):
            rows = [self.query() for _ in range(b)]
            demands = np.stack([r[0] for r in rows])
            bids = np.array([r[1] for r in rows])
            pids = np.array([r[2] for r in rows], dtype=np.int64)
            got = port.direct_mask_batch(demands, bids, pids)
            assert got.shape == (b, port.n) and got.dtype == bool
            want = np.stack([scratch_direct(port, *r, self.prices)
                             for r in rows])
            assert np.array_equal(got, want)
            assert np.array_equal(got, ref.direct_mask_batch(demands, bids,
                                                             pids))
            plain = port.direct_mask_batch(demands)
            assert np.array_equal(plain, np.stack(
                [scratch_direct(port, r[0], prices=self.prices)
                 for r in rows]))


@pytest.mark.parametrize("market", [False, True], ids=["no-market", "market"])
@pytest.mark.parametrize("seed", range(3))
def test_masks_equal_scratch_and_reference(seed, market):
    """A pool built with a hint of 4, grown to ~60 hosts over 150 steps."""
    twin = _Twin(seed, market, hint=4)
    twin.add_hosts(6)
    if market:
        twin.enable_market()
        twin.set_prices()
    twin.check()
    for _ in range(150):
        twin.step()
        twin.check()
    assert twin.port._free_t.shape[1] > 4


@pytest.mark.parametrize("market", [False, True], ids=["no-market", "market"])
@pytest.mark.parametrize("seed", range(2))
def test_masks_equal_after_growth_past_default_hint(seed, market):
    """The default hint of 64, grown to >= 1,000 hosts in batches, with the
    stream's other operations between the batches."""
    twin = _Twin(100 + seed, market, hint=None)
    assert twin.port._free_t.shape == (4, 64)
    twin.add_hosts(10)
    if market:
        twin.enable_market()
        twin.set_prices()
    twin.check()
    while twin.port.n < 1_000:
        twin.add_hosts(int(twin.rng.integers(60, 240)))
        twin.check()
        for _ in range(3):
            twin.step()
            twin.check()
    for _ in range(40):
        twin.place()
    twin.check()
    for _ in range(12):
        twin.step()
        twin.check()
    assert twin.port.n >= 1_000 and twin.port._free_t.shape[1] >= 1_000


# -- a whole gtrace-fill-shaped run -------------------------------------------
def _scratch_masks(pool, calls):
    """Replace the pool's masks by the from-scratch (n, 4) computation (the
    market is off in this cell, so only pool pins apply); ``calls`` counts
    the calls by mask."""
    def direct(self, demand, bid=np.inf, pid=-1):
        calls["direct"] += 1
        return scratch_direct(self, demand, bid, pid)

    def idx(self, demand, bid=np.inf, pid=-1):
        return np.flatnonzero(direct(self, demand, bid, pid))

    def clearing(self, demand, bid=np.inf, pid=-1):
        calls["clearing"] += 1
        return scratch_clearing(self, demand, bid, pid, None)

    def batch(self, demands, bids=None, pids=None):
        calls["batch"] += 1
        pids = np.full(len(demands), -1) if pids is None else pids
        return np.stack([scratch_direct(self, d, np.inf, int(p))
                         for d, p in zip(demands, pids)])

    for name, fn in (("direct_mask_into", direct), ("direct_idx_into", idx),
                     ("clearing_mask_into", clearing),
                     ("direct_mask_batch", batch)):
        setattr(pool, name, types.MethodType(fn, pool))


def _replay(seed, scratch):
    """One replay of the ``gtrace-fill`` cell's first 346 s at 300 machines,
    with the arrival rate raised so that the fleet fills: the masks then
    decide (an emptying fleet's masks pass almost every host) and the
    batched flush runs over the waiting queue."""
    from portbench import harness
    from portbench.drivers import trace_fill

    cell = harness.load_cell(
        "gtrace-fill",
        config_overrides={"n_machines": 300, "n_spot": 200,
                          "load_per_machine": 250.0},
        traffic_overrides={"sim_days": 0.004})
    inputs = trace_fill.prepare(cell, seed)
    sim = trace_fill.build(inputs, cell, "cpu", traced=False)
    calls = {"direct": 0, "clearing": 0, "batch": 0}
    if scratch:
        _scratch_masks(sim.pool, calls)
    log = []
    place = sim.pool.place

    def logged(vm, hid, now=0.0):
        log.append((vm.id, int(hid), now))
        place(vm, hid, now=now)

    sim.pool.place = logged
    sim.run(until=trace_fill.horizon(cell))
    sim.pool.check_invariants()
    full = float(np.mean(sim.pool.free()[:, 0] < 8.0))
    return log, calls, full


@pytest.mark.parametrize("seed", [11, 2**31 + 5])
def test_trace_fill_run_places_as_scratch_masks(seed):
    got, _, full = _replay(seed, scratch=False)
    want, calls, _ = _replay(seed, scratch=True)
    assert full > 0.9 and len(want) > 4_000
    assert calls["direct"] > 4_000 and calls["batch"] > 0, calls
    assert calls["clearing"] > 0, calls
    assert got == want
