"""Plain NumPy reference for the dynamic spot market.

An independent statement of what the simulator does on the ``--market``
scenario (arXiv 2511.18137's Table II/III fleet and VMs in capacity pools,
repriced every tick): each tick clears every pool's price from its CPU
utilization through an auction price process (an AR(1) log-shock per pool
with the Spot-Advisor volatility, plus a shared AR(1) demand shock in the
correlated regime); every running spot VM past its minimum running time
whose bid lies below its pool's new price is interrupted into hibernation
(the wave); queued VMs are then placed again.  On-demand arrivals that fit
no host reclaim spot capacity (the chosen host's interruptible spot VMs,
in residence order, until the demand is covered).  Hosts are chosen by
HLEM-VMP (``trace_fill.hlem_scores``).  It imports nothing of the program.

It runs in two modes:

* ``judge``: teacher-forced on the program's outputs.  Which VM is placed
  next, and when, the set of each wave's victims, the capacity victims,
  each tick's prices and the lifecycle counts are the reference's own; the
  host of each placement and the order in which one wave's victims are
  processed are taken from the program (the latter is arbitrary: the
  reference only requires the same set), after the host is scored.
* ``decide``: makes every decision itself at a given precision; at float32
  in the program's place it is the control.

With a migration policy, each tick's planner (after the wave and the
flush) moves at-risk running spot VMs ahead of a projected price rise:
the ``gradient-aware`` rule, its net score in projected prices (a
least-squares line through the last ticks), the hysteresis, the danger
margin, the destination headroom and utilization ceiling, the price-impact
commit loop and the per-tick cap.  A move leaves the source, reserves its
destination host (chosen by HLEM-VMP among the destination pool's hosts
that fit) for the downtime, and arrives, or fails into hibernation when
the destination's price has risen above the bid.  The destination host is
taken from the program, after it is scored.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

from .trace_fill import FIT_SLACK, TOT_EPS_RS, TOT_EPS_SPOT, hlem_scores

WAVE_EPS = 1e-9          # bid below price by more than this is reclaimed
FINISH, COMMIT, HIB_EXPIRE, TICK, SUBMIT, MIG_START = 1, 2, 4, 5, 6, 7
MIG_DONE = 2             # an arrival is an allocation: after finishes
MIGRATION_FAILED = "migration-failed"
DONE_EPS = 1e-9          # an interrupted VM with less work left finishes
CAPACITY, PRICE_WAVE = "capacity", "price-wave"

# Spot-Advisor bands -> pool volatility (the program's market/advisor.py and
# market/risk.py, as written when the benchmark was)
_BANDS = ["<5%", "5-10%", "10-15%", "15-20%", ">20%"]
_BAND_RATES = {"<5%": 0.025, "5-10%": 0.075, "10-15%": 0.125,
               "15-20%": 0.175, ">20%": 0.25}
_CATEGORIES = {
    "general": ["m5", "m5a", "m6i", "t3", "t3a"],
    "compute": ["c5", "c5a", "c6i", "c7g"],
    "memory": ["r5", "r5a", "r6i", "x2"],
    "accelerated": ["p3", "g4dn", "g5"],
    "storage": ["i3", "d3"],
}
_SIZES = ["large", "xlarge", "2xlarge", "4xlarge", "8xlarge"]


class Unsupported(RuntimeError):
    """The replay did something this reference does not state."""


class Parted(Exception):
    """The program's output is not what the reference derives."""


def advisor_sigmas(n_pools: int, seed: int, n_rows: int = 1200) -> np.ndarray:
    """Per-pool shock sigma from the synthetic Spot-Advisor dataset: families
    ranked by mean interruption-band rate, split into ``n_pools`` contiguous
    groups, each group's mean rate mapped linearly from (0.025, 0.25) to
    sigma (0.12, 0.60)."""
    rng = np.random.default_rng(seed)
    cats = list(_CATEGORIES)
    fam_base: Dict[str, float] = {}
    type_base: Dict[str, float] = {}
    cat_base = {c: rng.uniform(0.3, 0.7) for c in cats}
    families, bands = [], []
    for _ in range(n_rows):
        cat = cats[rng.integers(len(cats))]
        fam = _CATEGORIES[cat][rng.integers(len(_CATEGORIES[cat]))]
        size = _SIZES[rng.integers(len(_SIZES))]
        itype = f"{fam}.{size}"
        if fam not in fam_base:
            fam_base[fam] = np.clip(cat_base[cat] + rng.normal(0, 0.22), 0, 1)
        if itype not in type_base:
            type_base[itype] = np.clip(fam_base[fam] + rng.normal(0, 0.3),
                                       0, 1)
        if cat == "accelerated":
            rng.integers(1, 9)                      # gpu count
        rng.normal(70, 12)                          # savings
        rng.lognormal(-3.0, 0.4)                    # price per GB
        lam = 0.8 * type_base[itype] + 0.2 * rng.random()
        bands.append(_BANDS[min(int(lam * len(_BANDS)), len(_BANDS) - 1)])
        families.append(fam)
        rng.integers(3)                             # region
        rng.integers(2)                             # os
        rng.integers(7)                             # day
        rng.random()                                # free tier
    rates = np.array([_BAND_RATES[b] for b in bands])
    fam_rate: Dict[str, list] = {}
    for f, r in zip(families, rates):
        fam_rate.setdefault(f, []).append(r)
    ranked = sorted(fam_rate, key=lambda f: (float(np.mean(fam_rate[f])), f))
    groups = np.array_split(np.arange(len(ranked)), n_pools)
    fam_pool = {ranked[i]: p for p, g in enumerate(groups) for i in g}
    pools = np.array([fam_pool[f] for f in families], dtype=np.int64)
    sums = np.bincount(pools, weights=rates, minlength=n_pools)
    counts = np.bincount(pools, minlength=n_pools)
    mean_rate = np.where(counts > 0, sums / np.maximum(counts, 1),
                         rates.mean())
    return np.interp(mean_rate, (0.025, 0.25), (0.12, 0.60))


class Prices:
    """The pools' auction price processes (one step per tick)."""

    SHOCK_BLOCK = 64

    def __init__(self, n_pools: int, seed: int, market: Dict, dtype):
        self.dtype = dtype
        self.od = 1.0
        rho = float(market["shock_rho"])
        sigma = advisor_sigmas(n_pools, seed)
        self.rho = np.full(n_pools, rho)
        self.innov = np.array([float(s) * float(np.sqrt(1.0 - rho ** 2))
                               for s in sigma])
        self.log_shock = np.zeros(n_pools)
        self.corr = float(market["correlation"])
        self.shared_sigma = float(market["shared_sigma"])
        self.shared_rho = float(market["shared_rho"])
        self.shared = 0.0
        self.rng = np.random.default_rng(seed)
        self.pool_rngs = [np.random.default_rng(seed + i)
                          for i in range(n_pools)]
        self.block = np.zeros((0, n_pools))
        self.pos = 0

    def step(self, util: np.ndarray) -> np.ndarray:
        dt = self.dtype
        if self.corr > 0.0:
            rho = self.shared_rho
            innov = float(self.rng.normal(
                0.0, self.shared_sigma * np.sqrt(1.0 - rho ** 2)))
            self.shared = rho * self.shared + innov
            util = np.clip(util + self.corr * self.shared, 0.0, 1.0)
        if self.pos >= self.block.shape[0]:
            self.block = np.stack([g.standard_normal(self.SHOCK_BLOCK)
                                   for g in self.pool_rngs], axis=1)
            self.pos = 0
        z = self.block[self.pos]
        self.pos += 1
        u = np.clip(util, 0.0, 1.0).astype(dt)
        base = dt(self.od) * (dt(0.1) + dt(0.9) * u ** 3)
        log_shock = (self.rho.astype(dt) * self.log_shock.astype(dt)
                     + self.innov.astype(dt) * z.astype(dt))
        self.log_shock = log_shock.astype(np.float64)
        return np.minimum(base * np.exp(log_shock), dt(self.od)).astype(
            np.float64)


class _Vm:
    __slots__ = ("id", "spot", "demand", "bid", "pin", "remaining", "mrt",
                 "hib_timeout", "state", "run_start", "host", "gen",
                 "intervals", "hibernated_at", "placed_at", "rem0",
                 "cooldown")

    def __init__(self, d: Dict):
        self.id = int(d["id"])
        self.spot = d["kind"] == "spot"
        self.demand = np.asarray(d["demand"], dtype=np.float64)
        self.bid = float(d["bid"])
        self.pin = int(d["pool"])
        self.remaining = float(d["duration"])
        self.mrt = float(d["min_running_time"])
        self.hib_timeout = float(d["hibernation_timeout"])
        self.state = "new"
        self.run_start = -1.0
        self.host = -1
        self.gen = 0
        self.intervals: List[list] = []
        self.hibernated_at = -1.0
        self.placed_at = 0.0
        self.rem0 = self.remaining
        self.cooldown = 0.0


class Replay:
    """One market replay; ``chooser`` supplies the hosts and wave orders."""

    def __init__(self, hosts, vms, market: Dict, policy: Dict, seed: int,
                 chooser, dtype=np.float64, migration: Optional[Dict] = None):
        caps = np.array([c for c, _ in hosts], dtype=np.float64)
        self.total = np.ascontiguousarray(caps.T)
        self.used = np.zeros_like(self.total)
        self.spot_used = np.zeros_like(self.total)
        self.pool_of = np.array([p for _, p in hosts], dtype=np.int64)
        self.n_pools = int(market["n_pools"])
        self.tot_cpu = np.maximum(self.total[0], TOT_EPS_RS)
        self.tot_spot = np.maximum(self.total, TOT_EPS_SPOT)
        self.host_price = np.zeros(self.pool_of.size)
        self.residents: List[Dict[int, _Vm]] = [{} for _ in hosts]
        self.vms = {int(v["id"]): _Vm(v) for v in vms}
        self.order = [int(v["id"]) for v in vms]
        self.submit_at = {int(v["id"]): float(v["submit"]) for v in vms}
        self.prices = Prices(self.n_pools, seed, market, dtype)
        self.tick_s = float(market["tick_interval"])
        self.policy = policy
        self.dtype = dtype
        self.chooser = chooser
        self.waiting_od: Dict[int, _Vm] = {}
        self.waiting_spot: Dict[int, _Vm] = {}
        self.hibernated: Dict[int, _Vm] = {}
        self.heap: List[tuple] = []
        self.seq = 0
        self.now = 0.0
        self.allocations = 0
        self.resumed = 0
        self.interruptions: List[tuple] = []   # (vm, time, cause)
        self.waves = 0
        self.price_log: List[tuple] = []       # (time, prices)
        self.mig = migration
        self.migrations: List[tuple] = []      # (vm, t, src, dst, pools)
        self.migrated = self.mig_failed = 0

    # -- events ---------------------------------------------------------------
    def push(self, t: float, kind: int, payload=None, gen: int = -1):
        heapq.heappush(self.heap, (t, kind, self.seq, payload, gen))
        self.seq += 1

    def run(self, until: float) -> None:
        self.push(0.0, TICK)
        for vid in self.order:
            self.push(self.submit_at[vid], SUBMIT, vid)
        while self.heap and self.heap[0][0] <= until:
            t, kind, _, payload, gen = heapq.heappop(self.heap)
            self.now = t
            if kind == SUBMIT:
                vm = self.vms[payload]
                vm.state = "waiting"
                self.try_allocate(vm, fresh=True)
            elif kind == FINISH:
                vm = self.vms[payload]
                if gen == vm.gen and vm.state in ("running", "interrupting"):
                    self.finish(vm)
            elif kind == HIB_EXPIRE:
                vm = self.vms[payload]
                if gen == vm.gen and vm.state == "hibernated":
                    self.hibernated.pop(vm.id, None)
                    vm.state = "terminated"
                    vm.gen += 1
            elif kind == COMMIT and payload[0] == "arrive":
                self.migrate_done(payload[1:], gen)
            elif kind == COMMIT:
                self.commit(*payload)
            elif kind == TICK:
                self.tick()
            elif kind == MIG_START:
                self.migrate_start(payload, gen)

    # -- host state ---------------------------------------------------------
    def free(self) -> np.ndarray:
        return self.total - self.used

    def direct_mask(self, vm: _Vm) -> np.ndarray:
        free = self.free()
        m = free[0] >= vm.demand[0] - FIT_SLACK
        for k in range(1, free.shape[0]):
            m &= free[k] >= vm.demand[k] - FIT_SLACK
        return self._admit(m, vm)

    def clearing_mask(self, vm: _Vm) -> np.ndarray:
        """Hosts that fit once their interruptible spot VMs are reclaimed
        (those past their minimum running time, still running)."""
        ready = np.zeros_like(self.total)
        for h, res in enumerate(self.residents):
            for v in res.values():
                if v.spot and v.state == "running" and \
                        v.placed_at + v.mrt <= self.now:
                    ready[:, h] += v.demand
        room = self.free() + ready
        m = room[0] >= vm.demand[0] - FIT_SLACK
        for k in range(1, room.shape[0]):
            m &= room[k] >= vm.demand[k] - FIT_SLACK
        return self._admit(m, vm)

    def _admit(self, m: np.ndarray, vm: _Vm) -> np.ndarray:
        if np.isfinite(vm.bid):
            m &= self.host_price <= vm.bid + FIT_SLACK
        if vm.pin >= 0:
            m &= self.pool_of == vm.pin
        return m

    def candidates(self, vm: _Vm, mask: np.ndarray) -> np.ndarray:
        """HLEM candidates: the mask's hosts above the RsDiff threshold, or
        all of them when none is (Eqs. 1-2)."""
        idx = np.flatnonzero(mask)
        tot = self.tot_cpu[idx]
        rs = vm.demand[0] / tot - self.used[0, idx] / tot \
            * float(self.policy["rc"])
        primary = idx[rs > float(self.policy["threshold"])]
        return primary if primary.size else idx

    def scores(self, vm: _Vm, cand: np.ndarray, dtype=None) -> np.ndarray:
        alpha = float(self.policy["alpha"]) if vm.spot else 0.0
        return hlem_scores(self.free(), self.spot_used / self.tot_spot,
                           cand, alpha, dtype or self.dtype)

    # -- lifecycle ------------------------------------------------------------
    def try_allocate(self, vm: _Vm, fresh: bool) -> None:
        mask = self.direct_mask(vm)
        if mask.any():
            self.start(vm, self.chooser.host(self, vm, mask))
            return
        if not vm.spot:
            mask = self.clearing_mask(vm)
            if mask.any():
                host = self.chooser.clearing_host(self, vm, mask)
                if host is not None and self.preempt(vm, host):
                    return
        self.enqueue(vm)

    def preempt(self, vm: _Vm, host: int) -> bool:
        deficit = np.maximum(vm.demand - self.free()[:, host], 0.0)
        victims, covered = [], np.zeros_like(deficit)
        for v in self.residents[host].values():
            if not (v.spot and v.state == "running"
                    and self.now - v.run_start >= v.mrt):
                continue
            if np.all(covered >= deficit - FIT_SLACK):
                break
            victims.append(v)
            covered += v.demand
        if not victims or not np.all(covered >= deficit - FIT_SLACK):
            return False
        for v in victims:
            v.state = "interrupting"
        self.push(self.now, COMMIT, (host, vm.id, [v.id for v in victims]))
        return True

    def commit(self, host: int, od_id: int, victim_ids: Sequence[int]):
        for vid in victim_ids:
            v = self.vms[vid]
            if v.state == "interrupting":
                self.interrupt(v, CAPACITY)
        od = self.vms[od_id]
        if od.state == "waiting" and \
                np.all(self.free()[:, host] >= od.demand - FIT_SLACK):
            self.start(od, self.chooser.committed(self, od, host))
        elif od.state == "waiting":
            self.try_allocate(od, fresh=False)
        self.flush()

    def enqueue(self, vm: _Vm) -> None:
        if vm.hibernated_at >= 0:
            vm.state = "hibernated"
            self.hibernated[vm.id] = vm
        else:
            vm.state = "waiting"
            (self.waiting_spot if vm.spot else self.waiting_od)[vm.id] = vm

    def start(self, vm: _Vm, host: int) -> None:
        self.waiting_od.pop(vm.id, None)
        self.waiting_spot.pop(vm.id, None)
        self.hibernated.pop(vm.id, None)
        if not np.all(self.free()[:, host] >= vm.demand - FIT_SLACK):
            raise Parted(f"vm {vm.id} placed on host {host}, which it does "
                         f"not fit, at t={self.now}")
        self.used[:, host] += vm.demand
        if vm.spot:
            self.spot_used[:, host] += vm.demand
        self.residents[host][vm.id] = vm
        vm.host, vm.placed_at, vm.rem0 = host, self.now, vm.remaining
        vm.state = "running"
        vm.run_start = self.now
        vm.hibernated_at = -1.0
        vm.gen += 1
        vm.intervals.append([host, self.now, None, "start"])
        self.push(self.now + vm.remaining, FINISH, vm.id, vm.gen)
        self.allocations += 1
        self.resumed += int(len(vm.intervals) > 1)

    def _stop_running(self, vm: _Vm) -> None:
        ran = self.now - vm.run_start
        vm.remaining = max(0.0, vm.remaining - ran)
        vm.intervals[-1][2] = self.now
        h = vm.host
        self.used[:, h] = np.maximum(self.used[:, h] - vm.demand, 0.0)
        if vm.spot:
            self.spot_used[:, h] = np.maximum(
                self.spot_used[:, h] - vm.demand, 0.0)
        del self.residents[h][vm.id]
        vm.host = -1

    def finish(self, vm: _Vm) -> None:
        self._stop_running(vm)
        self._finished(vm)
        self.flush()

    def _finished(self, vm: _Vm) -> None:
        vm.state = "finished"
        vm.gen += 1
        self.hibernated.pop(vm.id, None)

    def interrupt(self, vm: _Vm, cause: str) -> None:
        self._stop_running(vm)
        self._interrupted(vm, cause)

    def _interrupted(self, vm: _Vm, cause: str) -> None:
        self.interruptions.append((vm.id, self.now, cause))
        if vm.remaining <= DONE_EPS:
            self._finished(vm)
            return
        vm.state = "hibernated"
        vm.hibernated_at = self.now
        vm.gen += 1
        self.hibernated[vm.id] = vm
        if np.isfinite(vm.hib_timeout):
            self.push(self.now + vm.hib_timeout, HIB_EXPIRE, vm.id, vm.gen)

    def flush(self) -> None:
        """Place queued VMs in order (waiting on-demand, waiting spot,
        hibernated; each queue in arrival order) until a pass places none:
        each VM that fits some host right now is placed."""
        while True:
            placed = 0
            for q in (self.waiting_od, self.waiting_spot, self.hibernated):
                for vm in list(q.values()):
                    if vm.state not in ("waiting", "hibernated"):
                        q.pop(vm.id, None)
                        continue
                    mask = self.direct_mask(vm)
                    if mask.any():
                        q.pop(vm.id, None)
                        self.start(vm, self.chooser.host(self, vm, mask))
                        placed += 1
            if not placed:
                return

    def tick(self) -> None:
        t = self.now
        used = np.bincount(self.pool_of, weights=self.used[0],
                           minlength=self.n_pools)
        tot = np.bincount(self.pool_of, weights=self.total[0],
                          minlength=self.n_pools)
        util = np.divide(used, tot, out=np.zeros(self.n_pools),
                         where=tot > 0)
        prices = self.chooser.prices(self, self.prices.step(util))
        self.price_log.append((t, prices))
        self.host_price = prices[self.pool_of]
        victims = [v for v in self.vms.values()
                   if v.spot and v.state == "running"
                   and v.bid < prices[self.pool_of[v.host]] - WAVE_EPS
                   and v.placed_at + v.mrt <= t + WAVE_EPS]
        if victims:
            self.waves += len({int(self.pool_of[v.host]) for v in victims})
        for v in self.chooser.wave(self, victims):
            self.interrupt(v, PRICE_WAVE)
        self.flush()
        if self.mig is not None:
            for vid, dst in self.plan(prices):
                self.push(t, MIG_START, (vid, dst), self.vms[vid].gen)
        running = any(v.state in ("running", "interrupting")
                      for v in self.vms.values())
        queued = bool(self.waiting_od or self.waiting_spot
                      or self.hibernated)
        if self.heap or running or queued:
            self.push(t + self.tick_s, TICK)

    # -- proactive migration ------------------------------------------------
    def _projected(self) -> np.ndarray:
        """Each pool's price ``downtime + tick`` seconds past the last
        tick, on the least-squares line through the last ``window`` ticks,
        clipped to [0, on-demand rate]."""
        cfg = self.mig
        lead = float(cfg["downtime"]) + self.tick_s
        k = min(int(cfg["gradient_window"]), len(self.price_log))
        ts = np.array([t for t, _ in self.price_log[-k:]])
        p = np.stack([pr for _, pr in self.price_log[-k:]], axis=1)
        if k < 2:
            return np.clip(p.mean(axis=1), 0.0, self.prices.od)
        tc = ts - ts.mean()
        var = float(np.dot(tc, tc))
        means = p.mean(axis=1)
        if var <= 0.0:
            return np.clip(means, 0.0, self.prices.od)
        slopes = (p - means[:, None]) @ tc / var
        proj = means + slopes * (float(ts[-1] - ts.mean()) + lead)
        return np.clip(proj, 0.0, self.prices.od)

    def _pool_cpu(self):
        free = np.bincount(self.pool_of, weights=self.free()[0],
                           minlength=self.n_pools)
        used = np.bincount(self.pool_of, weights=self.used[0],
                           minlength=self.n_pools)
        tot = np.bincount(self.pool_of, weights=self.total[0],
                          minlength=self.n_pools)
        util = np.divide(used, tot, out=np.zeros(self.n_pools),
                         where=tot > 0)
        return free, tot, util

    def plan(self, prices: np.ndarray) -> List[tuple]:
        """(vm, destination pool) moves of this tick, in commit order."""
        cfg = self.mig
        if cfg["policy"] != "gradient-aware":
            raise Unsupported(f"migration policy {cfg['policy']!r}")
        now = self.now
        p_hat = self._projected()
        free_cpu, tot_cpu, util = self._pool_cpu()
        hyst, margin = float(cfg["hysteresis"]), float(cfg["danger_margin"])
        cost = float(cfg["downtime"]) * float(cfg["delay_cost_rate"])
        ceiling = float(cfg["dest_util_ceiling"])
        rows = []
        for v in self.vms.values():
            if not (v.spot and v.state == "running"):
                continue
            rem_now = v.rem0 - (now - v.placed_at)
            src = int(self.pool_of[v.host])
            if (v.pin >= 0 or v.cooldown > now or v.placed_at + v.mrt > now
                    or not rem_now > float(cfg["min_remaining"])
                    or not p_hat[src] > v.bid - margin):
                continue
            gap = p_hat[src] - p_hat
            w = min(rem_now, float(cfg["horizon"]))
            net = gap * w - cost
            ok = (gap > hyst) & (prices <= v.bid - hyst) \
                & (p_hat <= v.bid - hyst) & (free_cpu >= v.demand[0]) \
                & (util <= ceiling) & (np.arange(self.n_pools) != src)
            best = float(np.where(ok, net, -np.inf).max())
            if best > 0.0:
                rows.append((-best, v.id, src, w))
        rows.sort()
        impact = 1.0 * 2.7 * np.clip(util, 0.0, 1.0) ** 2 \
            / np.maximum(tot_cpu, 1e-9)
        delta = np.zeros(self.n_pools)
        free = free_cpu.astype(np.float64).copy()
        util_eff = util.copy()
        pool_tot = np.maximum(tot_cpu, 1e-9)
        plans: List[tuple] = []
        scan = 4 * int(cfg["max_plans_per_tick"])
        for _, vid, s, w in rows:
            if len(plans) >= int(cfg["max_plans_per_tick"]) or scan <= 0:
                break
            scan -= 1
            v = self.vms[vid]
            cpu = float(v.demand[0])
            p_eff = p_hat + impact * delta
            gap = p_eff[s] - p_eff
            net = gap * float(w) - cost
            ok = (gap > hyst) & (prices <= v.bid - hyst) \
                & (p_eff <= v.bid - hyst) & (free >= cpu) \
                & (util_eff <= ceiling) & (np.arange(self.n_pools) != s)
            net = np.where(ok, net, -np.inf)
            q = int(np.argmax(net))
            if net[q] <= 0.0:
                continue
            plans.append((vid, q))
            delta[q] += cpu
            delta[s] -= cpu
            free[q] -= cpu
            free[s] += cpu
            util_eff[q] += cpu / pool_tot[q]
            util_eff[s] -= cpu / pool_tot[s]
        return plans

    def migrate_start(self, payload, gen: int) -> None:
        vid, dst = payload
        vm = self.vms[vid]
        if gen != vm.gen or vm.state != "running":
            return
        free = self.free()
        mask = free[0] >= vm.demand[0] - FIT_SLACK
        for k in range(1, free.shape[0]):
            mask &= free[k] >= vm.demand[k] - FIT_SLACK
        mask &= self.host_price <= vm.bid + FIT_SLACK
        mask &= self.pool_of == dst
        if not mask.any():
            vm.cooldown = self.now + float(self.mig["cooldown"])
            return
        host = self.chooser.migrate_host(self, vm, mask, dst)
        src = vm.host
        self._stop_running(vm)
        vm.state = "migrating"
        vm.gen += 1
        vm.run_start = -1.0
        self.used[:, host] += vm.demand
        self.migrations.append((vid, self.now, src, host,
                                int(self.pool_of[src]), int(dst)))
        self.push(self.now + float(self.mig["downtime"]), COMMIT,
                  ("arrive", vid, host), vm.gen)
        self.flush()

    def migrate_done(self, payload, gen: int) -> None:
        vid, host = payload
        vm = self.vms[vid]
        if gen != vm.gen or vm.state != "migrating":
            return
        self.used[:, host] = np.maximum(self.used[:, host] - vm.demand, 0.0)
        if self.host_price[host] <= vm.bid + FIT_SLACK and \
                np.all(self.free()[:, host] >= vm.demand - FIT_SLACK):
            vm.cooldown = self.now + float(self.mig["cooldown"])
            self.chooser.arrived(self, vm, host)
            self.used[:, host] += vm.demand
            self.spot_used[:, host] += vm.demand
            self.residents[host][vm.id] = vm
            vm.host, vm.placed_at, vm.rem0 = host, self.now, vm.remaining
            vm.state = "running"
            vm.run_start = self.now
            vm.gen += 1
            vm.intervals.append([host, self.now, None, "migrate"])
            self.push(self.now + vm.remaining, FINISH, vm.id, vm.gen)
            self.migrated += 1
        else:
            self.mig_failed += 1
            self._interrupted(vm, MIGRATION_FAILED)
        self.flush()

    def counts(self) -> Dict:
        gaps = [nxt[1] - prev[2] for v in self.vms.values() if v.spot
                for prev, nxt in zip(v.intervals, v.intervals[1:])
                if nxt[3] != "migrate"]
        return {
            "allocations": self.allocations,
            "interruptions": len(self.interruptions),
            # every spot VM of the scenario hibernates when interrupted
            "hibernations": len(self.interruptions),
            "redeployed": self.resumed,
            "max_interruption_s": float(max(gaps)) if gaps else 0.0,
            "finished": sum(1 for v in self.vms.values()
                            if v.state == "finished"),
            "waves": self.waves,
            "migrations": self.migrated,
            "migrations_failed": self.mig_failed,
        }


class _Decide:
    """The reference's own choices (the control at float32)."""

    def __init__(self):
        self.placements: List[tuple] = []

    def host(self, r: Replay, vm: _Vm, mask) -> int:
        cand = r.candidates(vm, mask)
        host = int(cand[int(np.argmax(r.scores(vm, cand)))])
        self.placements.append((vm.id, host, r.now))
        return host

    def clearing_host(self, r: Replay, vm: _Vm, mask) -> int:
        cand = r.candidates(vm, mask)
        return int(cand[int(np.argmax(r.scores(vm, cand)))])

    def committed(self, r: Replay, vm: _Vm, host: int) -> int:
        self.placements.append((vm.id, host, r.now))
        return host

    def prices(self, r: Replay, prices):
        return prices

    def wave(self, r: Replay, victims):
        return sorted(victims, key=lambda v: v.id)

    def migrate_host(self, r: Replay, vm: _Vm, mask, dst: int) -> int:
        cand = r.candidates(vm, mask)
        return int(cand[int(np.argmax(r.scores(vm, cand)))])

    def arrived(self, r: Replay, vm: _Vm, host: int) -> None:
        self.placements.append((vm.id, host, r.now))


class _Judge:
    """Teacher forcing on the program's outputs, with the readings."""

    def __init__(self, placements, interruptions, price_log, migrations,
                 score_at, gap_limit):
        self.placements = placements
        self.k = 0
        self.migrations = migrations
        self.mig_k = 0
        self.interruptions = interruptions
        self.price_log = price_log
        self.tick_k = 0
        self.score_at = set(int(i) for i in score_at)
        self.gap_limit = gap_limit
        self.gap_max = 0.0
        self.price_gap_max = 0.0
        self.judged = self.over = 0

    def _next(self, r: Replay, vm: _Vm) -> int:
        if self.k >= len(self.placements):
            raise Parted(f"the program placed no vm {vm.id} at t={r.now}")
        p_vm, p_host, p_t = self.placements[self.k]
        if p_vm != vm.id or p_t != r.now:
            raise Parted(f"placement #{self.k}: the program placed vm "
                         f"{p_vm} at t={p_t}, the reference expects vm "
                         f"{vm.id} at t={r.now}")
        return int(p_host)

    def _score(self, r: Replay, vm: _Vm, mask, host: int) -> None:
        if self.k not in self.score_at:
            return
        self.judged += 1
        cand = r.candidates(vm, mask)
        pos = np.searchsorted(cand, host)
        if pos >= cand.size or cand[pos] != host:
            gap = np.inf
        elif cand.size == 1:
            gap = 0.0
        else:
            hs = r.scores(vm, cand)
            best = hs.max()
            gap = float((best - hs[pos]) / max(abs(best), 1e-300))
        self.gap_max = max(self.gap_max, gap)
        self.over += int(gap > self.gap_limit)

    def host(self, r: Replay, vm: _Vm, mask) -> int:
        host = self._next(r, vm)
        if not (0 <= host < mask.size and mask[host]):
            raise Parted(f"vm {vm.id} placed on host {host}, outside the "
                         f"hosts it may take at t={r.now}")
        self._score(r, vm, mask, host)
        self.k += 1
        return host

    def clearing_host(self, r: Replay, vm: _Vm, mask) -> Optional[int]:
        """The program's clearing choice shows as its next placement, at
        the commit that follows at once; when its next placement is another
        VM, it found no victims to reclaim on its host, and the reference
        checks that its own best host has none either."""
        nxt = self.placements[self.k] if self.k < len(self.placements) \
            else None
        if nxt is None or nxt[0] != vm.id or nxt[2] != r.now:
            cand = r.candidates(vm, mask)
            best = int(cand[int(np.argmax(r.scores(vm, cand)))])
            return best
        host = int(nxt[1])
        if not (0 <= host < mask.size and mask[host]):
            raise Parted(f"vm {vm.id} reclaims host {host}, outside the "
                         f"hosts it may take at t={r.now}")
        self._score(r, vm, mask, host)
        return host

    def committed(self, r: Replay, vm: _Vm, host: int) -> int:
        got = self._next(r, vm)
        if got != host:
            raise Parted(f"vm {vm.id} committed on host {got}, chosen {host}")
        self.k += 1
        return host

    def prices(self, r: Replay, prices):
        if self.tick_k >= len(self.price_log):
            raise Parted(f"the program has no price tick at t={r.now}")
        t, got = self.price_log[self.tick_k]
        if t != r.now:
            raise Parted(f"tick #{self.tick_k} at t={t}, the reference's at "
                         f"t={r.now}")
        self.tick_k += 1
        gap = np.max(np.abs(got - prices) / np.maximum(np.abs(prices), 1e-300))
        self.price_gap_max = max(self.price_gap_max, float(gap))
        return np.asarray(got, dtype=np.float64)

    def migrate_host(self, r: Replay, vm: _Vm, mask, dst: int) -> int:
        """The program's destination host of the move the reference starts
        (its next migration), scored like a placement."""
        if self.mig_k >= len(self.migrations):
            raise Parted(f"the program started no migration of vm {vm.id} "
                         f"at t={r.now}")
        m_vm, m_t, m_src, m_dst, _src_pool, m_pool = self.migrations[
            self.mig_k]
        if (m_vm, m_t, m_src, m_pool) != (vm.id, r.now, vm.host, dst):
            raise Parted(f"migration #{self.mig_k}: the program moved vm "
                         f"{m_vm} to pool {m_pool} at t={m_t}, the reference "
                         f"vm {vm.id} to pool {dst} at t={r.now}")
        if not (0 <= m_dst < mask.size and mask[m_dst]):
            raise Parted(f"vm {vm.id} moves to host {m_dst}, outside the "
                         f"hosts it may take at t={r.now}")
        self.mig_k += 1
        self.judged += 1
        cand = r.candidates(vm, mask)
        pos = np.searchsorted(cand, m_dst)
        if pos >= cand.size or cand[pos] != m_dst:
            gap = np.inf
        elif cand.size == 1:
            gap = 0.0
        else:
            hs = r.scores(vm, cand)
            gap = float((hs.max() - hs[pos]) / max(abs(hs.max()), 1e-300))
        self.gap_max = max(self.gap_max, gap)
        self.over += int(gap > self.gap_limit)
        return int(m_dst)

    def arrived(self, r: Replay, vm: _Vm, host: int) -> None:
        if self._next(r, vm) != host:
            raise Parted(f"vm {vm.id} arrived elsewhere than host {host}")
        self.k += 1

    def wave(self, r: Replay, victims):
        got = [vid for vid, t, cause in self.interruptions
               if t == r.now and cause == PRICE_WAVE]
        want = {v.id for v in victims}
        if set(got) != want or len(got) != len(want):
            raise Parted(f"wave at t={r.now}: the program interrupted "
                         f"{len(got)} VMs, the reference {len(want)} "
                         f"({len(set(got) ^ want)} differ)")
        return [r.vms[vid] for vid in got]


def judge(hosts, vms, market: Dict, policy: Dict, seed: int, until: float,
          placements, interruptions, price_log, migrations, score_at,
          gap_limit: float = np.inf,
          migration: Optional[Dict] = None) -> Dict:
    """Teacher-forced check of one replay's program outputs up to ``until``.

    Readings: ``gap_max`` (widest relative HLEM score gap of a scored
    placement's host below the reference's best), ``price_gap_max``
    (widest relative gap of a tick's price from the reference's, computed
    from its own utilization), ``mismatches`` (placements the reference
    could not follow from the first departure on, plus interruptions that
    differ), with the reference's lifecycle counts."""
    j = _Judge(placements, interruptions, price_log, migrations, score_at,
               gap_limit)
    r = Replay(hosts, vms, market, policy, seed, j, migration=migration)
    mismatches = 0
    try:
        r.run(until)
    except Parted:
        mismatches = max(1, len(placements) - j.k)
    else:
        mismatches = len(placements) - j.k
        mine = r.interruptions
        mismatches += sum(1 for a, b in zip(mine, interruptions) if a != b)
        mismatches += abs(len(mine) - len(interruptions))
        mismatches += abs(len(r.price_log) - len(price_log))
        mismatches += abs(len(r.migrations) - len(migrations))
    return {"gap_max": j.gap_max, "price_gap_max": j.price_gap_max,
            "mismatches": mismatches, "judged": j.judged, "over": j.over,
            "counts": r.counts()}


def decide(hosts, vms, market: Dict, policy: Dict, seed: int, until: float,
           dtype=np.float64, migration: Optional[Dict] = None) -> Dict:
    """The reference's own outputs at ``dtype``: placements, interruptions
    and price ticks, as the program's are recorded."""
    d = _Decide()
    r = Replay(hosts, vms, market, policy, seed, d, dtype, migration)
    r.run(until)
    return {"placements": d.placements, "interruptions": r.interruptions,
            "price_log": r.price_log, "migrations": r.migrations}
