"""Vectorized host pool with incremental accounting.

Host state lives in dense numpy arrays (capacity / used / spot-used per
resource dimension) so allocation policies can score *all* hosts in one
vectorized pass — this is the JAX/TPU-native replacement for CloudSim Plus's
per-host Java object iteration (the paper reports 1.5 real days per simulated
day, bottlenecked on per-entity updates; §VII-D1).

Incremental accounting (the trace-scale hot path):

* ``free`` / ``spot_frac`` / cpu-utilization caches are updated **in place**
  on every ``place``/``release``/host add/remove/update, so feasibility masks
  and HLEM scoring read cached rows instead of recomputing ``total - used``
  for the whole fleet per call.
* Reclaimable spot capacity (what ``clearing_mask`` needs) is maintained as a
  per-host running sum over *interruptible* resident spot VMs.  Minimum
  running time (§IV-B) is handled by a time-threshold index: a VM placed with
  ``min_running_time > 0`` sits in a ready-time heap and is folded into the
  reclaimable sum by :meth:`refresh_reclaim` once its threshold passes — no
  per-call Python walk over residents.
* A monotone *gain log* records every host whose free capacity increased
  (release / add / reactivate / capacity update).  The simulator's
  resubmission queue uses it to skip VMs whose placement can't possibly have
  become feasible since their last failed attempt.

Market mode (price-driven engine; see ``repro.market.engine``):

* Every host belongs to a *capacity pool* (``pool_of``; region / instance
  class).  When a market engine is attached (:meth:`enable_market`), each
  pool's clearing price is pushed down per tick via :meth:`set_pool_prices`
  into a per-host price row, and all feasibility masks additionally require
  ``host_price <= vm.bid`` (spot admission) and — when a VM is pool-pinned —
  ``pool_of == vm.pool``.  A price *drop* is treated like a capacity gain:
  the affected hosts are appended to the gain log so the resubmission memo
  rechecks queued spot VMs whose bid now clears (price rises only shrink
  masks, so memos stay valid without flooding).
* Running spot VMs are mirrored in a dense *market registry* (bid / pool /
  min-running-time-ready arrays with swap-remove).  Interruption-wave victim
  selection is one masked comparison over these arrays
  (:meth:`market_victims`) — no Python walk over residents.

Contract: a spot VM's ``min_running_time`` must be set **before** it is
placed; the reclaim index snapshots it at placement time.

Device mirror (``core/hlem.py``): a pool scored on a card keeps its ``free``
and ``spot_frac`` rows there between scoring calls (``mirror``), and each
call brings over only the rows written since the last.  ``_refresh_row`` is
the only writer of those rows after a host is added, so it keeps the log of
changed rows that the mirror reads (:meth:`take_changed`): a flag a row and
the rows in order of first write, each at most once, so the log never
outgrows the pool whether or not it is read.  ``_grow`` marks every row
stale.

Every mutation bumps ``epoch``; ``check_invariants`` cross-checks all cached
arrays against from-scratch recomputation.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .types import N_DIMS, Vm, VmState, VmType

_EPS = 1e-9          # feasibility slack (matches the allocation layer)
_EPS_RS = 1e-12      # RsDiff clamp (matches repro.core.hlem._EPS)


class HostPool:
    """Dense, growable pool of hosts supporting dynamic add/remove (trace
    machine events), spot/on-demand accounting, and O(1)-amortized cached
    views for the allocation hot path."""

    def __init__(self, capacity_hint: int = 64):
        n = max(capacity_hint, 1)
        self.total = np.zeros((n, N_DIMS), dtype=np.float64)
        self.used = np.zeros((n, N_DIMS), dtype=np.float64)
        self.spot_used = np.zeros((n, N_DIMS), dtype=np.float64)
        self.active = np.zeros(n, dtype=bool)
        self.n_hosts = 0
        # host -> set of resident VM ids, in insertion order (dict preserves it)
        self.residents: List[Dict[int, Vm]] = [dict() for _ in range(n)]
        # -- incremental caches (epoch-stamped) ------------------------------
        self.epoch = 0
        #: the free and spot_frac caches below, one plane each, in the layout
        #: of the device mirror's planes
        self._planes = np.zeros((2, n, N_DIMS), dtype=np.float64)
        #: total - used where active, 0 elsewhere; updated row-wise in place
        self._free = self._planes[0]
        #: ``_free`` transposed, bit for bit: the masks compare each
        #: dimension's contiguous row and reduce over the short leading axis
        self._free_t = np.zeros((N_DIMS, n), dtype=np.float64)
        #: spot_used / max(total, 1e-9) per (host, dim)
        self._spot_frac = self._planes[1]
        #: max(total, 1e-9) — the spot_frac denominator, refreshed only when
        #: capacity changes (place/release divide by the cached row)
        self._tot_clamped = np.full((n, N_DIMS), _EPS, dtype=np.float64)
        #: max(total_cpu, 1e-12) and used_cpu / that — RsDiff inputs (Eq. 1)
        self._rs_tot_cpu = np.full(n, _EPS_RS, dtype=np.float64)
        self._rs_util_cpu = np.zeros(n, dtype=np.float64)
        #: per-host sum of demands of interruptible-now resident spot VMs
        self._reclaim_ready = np.zeros((n, N_DIMS), dtype=np.float64)
        # min-running-time index: vm_id -> (ready_time, hid) awaiting expiry,
        # vm_id -> hid once folded into _reclaim_ready; heap entries are
        # lazily invalidated against _reclaim_pending.
        self._reclaim_pending: Dict[int, Tuple[float, int]] = {}
        self._reclaim_counted: Dict[int, int] = {}
        self._reclaim_heap: List[Tuple[float, int]] = []
        #: log of hosts whose free capacity increased; consumers remember a
        #: position (``gain_pos``) and later scan the suffix.  Positions are
        #: absolute: ``_gain_base`` counts entries dropped by
        #: :meth:`compact_gain_log`, which bounds memory over long runs.
        self.gain_log: List[int] = []
        self._gain_base = 0
        # scratch buffers for zero-allocation mask computation
        self._scratch_ge = np.zeros((N_DIMS, n), dtype=bool)
        self._scratch_row = np.zeros(n, dtype=bool)
        self._scratch_row2 = np.zeros(n, dtype=bool)
        self._scratch_sum = np.zeros((N_DIMS, n), dtype=np.float64)
        self._scratch_dm = np.zeros(N_DIMS, dtype=np.float64)
        # -- the log of rows written for the device mirror -------------------
        #: row written since the last :meth:`take_changed`
        self._changed = np.zeros(n, dtype=bool)
        #: those rows, in order of first write, each once
        self._changed_rows: List[int] = []
        #: every row is stale (a new pool, or one that grew)
        self._changed_all = True
        #: the device copy of ``free`` and ``spot_frac`` that the scorer keeps
        #: (``core/hlem.py`` ``_FleetMirror``), made by the first scoring call
        #: on a card; it dies with the pool
        self.mirror = None
        # -- market state (inert until enable_market) ------------------------
        #: capacity pool each host belongs to (region / instance class)
        self.pool_of = np.zeros(n, dtype=np.int64)
        self.n_pools = 1
        self._market_on = False
        #: current clearing price of each host's pool (0.0 = everything
        #: admissible until the engine's first tick)
        self._host_price = np.zeros(n, dtype=np.float64)
        self._scratch_adm = np.zeros(n, dtype=bool)
        # dense registry of RUNNING spot VMs for vectorized wave selection and
        # migration-planner scoring: (bid, pool, min-running-time expiry,
        # vm id, host, cpu demand, remaining work at placement, placement
        # time, pool pin, migration-cooldown expiry) with swap-remove
        self._mk_cap = 0
        self._mk_n = 0
        self._mk_bid = np.zeros(0, dtype=np.float64)
        self._mk_ready = np.zeros(0, dtype=np.float64)
        self._mk_pool = np.zeros(0, dtype=np.int64)
        self._mk_vid = np.zeros(0, dtype=np.int64)
        self._mk_hid = np.zeros(0, dtype=np.int64)
        self._mk_cpu = np.zeros(0, dtype=np.float64)
        self._mk_rem0 = np.zeros(0, dtype=np.float64)
        self._mk_t0 = np.zeros(0, dtype=np.float64)
        self._mk_pin = np.zeros(0, dtype=np.int64)
        self._mk_cd = np.zeros(0, dtype=np.float64)
        self._mk_slot: Dict[int, int] = {}
        #: last prices pushed by the engine (hosts added mid-run inherit them)
        self._pool_prices = np.zeros(1, dtype=np.float64)
        #: migration reservations: vm_id -> (dest host, demand) held in
        #: ``used`` (capacity blocked) but NOT in residents/spot_used/the
        #: registry — a reserved slot is neither wave-interruptible nor
        #: reclaimable, and the in-flight VM is resident nowhere (no
        #: double-counting across source and destination)
        self._reserved: Dict[int, Tuple[int, np.ndarray]] = {}

    # -- structural ---------------------------------------------------------
    def _grow(self, need: int) -> None:
        cap = self.total.shape[0]
        if need <= cap:
            return
        new_cap = max(need, cap * 2)
        pad = new_cap - cap

        def vpad(a, fill=0.0):
            return np.vstack([a, np.full((pad, N_DIMS), fill, dtype=np.float64)])

        self.total = vpad(self.total)
        self.used = vpad(self.used)
        self.spot_used = vpad(self.spot_used)
        self.active = np.concatenate([self.active, np.zeros(pad, dtype=bool)])
        self.residents.extend(dict() for _ in range(pad))
        self._planes = np.concatenate(
            [self._planes, np.zeros((2, pad, N_DIMS), dtype=np.float64)],
            axis=1)
        self._free, self._spot_frac = self._planes
        self._free_t = np.hstack(
            [self._free_t, np.zeros((N_DIMS, pad), dtype=np.float64)])
        self._tot_clamped = vpad(self._tot_clamped, _EPS)
        self._rs_tot_cpu = np.concatenate(
            [self._rs_tot_cpu, np.full(pad, _EPS_RS, dtype=np.float64)])
        self._rs_util_cpu = np.concatenate(
            [self._rs_util_cpu, np.zeros(pad, dtype=np.float64)])
        self._reclaim_ready = vpad(self._reclaim_ready)
        self._scratch_ge = np.zeros((N_DIMS, new_cap), dtype=bool)
        self._scratch_row = np.zeros(new_cap, dtype=bool)
        self._scratch_row2 = np.zeros(new_cap, dtype=bool)
        self._scratch_sum = np.zeros((N_DIMS, new_cap), dtype=np.float64)
        self._changed = np.concatenate([self._changed,
                                        np.zeros(pad, dtype=bool)])
        self._changed_all = True
        self.pool_of = np.concatenate(
            [self.pool_of, np.zeros(pad, dtype=np.int64)])
        self._host_price = np.concatenate(
            [self._host_price, np.zeros(pad, dtype=np.float64)])
        self._scratch_adm = np.zeros(new_cap, dtype=bool)

    def _refresh_static_row(self, hid: int) -> None:
        """Recompute capacity-derived caches (host add / capacity update)."""
        np.maximum(self.total[hid], _EPS, out=self._tot_clamped[hid])
        self._rs_tot_cpu[hid] = max(float(self.total[hid, 0]), _EPS_RS)

    def _refresh_row(self, hid: int, spot_changed: bool = True) -> None:
        """Recompute load-derived caches for one host (place/release path)."""
        if self.active[hid]:
            np.subtract(self.total[hid], self.used[hid], out=self._free[hid])
            self._free_t[:, hid] = self._free[hid]
        else:
            self._free[hid] = 0.0
            self._free_t[:, hid] = 0.0
        if spot_changed:
            np.divide(self.spot_used[hid], self._tot_clamped[hid],
                      out=self._spot_frac[hid])
        self._rs_util_cpu[hid] = self.used[hid, 0] / self._rs_tot_cpu[hid]
        if not self._changed[hid]:
            self._changed[hid] = True
            self._changed_rows.append(hid)

    def take_changed(self) -> Optional[List[int]]:
        """The rows whose ``free`` or ``spot_frac`` were written since the
        last call, in order of first write, each once; None when every row
        is stale (the first call, or the pool grew).  Empties the log."""
        rows = None if self._changed_all else self._changed_rows
        if self._changed_all:
            self._changed.fill(False)
        else:
            flags = self._changed
            for hid in rows:
                flags[hid] = False
        self._changed_rows = []
        self._changed_all = False
        return rows

    def _log_gain(self, hid: int) -> None:
        if self.active[hid]:
            self.gain_log.append(hid)

    def add_host(self, capacity: np.ndarray, pool: int = 0) -> int:
        """Register a new host (optionally into capacity pool ``pool``);
        returns its id."""
        hid = self.n_hosts
        self._grow(hid + 1)
        self.total[hid] = np.asarray(capacity, dtype=np.float64)
        self.used[hid] = 0.0
        self.spot_used[hid] = 0.0
        self.active[hid] = True
        self.residents[hid] = dict()
        self.n_hosts += 1
        self._reclaim_ready[hid] = 0.0
        assert pool >= 0, f"pool id must be >= 0, got {pool}"
        if self._market_on:
            # fail fast here instead of at an unrelated later tick: the
            # engine's price vector is sized to its pool count
            assert pool < self._pool_prices.size, (
                f"host pool {pool} out of range for the attached market "
                f"engine ({self._pool_prices.size} pools)")
        self.pool_of[hid] = pool
        self.n_pools = max(self.n_pools, pool + 1)
        self._host_price[hid] = (self._pool_prices[pool]
                                 if pool < self._pool_prices.size else 0.0)
        self._refresh_static_row(hid)
        self._refresh_row(hid)
        self._log_gain(hid)
        self.epoch += 1
        return hid

    def update_host(self, hid: int, capacity: np.ndarray) -> None:
        """Trace 'UPDATE' machine event — change host capacity in place."""
        self.total[hid] = np.asarray(capacity, dtype=np.float64)
        self._refresh_static_row(hid)
        self._refresh_row(hid)
        self._log_gain(hid)  # capacity may have grown; rechecks are cheap
        self.epoch += 1

    def remove_host(self, hid: int) -> List[Vm]:
        """Deactivate a host; returns resident VMs (caller decides their fate)."""
        victims = list(self.residents[hid].values())
        self.active[hid] = False
        self._refresh_row(hid)
        self.epoch += 1
        return victims

    def reactivate_host(self, hid: int) -> None:
        self.active[hid] = True
        self._refresh_row(hid)
        self._log_gain(hid)
        self.epoch += 1

    # -- views --------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.n_hosts

    def free(self) -> np.ndarray:
        """(n_hosts, 4) free capacity (inactive hosts report 0 free).

        Returns a cached read-only-by-convention view; do not mutate."""
        return self._free[: self.n]

    def spot_frac_view(self) -> np.ndarray:
        """(n_hosts, 4) spot_used / total (cached)."""
        return self._spot_frac[: self.n]

    def planes(self) -> np.ndarray:
        """(2, capacity, 4): :meth:`free` and :meth:`spot_frac_view` over
        the pool's whole capacity (rows from ``n`` on are 0), one contiguous
        array (cached; do not mutate)."""
        return self._planes

    def totals(self) -> np.ndarray:
        return self.total[: self.n]

    def used_view(self) -> np.ndarray:
        return self.used[: self.n]

    def spot_used_view(self) -> np.ndarray:
        return self.spot_used[: self.n]

    def active_view(self) -> np.ndarray:
        return self.active[: self.n]

    def reclaim_ready_view(self) -> np.ndarray:
        """(n_hosts, 4) reclaimable (interruptible-now) spot capacity.

        Call :meth:`refresh_reclaim` first so min-running-time expiries up to
        ``now`` are folded in."""
        return self._reclaim_ready[: self.n]

    def cpu_utilization(self) -> np.ndarray:
        tot = self.total[: self.n, 0]
        return np.divide(self.used[: self.n, 0], tot, out=np.zeros(self.n, dtype=np.float64), where=tot > 0)

    def rsdiff_inputs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Cached (clamped cpu totals, cpu utilization) for Eq. 1."""
        return self._rs_tot_cpu[: self.n], self._rs_util_cpu[: self.n]

    # -- feasibility masks (scratch-backed, zero per-call allocation) --------
    def direct_mask_into(self, demand: np.ndarray, bid: float = np.inf,
                         pid: int = -1) -> np.ndarray:
        """Hosts that fit ``demand`` right now (and, in market mode, whose
        pool clears at <= ``bid`` / matches a ``pid`` pin).  Returns a view
        into a scratch buffer — consume (or copy) before the next
        ``*_mask_into`` call."""
        n = self.n
        np.subtract(demand, _EPS, out=self._scratch_dm)
        np.greater_equal(self._free_t[:, :n], self._scratch_dm[:, None],
                         out=self._scratch_ge[:, :n])
        np.logical_and.reduce(self._scratch_ge[:, :n], axis=0,
                              out=self._scratch_row[:n])
        np.logical_and(self._scratch_row[:n], self.active[:n],
                       out=self._scratch_row[:n])
        if (self._market_on and bid != np.inf) or pid >= 0:
            self.market_admit(self._scratch_row[:n], bid, pid)
        return self._scratch_row[:n]

    def clearing_mask_into(self, demand: np.ndarray, bid: float = np.inf,
                           pid: int = -1) -> np.ndarray:
        """Hosts that fit ``demand`` after deallocating interruptible spot VMs
        (§VI-A).  Uses the cached reclaimable sums; callers must
        :meth:`refresh_reclaim` first.  Scratch-backed like
        :meth:`direct_mask_into` (separate buffer, so one direct + one
        clearing mask may be alive simultaneously)."""
        n = self.n
        np.add(self._free_t[:, :n], self._reclaim_ready[:n].T,
               out=self._scratch_sum[:, :n])
        np.subtract(demand, _EPS, out=self._scratch_dm)
        np.greater_equal(self._scratch_sum[:, :n], self._scratch_dm[:, None],
                         out=self._scratch_ge[:, :n])
        np.logical_and.reduce(self._scratch_ge[:, :n], axis=0,
                              out=self._scratch_row2[:n])
        np.logical_and(self._scratch_row2[:n], self.active[:n],
                       out=self._scratch_row2[:n])
        if (self._market_on and bid != np.inf) or pid >= 0:
            self.market_admit(self._scratch_row2[:n], bid, pid)
        return self._scratch_row2[:n]

    def direct_idx_into(self, demand: np.ndarray, bid: float = np.inf,
                        pid: int = -1) -> np.ndarray:
        """Candidate host ids fitting ``demand`` (fresh index array; one
        C-level nonzero pass over the scratch mask)."""
        return self.direct_mask_into(demand, bid, pid).nonzero()[0]

    def direct_mask_batch(self, demands: np.ndarray,
                          bids: Optional[np.ndarray] = None,
                          pids: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, n) feasibility matrix for a batch of demands — one vectorized
        comparison for the whole resubmission queue.  ``bids`` / ``pids``
        (per-row bid and pool pin) apply the market admission of
        :meth:`market_admit` row-wise."""
        demands = np.asarray(demands, dtype=np.float64)
        n = self.n
        ok = np.logical_and.reduce(
            self._free_t[:, None, :n] >= (demands - _EPS).T[:, :, None],
            axis=0)
        ok &= self.active[:n][None]
        if self._market_on and bids is not None:
            finite = np.isfinite(bids)
            if finite.any():
                ok &= ((self._host_price[None, :n] <= bids[:, None] + _EPS)
                       | ~finite[:, None])
        if pids is not None:
            pinned = pids >= 0
            if pinned.any():
                ok &= ((self.pool_of[None, :n] == pids[:, None])
                       | ~pinned[:, None])
        return ok

    # -- allocation ---------------------------------------------------------
    def fits(self, hid: int, demand: np.ndarray) -> bool:
        return bool(
            self.active[hid]
            and np.all(self.total[hid] - self.used[hid] >= demand - _EPS)
        )

    def fits_fast(self, hid: int, demand: np.ndarray) -> bool:
        """Same predicate as :meth:`fits` via the cached free row and scalar
        compares — the gain-log memo filter calls this per (VM, gained host),
        so it must not pay vectorized-numpy call overhead."""
        if not self.active[hid]:
            return False
        f = self._free[hid]
        for k in range(N_DIMS):
            if f[k] < demand[k] - _EPS:
                return False
        return True

    def place(self, vm: Vm, hid: int, now: float = 0.0) -> None:
        assert self.fits_fast(hid, vm.demand), \
            f"host {hid} cannot fit vm {vm.id}"
        spot = vm.vm_type is VmType.SPOT
        self.used[hid] += vm.demand
        if spot:
            self.spot_used[hid] += vm.demand
            self._register_reclaim(vm, hid, now)
            if self._market_on:
                self._mk_add(vm, hid, now)
        self.residents[hid][vm.id] = vm
        vm.host = hid
        self._refresh_row(hid, spot_changed=spot)
        self.epoch += 1

    def release(self, vm: Vm) -> None:
        hid = vm.host
        assert hid >= 0 and vm.id in self.residents[hid], (
            f"vm {vm.id} not resident on host {hid}"
        )
        spot = vm.vm_type is VmType.SPOT
        self.used[hid] -= vm.demand
        # numerical hygiene: clamp tiny negatives from float accumulation
        np.maximum(self.used[hid], 0.0, out=self.used[hid])
        if spot:
            self.spot_used[hid] -= vm.demand
            self._drop_reclaim(vm, hid)
            if self._market_on:
                self._mk_drop(vm.id)
            np.maximum(self.spot_used[hid], 0.0, out=self.spot_used[hid])
        del self.residents[hid][vm.id]
        vm.host = -1
        self._refresh_row(hid, spot_changed=spot)
        self._log_gain(hid)
        self.epoch += 1

    def spot_vms_on(self, hid: int) -> List[Vm]:
        """Resident spot VMs in insertion order (CloudSim host-VM-list order)."""
        return [v for v in self.residents[hid].values() if v.is_spot]

    # -- reclaimable-capacity index ------------------------------------------
    def _register_reclaim(self, vm: Vm, hid: int, now: float) -> None:
        if vm.min_running_time <= 0.0:
            self._reclaim_ready[hid] += vm.demand
            self._reclaim_counted[vm.id] = hid
        else:
            ready = now + vm.min_running_time
            self._reclaim_pending[vm.id] = (ready, hid)
            heapq.heappush(self._reclaim_heap, (ready, vm.id))

    def _drop_reclaim(self, vm: Vm, hid: int) -> None:
        counted = self._reclaim_counted.pop(vm.id, None)
        if counted is not None:
            self._reclaim_ready[hid] -= vm.demand
            np.clip(self._reclaim_ready[hid], 0.0, None,
                    out=self._reclaim_ready[hid])
        else:
            self._reclaim_pending.pop(vm.id, None)

    def mark_uninterruptible(self, vm: Vm) -> None:
        """Remove a still-resident spot VM from the reclaimable pool (it has
        left RUNNING, e.g. received an interruption warning)."""
        if vm.host >= 0:
            self._drop_reclaim(vm, vm.host)
            if self._market_on:
                self._mk_drop(vm.id)
            self.epoch += 1

    def refresh_reclaim(self, now: float) -> None:
        """Fold min-running-time expiries up to ``now`` into the reclaimable
        sums.  O(expired log n); O(1) when nothing expired."""
        heap = self._reclaim_heap
        while heap and heap[0][0] <= now:
            ready, vid = heapq.heappop(heap)
            ent = self._reclaim_pending.get(vid)
            if ent is None or ent[0] != ready:
                continue  # stale heap entry (VM released / re-placed)
            del self._reclaim_pending[vid]
            hid = ent[1]
            vm = self.residents[hid].get(vid)
            if vm is None or not vm.is_spot or vm.state is not VmState.RUNNING:
                continue
            self._reclaim_ready[hid] += vm.demand
            self._reclaim_counted[vid] = hid
            self.epoch += 1

    # -- market mode ---------------------------------------------------------
    def enable_market(self, n_pools: int) -> None:
        """Switch on price admission + the wave-selection registry.  Must be
        called before any spot VM is placed (the registry mirrors placements
        from this point on)."""
        assert self._mk_n == 0 and not any(
            v.is_spot for r in self.residents[: self.n] for v in r.values()
        ), "enable_market must precede spot placements"
        assert int(self.pool_of[: self.n].max(initial=-1)) < n_pools, (
            "existing hosts reference pools beyond the engine's pool count")
        self._market_on = True
        self.n_pools = max(self.n_pools, n_pools)
        if self._pool_prices.size < self.n_pools:
            self._pool_prices = np.zeros(self.n_pools, dtype=np.float64)

    @property
    def market_on(self) -> bool:
        return self._market_on

    def set_pool_prices(self, prices: np.ndarray) -> None:
        """Push per-pool clearing prices down to the per-host price row.

        A price *drop* re-opens hosts to queued spot VMs whose bid now
        clears; those hosts are appended to the gain log so the resubmission
        memo rechecks exactly the VMs that might benefit (``fits_fast`` is
        capacity-only, which is conservative but correct: the full mask still
        applies price admission).  Price rises only shrink masks, so existing
        memos stay valid.
        """
        prices = np.asarray(prices, dtype=np.float64)
        n = self.n
        self._pool_prices = prices.copy()
        new = prices[self.pool_of[:n]]
        np.less(new, self._host_price[:n] - 1e-15, out=self._scratch_adm[:n])
        np.logical_and(self._scratch_adm[:n], self.active[:n],
                       out=self._scratch_adm[:n])
        if self._scratch_adm[:n].any():
            self.gain_log.extend(np.flatnonzero(self._scratch_adm[:n]).tolist())
        self._host_price[:n] = new
        self.epoch += 1

    def market_admit(self, row_mask: np.ndarray, bid: float,
                     pid: int) -> np.ndarray:
        """AND market admission into ``row_mask`` in place: hosts whose pool
        clears at <= ``bid`` (skipped for infinite bids / market off) and —
        when ``pid >= 0`` — hosts belonging to pool ``pid``."""
        n = self.n
        if self._market_on and bid != np.inf:
            np.less_equal(self._host_price[:n], bid + _EPS,
                          out=self._scratch_adm[:n])
            np.logical_and(row_mask, self._scratch_adm[:n], out=row_mask)
        if pid >= 0:
            np.equal(self.pool_of[:n], pid, out=self._scratch_adm[:n])
            np.logical_and(row_mask, self._scratch_adm[:n], out=row_mask)
        return row_mask

    def pool_cpu_utilization(self) -> np.ndarray:
        """(n_pools,) CPU utilization per capacity pool over active hosts —
        the demand signal driving each pool's price process."""
        n = self.n
        act = self.active[:n]
        pools = self.pool_of[:n][act]
        used = np.bincount(pools, weights=self.used[:n, 0][act],
                           minlength=self.n_pools)
        tot = np.bincount(pools, weights=self.total[:n, 0][act],
                          minlength=self.n_pools)
        return np.divide(used, tot, out=np.zeros(self.n_pools, dtype=np.float64),
                         where=tot > 0)

    # -- market registry (vectorized wave selection) -------------------------
    def _mk_grow(self, need: int) -> None:
        if need <= self._mk_cap:
            return
        cap = max(need, max(self._mk_cap * 2, 64))

        def pad(a, dtype):
            out = np.zeros(cap, dtype=dtype)
            out[: a.size] = a
            return out

        self._mk_bid = pad(self._mk_bid, np.float64)
        self._mk_ready = pad(self._mk_ready, np.float64)
        self._mk_pool = pad(self._mk_pool, np.int64)
        self._mk_vid = pad(self._mk_vid, np.int64)
        self._mk_hid = pad(self._mk_hid, np.int64)
        self._mk_cpu = pad(self._mk_cpu, np.float64)
        self._mk_rem0 = pad(self._mk_rem0, np.float64)
        self._mk_t0 = pad(self._mk_t0, np.float64)
        self._mk_pin = pad(self._mk_pin, np.int64)
        self._mk_cd = pad(self._mk_cd, np.float64)
        self._mk_cap = cap

    def _mk_add(self, vm: Vm, hid: int, now: float) -> None:
        i = self._mk_n
        self._mk_grow(i + 1)
        self._mk_bid[i] = vm.bid
        self._mk_ready[i] = now + vm.min_running_time
        self._mk_pool[i] = self.pool_of[hid]
        self._mk_vid[i] = vm.id
        self._mk_hid[i] = hid
        self._mk_cpu[i] = vm.demand[0]
        self._mk_rem0[i] = vm.remaining
        self._mk_t0[i] = now
        self._mk_pin[i] = vm.pool
        self._mk_cd[i] = vm.migrate_cooldown_until
        self._mk_slot[vm.id] = i
        self._mk_n = i + 1

    def _mk_drop(self, vid: int) -> None:
        i = self._mk_slot.pop(vid, None)
        if i is None:
            return
        last = self._mk_n - 1
        if i != last:  # swap-remove keeps the arrays dense
            self._mk_bid[i] = self._mk_bid[last]
            self._mk_ready[i] = self._mk_ready[last]
            self._mk_pool[i] = self._mk_pool[last]
            self._mk_hid[i] = self._mk_hid[last]
            self._mk_cpu[i] = self._mk_cpu[last]
            self._mk_rem0[i] = self._mk_rem0[last]
            self._mk_t0[i] = self._mk_t0[last]
            self._mk_pin[i] = self._mk_pin[last]
            self._mk_cd[i] = self._mk_cd[last]
            moved = int(self._mk_vid[last])
            self._mk_vid[i] = moved
            self._mk_slot[moved] = i
        self._mk_n = last

    def market_registry(self) -> Dict[str, np.ndarray]:
        """Read-only views of the dense RUNNING-spot registry, length
        ``_mk_n`` — the migration planner's scoring input.  Valid until the
        next pool mutation; do not hold across events."""
        m = self._mk_n
        return {
            "vid": self._mk_vid[:m], "bid": self._mk_bid[:m],
            "pool": self._mk_pool[:m], "hid": self._mk_hid[:m],
            "cpu": self._mk_cpu[:m], "rem0": self._mk_rem0[:m],
            "t0": self._mk_t0[:m], "ready": self._mk_ready[:m],
            "pin": self._mk_pin[:m], "cooldown": self._mk_cd[:m],
        }

    def market_victims(self, prices: np.ndarray,
                       now: float) -> Tuple[np.ndarray, np.ndarray]:
        """(victim vm ids, their pools): running spot VMs past their minimum
        running time whose bid is strictly below their pool's clearing price.
        One masked comparison over the dense registry — no per-VM walk."""
        m = self._mk_n
        if m == 0:
            empty = np.zeros(0, dtype=np.int64)
            return empty, empty
        pools = self._mk_pool[:m]
        mask = self._mk_bid[:m] < np.asarray(prices, float)[pools] - _EPS
        mask &= self._mk_ready[:m] <= now + _EPS
        return self._mk_vid[:m][mask].copy(), pools[mask].copy()

    # -- migration reservations ----------------------------------------------
    def reserve(self, vm: Vm, hid: int) -> None:
        """Hold ``vm.demand`` on ``hid`` for an in-flight migration.  The
        capacity is blocked in ``used`` (feasibility masks and the pool
        utilization signal see it) but the VM is resident nowhere: not in
        ``residents``/``spot_used``, not reclaimable, not wave-interruptible.
        """
        assert vm.id not in self._reserved, f"vm {vm.id} already reserved"
        assert self.fits_fast(hid, vm.demand), (
            f"host {hid} cannot hold reservation for vm {vm.id}")
        self.used[hid] += vm.demand
        self._reserved[vm.id] = (hid, vm.demand.copy())
        self._refresh_row(hid, spot_changed=False)
        self.epoch += 1

    def release_reservation(self, vm_id: int) -> int:
        """Drop a migration reservation (arrival commit or failed flight);
        returns the host it was held on."""
        hid, demand = self._reserved.pop(vm_id)
        self.used[hid] -= demand
        np.maximum(self.used[hid], 0.0, out=self.used[hid])
        self._refresh_row(hid, spot_changed=False)
        self._log_gain(hid)
        self.epoch += 1
        return hid

    def stamp_migration_cooldown(self, vm: Vm, until: float) -> None:
        """Black the VM out of migration planning until ``until``, updating
        the live registry row in place (the column is otherwise only read
        from the VM at placement time).  Used when a planned move finds no
        destination host — without the stamp, a pool-level-feasible but
        host-level-infeasible VM would re-top the plan ranking every tick."""
        vm.migrate_cooldown_until = until
        i = self._mk_slot.get(vm.id)
        if i is not None:
            self._mk_cd[i] = until

    def price_clears(self, hid: int, bid: float) -> bool:
        """Does ``hid``'s pool currently clear at <= ``bid``?  (Always true
        with the market off or an infinite bid.)"""
        if not self._market_on or bid == np.inf:
            return True
        return bool(self._host_price[hid] <= bid + _EPS)

    def pool_free_cpu(self) -> np.ndarray:
        """(n_pools,) free CPU per capacity pool over active hosts — the
        migration planner's destination-headroom signal (reservations are
        already inside ``used``, hence excluded from ``free``)."""
        n = self.n
        act = self.active[:n]
        return np.bincount(self.pool_of[:n][act],
                           weights=self._free[:n, 0][act],
                           minlength=self.n_pools)

    def pool_total_cpu(self) -> np.ndarray:
        """(n_pools,) total CPU per capacity pool over active hosts — the
        denominator of the planner's price-impact estimate."""
        n = self.n
        act = self.active[:n]
        return np.bincount(self.pool_of[:n][act],
                           weights=self.total[:n, 0][act],
                           minlength=self.n_pools)

    # -- gain log ------------------------------------------------------------
    def gain_pos(self) -> int:
        """Current (absolute) position in the gain log; pass to
        :meth:`gained_since`."""
        return self._gain_base + len(self.gain_log)

    def gained_since(self, pos: int) -> List[int]:
        """Host ids whose free capacity increased since ``pos``."""
        start = pos - self._gain_base
        if start <= 0:
            return self.gain_log[:]
        return self.gain_log[start:]

    def compact_gain_log(self, min_live_pos: int) -> None:
        """Drop log entries before ``min_live_pos`` (the smallest position any
        consumer still holds).  Keeps memory bounded over trace-length runs;
        absolute positions remain valid."""
        drop = min(min_live_pos - self._gain_base, len(self.gain_log))
        if drop > 0:
            del self.gain_log[:drop]
            self._gain_base += drop

    # -- invariant checks (used by property tests) ---------------------------
    def check_invariants(self, now: Optional[float] = None) -> None:
        n = self.n
        reserved_sum = np.zeros((n, N_DIMS), dtype=np.float64)
        for _vid, (rhid, dem) in self._reserved.items():
            reserved_sum[rhid] += dem
        for hid in range(n):
            res = sum(
                (v.demand for v in self.residents[hid].values()),
                np.zeros(N_DIMS, dtype=np.float64),
            ) + reserved_sum[hid]
            assert np.allclose(res, self.used[hid], atol=1e-6), (
                f"host {hid}: used {self.used[hid]} != resident+reserved sum "
                f"{res}"
            )
            spot = sum(
                (v.demand for v in self.residents[hid].values() if v.is_spot),
                np.zeros(N_DIMS, dtype=np.float64),
            )
            assert np.allclose(spot, self.spot_used[hid], atol=1e-6)
            assert np.all(self.used[hid] <= self.total[hid] + 1e-6), (
                f"host {hid} over capacity: {self.used[hid]} > {self.total[hid]}"
            )
        # cached arrays vs from-scratch recomputation
        f = np.where(self.active[:n, None], self.total[:n] - self.used[:n], 0.0)
        assert np.allclose(f, self._free[:n], atol=1e-9), "stale free cache"
        assert np.array_equal(self._free_t[:, :n], self._free[:n].T), (
            "free mirror differs from the free cache")
        sf = self.spot_used[:n] / np.maximum(self.total[:n], _EPS)
        assert np.allclose(sf, self._spot_frac[:n], atol=1e-12), (
            "stale spot_frac cache")
        # the change log, and the device mirror outside it (one D2H copy)
        assert len(self._changed_rows) <= n
        assert len(set(self._changed_rows)) == len(self._changed_rows)
        assert np.array_equal(np.flatnonzero(self._changed),
                              np.sort(np.asarray(self._changed_rows, int)))
        held = None if self.mirror is None else self.mirror.held(n)
        if held is not None and not self._changed_all:
            m = held.shape[1]
            keep = ~self._changed[:m]
            assert self._changed[m:n].all(), (
                "rows beyond the mirror's planes missing from the change log")
            assert np.array_equal(held[0][keep], self._free[:m][keep]), (
                "device mirror of free differs outside the change log")
            assert np.array_equal(held[1][keep], self._spot_frac[:m][keep]), (
                "device mirror of spot_frac differs outside the change log")
        tc = np.maximum(self.total[:n, 0], _EPS_RS)
        assert np.allclose(tc, self._rs_tot_cpu[:n])
        assert np.allclose(self.used[:n, 0] / tc, self._rs_util_cpu[:n])
        # reclaim index: every counted VM is a resident spot VM; per-host sums
        # match; every RUNNING resident spot VM is tracked exactly once
        ready_sum = np.zeros((n, N_DIMS), dtype=np.float64)
        for vid, hid in self._reclaim_counted.items():
            vm = self.residents[hid].get(vid)
            assert vm is not None and vm.is_spot, (
                f"reclaim-counted vm {vid} not a resident spot VM of {hid}")
            ready_sum[hid] += vm.demand
        assert np.allclose(ready_sum, self._reclaim_ready[:n], atol=1e-6), (
            "stale reclaim_ready cache")
        for hid in range(n):
            for vm in self.residents[hid].values():
                if vm.is_spot and vm.state is VmState.RUNNING:
                    assert (vm.id in self._reclaim_counted
                            or vm.id in self._reclaim_pending), (
                        f"running spot vm {vm.id} missing from reclaim index")
        if now is not None:
            self.refresh_reclaim(now)
            for hid in range(n):
                expect = sum(
                    (v.demand for v in self.residents[hid].values()
                     if v.interruptible(now)),
                    np.zeros(N_DIMS, dtype=np.float64),
                )
                assert np.allclose(expect, self._reclaim_ready[hid],
                                   atol=1e-6), (
                    f"host {hid}: reclaimable {self._reclaim_ready[hid]} != "
                    f"interruptible sum {expect} at t={now}")
        if self._market_on:
            # market registry mirrors RUNNING resident spot VMs exactly
            assert len(self._mk_slot) == self._mk_n
            for vid, i in self._mk_slot.items():
                assert int(self._mk_vid[i]) == vid
            running = {v.id for hid in range(n)
                       for v in self.residents[hid].values()
                       if v.is_spot and v.state is VmState.RUNNING}
            assert set(self._mk_slot) == running, (
                f"market registry {set(self._mk_slot)} != running spot "
                f"{running}")
            for hid in range(n):
                for v in self.residents[hid].values():
                    if v.id in self._mk_slot:
                        i = self._mk_slot[v.id]
                        assert self._mk_bid[i] == v.bid
                        assert int(self._mk_pool[i]) == int(self.pool_of[hid])
                        assert int(self._mk_hid[i]) == hid
                        assert self._mk_cpu[i] == v.demand[0]
                        assert int(self._mk_pin[i]) == v.pool
                        assert self._mk_cd[i] == v.migrate_cooldown_until
