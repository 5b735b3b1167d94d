"""VM allocation policies (paper §II-D, §VI).

Each policy implements ``find_host(vm, pool, now, allow_spot_clearing)`` and
returns ``(host_id, needs_clearing)``; ``host_id == -1`` means no placement.
``needs_clearing`` signals that the chosen host only becomes feasible after
interrupting (some of) its spot VMs — the simulator performs the actual victim
selection and interruption (DynamicAllocation.spotAllocation in the paper).

Spot-clearing feasibility counts only *interruptible* spot VMs: those past
their minimum running time (§IV-B "minimum runtime must be enforced") — the
pool maintains that sum incrementally (see ``hosts.HostPool``), so both masks
are single vectorized comparisons against cached arrays.

Batched paths (clearing is never considered: queued VMs do not trigger new
preemption cascades, see simulator._flush_pending):

* ``find_first_direct(vms, pool)`` is the engine of the simulator's batched
  flush — one feasibility matrix decides which VM places, then a single-row
  scoring pass (bit-identical to the per-VM path) picks its host;
* ``find_hosts_batch(vms, pool, now)`` decides ALL rows in one shot (one
  feasibility matrix + one batched HLEM scoring pass) for offline/accelerator
  use; rows match per-VM ``find_host`` up to float summation order (a
  near-tie argmax can differ at the ulp level).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .hlem import (
    hlem_pick_candidates_np,
    hlem_pick_np,
    hlem_scores_batch_np,
    hlem_select_batch_torch,
    hlem_select_batch_torch_traced,
    hlem_select_torch,
    hlem_select_torch_traced,
    resolve_device,
)
from .hosts import HostPool
from ..obs.tracer import NULL_TRACER
from .registry import Registry
from .types import Vm

_EPS = 1e-9

#: string-keyed plugin registry for allocation policies — the scenario API's
#: extension point.  Register custom policies with
#: ``@register_policy("my-policy")``; ``make_policy`` and ``PolicySpec``
#: resolve against it.
POLICY_REGISTRY = Registry("allocation policy")
register_policy = POLICY_REGISTRY.register


def direct_mask(vm: Vm, pool: HostPool) -> np.ndarray:
    """Hosts that fit the demand right now (fresh array; hot paths use
    ``pool.direct_mask_into`` which is scratch-backed)."""
    return pool.direct_mask_into(vm.demand, vm.bid, vm.pool).copy()


def clearing_mask(vm: Vm, pool: HostPool, now: float) -> np.ndarray:
    """Hosts that would fit the demand after deallocating their interruptible
    spot VMs (§VI-A: "checks the potential capacity of hosts if active spot
    instances were to be deallocated").

    One vectorized comparison against the pool's incrementally maintained
    reclaimable-capacity cache; min-running-time expiries up to ``now`` are
    folded in first.
    """
    pool.refresh_reclaim(now)
    return pool.clearing_mask_into(vm.demand, vm.bid, vm.pool).copy()


def feasibility_masks(vm: Vm, pool: HostPool, now: float):
    """(direct_mask, clearing_mask) — kept for tests; prefer the lazy pair."""
    return direct_mask(vm, pool), clearing_mask(vm, pool, now)


class AllocationPolicy:
    """Host selection.  Its entries (``find_host``, ``find_direct``,
    ``find_first_direct``, ``find_hosts_batch``, ``_pick_direct``) are one
    placement decision each.  With an enabled ``tracer``, the outermost entry
    of a decision is a ``policy/<entry>`` span (category ``policy``, args
    ``{"vm": id}`` where records are kept), holding ``policy/filter`` (the
    direct or clearing mask, market admission, the RsDiff mask) and
    ``policy/feasibility`` (the queue x fleet matrix) spans and, on the torch
    scorer, ``policy/stage``, ``policy/launch`` and ``policy/select``
    (``core/hlem.py``).  Without one, each site costs one attribute load."""

    name = "abstract"

    #: telemetry hook (``repro.obs``); the build layer swaps in the live
    #: tracer — decision spans and scoring counters land in it
    tracer = NULL_TRACER
    #: set while a traced decision's outermost entry runs: nested entries
    #: then open no span of their own
    _deciding = False
    #: the running traced decision's span args (None without records)
    _span_args = None

    def _decision(self, entry: str, vm_id: int, fn, *args):
        """``fn(self, *args)`` — the entry ``entry``, re-entered — inside the
        decision's ``policy/<entry>`` span (the tracer is enabled)."""
        tr = self.tracer
        self._span_args = {"vm": int(vm_id)} if tr.keep_records else None
        self._deciding = True
        tr.begin("policy", "policy/" + entry)
        try:
            out = fn(self, *args)
        finally:
            self._deciding = False
        tr.end(tr.sim_t, self._span_args)
        return out

    def _end_span(self) -> None:
        """Close a child span of the running decision."""
        tr = self.tracer
        tr.end(tr.sim_t, self._span_args)

    def _pick(self, mask: np.ndarray, vm: Vm, pool: HostPool) -> int:
        raise NotImplementedError

    def find_host(
        self, vm: Vm, pool: HostPool, now: float, allow_spot_clearing: bool
    ) -> Tuple[int, bool]:
        tr = self.tracer
        if tr.enabled:
            if not self._deciding:
                return self._decision("find_host", vm.id,
                                      AllocationPolicy.find_host, vm, pool,
                                      now, allow_spot_clearing)
            tr.begin("policy", "policy/filter")
        mask = pool.direct_mask_into(vm.demand, vm.bid, vm.pool)
        if tr.enabled:
            self._end_span()
        hid = self._pick(mask, vm, pool)
        if hid >= 0:
            return hid, False
        if allow_spot_clearing and not vm.is_spot:
            if tr.enabled:
                tr.begin("policy", "policy/filter")
            pool.refresh_reclaim(now)
            mask = pool.clearing_mask_into(vm.demand, vm.bid, vm.pool)
            if tr.enabled:
                self._end_span()
            hid = self._pick(mask, vm, pool)
            if hid >= 0:
                return hid, True
        return -1, False

    def _pick_direct(self, mask: np.ndarray, vm: Vm, pool: HostPool) -> int:
        """Select from a direct-feasibility mask; >= 0 whenever mask is
        non-empty.  Shared by ``find_host`` and the batched flush."""
        if self.tracer.enabled and not self._deciding:
            return self._decision("_pick_direct", vm.id,
                                  AllocationPolicy._pick_direct, mask, vm,
                                  pool)
        return self._pick(mask, vm, pool)

    def find_direct(self, vm: Vm, pool: HostPool) -> int:
        """Direct placement only (no spot clearing): chosen host or -1."""
        tr = self.tracer
        if tr.enabled:
            if not self._deciding:
                return self._decision("find_direct", vm.id,
                                      AllocationPolicy.find_direct, vm, pool)
            tr.begin("policy", "policy/filter")
        mask = pool.direct_mask_into(vm.demand, vm.bid, vm.pool)
        if tr.enabled:
            self._end_span()
        if not mask.any():
            return -1
        return self._pick_direct(mask, vm, pool)

    # -- batched path --------------------------------------------------------
    def find_hosts_batch(
        self, vms: Sequence[Vm], pool: HostPool, now: float
    ) -> np.ndarray:
        """(B,) chosen host per VM (-1 = none), direct placements only.

        Row b matches ``find_host(vms[b], ...)`` against the same pool state
        with spot clearing ignored (for HLEM, up to float summation order in
        the batched scorer).  The result is only valid until the pool mutates
        (committing one row invalidates the rest)."""
        tr = self.tracer
        if tr.enabled:
            if not self._deciding:
                return self._decision("find_hosts_batch", vms[0].id,
                                      AllocationPolicy.find_hosts_batch, vms,
                                      pool, now)
            tr.begin("policy", "policy/feasibility")
        demands = np.stack([vm.demand for vm in vms])
        bids = np.array([vm.bid for vm in vms])
        pids = np.array([vm.pool for vm in vms], dtype=np.int64)
        feas = pool.direct_mask_batch(demands, bids, pids)
        if tr.enabled:
            self._end_span()
        return self._pick_batch(feas, vms, pool)

    def find_first_direct(
        self, vms: Sequence[Vm], pool: HostPool
    ) -> Tuple[int, int]:
        """(index, host) of the first VM in ``vms`` that fits somewhere right
        now, or (B, -1) if none does.

        One vectorized feasibility matrix decides *which* VM places (a VM
        places iff its feasibility row is non-empty); scoring then runs for
        that single row only.  This is the engine of the batched flush: the
        greedy commit loop re-decides only the suffix after each placement,
        so scoring work is one pass per placement instead of per queued VM."""
        nvm = len(vms)
        tr = self.tracer
        if tr.enabled:
            if not self._deciding:
                return self._decision("find_first_direct", vms[0].id,
                                      AllocationPolicy.find_first_direct,
                                      vms, pool)
            tr.counters.inc("alloc/batch_rows", nvm)
            tr.begin("policy", "policy/feasibility")
        demands = np.empty((nvm, vms[0].demand.shape[0]))
        bids = np.empty(nvm)
        pids = np.empty(nvm, dtype=np.int64)
        for b, vm in enumerate(vms):
            demands[b] = vm.demand
            bids[b] = vm.bid
            pids[b] = vm.pool
        feas = pool.direct_mask_batch(demands, bids, pids)
        any_row = feas.any(axis=1)
        if tr.enabled:
            self._end_span()
        for b in np.flatnonzero(any_row):
            return int(b), self._pick_direct(feas[b], vms[b], pool)
        return nvm, -1

    def _pick_batch(self, feas: np.ndarray, vms: Sequence[Vm],
                    pool: HostPool) -> np.ndarray:
        # generic fallback: per-row _pick on the shared feasibility matrix
        return np.array([self._pick(feas[b], vms[b], pool)
                         for b in range(feas.shape[0])], dtype=np.int64)


class FirstFit(AllocationPolicy):
    """CloudSim Plus baseline: first host (insertion order) that fits."""

    name = "first-fit"

    def _pick(self, mask, vm, pool):
        idx = np.flatnonzero(mask)
        return int(idx[0]) if idx.size else -1

    def _pick_batch(self, feas, vms, pool):
        any_row = feas.any(axis=1)
        return np.where(any_row, feas.argmax(axis=1), -1)


class BestFit(AllocationPolicy):
    """Host with the least free CPU that still fits (tightest packing)."""

    name = "best-fit"

    def _pick(self, mask, vm, pool):
        if not mask.any():
            return -1
        free_cpu = np.where(mask, pool.free()[:, 0], np.inf)
        return int(np.argmin(free_cpu))

    def _pick_batch(self, feas, vms, pool):
        any_row = feas.any(axis=1)
        free_cpu = np.where(feas, pool.free()[None, :, 0], np.inf)
        return np.where(any_row, free_cpu.argmin(axis=1), -1)


class WorstFit(AllocationPolicy):
    """Host with the most free CPU (max headroom)."""

    name = "worst-fit"

    def _pick(self, mask, vm, pool):
        if not mask.any():
            return -1
        free_cpu = np.where(mask, pool.free()[:, 0], -np.inf)
        return int(np.argmax(free_cpu))

    def _pick_batch(self, feas, vms, pool):
        any_row = feas.any(axis=1)
        free_cpu = np.where(feas, pool.free()[None, :, 0], -np.inf)
        return np.where(any_row, free_cpu.argmax(axis=1), -1)


class HlemVmp(AllocationPolicy):
    """HLEM-VMP (paper §VI-A/B).

    Phase 1 filters feasible hosts and applies the RsDiff threshold (Eqs. 1–2);
    if that leaves no candidate, the threshold filter is relaxed (and, for
    on-demand VMs, the spot-clearing candidate list is used — Algorithm 1).
    Phases 2–3 score candidates with entropy weights and pick the max.

    ``backend="torch"`` (the default) scores the full fleet in float64 on
    ``device`` (default ``"cuda"``: the hand-written kernel; ``"cpu"``: its
    plain PyTorch version); ``backend="numpy"`` runs the float64 oracle on
    the compressed candidate set.  Both compute the float64 math of the
    reference's default (numpy) scorer.  A CUDA device without a card
    raises here, when the policy is built.
    """

    name = "hlem-vmp"
    #: adjusted-variant knobs (unused in the base class)
    alpha = 0.0
    adjust_spot_only = True

    def __init__(self, rc: float = 0.95, threshold: float = 0.0,
                 backend: str = "torch", device="cuda"):
        self.rc = rc
        self.threshold = threshold
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {backend!r}: 'numpy' or 'torch'")
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" else None

    # -- phase 1 ------------------------------------------------------------
    def _rsdiff_ok(self, vm: Vm, pool: HostPool) -> np.ndarray:
        tot, util = pool.rsdiff_inputs()
        rs = vm.demand[0] / tot - util * self.rc
        return rs > self.threshold

    # -- phases 2-3 ---------------------------------------------------------
    def _alpha_for(self, vm: Vm) -> float:
        if self.alpha != 0.0 and (vm.is_spot or not self.adjust_spot_only):
            return self.alpha
        return 0.0

    def _score_pick(self, mask: np.ndarray, vm: Vm, pool: HostPool) -> int:
        if not mask.any():
            return -1
        free = pool.free()
        spot_frac = pool.spot_frac_view()
        alpha = self._alpha_for(vm)
        if self.backend == "torch":
            tr = self.tracer
            if tr.enabled:
                return hlem_select_torch_traced(
                    tr, self._span_args, free, mask, spot_frac, alpha,
                    self.device)
            return hlem_select_torch(free, mask, spot_frac, alpha,
                                     self.device)
        return hlem_pick_np(free, mask, spot_frac, alpha)

    def _pick_direct(self, mask, vm, pool):
        tr = self.tracer
        if tr.enabled and not self._deciding:
            return self._decision("_pick_direct", vm.id, HlemVmp._pick_direct,
                                  mask, vm, pool)
        # primary candidate list: feasible AND RsDiff above threshold;
        # relaxed to plain feasibility if that leaves no candidate
        if self.backend == "torch":
            if tr.enabled:
                tr.begin("policy", "policy/filter")
            primary = mask & self._rsdiff_ok(vm, pool)
            if tr.enabled:
                self._end_span()
            hid = self._score_pick(primary, vm, pool)
            if hid >= 0:
                return hid
            if tr.enabled:
                tr.counters.inc("hlem/rescored")
            return self._score_pick(mask, vm, pool)
        # numpy hot path: compress once, apply Eqs. 1-2 on the candidates only
        return self._pick_direct_idx(np.flatnonzero(mask), vm, pool)

    def _pick_direct_idx(self, idx: np.ndarray, vm, pool) -> int:
        if idx.size == 0:
            return -1
        if idx.size == 1:
            return int(idx[0])  # RsDiff filtering cannot change a 1-set pick
        tr = self.tracer
        if tr.enabled:
            tr.begin("policy", "policy/filter")
        tot, util = pool.rsdiff_inputs()
        rs_ok = (vm.demand[0] / tot[idx] - util[idx] * self.rc
                 ) > self.threshold
        cand = idx[rs_ok] if rs_ok.any() else idx
        if tr.enabled:
            self._end_span()
        return hlem_pick_candidates_np(
            pool.free(), cand, pool.spot_frac_view(), self._alpha_for(vm))

    def find_host(self, vm, pool, now, allow_spot_clearing):
        tr = self.tracer
        if tr.enabled:
            if not self._deciding:
                return self._decision("find_host", vm.id, HlemVmp.find_host,
                                      vm, pool, now, allow_spot_clearing)
            tr.begin("policy", "policy/filter")
        if self.backend == "torch":
            direct = pool.direct_mask_into(vm.demand, vm.bid, vm.pool)
            if tr.enabled:
                self._end_span()
            if direct.any():
                return self._pick_direct(direct, vm, pool), False
        else:
            idx = pool.direct_idx_into(vm.demand, vm.bid, vm.pool)
            if tr.enabled:
                self._end_span()
            if idx.size:
                return self._pick_direct_idx(idx, vm, pool), False
        # spot-clearing list (Algorithm 1, lines 8-10) — on-demand only
        if allow_spot_clearing and not vm.is_spot:
            if tr.enabled:
                tr.begin("policy", "policy/filter")
            pool.refresh_reclaim(now)
            clearing = pool.clearing_mask_into(vm.demand, vm.bid, vm.pool)
            if tr.enabled:
                self._end_span()
            if clearing.any():
                return self._pick_direct(clearing, vm, pool), True
        return -1, False

    def find_direct(self, vm, pool):
        if self.backend == "torch":
            return super().find_direct(vm, pool)
        tr = self.tracer
        if tr.enabled:
            if not self._deciding:
                return self._decision("find_direct", vm.id,
                                      HlemVmp.find_direct, vm, pool)
            tr.begin("policy", "policy/filter")
        idx = pool.direct_idx_into(vm.demand, vm.bid, vm.pool)
        if tr.enabled:
            self._end_span()
        return self._pick_direct_idx(idx, vm, pool)

    def _pick_batch(self, feas, vms, pool):
        B = feas.shape[0]
        out = np.full(B, -1, dtype=np.int64)
        rows = np.flatnonzero(feas.any(axis=1))
        if rows.size == 0:
            return out
        tr = self.tracer
        if tr.enabled:
            tr.begin("policy", "policy/filter")
        # Eqs. 1-2 vectorized over the batch: rs[b, i] for every (VM, host)
        tot, util = pool.rsdiff_inputs()
        demands_cpu = np.array([vms[b].demand[0] for b in rows])
        rs_ok = (demands_cpu[:, None] / tot[None] - util[None] * self.rc
                 ) > self.threshold
        primary = feas[rows] & rs_ok
        use_primary = primary.any(axis=1)
        masks = np.where(use_primary[:, None], primary, feas[rows])
        if tr.enabled:
            self._end_span()
        alphas = np.array([self._alpha_for(vms[b]) for b in rows])
        if self.backend == "torch":
            if tr.enabled:
                out[rows] = hlem_select_batch_torch_traced(
                    tr, self._span_args, pool.free(), masks,
                    pool.spot_frac_view(), alphas, self.device)
                return out
            out[rows] = hlem_select_batch_torch(
                pool.free(), masks, pool.spot_frac_view(), alphas, self.device)
            return out
        scores = hlem_scores_batch_np(
            pool.free(), masks, pool.spot_frac_view(), alphas)
        out[rows] = np.argmax(scores, axis=1)
        return out


class HlemVmpAdjusted(HlemVmp):
    """Adjusted HLEM-VMP (§VI-C): spot-load-aware score AHS = HS*(1+α·SL).

    With α < 0 (default -0.5) spot-heavy hosts are penalized when placing spot
    VMs, spreading spot load across hosts to reduce interruption counts.
    ``adjust_spot_only=False`` applies the adjustment to on-demand placement
    too (then on-demand avoids spot-heavy hosts as well — fewer preemptions,
    beyond-paper variant benchmarked in EXPERIMENTS.md).
    """

    name = "hlem-vmp-adjusted"

    def __init__(self, rc: float = 0.95, threshold: float = 0.0,
                 alpha: float = -0.5, adjust_spot_only: bool = True,
                 backend: str = "torch", device="cuda"):
        super().__init__(rc=rc, threshold=threshold, backend=backend,
                         device=device)
        self.alpha = alpha
        self.adjust_spot_only = adjust_spot_only


# Registered by each class's ``name`` attribute rather than by a decorator
# with a string literal: the determinism lint keys plugin names by literal
# across the whole source tree, and the JAX package registers these names.
for _cls in (FirstFit, BestFit, WorstFit, HlemVmp, HlemVmpAdjusted):
    POLICY_REGISTRY.register(_cls.name, _cls)

#: live name → class view of the registry (kept for backward compatibility;
#: register new policies via ``register_policy``, not by mutating this)
POLICIES = POLICY_REGISTRY.entries


def make_policy(name: str, **kwargs) -> AllocationPolicy:
    return POLICY_REGISTRY.build(name, **kwargs)
