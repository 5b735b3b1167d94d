"""The dynamic marketspace simulator (paper §V).

Implements the full spot-instance lifecycle of Fig. 4 on top of a discrete
event queue: persistent requests, capacity-driven interruption with a warning
period, TERMINATE/HIBERNATE behaviors, minimum running time, hibernation
timeout, waiting timeout, resubmission on deallocation, and dynamic host
add/remove (trace machine events).

Design notes vs. the Java original:
* Victim selection during preemption is configurable (``interruption_selector``)
  instead of the original's non-deterministic host-VM-list order — ``list_order``
  reproduces the paper's behavior; ``best_fit_remaining`` / ``max_progress`` are
  deterministic beyond-paper strategies (the paper's own §IX future-work item).
* Resubmission is triggered on every deallocation (the paper's
  onHostDeallocationListener variant) in the order: waiting on-demand →
  waiting spot → hibernated spot (configurable).

Trace-scale performance (§VII-D1): the resubmission pass is *batched* —
one feasibility matrix and one batched scoring call decide the whole queue,
and a gain-log memo skips VMs whose placement cannot have become feasible
since their last failed attempt (only hosts whose free capacity has since
*increased* need rechecking).  ``SimConfig.flush_mode = "per_vm"`` selects the
original one-VM-at-a-time loop, kept as the decision-identical reference the
batched path is regression-tested against.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .allocation import AllocationPolicy, FirstFit
from .causes import InterruptionCause
from .events import Event, EventKind, EventQueue
from .hosts import HostPool
from .metrics import (FaultRecord, InterruptionEvent, Metrics,
                      MigrationEvent, WaveEvent)
from ..obs.eventlog import NULL_RECORDER
from ..obs.tracer import NULL_TRACER
from .types import (
    ExecutionInterval,
    Vm,
    VmState,
    VmType,
)

_EPS = 1e-9


@dataclass
class SimConfig:
    warning_time: float = 0.0              # grace period before interruption
    interruption_selector: str = "list_order"  # | best_fit_remaining | max_progress
    resubmit_order: tuple = ("waiting_od", "waiting_spot", "hibernated")
    max_time: float = float("inf")
    record_timeline: bool = True
    strict_invariants: bool = False        # re-check host accounting each event
    flush_mode: str = "batched"            # | "per_vm" (legacy reference path)


class MarketSimulator:
    """Discrete-event spot-market simulator."""

    def __init__(self, policy: Optional[AllocationPolicy] = None,
                 config: Optional[SimConfig] = None,
                 engine=None, migration=None, rebid=None,
                 fleet=None, faults=None, serve=None, obs=None,
                 events=None):
        """``engine`` — optional :class:`repro.market.engine.MarketEngine`.
        When attached, the simulator runs periodic PRICE_TICK events: each
        tick re-clears every capacity pool's price from live utilization,
        interrupts resident spot VMs whose bid the price crossed (a
        vectorized *interruption wave*), and re-flushes the queue so victims
        can reallocate into cheaper pools.  Engines are stateful (price
        processes, cost integrals): use a fresh engine per run.  With
        ``engine=None`` every code path is bit-identical to the engine-less
        simulator.

        ``migration`` — optional
        :class:`repro.market.migration.MigrationPlanner`.  Runs after each
        tick's wave + flush and emits batched MIGRATE_START →
        MIGRATE_COMPLETE moves toward cheaper pools.  A planner with policy
        ``"none"`` (or ``migration=None``) leaves every run bit-identical to
        a planner-less simulator.

        ``rebid`` — optional :class:`repro.market.bids.RebidOnResume`:
        adaptive re-bidding applied when a spot VM enters hibernation, so it
        resubmits with a (seeded, randomized) higher bid.  Off by default.

        ``fleet`` — optional :class:`repro.market.fleet.FleetManager`.  Runs
        at the end of each PRICE_TICK (post-wave, post-flush, post-planner):
        it samples the fleet's live capacity, and launches replacements for
        dead slots through its fallback ladder.  ``fleet=None`` is
        bit-identical to a fleet-less simulator.

        ``faults`` — optional :class:`repro.market.faults.FaultInjector`.
        Each PRICE_TICK first advances the fault schedule: pool outages
        deactivate/reactivate their hosts, crunch/spike windows bias the
        engine's tick inputs, and interruption storms reclaim resident spot
        VMs right after the normal price wave.  ``faults=None`` is
        bit-identical to a fault-less simulator.

        ``serve`` — optional :class:`repro.serve.service.ServeManager`.
        Adds two self-scheduling event chains: SERVE_TICK (demand arrivals,
        request dispatch onto live fleet capacity, decode progress) and —
        when the manager carries an autoscaler — AUTOSCALE (damped
        target-capacity decisions applied to the fleet).  Interrupted or
        finished serving VMs requeue their in-flight requests through the
        ordinary lifecycle listeners.  ``serve=None`` is bit-identical to a
        serve-less simulator.

        ``obs`` — optional :class:`repro.obs.tracer.Tracer`.  When enabled,
        the event loop runs a traced variant that records a span per
        dispatch, per-kind/per-cause counters, and cadence counter
        snapshots; subsystem tick phases add nested spans.  The tracer is
        observation-only (no randomness, no state mutation), so metrics
        are identical with or without it; ``obs=None`` selects the plain
        untraced loop with zero added per-event work.

        ``events`` — optional :class:`repro.obs.eventlog.EventLog`: the
        structured flight recorder.  Every lifecycle and market transition
        emits one record (guarded by ``events.enabled`` — a single
        attribute load when off); like the tracer it is observation-only,
        so logged and unlogged runs produce byte-identical metrics."""
        self.policy = policy or FirstFit()
        self.obs = obs if obs is not None else NULL_TRACER
        self.events = events if events is not None else NULL_RECORDER
        self.config = config or SimConfig()
        assert self.config.flush_mode in ("batched", "per_vm")
        self.pool = HostPool()
        self.engine = engine
        self.migration = migration
        if migration is not None and migration.config.policy != "none":
            assert engine is not None, (
                "a migration planner (policy != 'none') requires a market "
                "engine — prices drive the scoring")
        self._rebid = rebid
        self.fleet = fleet
        self.faults = faults
        if fleet is not None:
            assert engine is not None, (
                "a fleet manager requires a market engine — pool prices "
                "drive admission and the fallback ladder")
        if faults is not None:
            assert engine is not None, (
                "a fault injector requires a market engine — faults flow "
                "through the PRICE_TICK machinery")
            assert faults.n_pools == engine.n_pools, (
                f"fault injector covers {faults.n_pools} pools, engine has "
                f"{engine.n_pools}")
        self.serve = serve
        if serve is not None:
            assert engine is not None, (
                "a serve manager requires a market engine — serving "
                "capacity is live spot VMs priced by the market")
        # transient pool outages: fault-event index -> deactivated host ids
        self._outage_hosts: Dict[int, List[int]] = {}
        # storms that fired at the current tick, applied after the wave
        self._storms_due: List = []
        # in-flight migrations: vm_id -> its MigrationEvent, plus a per-pool
        # arrival counter feeding the risk-budgeted planner
        self._migrating: Dict[int, MigrationEvent] = {}
        self._mig_inflight = np.zeros(
            engine.n_pools if engine is not None else 1, dtype=np.int64)
        self.queue = EventQueue()
        self.vms: Dict[int, Vm] = {}
        self.metrics = Metrics()
        self.now = 0.0
        self._waiting_od: Dict[int, Vm] = {}
        self._waiting_spot: Dict[int, Vm] = {}
        self._hibernated: Dict[int, Vm] = {}
        # hosts with a pending interruption commit: host -> reserved VM ids
        self._pending_victims: Dict[int, List[int]] = {}
        # gain-log position at a queued VM's last failed full placement test;
        # absent = never tested against current membership (full check needed)
        self._retry_pos: Dict[int, int] = {}
        self.listeners: Dict[str, List[Callable]] = {}
        self._next_vm_id = 0
        self._run_limit = self.config.max_time
        self._tick_armed = False
        if engine is not None:
            self.pool.enable_market(engine.n_pools)
            self._arm_tick(0.0)
        if serve is not None:
            # start the serving chain one serve tick in (arrivals integrate
            # the demand curve over (0, tick]); the autoscale chain one
            # control period in.  VM-loss requeue rides the ordinary
            # lifecycle listeners — serve-less runs keep `listeners` empty.
            self.queue.push(serve.config.tick, EventKind.SERVE_TICK)
            if serve.autoscaler is not None:
                self.queue.push(serve.autoscaler.config.cadence,
                                EventKind.AUTOSCALE)
            self.on("vm_interrupted", serve.on_vm_interrupted)
            self.on("vm_finished", serve.on_vm_finished)

    def _arm_tick(self, t: float) -> None:
        """(Re)start the PRICE_TICK chain.  The chain stops itself when the
        simulator goes fully idle, so every entry point that can introduce
        new activity (submit, scheduled host events) must re-arm it —
        otherwise later-submitted VMs would be admitted against frozen
        prices."""
        if self.engine is not None and not self._tick_armed:
            self._tick_armed = True
            self.queue.push(max(t, self.now), EventKind.PRICE_TICK)

    # ------------------------------------------------------------------ setup
    def add_host(self, capacity: np.ndarray, pool: int = 0) -> int:
        return self.pool.add_host(capacity, pool)

    def on(self, event_name: str, fn: Callable) -> None:
        """Register an event listener (CloudSim Plus EventListener analogue).

        Names: vm_allocated, vm_deallocated, vm_interrupted, vm_finished,
        vm_failed, clock_tick."""
        self.listeners.setdefault(event_name, []).append(fn)

    def _emit(self, name: str, **kw) -> None:
        if not self.listeners:
            return
        for fn in self.listeners.get(name, ()):
            fn(sim=self, time=self.now, **kw)

    def submit(self, vm: Vm) -> None:
        """Submit a VM at ``vm.submit_time`` (broker submitVm)."""
        assert vm.id not in self.vms, f"duplicate vm id {vm.id}"
        self.vms[vm.id] = vm
        self.queue.push(vm.submit_time, EventKind.VM_SUBMIT, vm.id)
        self._arm_tick(vm.submit_time)

    def new_vm_id(self) -> int:
        while self._next_vm_id in self.vms:
            self._next_vm_id += 1
        vid = self._next_vm_id
        self._next_vm_id += 1
        return vid

    def schedule_host_add(self, time: float, capacity: np.ndarray,
                          pool: int = 0) -> None:
        self.queue.push(time, EventKind.HOST_ADD,
                        (np.asarray(capacity, float), pool))
        self._arm_tick(time)

    def schedule_host_remove(self, time: float, hid: int) -> None:
        self.queue.push(time, EventKind.HOST_REMOVE, hid)
        self._arm_tick(time)

    def schedule_host_update(self, time: float, hid: int, capacity) -> None:
        self.queue.push(time, EventKind.HOST_UPDATE,
                        (hid, np.asarray(capacity, float)))
        self._arm_tick(time)

    # ----------------------------------------------------------- transitions
    def _set_state(self, vm: Vm, new: VmState) -> None:
        """Single funnel for VM state changes — keeps the metrics' incremental
        state counters exact (replaces the per-event full-VM scan)."""
        old = vm.state
        if old is new:
            return
        self.metrics.on_transition(vm, old, new)
        vm.state = new

    # ------------------------------------------------------------------- run
    def run(self, until: Optional[float] = None) -> Metrics:
        limit = until if until is not None else self.config.max_time
        self._run_limit = limit
        heap = self.queue._heap  # hot loop: skip peek/pop wrapper calls
        if (self.engine is not None and not self._tick_armed
                and (heap or sum(self.metrics.state_counts[1:]) > 0)):
            # the chain stopped in a previous run (idle, or queued-only
            # state under an unbounded horizon); resume it for this run
            self._arm_tick(self.now)
        if self.obs.enabled:
            return self._run_traced(limit)
        heappop = heapq.heappop
        strict = self.config.strict_invariants
        while heap and heap[0][0] <= limit:
            ev = heappop(heap)[3]
            self.now = ev.time
            self._dispatch(ev)
            if strict:
                self.pool.check_invariants(self.now)
        self.now = min(limit, self.now) if limit != float("inf") else self.now
        return self.metrics

    def _run_traced(self, limit: float) -> Metrics:
        """Traced twin of the ``run`` hot loop: a ``dispatch/<kind>`` span
        and per-kind counter per event, plus cadence counter snapshots.
        Kept separate so the untraced loop carries zero added per-event
        work — selecting the loop body happens once per ``run`` call."""
        heap = self.queue._heap
        heappop = heapq.heappop
        strict = self.config.strict_invariants
        tr = self.obs
        counters = tr.counters
        inc = counters.inc
        while heap and heap[0][0] <= limit:
            ev = heappop(heap)[3]
            t = ev.time
            self.now = t
            tr.sim_t = t
            kind_name = ev.kind.value
            inc("events/total")
            inc("events/" + kind_name)
            tr.begin("event-loop", "dispatch/" + kind_name)
            try:
                self._dispatch(ev)
            except BaseException:
                # a handler (or a listener it called) raised mid-span:
                # close every open span so the stack stays well-nested and
                # the truncated trace still exports as valid Chrome JSON
                tr.unwind(t)
                raise
            tr.end(t, None)
            if tr.counters_due(t):
                tr.snapshot(t, self._obs_gauges())
            if strict:
                self.pool.check_invariants(self.now)
        self.now = min(limit, self.now) if limit != float("inf") else self.now
        # closing snapshot so the counter timeseries always covers run end
        tr.snapshot(self.now, self._obs_gauges())
        return self.metrics

    def _obs_gauges(self) -> Dict[str, float]:
        """Point-in-time gauges merged into each counter snapshot."""
        c = self.metrics.state_counts
        pool = self.pool
        return {
            "gauge/queue_depth": len(self.queue._heap),
            "gauge/registry_size": getattr(pool, "_mk_n", 0) or 0,
            "gauge/running_spot": c[1],
            "gauge/running_od": c[2],
            "gauge/waiting": c[3],
            "gauge/hibernated": c[4],
            "gauge/hosts_active": int(np.count_nonzero(pool.active[:pool.n])),
        }

    def _dispatch(self, ev: Event) -> None:
        kind = ev.kind
        if kind is EventKind.VM_SUBMIT:
            self._on_submit(self.vms[ev.payload])
        elif kind is EventKind.VM_FINISH:
            vm = self.vms[ev.payload]
            if ev.generation == vm.generation:
                self._on_finish(vm)
        elif kind is EventKind.WAIT_EXPIRE:
            vm = self.vms[ev.payload]
            if ev.generation == vm.generation and vm.state is VmState.WAITING:
                self._on_wait_expire(vm)
        elif kind is EventKind.HIBERNATION_EXPIRE:
            vm = self.vms[ev.payload]
            if ev.generation == vm.generation and vm.state is VmState.HIBERNATED:
                self._on_hibernation_expire(vm)
        elif kind is EventKind.INTERRUPT_COMMIT:
            self._on_interrupt_commit(ev.payload)
        elif kind is EventKind.PRICE_TICK:
            self._on_price_tick()
        elif kind is EventKind.MIGRATE_START:
            self._on_migrate_start(ev.payload, ev.generation)
        elif kind is EventKind.MIGRATE_COMPLETE:
            self._on_migrate_complete(ev.payload, ev.generation)
        elif kind is EventKind.HOST_ADD:
            hid = self.pool.add_host(*ev.payload)
            if self.events.enabled:
                self.events.emit(self.now, "host-add", host=hid,
                                 pool=int(ev.payload[1]))
            self._flush_pending()
        elif kind is EventKind.HOST_REMOVE:
            self._on_host_remove(ev.payload)
        elif kind is EventKind.HOST_UPDATE:
            hid, cap = ev.payload
            self.pool.update_host(hid, cap)
        elif kind is EventKind.SERVE_TICK:
            self._on_serve_tick()
        elif kind is EventKind.AUTOSCALE:
            self._on_autoscale()
        if self.listeners:
            self._emit("clock_tick")

    # ------------------------------------------------------------ allocation
    def _on_submit(self, vm: Vm) -> None:
        self._set_state(vm, VmState.WAITING)
        vm.waiting_since = self.now
        if self.events.enabled:
            self.events.emit(self.now, "submit", vm=vm.id,
                             a=float(vm.bid) if np.isfinite(vm.bid) else 0.0,
                             aux=vm.vm_type.value)
        self._try_allocate(vm, fresh=True)
        self._record()

    def _try_allocate(self, vm: Vm, fresh: bool) -> bool:
        hid, needs_clearing = self.policy.find_host(
            vm, self.pool, self.now, allow_spot_clearing=True
        )
        if hid < 0:
            self._enqueue_pending(vm, fresh, tested=True)
            return False
        if needs_clearing:
            self.metrics.preemption_scans += 1
            started = self._preempt_for(vm, hid)
            if not started:
                self._enqueue_pending(vm, fresh, tested=True)
            return False  # allocation happens at INTERRUPT_COMMIT
        self._start_vm(vm, hid)
        return True

    def _enqueue_pending(self, vm: Vm, fresh: bool, tested: bool = False) -> None:
        if not vm.persistent:
            self._set_state(vm, VmState.FAILED)
            if self.events.enabled:
                self.events.emit(self.now, "fail", vm=vm.id,
                                 aux="unplaceable")
            self._emit("vm_failed", vm=vm)
            return
        if tested:
            # direct placement just failed against the current pool state:
            # only hosts gaining capacity after this point need rechecking
            self._retry_pos[vm.id] = self.pool.gain_pos()
        else:
            self._retry_pos.pop(vm.id, None)
        self._set_state(vm, VmState.HIBERNATED if vm.hibernated_at >= 0
                        else VmState.WAITING)
        if vm.hibernated_at >= 0:
            self._hibernated[vm.id] = vm
        elif vm.vm_type is VmType.ON_DEMAND:
            self._waiting_od[vm.id] = vm
        else:
            self._waiting_spot[vm.id] = vm
        if fresh and np.isfinite(vm.waiting_timeout) and vm.hibernated_at < 0:
            self.queue.push(vm.waiting_since + vm.waiting_timeout,
                            EventKind.WAIT_EXPIRE, vm.id, vm.generation)

    def _start_vm(self, vm: Vm, hid: int) -> None:
        self._waiting_od.pop(vm.id, None)
        self._waiting_spot.pop(vm.id, None)
        self._retry_pos.pop(vm.id, None)
        resumed = self._hibernated.pop(vm.id, None) is not None
        self.pool.place(vm, hid, now=self.now)
        self._set_state(vm, VmState.RUNNING)
        vm.run_start = self.now
        vm.hibernated_at = -1.0
        vm.generation += 1
        vm.history.append(ExecutionInterval(host=hid, start=self.now))
        self.queue.push(self.now + vm.remaining, EventKind.VM_FINISH,
                        vm.id, vm.generation)
        self.metrics.allocations += 1
        if resumed:
            self.metrics.resubmissions += 1
        if self.events.enabled:
            self.events.emit(
                self.now, "resume" if resumed else "start", vm=vm.id,
                pool=int(self.pool.pool_of[hid]), host=hid,
                a=float(vm.bid) if np.isfinite(vm.bid) else 0.0)
        self._emit("vm_allocated", vm=vm, host=hid, resumed=resumed)

    # ----------------------------------------------------------- preemption
    def _select_victims(self, vm: Vm, hid: int) -> List[Vm]:
        """Choose interruptible spot VMs on ``hid`` to cover the deficit."""
        free = self.pool.free()[hid]
        deficit = np.maximum(vm.demand - free, 0.0)
        candidates = [v for v in self.pool.spot_vms_on(hid)
                      if v.interruptible(self.now)]
        sel = self.config.interruption_selector
        if sel == "best_fit_remaining":
            # fewest wasted resources: smallest remaining work first among those
            # that cover the deficit; deterministic beyond-paper strategy.
            candidates.sort(key=lambda v: (v.remaining, v.id))
        elif sel == "max_progress":
            # protect VMs closest to completion: interrupt least-progressed first
            candidates.sort(key=lambda v: (-(v.duration - v.remaining), v.id))
        # "list_order": keep host residence order (paper's behavior)
        victims, covered = [], np.zeros_like(deficit)
        for v in candidates:
            if np.all(covered >= deficit - _EPS):
                break
            victims.append(v)
            covered += v.demand
        if not np.all(covered >= deficit - _EPS):
            return []  # cannot actually free enough (mid-warning state changed)
        return victims

    def _preempt_for(self, vm: Vm, hid: int) -> bool:
        victims = self._select_victims(vm, hid)
        if not victims:
            return False
        w = self.config.warning_time
        for v in victims:
            # keep the victim's VM_FINISH event valid: a spot VM that
            # completes during the warning window finishes normally (its
            # capacity is then free at commit time anyway).
            self._set_state(v, VmState.INTERRUPTING)
            self.pool.mark_uninterruptible(v)
        self._pending_victims[hid] = [v.id for v in victims]
        self.queue.push(self.now + w, EventKind.INTERRUPT_COMMIT,
                        (hid, vm.id, [v.id for v in victims]))
        return True

    def _on_interrupt_commit(self, payload) -> None:
        if payload[0] == "wave":
            # end of a price-wave warning window: apply each victim's behavior
            for vid in payload[1]:
                v = self.vms[vid]
                if v.state is not VmState.INTERRUPTING:
                    continue  # finished during the warning
                self._interrupt(v, kind=v.behavior.value,
                                cause=InterruptionCause.PRICE_WAVE)
            self._flush_pending()
            self._record()
            return
        hid, od_id, victim_ids = payload
        od = self.vms[od_id]
        self._pending_victims.pop(hid, None)
        for vid in victim_ids:
            v = self.vms[vid]
            if v.state is not VmState.INTERRUPTING:
                continue  # finished or otherwise transitioned during warning
            self._interrupt(v, kind=v.behavior.value)
        if od.state in (VmState.WAITING,) and self.pool.fits(hid, od.demand):
            self._start_vm(od, hid)
        elif od.state is VmState.WAITING:
            # capacity changed during the warning window; retry globally
            self._try_allocate(od, fresh=False)
        self._flush_pending()
        self._record()

    def _interrupt(self, vm: Vm, kind: str,
                   cause: str = InterruptionCause.CAPACITY) -> None:
        """Stop a running/interrupting spot VM and apply its behavior."""
        self._account_progress(vm)
        self.pool.release(vm)
        vm.interruptions += 1
        self.metrics.interruption_events.append(
            InterruptionEvent(vm.id, self.now, vm.history[-1].host, kind,
                              cause))
        if self.obs.enabled:
            self.obs.counters.inc("interruptions/" + cause)
        if self.events.enabled:
            hid = vm.history[-1].host
            self.events.emit(self.now, "interrupt", vm=vm.id,
                             pool=int(self.pool.pool_of[hid]), host=hid,
                             a=float(vm.bid) if np.isfinite(vm.bid) else 0.0,
                             aux=cause)
        self._emit("vm_interrupted", vm=vm, kind=kind)
        self._apply_interruption_behavior(vm, kind)

    def _apply_interruption_behavior(self, vm: Vm, kind: str) -> None:
        """Shared post-interruption triage (capacity/wave interruption, host
        removal, failed migration): a VM whose work is done finishes;
        otherwise it hibernates or terminates per ``kind``."""
        if vm.remaining <= _EPS:
            self._finish_now(vm)
        elif kind == "hibernate":
            self._enter_hibernation(vm)
        else:
            self._set_state(vm, VmState.TERMINATED)
            vm.generation += 1
            if self.events.enabled:
                self.events.emit(self.now, "terminate", vm=vm.id)
            self._emit("vm_terminated", vm=vm)

    def _enter_hibernation(self, vm: Vm) -> None:
        """Shared hibernation entry (wave/capacity interruption, host
        removal, failed migration).  The VM is already released from its
        host.  The optional re-bid hook fires here: the VM resubmits with
        its adapted bid governing readmission."""
        if self._rebid is not None:
            vm.bid = self._rebid.rebid(vm)
        self._set_state(vm, VmState.HIBERNATED)
        vm.hibernated_at = self.now
        vm.generation += 1
        self._hibernated[vm.id] = vm
        self._retry_pos.pop(vm.id, None)  # untested in hibernated form
        if self.events.enabled:
            # a carries the (possibly re-bid) price governing readmission
            self.events.emit(self.now, "hibernate", vm=vm.id,
                             a=float(vm.bid) if np.isfinite(vm.bid) else 0.0)
        if np.isfinite(vm.hibernation_timeout):
            self.queue.push(self.now + vm.hibernation_timeout,
                            EventKind.HIBERNATION_EXPIRE, vm.id,
                            vm.generation)

    # ------------------------------------------------------------ market tick
    def _on_price_tick(self) -> None:
        """Re-clear every pool's price from live utilization, then emit the
        interruption wave: one masked comparison over the market registry
        selects every resident spot VM whose bid the new price crossed."""
        eng = self.engine
        t = self.now
        fi = self.faults
        tr = self.obs
        traced = tr.enabled
        if fi is not None:
            # outage transitions first (the utilization signal must see the
            # downed hosts), then crunch/spike biases into the normal tick
            if traced:
                tr.begin("market-tick", "tick/faults")
            self._fault_begin_tick(t)
            if traced:
                tr.end(t, None)
                tr.begin("market-tick", "tick/engine")
            prices = eng.tick(self.pool, t, util_bias=fi.util_bias(t),
                              shock_bias=fi.shock_bias(t))
        else:
            if traced:
                tr.begin("market-tick", "tick/engine")
            prices = eng.tick(self.pool, t)
        if traced:
            tr.end(t, None)
            tr.counters.inc("ticks")
            tr.begin("market-tick", "tick/wave")
        self.pool.set_pool_prices(prices)
        m = self.metrics
        m.price_series.extend(
            (t, pid, float(p)) for pid, p in enumerate(prices))
        victims, vpools = self.pool.market_victims(prices, t)
        if victims.size:
            counts = np.bincount(vpools, minlength=eng.n_pools)
            evl = self.events
            for pid in np.flatnonzero(counts):
                m.wave_events.append(
                    WaveEvent(t, int(pid), float(prices[pid]),
                              int(counts[pid])))
                if evl.enabled:
                    evl.emit(t, "wave", pool=int(pid),
                             a=float(prices[pid]), b=float(counts[pid]))
            if traced:
                tr.counters.inc("waves")
                tr.counters.inc("wave_victims", int(victims.size))
                tr.instant("market-tick", "wave", t,
                           {"victims": int(victims.size)})
            w = self.config.warning_time
            if w > 0:
                vids = [int(v) for v in victims]
                for vid in vids:
                    v = self.vms[vid]
                    self._set_state(v, VmState.INTERRUPTING)
                    self.pool.mark_uninterruptible(v)
                self.queue.push(t + w, EventKind.INTERRUPT_COMMIT,
                                ("wave", vids))
            else:
                for vid in victims:
                    v = self.vms[int(vid)]
                    self._interrupt(v, kind=v.behavior.value,
                                    cause=InterruptionCause.PRICE_WAVE)
        if traced:
            tr.end(t, {"victims": int(victims.size)})
        # injected interruption storms land after the ordinary wave — the
        # wave already reclaimed below-bid VMs, the storm takes its share of
        # whoever is left running
        if fi is not None and self._storms_due:
            if traced:
                tr.begin("market-tick", "tick/storms")
                self._fault_apply_storms()
                tr.end(t, None)
            else:
                self._fault_apply_storms()
        # capacity freed by the wave (and any price drops, via the gain log)
        # feeds straight back into the queue — victims can land in a cheaper
        # pool within the same tick
        self._flush_pending()
        # proactive migration: the planner scores the settled post-wave,
        # post-flush state and emits MIGRATE_START events at this timestamp
        # (processed after same-time submissions; each start re-validates)
        if self.migration is not None:
            if traced:
                tr.begin("market-tick", "tick/migration")
                self._plan_migrations()
                tr.end(t, None)
            else:
                self._plan_migrations()
        # the fleet manager observes the settled post-wave, post-flush,
        # post-planner state: sample capacity, replace dead slots (its
        # submissions are VM_SUBMIT events at this timestamp, processed
        # after the tick by event priority)
        if self.fleet is not None:
            if traced:
                tr.begin("market-tick", "tick/fleet")
                self.fleet.on_tick(self, t)
                tr.end(t, None)
            else:
                self.fleet.on_tick(self, t)
        self._record()
        # keep ticking while any event or live VM remains (the chain is the
        # only self-scheduling event kind, so it must not outlive the run).
        # With an *unbounded* horizon, queued-only state (WAITING/HIBERNATED
        # with infinite timeouts, gated purely on a price that may never
        # clear) must not keep the chain alive — the pre-engine simulator
        # terminated there, and run(until=inf) would otherwise never return.
        # A fleet with live (unretired) slots, or a fault schedule with
        # events still to fire, also keeps a *bounded* run ticking — backoff
        # retries and future faults need the clock even when nothing runs.
        c = m.state_counts
        bounded = self._run_limit != float("inf")
        if (self.queue._heap or c[1] + c[2] > 0
                or (bounded and c[3] + c[4] > 0)
                or (bounded and self.fleet is not None
                    and self.fleet.wants_tick())
                or (bounded and fi is not None and fi.pending())):
            self.queue.push(t + eng.tick_interval, EventKind.PRICE_TICK)
        else:
            self._tick_armed = False  # idle: submit()/schedule_* re-arm

    # -------------------------------------------------------- serving layer
    def _serve_rearm(self) -> bool:
        """Keep a serve chain alive?  A bounded run carries its chains to
        the horizon (events past the limit stay in the heap, like
        PRICE_TICK's re-arm); an unbounded run stops once the request
        backlog drained and nothing runs, so ``run(until=inf)`` returns."""
        c = self.metrics.state_counts
        return (self._run_limit != float("inf") or self.serve.pending()
                or c[1] + c[2] > 0)

    def _on_serve_tick(self) -> None:
        sv = self.serve
        if sv is None:
            return
        t = self.now
        tr = self.obs
        if tr.enabled:
            tr.begin("serve", "tick/serve")
            sv.on_tick(self, t)
            tr.end(t, None)
        else:
            sv.on_tick(self, t)
        if self._serve_rearm():
            self.queue.push(t + sv.config.tick, EventKind.SERVE_TICK)

    def _on_autoscale(self) -> None:
        sv = self.serve
        if sv is None or sv.autoscaler is None:
            return
        t = self.now
        tr = self.obs
        if tr.enabled:
            tr.begin("serve", "tick/autoscale")
            sv.on_autoscale(self, t)
            tr.end(t, None)
        else:
            sv.on_autoscale(self, t)
        if self._serve_rearm():
            self.queue.push(t + sv.autoscaler.config.cadence,
                            EventKind.AUTOSCALE)

    def decommission(self, vm: Vm) -> None:
        """Voluntarily end a RUNNING/INTERRUPTING VM now (autoscaler
        scale-in): rides the ordinary VM_FINISH path, so progress
        accounting, host release, metrics, and lifecycle listeners behave
        exactly like a natural completion."""
        self.queue.push(self.now, EventKind.VM_FINISH, vm.id, vm.generation)

    # ---------------------------------------------------- proactive migration
    def _plan_migrations(self) -> None:
        plans = self.migration.plan(self.pool, self.engine, self.now,
                                    self._mig_inflight)
        if not plans:
            return
        self.metrics.migrations_planned += len(plans)
        for p in plans:
            vm = self.vms[p.vm_id]
            self.queue.push(self.now, EventKind.MIGRATE_START,
                            (p.vm_id, p.dst_pool, p.predicted_saving),
                            vm.generation)

    def _on_migrate_start(self, payload, gen: int) -> None:
        """Leave the source host and reserve the destination: the VM makes no
        progress (and pays nothing) until MIGRATE_COMPLETE."""
        vid, dst_pool, predicted = payload
        vm = self.vms[vid]
        if gen != vm.generation or vm.state is not VmState.RUNNING:
            return  # finished / interrupted / preempt-warned since planning
        mask = self.pool.direct_mask_into(vm.demand, vm.bid, dst_pool)
        hid = self.policy._pick_direct(mask, vm, self.pool) if mask.any() else -1
        if hid < 0:
            # no single host fits (pool-aggregate headroom was fragmented,
            # or same-time submissions took it): stay put, and black the VM
            # out of planning for one cooldown so it cannot re-top the
            # ranking and monopolize the per-tick plan budget every tick
            self.pool.stamp_migration_cooldown(
                vm, self.now + self.migration.config.cooldown)
            return
        src = vm.host
        self._account_progress(vm)
        self.pool.release(vm)
        self._set_state(vm, VmState.MIGRATING)
        vm.generation += 1
        vm.run_start = -1.0
        self.pool.reserve(vm, hid)
        self._mig_inflight[dst_pool] += 1
        mev = MigrationEvent(vid, self.now, src, hid,
                             int(self.pool.pool_of[src]), int(dst_pool),
                             predicted, bid=vm.bid)
        self._migrating[vid] = mev
        self.metrics.migration_events.append(mev)
        self.metrics.migrations_started += 1
        if self.obs.enabled:
            self.obs.counters.inc("migrations/started")
        if self.events.enabled:
            # pool/host name the *source* (the departure side — occupancy
            # analytics key on it); the destination pool rides in b and the
            # arrival is its own migrate-complete event
            self.events.emit(self.now, "migrate-start", vm=vid,
                             pool=int(self.pool.pool_of[src]), host=src,
                             a=float(predicted), b=float(dst_pool))
        self.queue.push(self.now + self.migration.config.downtime,
                        EventKind.MIGRATE_COMPLETE, (vid, hid),
                        vm.generation)
        self._emit("vm_migration_start", vm=vm, src=src, dst=hid)
        # the vacated source capacity is a gain: queued VMs may take it now
        self._flush_pending()
        self._record()

    def _on_migrate_complete(self, payload, gen: int) -> None:
        """End of the stop-and-copy window: commit the reservation into a
        placement — or, if the destination stopped clearing during the
        flight (price spiked above the bid / host removed), fail the
        migration and apply the VM's interruption behavior."""
        vid, hid = payload
        vm = self.vms[vid]
        if gen != vm.generation or vm.state is not VmState.MIGRATING:
            return
        mev = self._migrating.pop(vid)
        self.pool.release_reservation(vid)
        self._mig_inflight[mev.dst_pool] -= 1
        mev.t_complete = self.now
        pool = self.pool
        if (pool.active[hid] and pool.price_clears(hid, vm.bid)
                and pool.fits_fast(hid, vm.demand)):
            # arrival: like _start_vm, but the interval is via="migrate" and
            # the cooldown stamp lands in the registry before place()
            vm.migrate_cooldown_until = self.now + self.migration.config.cooldown
            pool.place(vm, hid, now=self.now)
            self._set_state(vm, VmState.RUNNING)
            vm.run_start = self.now
            vm.generation += 1
            vm.migrations += 1
            vm.history.append(
                ExecutionInterval(host=hid, start=self.now, via="migrate"))
            self.queue.push(self.now + vm.remaining, EventKind.VM_FINISH,
                            vm.id, vm.generation)
            self.metrics.migrations_completed += 1
            self.metrics.migration_downtime += self.now - mev.t_start
            if self.obs.enabled:
                self.obs.counters.inc("migrations/completed")
            if self.events.enabled:
                self.events.emit(self.now, "migrate-complete", vm=vm.id,
                                 pool=int(mev.dst_pool), host=hid,
                                 a=float(mev.predicted_saving), aux="ok")
            self._emit("vm_migrated", vm=vm, host=hid)
        else:
            mev.failed = True
            self.metrics.migrations_failed += 1
            vm.interruptions += 1
            kind = vm.behavior.value
            # the flight's downtime becomes part of the interruption gap
            # (the interval closed at MIGRATE_START), so it is NOT also
            # added to migration_downtime — each second has one home.
            # Attribute the event to the host the VM last ran on (like
            # every other interruption path); the destination it never
            # reached is in the MigrationEvent.
            self.metrics.interruption_events.append(
                InterruptionEvent(vid, self.now, vm.history[-1].host, kind,
                                  cause=InterruptionCause.MIGRATION_FAILED))
            if self.obs.enabled:
                self.obs.counters.inc(
                    "interruptions/" + InterruptionCause.MIGRATION_FAILED)
                self.obs.counters.inc("migrations/failed")
            if self.events.enabled:
                self.events.emit(self.now, "migrate-complete", vm=vm.id,
                                 pool=int(mev.dst_pool), host=hid,
                                 aux="failed")
                last = vm.history[-1].host
                self.events.emit(
                    self.now, "interrupt", vm=vm.id,
                    pool=int(self.pool.pool_of[last]), host=last,
                    a=float(vm.bid) if np.isfinite(vm.bid) else 0.0,
                    aux=InterruptionCause.MIGRATION_FAILED)
            self._emit("vm_interrupted", vm=vm, kind=kind)
            self._apply_interruption_behavior(vm, kind)
        self._flush_pending()
        self._record()

    def _account_progress(self, vm: Vm) -> None:
        """Close the current execution interval and decrement remaining work."""
        ran = self.now - vm.run_start
        vm.remaining = max(0.0, vm.remaining - ran)
        vm.history[-1].stop = self.now
        self._emit("vm_deallocated", vm=vm, host=vm.host)

    # ------------------------------------------------------------ lifecycle
    def _on_finish(self, vm: Vm) -> None:
        if vm.state not in (VmState.RUNNING, VmState.INTERRUPTING):
            return
        hid = vm.history[-1].host
        self._account_progress(vm)
        self.pool.release(vm)
        self._finish_now(vm, host=hid)
        self._flush_pending()
        self._record()

    def _finish_now(self, vm: Vm, host: int = -1) -> None:
        self._set_state(vm, VmState.FINISHED)
        vm.finish_time = self.now
        vm.generation += 1
        self._hibernated.pop(vm.id, None)
        self._retry_pos.pop(vm.id, None)
        if self.events.enabled:
            # host/pool only for the ran-to-completion path — departure
            # accounting in obs.analyze keys on pool >= 0 (finishes after
            # an interruption already decremented via the interrupt event)
            self.events.emit(
                self.now, "finish", vm=vm.id, host=host,
                pool=int(self.pool.pool_of[host]) if host >= 0 else -1)
        self._emit("vm_finished", vm=vm)

    def _on_wait_expire(self, vm: Vm) -> None:
        self._waiting_od.pop(vm.id, None)
        self._waiting_spot.pop(vm.id, None)
        self._retry_pos.pop(vm.id, None)
        self._set_state(vm, VmState.FAILED)
        vm.generation += 1
        if self.events.enabled:
            self.events.emit(self.now, "fail", vm=vm.id, aux="wait-expire")
        self._emit("vm_failed", vm=vm)
        self._record()

    def _on_hibernation_expire(self, vm: Vm) -> None:
        self._hibernated.pop(vm.id, None)
        self._retry_pos.pop(vm.id, None)
        self._set_state(vm, VmState.TERMINATED)
        vm.generation += 1
        if self.events.enabled:
            self.events.emit(self.now, "terminate", vm=vm.id,
                             aux="hibernation-expire")
        self._emit("vm_terminated", vm=vm)
        self._record()

    def _on_host_remove(self, hid: int) -> None:
        self._evict_host(hid, InterruptionCause.CAPACITY)
        self._flush_pending()
        self._record()

    def _evict_host(self, hid: int,
                    cause: str = InterruptionCause.CAPACITY) -> None:
        """Deactivate ``hid`` and evict its residents through the ordinary
        interruption lifecycle (spot VMs take their behavior, on-demand VMs
        requeue).  Shared by trace machine-removal events (``cause``
        "capacity", the historical value) and transient pool outages from
        the fault injector ("fault-outage").  The caller flushes/records."""
        if self.events.enabled:
            self.events.emit(self.now, "host-remove", host=hid,
                             pool=int(self.pool.pool_of[hid]), aux=cause)
        victims = self.pool.remove_host(hid)
        for v in victims:
            if v.vm_type is VmType.SPOT:
                self._account_progress(v)
                self.pool.release(v)
                v.interruptions += 1
                self.metrics.interruption_events.append(
                    InterruptionEvent(v.id, self.now, hid,
                                      InterruptionCause.HOST_REMOVED, cause))
                if self.obs.enabled:
                    self.obs.counters.inc("interruptions/" + cause)
                if self.events.enabled:
                    self.events.emit(
                        self.now, "interrupt", vm=v.id,
                        pool=int(self.pool.pool_of[hid]), host=hid,
                        a=float(v.bid) if np.isfinite(v.bid) else 0.0,
                        aux=cause)
                self._apply_interruption_behavior(v, v.behavior.value)
            else:
                # on-demand VMs are resubmitted as persistent requests
                self._account_progress(v)
                self.pool.release(v)
                v.generation += 1
                if v.remaining <= _EPS:
                    self._finish_now(v)
                else:
                    self._set_state(v, VmState.WAITING)
                    v.waiting_since = self.now
                    self._waiting_od[v.id] = v
                    self._retry_pos.pop(v.id, None)  # untested after removal

    # -------------------------------------------------------- fault injection
    def _fault_begin_tick(self, t: float) -> None:
        """Advance the fault schedule to ``t``: record fired faults, start /
        end pool outages, and stash storms for application after the wave."""
        fi = self.faults
        started, ended = fi.begin_tick(t)
        for i, ev in started:
            self.metrics.fault_records.append(
                FaultRecord(ev.kind, ev.t0, ev.t1,
                            tuple(fi._pool_ids(ev)), ev.magnitude))
            if ev.kind == "pool-outage":
                pool = self.pool
                n = pool.n
                hids = [int(h) for p in fi._pool_ids(ev)
                        for h in np.flatnonzero(
                            pool.active[:n] & (pool.pool_of[:n] == p))]
                for hid in hids:
                    self._evict_host(hid, InterruptionCause.FAULT_OUTAGE)
                self._outage_hosts[i] = hids
            elif ev.kind == "storm":
                self._storms_due.append(ev)
        for i in ended:
            for hid in self._outage_hosts.pop(i, ()):
                self.pool.reactivate_host(hid)

    def _fault_apply_storms(self) -> None:
        """Reclaim each due storm's victims — a fraction of the resident
        running spot VMs per affected pool, lowest bids first — through the
        normal interruption path (cause "fault-storm", no warning: storms
        model abrupt provider reclamation)."""
        fi = self.faults
        for ev in self._storms_due:
            vids = fi.victims(self.pool.market_registry(), ev)
            for vid in vids:
                v = self.vms[int(vid)]
                self._interrupt(v, kind=v.behavior.value,
                                cause=InterruptionCause.FAULT_STORM)
        self._storms_due.clear()

    # --------------------------------------------------------- resubmission
    def _flush_pending(self) -> None:
        """Resubmission pass: try to place queued requests (§V-D)."""
        tr = self.obs
        evl = self.events
        if not (tr.enabled or evl.enabled):
            if self.config.flush_mode == "per_vm":
                self._flush_pending_per_vm()
            else:
                self._flush_pending_batched()
            return
        mode = self.config.flush_mode
        before = self.metrics.allocations
        if tr.enabled:
            tr.begin("allocation", "flush/" + mode)
        if mode == "per_vm":
            self._flush_pending_per_vm()
        else:
            self._flush_pending_batched()
        placed = self.metrics.allocations - before
        if tr.enabled:
            tr.end(self.now, {"placed": placed})
        if evl.enabled:
            evl.emit(self.now, "alloc-flush", a=float(placed))

    def _queues(self) -> Dict[str, Dict[int, Vm]]:
        return {
            "waiting_od": self._waiting_od,
            "waiting_spot": self._waiting_spot,
            "hibernated": self._hibernated,
        }

    def _flush_pending_per_vm(self) -> None:
        """Legacy reference path: one full ``find_host`` per queued VM per
        pass.  Kept verbatim as the oracle the batched path is tested against."""
        queues = self._queues()
        progress = True
        while progress:
            progress = False
            for name in self.config.resubmit_order:
                q = queues[name]
                for vid in list(q.keys()):
                    vm = q[vid]
                    if vm.state not in (VmState.WAITING, VmState.HIBERNATED):
                        q.pop(vid, None)
                        continue
                    allow_clear = vm.vm_type is VmType.ON_DEMAND
                    hid, needs_clearing = self.policy.find_host(
                        vm, self.pool, self.now, allow_spot_clearing=allow_clear)
                    if hid >= 0 and not needs_clearing:
                        q.pop(vid, None)
                        self._start_vm(vm, hid)
                        progress = True
                    # note: queued on-demand VMs do not trigger *new* preemption
                    # cascades here — preemption happens on the submit path;
                    # this avoids livelock between queued od and running spot.
        self._maybe_compact_gains()

    def _flush_pending_batched(self) -> None:
        """Batched resubmission: decision-identical to the per-VM loop.

        Per pass, one feasibility matrix decides which queued VM places next
        (a VM places iff its row is non-empty) and scoring runs only for that
        row; after each placement the not-yet-visited suffix is re-decided
        (state changed).  A gain-log memo skips VMs for which no host's free
        capacity has increased since their last failed test — placements
        can't create feasibility, so the answer is unchanged by construction.
        Queued VMs never trigger new preemption cascades (see the per-VM
        loop's note), so only direct placements are considered."""
        if not (self._waiting_od or self._waiting_spot or self._hibernated):
            # still bound the gain log: market price *drops* flood it every
            # tick (hosts re-opened to queued bids), and with no queued VMs
            # nobody would otherwise ever consume or compact those entries
            self._maybe_compact_gains()
            return
        queues = self._queues()
        while True:
            pending: List[Tuple[Dict[int, Vm], Vm]] = []
            for name in self.config.resubmit_order:
                q = queues[name]
                stale = False
                for vm in q.values():
                    if vm.state in (VmState.WAITING, VmState.HIBERNATED):
                        pending.append((q, vm))
                    else:
                        stale = True
                if stale:  # rare: purge invalid entries with a snapshot pass
                    for vid in list(q.keys()):
                        if q[vid].state not in (VmState.WAITING,
                                                VmState.HIBERNATED):
                            q.pop(vid, None)
                            self._retry_pos.pop(vid, None)
            if not pending or not self._flush_batch_pass(pending):
                self._maybe_compact_gains()
                return

    def _maybe_compact_gains(self) -> None:
        """Bound the pool's gain log: drop entries no queued VM still
        references (positions only move forward, so this is safe)."""
        pool = self.pool
        if len(pool.gain_log) > max(1024, 4 * pool.n):
            pool.compact_gain_log(
                min(self._retry_pos.values(), default=pool.gain_pos()))

    def _flush_batch_pass(self, pending) -> int:
        """One pass over the queue snapshot; returns the number placed.
        Traced, it counts ``flush/passes``, ``flush/rows_scanned`` (rows
        the memo filter looked at) and ``flush/rows_tested`` (rows that
        reached the policy)."""
        pool, placed, i = self.pool, 0, 0
        retry, log = self._retry_pos, pool.gain_log
        fits = pool.fits_fast
        n_pending = len(pending)
        tr = self.obs
        if tr.enabled:
            tr.counters.inc("flush/passes")
        while i < n_pending:
            # memo filter: keep only VMs that might fit under current state —
            # a VM that failed its last full test can only have become
            # feasible on a host whose free capacity increased since then.
            # Positions are absolute (base counts compacted-away entries).
            base = pool._gain_base
            glen = base + len(log)
            check: List[int] = []
            for j in range(i, n_pending):
                vm = pending[j][1]
                pos = retry.get(vm.id)
                if pos is not None:
                    if pos >= glen:
                        continue  # nothing gained since the last failure
                    hit = False
                    for h in log[max(pos - base, 0):]:
                        if fits(h, vm.demand):
                            hit = True
                            break
                    if not hit:
                        retry[vm.id] = glen
                        continue
                check.append(j)
            if tr.enabled:
                tr.counters.inc("flush/rows_scanned", n_pending - i)
                tr.counters.inc("flush/rows_tested", len(check))
            if not check:
                break
            # one feasibility matrix decides which VM places (a VM places iff
            # its row is non-empty); scoring runs for that single row only
            if len(check) == 1:
                hid = self.policy.find_direct(pending[check[0]][1], pool)
                b = 0 if hid >= 0 else 1
            else:
                b, hid = self.policy.find_first_direct(
                    [pending[j][1] for j in check], pool)
            pos_now = base + len(log)
            for j in check[:b]:
                retry[pending[j][1].id] = pos_now
            if hid < 0:
                break
            q, vm = pending[check[b]]
            q.pop(vm.id, None)
            self._start_vm(vm, hid)
            placed += 1
            # pool state changed: re-decide the remaining suffix
            i = check[b] + 1
        return placed

    def _record(self) -> None:
        if self.config.record_timeline:
            self.metrics.record_sample(self.now)

    # ------------------------------------------------------------- reporting
    def finished_vms(self) -> List[Vm]:
        return [v for v in self.vms.values() if v.state is VmState.FINISHED]

    def all_vms(self) -> List[Vm]:
        return list(self.vms.values())
