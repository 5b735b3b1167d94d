"""Simulation output & monitoring (paper §IV-B: execution history, interruption
counts, average interruption times) + table builders (§V-E-f) with CSV/JSON
export (§V-F TableBuilder extension)."""
from __future__ import annotations

import csv
import io
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .causes import InterruptionCause
from .types import Vm, VmState, VmType


@dataclass
class InterruptionEvent:
    vm_id: int
    time: float
    host: int
    kind: str  # "terminate" | "hibernate" | "host-removed"
    #: why — one of :class:`repro.core.causes.InterruptionCause` (serialized
    #: verbatim; "capacity" is the classic on-demand-preemption default)
    cause: str = InterruptionCause.CAPACITY


@dataclass
class WaveEvent:
    """One price-driven interruption wave in one capacity pool: at ``time``
    the pool's clearing price crossed ``size`` resident spot bids."""
    time: float
    pool: int
    price: float
    size: int


@dataclass
class FaultRecord:
    """One injected market fault that fired during the run (``market/faults``).

    ``t1`` equals ``t0`` for instantaneous faults (storms); windowed faults
    (crunch / spike / outage) carry their scheduled end."""
    kind: str
    t0: float
    t1: float
    pools: tuple
    magnitude: float


@dataclass
class MigrationEvent:
    """One proactive cross-pool migration (MIGRATE_START → MIGRATE_COMPLETE).

    ``predicted_saving`` is the planner's net score at plan time in
    price·seconds (expected price-gap over the remaining work minus the
    downtime penalty).  ``t_complete`` stays -1 while in flight; ``failed``
    marks a flight whose destination stopped clearing (price spike above the
    bid, host removal) — the VM then takes its interruption behavior."""
    vm_id: int
    t_start: float
    src_host: int
    dst_host: int
    src_pool: int
    dst_pool: int
    predicted_saving: float
    t_complete: float = -1.0
    failed: bool = False
    #: the VM's bid when the flight left (realized-saving integrals cap at
    #: this, not the final bid — adaptive re-bidding may change it later)
    bid: float = float("inf")


def _timeline_bucket(state: VmState, vm_type: VmType) -> int:
    """Timeline column (1-4) a (state, type) pair contributes to, or 0."""
    if state in (VmState.RUNNING, VmState.INTERRUPTING):
        return 1 if vm_type is VmType.SPOT else 2
    if state is VmState.WAITING:
        return 3
    if state is VmState.HIBERNATED:
        return 4
    return 0


#: precomputed state -> bucket tables (one per VM type); on_transition runs
#: per VM state change, so it pays one enum-key dict lookup, not tuple hashing
_BUCKET_SPOT = {s: _timeline_bucket(s, VmType.SPOT) for s in VmState}
_BUCKET_OD = {s: _timeline_bucket(s, VmType.ON_DEMAND) for s in VmState}


@dataclass
class Metrics:
    """Collected over one simulation run.

    The timeline columns (active spot / active on-demand / waiting /
    hibernated) are maintained as O(1) incremental counters updated at each
    VM state transition (:meth:`on_transition`), replacing the original
    full-VM scan per event — at trace scale that scan made recording O(V²)
    over the run (the paper's §VII-D1 per-entity-update bottleneck)."""

    interruption_events: List[InterruptionEvent] = field(default_factory=list)
    # time series sampled at every state change: (t, active_spot, active_od,
    # waiting, hibernated)
    timeline: List[tuple] = field(default_factory=list)
    allocations: int = 0
    resubmissions: int = 0
    preemption_scans: int = 0
    # incremental state counters, indexed by _timeline_bucket (slot 0 unused)
    state_counts: List[int] = field(default_factory=lambda: [0, 0, 0, 0, 0])
    # -- market engine series (empty when no engine is attached) -------------
    # (t, pool, clearing price) per pool per PRICE_TICK
    price_series: List[tuple] = field(default_factory=list)
    wave_events: List[WaveEvent] = field(default_factory=list)
    # -- proactive migration subsystem (empty when no planner is attached) ---
    migration_events: List[MigrationEvent] = field(default_factory=list)
    migrations_planned: int = 0     # plans emitted by the planner
    migrations_started: int = 0     # flights that left their source host
    migrations_completed: int = 0   # arrivals placed on the destination
    migrations_failed: int = 0      # flights whose destination stopped clearing
    #: stop-and-copy seconds of *completed* migrations; a failed flight's
    #: downtime lands in the VM's interruption gap instead (one home each)
    migration_downtime: float = 0.0
    # -- fleet resilience layer (empty when no FleetManager is attached) -----
    #: (t, up_cpu, target_cpu) sampled by the fleet manager each PRICE_TICK
    fleet_samples: List[tuple] = field(default_factory=list)
    #: fallback-ladder rung usage: rung name -> replacement attempts routed
    #: through it (including the implicit initial "launch" rung)
    fallback_counts: Dict[str, int] = field(default_factory=dict)
    fleet_launches: int = 0         # spot launch attempts submitted
    od_spill_launches: int = 0      # on-demand fallback launches submitted
    fleet_slots_retired: int = 0    # slots that exhausted the ladder
    #: vm ids the fleet manager launched (spot / on-demand spill), for the
    #: batched realized-billing pass in :meth:`resilience_stats`
    fleet_spot_ids: List[int] = field(default_factory=list)
    fleet_od_ids: List[int] = field(default_factory=list)
    # -- fault injection (empty when no FaultInjector is attached) -----------
    fault_records: List[FaultRecord] = field(default_factory=list)
    # -- serving layer (empty when no ServeManager is attached) --------------
    #: (t, arrivals, rate, queue_depth, live_units, target_units) per
    #: SERVE_TICK, sampled after dispatch — the closed loop's flight data
    serve_samples: List[tuple] = field(default_factory=list)
    request_latencies: List[float] = field(default_factory=list)
    request_done_times: List[float] = field(default_factory=list)
    requests_arrived: int = 0
    requests_done: int = 0
    requests_requeued: int = 0      # in-flight requests bounced by VM loss
    #: (t, old_units, new_units) per AUTOSCALE evaluation (old == new when
    #: the policy or its hysteresis/cooldown damping held the target)
    autoscale_decisions: List[tuple] = field(default_factory=list)

    def on_transition(self, vm: Vm, old: VmState, new: VmState) -> None:
        """Update the incremental counters for one VM state change."""
        table = _BUCKET_SPOT if vm.vm_type is VmType.SPOT else _BUCKET_OD
        a = table[old]
        b = table[new]
        if a != b:
            if a:
                self.state_counts[a] -= 1
            if b:
                self.state_counts[b] += 1

    def record_sample(self, t: float) -> None:
        """Append a timeline sample from the incremental counters — O(1)."""
        c = self.state_counts
        self.timeline.append((t, c[1], c[2], c[3], c[4]))

    def record_state(self, t: float, vms: Dict[int, Vm]) -> None:
        """Legacy full-scan recording (O(V) per call); kept as the oracle the
        incremental counters are validated against in tests."""
        spot = od = waiting = hib = 0
        for v in vms.values():
            if v.state in (VmState.RUNNING, VmState.INTERRUPTING):
                if v.vm_type is VmType.SPOT:
                    spot += 1
                else:
                    od += 1
            elif v.state is VmState.WAITING:
                waiting += 1
            elif v.state is VmState.HIBERNATED:
                hib += 1
        self.timeline.append((t, spot, od, waiting, hib))

    # -- aggregate statistics -------------------------------------------------
    def interruption_count(self) -> int:
        return len(self.interruption_events)

    def spot_stats(self, vms: Dict[int, Vm]) -> dict:
        """Aggregates matching the paper's Figs. 14–15 and §VII-D2."""
        gaps: List[float] = []
        per_vm_interruptions: List[int] = []
        finished = finished_after_interruption = terminated = 0
        uninterrupted_finished = 0
        for v in vms.values():
            if v.vm_type is not VmType.SPOT:
                continue
            g = v.interruption_gaps()
            gaps.extend(g)
            per_vm_interruptions.append(v.interruptions)
            if v.state is VmState.FINISHED:
                finished += 1
                if v.interruptions > 0:
                    finished_after_interruption += 1
                else:
                    uninterrupted_finished += 1
            elif v.state is VmState.TERMINATED:
                terminated += 1
        return {
            "interruptions": self.interruption_count(),
            "avg_interruption_time": float(np.mean(gaps)) if gaps else 0.0,
            "max_interruption_time": float(np.max(gaps)) if gaps else 0.0,
            "min_interruption_time": float(np.min(gaps)) if gaps else 0.0,
            "max_interruptions_per_vm": int(max(per_vm_interruptions, default=0)),
            "resumed_gaps": len(gaps),
            "spot_finished": finished,
            "spot_finished_after_interruption": finished_after_interruption,
            "spot_finished_uninterrupted": uninterrupted_finished,
            "spot_terminated": terminated,
        }

    def market_stats(self) -> dict:
        """Price/wave aggregates of a market-engine run (paper-style market
        risk summary).  All-zero when no engine was attached."""
        waves = self.wave_events
        sizes = [w.size for w in waves]
        price_interruptions = sum(
            1 for e in self.interruption_events
            if e.cause == InterruptionCause.PRICE_WAVE)
        by_pool: Dict[int, List[float]] = {}
        for (_, pid, price) in self.price_series:
            by_pool.setdefault(pid, []).append(price)
        pool_rows = {
            pid: {
                "mean_price": float(np.mean(ps)),
                "max_price": float(np.max(ps)),
                "price_cv": float(np.std(ps) / max(np.mean(ps), 1e-12)),
            }
            for pid, ps in sorted(by_pool.items())
        }
        return {
            "waves": len(waves),
            "wave_victims": int(sum(sizes)),
            "max_wave_size": int(max(sizes, default=0)),
            "price_interruptions": price_interruptions,
            "pools": pool_rows,
        }

    def migration_stats(self, vms: Optional[Dict[int, Vm]] = None,
                        engine=None) -> dict:
        """Aggregates of the proactive migration subsystem.  With ``vms`` and
        the run's :class:`repro.market.engine.MarketEngine`, also reports the
        *realized* saving of each completed migration — the price-gap
        integral ∫ (price_src − price_dst) dt (both capped at the VM's bid,
        matching billing) over the interval the VM actually ran on its
        destination — next to the planner's prediction."""
        out = {
            "planned": self.migrations_planned,
            "started": self.migrations_started,
            "completed": self.migrations_completed,
            "failed": self.migrations_failed,
            "downtime_s": round(self.migration_downtime, 3),
            "predicted_saving": float(sum(
                e.predicted_saving for e in self.migration_events
                if e.t_complete >= 0 and not e.failed)),
        }
        if vms is None or engine is None:
            return out
        # an interval still open at end-of-run realizes savings up to the
        # engine's last reprice (otherwise in-flight migrations would count
        # their prediction but contribute zero realization)
        ts = engine.tick_times()
        end = float(ts[-1]) if ts.size else 0.0
        # gather every realized span, then bill src and dst in one batched
        # price_integrals call each (the scalar capped integral scans the
        # whole price history per call — per-event billing would be
        # O(events × ticks))
        src_p: List[int] = []
        dst_p: List[int] = []
        t0s: List[float] = []
        t1s: List[float] = []
        caps: List[float] = []
        for e in self.migration_events:
            if e.t_complete < 0 or e.failed:
                continue
            vm = vms[e.vm_id]
            for itv in vm.history:
                if itv.start == e.t_complete and itv.host == e.dst_host:
                    stop = (itv.stop if itv.stop is not None
                            else max(end, e.t_complete))
                    src_p.append(e.src_pool)
                    dst_p.append(e.dst_pool)
                    t0s.append(itv.start)
                    t1s.append(stop)
                    caps.append(e.bid)
                    break
        t0a, t1a, capa = (np.asarray(t0s), np.asarray(t1s),
                          np.asarray(caps))
        src_int = engine.price_integrals(np.asarray(src_p, dtype=np.int64),
                                         t0a, t1a, capa)
        dst_int = engine.price_integrals(np.asarray(dst_p, dtype=np.int64),
                                         t0a, t1a, capa)
        # sequential left-to-right accumulation, matching the historical
        # per-event loop bit for bit (a .sum()-of-sums reorders the floats)
        out["realized_saving"] = float(sum((src_int - dst_int).tolist(),
                                           0.0))
        return out

    def resilience_stats(self, vms: Optional[Dict[int, Vm]] = None,
                         engine=None, host_pool=None) -> dict:
        """Fleet resilience aggregates (all-zero when no fleet manager ran).

        Core statistics integrate the per-tick ``fleet_samples`` series
        piecewise-constant: *time below target capacity* (seconds the fleet's
        running CPU sat under its effective target), *shortfall area*
        (∫ max(target − up, 0) dt, CPU·seconds — how deep × how long), and a
        per-fault *recovery time* (from the fault start to the first sample
        back at target after the dip; censored at the last sample when the
        fleet never recovered).  With ``vms`` + the run's engine + host pool,
        also bills the fleet's realized cost: spot launches through one
        batched :meth:`~repro.market.engine.MarketEngine.price_integrals`
        call (clearing price capped at bid, the billing contract), on-demand
        spill at the pools' flat on-demand rates — both in price·hours, the
        same unit as :func:`~repro.market.pricing.realized_cost_stats`."""
        samples = self.fleet_samples
        out = {
            "time_below_target": 0.0,
            "shortfall_area": 0.0,
            "time_below_frac": 0.0,
            "fleet_launches": self.fleet_launches,
            "od_spill_launches": self.od_spill_launches,
            "slots_retired": self.fleet_slots_retired,
            "fallback_counts": dict(sorted(self.fallback_counts.items())),
            "faults_fired": len(self.fault_records),
            "mean_recovery_s": 0.0,
            "max_recovery_s": 0.0,
        }
        if len(samples) >= 2:
            arr = np.asarray(samples, dtype=np.float64)
            t, up, tgt = arr[:, 0], arr[:, 1], arr[:, 2]
            dt = np.diff(t)
            short = np.maximum(tgt[:-1] - up[:-1], 0.0)
            below = short > 1e-12
            out["time_below_target"] = float(np.sum(dt[below]))
            out["shortfall_area"] = float(np.sum(short * dt))
            span = float(t[-1] - t[0])
            if span > 0:
                out["time_below_frac"] = out["time_below_target"] / span
            # per-fault recovery: from the fault start, find the dip below
            # the effective target, then the first sample back at it
            recoveries = []
            fault_rows = []
            for rec in self.fault_records:
                after = np.flatnonzero(t >= rec.t0 - 1e-9)
                r = 0.0
                censored = False
                if after.size:
                    dips = after[up[after] < tgt[after] - 1e-12]
                    if dips.size:
                        d0 = dips[0]
                        back = np.flatnonzero(up[d0:] >= tgt[d0:] - 1e-12)
                        if back.size:
                            r = float(t[d0 + back[0]] - rec.t0)
                        else:
                            r = float(t[-1] - rec.t0)
                            censored = True
                recoveries.append(r)
                fault_rows.append({
                    "kind": rec.kind, "t0": rec.t0,
                    "recovery_s": round(r, 3), "censored": censored,
                })
            if recoveries:
                out["mean_recovery_s"] = float(np.mean(recoveries))
                out["max_recovery_s"] = float(np.max(recoveries))
            out["faults"] = fault_rows
        if vms is None or engine is None or host_pool is None:
            return out
        # realized fleet billing: one batched integral call for every closed
        # spot interval, flat od rate × duration for the spill
        pool_of = host_pool.pool_of
        pids: List[int] = []
        t0s: List[float] = []
        t1s: List[float] = []
        caps: List[float] = []
        for vid in self.fleet_spot_ids:
            vm = vms[vid]
            for itv in vm.history:
                if itv.stop is None:
                    continue
                pids.append(int(pool_of[itv.host]))
                t0s.append(itv.start)
                t1s.append(itv.stop)
                caps.append(vm.bid)
        integrals = engine.price_integrals(
            np.asarray(pids, dtype=np.int64), np.asarray(t0s),
            np.asarray(t1s), np.asarray(caps))
        out["fleet_spot_cost"] = float(sum(integrals.tolist(), 0.0)) / 3600.0
        od_rates = engine.od_rates
        spill = 0.0
        for vid in self.fleet_od_ids:
            vm = vms[vid]
            for itv in vm.history:
                if itv.stop is None:
                    continue
                spill += float(od_rates[int(pool_of[itv.host])]) * (
                    itv.stop - itv.start) / 3600.0
        out["od_spill_cost"] = spill
        return out


# ---------------------------------------------------------------------------
# Table builders (DynamicVmTableBuilder / SpotVmTableBuilder /
# ExecutionTableBuilder equivalents)
# ---------------------------------------------------------------------------
def dynamic_vm_table(vms: List[Vm]) -> List[dict]:
    rows = []
    for v in vms:
        start = v.history[0].start if v.history else -1.0
        stop = v.history[-1].stop if v.history and v.history[-1].stop is not None else -1.0
        rows.append({
            "vm_id": v.id,
            "host": v.history[-1].host if v.history else -1,
            "cpu": float(v.demand[0]),
            "ram": float(v.demand[1]),
            "start_time": start,
            "stop_time": stop,
            "submission_delay": v.submit_time,
            "type": v.vm_type.value,
            "state": v.state.value,
        })
    return rows


def spot_vm_table(vms: List[Vm]) -> List[dict]:
    rows = []
    for v in vms:
        if v.vm_type is not VmType.SPOT:
            continue
        rows.append({
            "vm_id": v.id,
            "cpu": float(v.demand[0]),
            "state": v.state.value,
            "interruptions": v.interruptions,
            "avg_interruption_time": v.average_interruption_time(),
        })
    return rows


def execution_table(vms: List[Vm]) -> List[dict]:
    rows = []
    for v in vms:
        for i, itv in enumerate(v.history):
            rows.append({
                "vm_id": v.id,
                "interval": i,
                "host": itv.host,
                "start": itv.start,
                "stop": itv.stop if itv.stop is not None else -1.0,
            })
    return rows


def to_csv(rows: List[dict], path: Optional[str] = None) -> str:
    buf = io.StringIO()
    if rows:
        writer = csv.DictWriter(buf, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    out = buf.getvalue()
    if path:
        with open(path, "w") as f:
            f.write(out)
    return out


def to_json(rows: List[dict], path: Optional[str] = None) -> str:
    out = json.dumps(rows, indent=1)
    if path:
        with open(path, "w") as f:
            f.write(out)
    return out
