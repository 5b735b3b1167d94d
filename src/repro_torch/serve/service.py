"""ServeManager: the demand → queue → spot-capacity closed loop.

Driven by two self-scheduling simulator events:

* ``SERVE_TICK`` (cadence ``ServeConfig.tick``): integrate the demand
  curve into whole request arrivals (fractional-accumulator, no RNG in
  the hot path), map serving capacity onto the live fleet VMs — one
  :class:`~repro_torch.serve.scheduler.SpotServingScheduler` per VM, sized
  ``slots_per_vm`` — dispatch queued requests, advance every batch by
  ``tokens_per_s · dt`` decode tokens, and record per-request latencies.
* ``AUTOSCALE`` (cadence ``AutoscaleConfig.cadence``): assemble
  :class:`~repro_torch.serve.autoscale.DemandSignals` and apply the policy's
  damped decision through ``FleetManager.set_target_units``.

Interrupted (or finished / decommissioned) serving VMs requeue their
in-flight requests through the simulator's ordinary lifecycle listeners:
the per-VM scheduler's ``interrupt()`` applies the configured
hibernate-vs-requeue behavior, then everything it still holds drains back
into the global queue to be re-dispatched onto surviving capacity.

Determinism: request ids, arrival counts and token-length draws depend
only on (config, seed, event order); VM iteration is in sorted-id order;
the token-length generator is seeded per run.  Identical specs replay
bit for bit, serve-absent runs are untouched (the manager only exists
when ``ServeSpec`` is present).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import collections

import numpy as np

from ..core.types import VmState
from ..obs.eventlog import NULL_RECORDER
from ..obs.tracer import NULL_TRACER
from .autoscale import Autoscaler, DemandSignals
from .demand import DemandCurve
from .scheduler import Request, SpotServingScheduler

#: VM states that hold serving capacity (MIGRATING VMs are in flight and
#: decode nothing — their requests wait out the stop-and-copy window)
_SERVING_STATES = (VmState.RUNNING, VmState.INTERRUPTING)


@dataclass(frozen=True)
class ServeConfig:
    """Configuration of one serving scenario (the ``ServeSpec`` payload).

    ``tick`` paces the serving loop; each live fleet VM contributes
    ``slots_per_vm`` concurrent decode slots at ``tokens_per_s`` tokens/s
    each.  Request token lengths draw from an exponential with mean
    ``mean_tokens`` (seeded per run).  ``slo_latency_s`` / ``slo_objective``
    / ``window_s`` define the SLO: attainment is the fraction of requests
    served within the latency bound, the error budget ``1 − objective``
    burns per ``window_s`` window.  ``hibernate_requests`` selects the
    paper's HIBERNATE analogue at request granularity (keep decode
    progress across a VM loss) vs TERMINATE (restart from scratch)."""
    tick: float = 60.0
    slots_per_vm: int = 4
    tokens_per_s: float = 2.0
    prompt_len: int = 128
    mean_tokens: float = 240.0
    slo_latency_s: float = 300.0
    slo_objective: float = 0.95
    window_s: float = 1800.0
    hibernate_requests: bool = True

    @property
    def unit_throughput(self) -> float:
        """Requests/s one live VM sustains at steady state."""
        return self.slots_per_vm * self.tokens_per_s / self.mean_tokens


def validate_serve_config(cfg: ServeConfig) -> None:
    """Fail-fast validation (construction-time, fail-fast errors)."""
    if not cfg.tick > 0:
        raise ValueError(f"serve tick must be > 0 (got {cfg.tick!r})")
    if int(cfg.slots_per_vm) < 1:
        raise ValueError(
            f"serve slots_per_vm must be >= 1 (got {cfg.slots_per_vm!r})")
    if not cfg.tokens_per_s > 0:
        raise ValueError(
            f"serve tokens_per_s must be > 0 (got {cfg.tokens_per_s!r})")
    if int(cfg.prompt_len) < 0:
        raise ValueError(
            f"serve prompt_len must be >= 0 (got {cfg.prompt_len!r})")
    if not cfg.mean_tokens > 0:
        raise ValueError(
            f"serve mean_tokens must be > 0 (got {cfg.mean_tokens!r})")
    if not cfg.slo_latency_s > 0:
        raise ValueError(
            f"serve slo_latency_s must be > 0 (got {cfg.slo_latency_s!r})")
    if not 0.0 < cfg.slo_objective < 1.0:
        raise ValueError(
            f"serve slo_objective must be in (0, 1) "
            f"(got {cfg.slo_objective!r})")
    if not cfg.window_s > 0:
        raise ValueError(
            f"serve window_s must be > 0 (got {cfg.window_s!r})")


class ServeManager:
    """Holds the global request queue and the per-VM scheduler map.

    Stateful across one run; use a fresh manager per simulation, like the
    engine and the fleet manager."""

    #: telemetry hook (``repro_torch.obs``); the build layer swaps in the live
    #: tracer — arrival/served/requeue counters feed the counter registry
    tracer = NULL_TRACER
    #: event recorder — request/serve/autoscale records for the flight log
    events = NULL_RECORDER

    def __init__(self, config: ServeConfig,
                 autoscaler: Optional[Autoscaler] = None, seed: int = 0):
        validate_serve_config(config)
        self.config = config
        self.autoscaler = autoscaler
        self.curve: Optional[DemandCurve] = None
        self.seed = int(seed)
        # token-length draws only — arrivals come from the deterministic
        # fractional accumulator, so the sequence of generator calls is a
        # pure function of (config, seed, event order)
        self._rng = np.random.default_rng(0x5E12 + 7919 * self.seed)
        self._queue: Deque[Request] = collections.deque()
        self._scheds: Dict[int, SpotServingScheduler] = {}
        self._arrive_t: Dict[int, float] = {}
        self._next_id = 0
        self._accum = 0.0
        self._last_t = 0.0
        self._ewma: Optional[float] = None
        self._lat_window: Deque[Tuple[float, float]] = collections.deque()
        if autoscaler is not None:
            self._alpha = autoscaler.config.ewma_alpha
            self._window = autoscaler.config.latency_window
        else:
            self._alpha = 0.3
            self._window = 1800.0

    # ------------------------------------------------------------- queries
    def set_demand(self, curve: DemandCurve) -> None:
        """Attach the demand curve (called by the serve workload's
        ``populate`` — the curve's seed/horizon live in workload params)."""
        self.curve = curve

    def queue_depth(self) -> int:
        """Requests waiting anywhere: the global queue plus every per-VM
        scheduler's local queued + hibernated backlog."""
        depth = len(self._queue)
        for sched in self._scheds.values():
            depth += len(sched.queue) + len(sched.hibernated)
        return depth

    def pending(self) -> bool:
        """Outstanding requests (keeps an unbounded run's event chains
        alive until the backlog drains).  ``_arrive_t`` holds exactly the
        arrived-but-not-served ids — entries pop when the request is
        served."""
        return bool(self._arrive_t)

    def target_units(self, sim) -> int:
        if sim.fleet is not None:
            return int(sim.fleet.target_units)
        return len(self._scheds)

    # ---------------------------------------------------------------- tick
    def on_tick(self, sim, now: float) -> None:
        cfg = self.config
        m = sim.metrics
        dt = now - self._last_t
        self._last_t = now
        # -- arrivals: integrate the demand curve ---------------------------
        rate = float(self.curve(now)) if self.curve is not None else 0.0
        self._accum += rate * dt
        n_new = int(self._accum)
        self._accum -= n_new
        for _ in range(n_new):
            tokens = max(1, int(round(
                float(self._rng.exponential(cfg.mean_tokens)))))
            req = Request(id=self._next_id, prompt_len=int(cfg.prompt_len),
                          target_tokens=tokens)
            self._next_id += 1
            self._queue.append(req)
            self._arrive_t[req.id] = now
        m.requests_arrived += n_new
        obs_rate = n_new / dt if dt > 0 else 0.0
        self._ewma = (obs_rate if self._ewma is None
                      else self._alpha * obs_rate
                      + (1.0 - self._alpha) * self._ewma)
        if self.tracer.enabled and n_new:
            self.tracer.counters.inc("serve/arrivals", n_new)
        if self.events.enabled:
            self.events.emit(now, "request-arrive", a=float(n_new),
                             b=float(rate))
        # -- capacity sync: one scheduler per live serving VM ---------------
        live = self._live_vids(sim)
        live_set = set(live)
        for vid in sorted(self._scheds):
            if vid not in live_set:
                # left the serving set without an interrupt/finish event
                # (e.g. departed into a migration flight): requeue
                self._requeue_vm(sim, now, vid)
        for vid in live:
            if vid not in self._scheds:
                self._scheds[vid] = SpotServingScheduler(
                    batch_size=int(cfg.slots_per_vm),
                    hibernate=cfg.hibernate_requests)
        # -- dispatch + decode ----------------------------------------------
        tokens_dt = cfg.tokens_per_s * dt
        n_done = 0
        for vid in sorted(self._scheds):
            sched = self._scheds[vid]
            free = (cfg.slots_per_vm - len(sched.running)
                    - len(sched.hibernated) - len(sched.queue))
            while free > 0 and self._queue:
                sched.add(self._queue.popleft())
                free -= 1
            sched.fill_batch()
            if sched.running and tokens_dt > 0:
                sched.step(tokens_dt)
            while sched.done:
                r = sched.done.pop(0)
                lat = now - self._arrive_t.pop(r.id)
                m.request_latencies.append(lat)
                m.request_done_times.append(now)
                n_done += 1
                self._lat_window.append((now, lat))
                if self.events.enabled:
                    self.events.emit(now, "request-done", a=float(lat),
                                     b=float(r.target_tokens))
        m.requests_done += n_done
        if self.tracer.enabled and n_done:
            self.tracer.counters.inc("serve/done", n_done)
        while self._lat_window and self._lat_window[0][0] < now - self._window:
            self._lat_window.popleft()
        # -- sample ---------------------------------------------------------
        depth = self.queue_depth()
        tgt = self.target_units(sim)
        m.serve_samples.append((now, float(n_new), float(rate),
                                float(depth), float(len(self._scheds)),
                                float(tgt)))
        if self.events.enabled:
            self.events.emit(now, "serve-sample", a=float(depth),
                             b=float(len(self._scheds)))

    # ----------------------------------------------------------- autoscale
    def on_autoscale(self, sim, now: float) -> None:
        if self.autoscaler is None or sim.fleet is None:
            return
        cfg = self.config
        m = sim.metrics
        old = int(sim.fleet.target_units)
        p95 = float("nan")
        if self._lat_window:
            lats = np.asarray([x[1] for x in self._lat_window],
                              dtype=np.float64)
            p95 = float(np.percentile(lats, 95.0))
        lead = self.autoscaler.config.lead
        ahead = (float(self.curve(now + lead))
                 if self.curve is not None else 0.0)
        signals = DemandSignals(
            t=now, rate_ewma=self._ewma if self._ewma is not None else 0.0,
            queue_depth=self.queue_depth(), p95_latency=p95,
            live_units=len(self._scheds), target_units=old,
            unit_throughput=cfg.unit_throughput, rate_ahead=ahead)
        decided = self.autoscaler.decide(signals)
        new = old if decided is None else int(decided)
        m.autoscale_decisions.append((now, old, new))
        if self.events.enabled:
            self.events.emit(now, "autoscale", a=float(new), b=float(old),
                             aux=self.autoscaler.policy_name)
        if decided is not None:
            if self.tracer.enabled:
                self.tracer.counters.inc("autoscale/actions")
                self.tracer.instant("serve", "autoscale", now,
                                    {"from": old, "to": new})
            sim.fleet.set_target_units(sim, new, now)

    # ------------------------------------------------- lifecycle listeners
    def on_vm_interrupted(self, sim, time: float, vm, **kw) -> None:
        """Simulator ``vm_interrupted`` listener: a serving VM lost its
        capacity — bounce its in-flight requests through the configured
        hibernate/requeue behavior back into the global queue."""
        if vm.id in self._scheds:
            self._requeue_vm(sim, time, vm.id)

    def on_vm_finished(self, sim, time: float, vm, **kw) -> None:
        """Simulator ``vm_finished`` listener: an on-demand lease expired or
        the autoscaler decommissioned the VM — same requeue path."""
        if vm.id in self._scheds:
            self._requeue_vm(sim, time, vm.id)

    def _requeue_vm(self, sim, now: float, vid: int) -> None:
        sched = self._scheds.pop(vid)
        n_inflight = len(sched.running)
        sched.interrupt()
        moved = 0
        # hibernated first (the paper's resubmission order: checkpointed
        # requests resume before fresh queued work)
        for r in sched.hibernated:
            self._queue.append(r)
            moved += 1
        for r in sched.queue:
            self._queue.append(r)
            moved += 1
        m = sim.metrics
        m.requests_requeued += n_inflight
        if self.tracer.enabled and n_inflight:
            self.tracer.counters.inc("serve/requeued", n_inflight)
        if self.events.enabled:
            vm = sim.vms[vid]
            self.events.emit(now, "request-requeue", vm=vid,
                             pool=int(vm.pool), a=float(n_inflight),
                             b=float(moved))

    # ------------------------------------------------------------ internal
    def _live_vids(self, sim) -> List[int]:
        """Serving-capable VM ids, sorted (determinism): the fleet's live
        unretired/unshed slots, or — with no fleet attached — every running
        market spot VM."""
        fleet = sim.fleet
        if fleet is not None:
            vids = []
            for s in range(fleet.n_slots):
                if fleet.slot_retired[s] or fleet.slot_shed[s]:
                    continue
                vid = int(fleet.slot_vid[s])
                if vid < 0:
                    continue
                if sim.vms[vid].state in _SERVING_STATES:
                    vids.append(vid)
            vids.sort()
            return vids
        return sorted(v.id for v in sim.vms.values()
                      if v.pool >= 0 and v.state in _SERVING_STATES)


def make_serve_manager(config: Optional[ServeConfig] = None,
                       autoscaler: Optional[Autoscaler] = None,
                       seed: int = 0, **kwargs) -> ServeManager:
    """Build a manager from a config (or config kwargs); a bad config
    fails fast."""
    cfg = config if config is not None else ServeConfig(**kwargs)
    return ServeManager(cfg, autoscaler=autoscaler, seed=seed)
