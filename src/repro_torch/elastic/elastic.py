"""Elastic data-parallel training driven by the spot market simulator.

The integration that makes the paper's technique a first-class feature of the
trainer: worker VMs hosting mesh slices are *spot instances* in a
:class:`repro_torch.core.MarketSimulator`; interruptions (capacity reclaimed
for on-demand load) shrink the data-parallel axis after an emergency
checkpoint inside the warning window, resumptions grow it back — the
training-side mirror of the paper's HIBERNATE/resume lifecycle (Fig. 4).

Global batch is invariant across rescales (per-replica batch is re-derived),
so the loss trajectory is comparable to the uninterrupted run.

A port of the reference package's ``elastic/elastic.py``.  The availability
timeline comes from the port's simulator, whose ``HlemVmpAdjusted`` scores
through the HLEM kernel on the card by default.

SPMD, as JAX runs it: every one of ``max_workers`` ranks (one process each,
a default process group over all of them: ``launch.mesh.spawn``, or a
single process, which gets a one-rank group of its own that lasts until
``launch.mesh.destroy_group``) runs the same
``train_elastic`` over the same timeline.  A mesh is a ``DeviceMesh`` over
ranks ``0..n_data-1`` (``build_mesh``; every rank creates it, in the same
order); ``configure`` restores the last checkpoint onto the new mesh's
placements (``train_state_specs``).  The ranks in the mesh each take their
``batch/n_data`` slice of the same global batch and step; the gradients
come out reduced through DTensor.  Ranks outside the mesh skip the steps
and meet the checkpoint barriers.  Losses are read on every mesh rank, and
rank 0 writes the checkpoints.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core import (
    HlemVmpAdjusted,
    MarketSimulator,
    SimConfig,
    make_on_demand,
    make_spot,
    resources,
)
from ..launch.mesh import ensure_group, make_mesh
from ..models.config import ArchConfig
from ..models.sharding import attach, full, tree_shardings, use_mesh
from ..train.data import DataConfig, SyntheticDataset
from ..train.train_step import (
    TrainState,
    batch_to_device,
    init_train_state,
    make_train_step,
    train_state_specs,
)
from .checkpoint import CheckpointManager

#: logical axes of a training batch
BATCH_SPECS = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}


# ---------------------------------------------------------------------------
# worker availability from the market simulator
# ---------------------------------------------------------------------------
@dataclass
class AvailabilityEvent:
    time: float
    available: int          # number of live workers after this event
    kind: str               # "interrupt" | "resume" | "start"


def simulate_worker_availability(
    n_workers: int,
    horizon: float,
    seed: int = 0,
    contention: float = 1.5,
    policy=None,
    device="cuda",
) -> List[AvailabilityEvent]:
    """Run a small spot market where our training workers are spot VMs and a
    background on-demand load creates contention. Returns the availability
    timeline of the worker fleet.  Without ``policy``, ``HlemVmpAdjusted``
    scores on ``device``."""
    rng = np.random.default_rng(seed)
    sim = MarketSimulator(
        policy=policy or HlemVmpAdjusted(device=device),
        config=SimConfig(record_timeline=False, warning_time=2.0))
    n_hosts = max(2, n_workers)
    for _ in range(n_hosts):
        sim.add_host(resources(8, 32_768, 10_000, 400_000))

    worker_demand = resources(4, 16_384, 4_000, 100_000)
    for i in range(n_workers):
        sim.submit(make_spot(i, worker_demand, duration=horizon * 10,
                             min_running_time=5.0,
                             hibernation_timeout=horizon * 10,
                             waiting_timeout=horizon * 10))

    # background on-demand churn
    vid = n_workers
    t = 0.0
    while t < horizon:
        t += float(rng.exponential(horizon / (6.0 * contention)))
        if t >= horizon:
            break
        cpu = float(rng.choice([4, 8]))
        dur = float(rng.uniform(horizon * 0.05, horizon * 0.2))
        sim.submit(make_on_demand(vid, resources(cpu, cpu * 4_096, 2_000,
                                                 50_000),
                                  dur, waiting_timeout=dur, submit_time=t))
        vid += 1

    events: List[AvailabilityEvent] = []
    live = {i: False for i in range(n_workers)}

    def on_alloc(sim, time, vm, host, resumed, **kw):
        if vm.id in live:
            live[vm.id] = True
            events.append(AvailabilityEvent(
                time, sum(live.values()), "resume" if resumed else "start"))

    def on_interrupt(sim, time, vm, kind, **kw):
        if vm.id in live:
            live[vm.id] = False
            events.append(AvailabilityEvent(time, sum(live.values()),
                                            "interrupt"))

    sim.on("vm_allocated", on_alloc)
    sim.on("vm_interrupted", on_interrupt)
    sim.run(until=horizon)
    return events


# ---------------------------------------------------------------------------
# elastic trainer
# ---------------------------------------------------------------------------
def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def build_mesh(n_data: int, n_model: int = 1, device="cuda") -> DeviceMesh:
    """A (data, model) mesh over ranks ``0..n_data*n_model-1`` of the
    default group (a one-rank group is started if none is running); raises
    ``ValueError`` when the group has fewer ranks.  Every rank of the group
    calls it, in the same order."""
    ensure_group(device)
    return make_mesh((n_data, n_model), ("data", "model"),
                     device=torch.device(device).type)


def shard_batch(batch, mesh: DeviceMesh):
    """A dataset batch (numpy, the same global batch on every rank) as
    DTensors on ``mesh``, split along the batch: each rank holds its
    ``batch/n_data`` rows."""
    tensors = batch_to_device(batch, mesh.device_type)
    with use_mesh(mesh):
        return attach(tensors, {k: BATCH_SPECS[k] for k in tensors})


@dataclass
class ElasticReport:
    steps_run: int = 0
    rescales: int = 0
    emergency_saves: int = 0
    restores: int = 0
    losses: List[float] = field(default_factory=list)
    mesh_history: List[Tuple[int, int]] = field(default_factory=list)


class ElasticTrainer:
    """Trains under a worker-availability timeline with checkpoint/rescale."""

    def __init__(self, cfg: ArchConfig, dcfg: DataConfig, ckpt_dir: str,
                 max_workers: int, impl: str = "xla", seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.dcfg = dcfg
        self.max_workers = max_workers
        self.impl = impl
        self.seed = seed
        self.device = torch.device(device)
        self.ckpt = CheckpointManager(ckpt_dir, keep_n=2, async_save=False)
        self.dataset = SyntheticDataset(cfg, dcfg)
        self.mesh: Optional[DeviceMesh] = None
        self.state: Optional[TrainState] = None
        self.step = 0               # on every rank, in the mesh or not
        self._step_fn = None
        self.n_data = 0
        self.report = ElasticReport()

    @property
    def in_mesh(self) -> bool:
        return self.mesh is not None and self.mesh.get_coordinate() is not None

    # -- (re)configuration ---------------------------------------------------
    def _init_state(self, device) -> TrainState:
        gen = torch.Generator(device=device).manual_seed(self.seed)
        return init_train_state(self.cfg, gen, device=device)

    def configure(self, n_workers: int) -> None:
        """(Re)build mesh for n_workers and restore/initialize state on it."""
        n_data = max(1, _pow2_floor(min(n_workers, self.max_workers)))
        if n_data == self.n_data and self.mesh is not None and (
                self.state is not None or not self.in_mesh):
            return
        prev_state_exists = self.state is not None or \
            self.ckpt.latest_step() is not None
        self.n_data = n_data
        self.mesh = build_mesh(n_data, device=self.device)
        self.state = None
        meta = {}
        if self.in_mesh:
            with use_mesh(self.mesh):
                specs = train_state_specs(self.cfg)
                state = self._init_state(self.device)
                if prev_state_exists:
                    state, meta = self.ckpt.restore(
                        state, shardings=tree_shardings(specs))
                else:
                    state = attach(state, specs)
            self.state = state
            self._step_fn = make_train_step(self.cfg, impl=self.impl)
        elif prev_state_exists:
            meta = self.ckpt.read_meta()
        if prev_state_exists:
            self.step = int(meta["step"])
            if "data_step" in meta:
                self.dataset.load_state_dict(
                    {"step": meta["data_step"], "seed": self.dcfg.seed})
            self.report.restores += 1
        self.report.rescales += 1
        self.report.mesh_history.append((self.step, n_data))

    # -- event handlers --------------------------------------------------------
    def on_warning(self) -> None:
        """Spot interruption warning: emergency checkpoint (every rank)."""
        self.ckpt.save_on_warning(
            self.state, self.step, {"data_step": self.dataset.step})
        self.report.emergency_saves += 1

    # -- training -------------------------------------------------------------
    def run_steps(self, n: int, checkpoint_every: int = 50) -> None:
        if self.mesh is None:
            raise RuntimeError("configure() first")
        for _ in range(n):
            batch = self.dataset.next_batch()
            self.step += 1
            self.report.steps_run += 1
            if self.in_mesh:
                with use_mesh(self.mesh):
                    self.state, metrics = self._step_fn(
                        self.state, shard_batch(batch, self.mesh))
                self.report.losses.append(float(full(metrics["loss"])))
            if checkpoint_every and self.step % checkpoint_every == 0:
                self.ckpt.save(self.state, self.step,
                               {"data_step": self.dataset.step})

    def train_elastic(self, total_steps: int,
                      events: List[AvailabilityEvent],
                      steps_per_sim_unit: float = 1.0,
                      min_workers: int = 1) -> ElasticReport:
        """Interleave training with the availability timeline."""
        timeline = sorted(events, key=lambda e: e.time)
        idx = 0
        current = self.max_workers
        self.configure(current)
        while self.report.steps_run < total_steps:
            next_change = (timeline[idx].time * steps_per_sim_unit
                           if idx < len(timeline) else float("inf"))
            target = min(total_steps,
                         int(next_change) if next_change != float("inf")
                         else total_steps)
            chunk = max(0, target - self.report.steps_run)
            if chunk:
                self.run_steps(chunk)
            if idx < len(timeline) and self.report.steps_run < total_steps:
                ev = timeline[idx]
                idx += 1
                new_workers = max(min_workers, ev.available)
                if ev.kind == "interrupt":
                    self.on_warning()          # save within warning window
                if _pow2_floor(new_workers) != self.n_data:
                    # final sync checkpoint then re-mesh + restore
                    self.ckpt.save(self.state, self.step,
                                   {"data_step": self.dataset.step},
                                   block=True)
                    self.state = None
                    self.configure(new_workers)
        return self.report
