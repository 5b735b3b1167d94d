"""The port's ``repro_torch.elastic`` on the CPU: the cases of the
reference's ``tests/runtime/test_{checkpoint,compression_straggler,
placement}.py`` one for one, and the port's ``ClusterScheduler``,
``simulate_worker_availability`` (``device="cpu"``: the HLEM kernel's plain
PyTorch version) and ``ElasticTrainer`` against the reference's on the same
inputs: at width 1 in this process, and rescaling 8 -> 4 -> 8 on 8 gloo
ranks (``launch.mesh.spawn``)."""
import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.elastic as relastic
from repro.train import DataConfig as RDataConfig
from repro.train import init_train_state as rinit
import repro_torch.configs as tcfg
import repro_torch.elastic.elastic as telastic_mod
from repro_torch.elastic import (
    AvailabilityEvent,
    CheckpointManager,
    ClusterScheduler,
    ElasticTrainer,
    JobSpec,
    StragglerDetector,
    build_mesh,
    compress_tree,
    compressed_grad_combine,
    decompress_tree,
    dequantize_int8,
    init_error_feedback,
    masked_grad_mean,
    quantize_int8,
    simulate_worker_availability,
)
from repro_torch.elastic.checkpoint import _flatten
from repro_torch.launch.mesh import destroy_group, spawn
from repro_torch.models.weights import train_state_from_jax
from repro_torch.train import DataConfig, init_train_state
from torch.distributed.device_mesh import DeviceMesh


@pytest.fixture(autouse=True)
def _end_process_group():
    """A trainer alone in this process starts a one-rank process group:
    end it, so that no later test finds one."""
    yield
    destroy_group()


def _leaves_equal(a, b):
    la, lb = _flatten(a), _flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype
            assert torch.equal(x.detach(), y.detach())
        else:
            assert x == y


def test_exports_equal_the_reference():
    import repro_torch.elastic as telastic

    assert set(telastic.__all__) == set(relastic.__all__)


# ---------------------------------------------------------------------------
# checkpoint (tests/runtime/test_checkpoint.py)
# ---------------------------------------------------------------------------
@pytest.fixture
def state():
    cfg = tcfg.get_smoke_config("deepseek_7b")
    return init_train_state(cfg, torch.Generator().manual_seed(0))


def _template(dtype="float32"):
    cfg = tcfg.get_smoke_config("deepseek_7b").replace(dtype=dtype)
    return init_train_state(cfg, torch.Generator().manual_seed(1))


def test_roundtrip(tmp_path, state):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(state._replace(step=5), 5, {"data_step": 17})
    restored, meta = cm.restore(_template())
    assert meta["step"] == 5 and meta["data_step"] == 17
    assert restored.step == 5
    _leaves_equal(state._replace(step=5), restored)


def test_bf16_leaves_roundtrip_exactly(tmp_path):
    """numpy has no bfloat16: saved widened to f32, restored as bf16."""
    cfg = tcfg.get_smoke_config("deepseek_7b").replace(dtype="bfloat16")
    st = init_train_state(cfg, torch.Generator().manual_seed(0))
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(st, 1)
    with np.load(tmp_path / "step_1" / "arrays.npz") as npz:
        assert all(npz[k].dtype != np.dtype("V2") for k in npz.files)
    restored, _ = cm.restore(_template("bfloat16"))
    assert restored.params.lm_head.dtype == torch.bfloat16
    _leaves_equal(st, restored)


def test_save_takes_host_copies(tmp_path, state):
    """The step updates parameters in place: what an async save writes is
    the state at the save, whatever happens to the tensors after it."""
    want = [t.detach().clone() for t in _flatten(state.params)]
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(state, 1)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    cm.wait()
    restored, _ = cm.restore(_template())
    for w, g in zip(want, _flatten(restored.params)):
        assert torch.equal(w, g)


def test_async_save_and_wait(tmp_path, state):
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(state, 1)
    cm.save(state, 2)
    cm.wait()
    assert cm.all_steps() == [1, 2]


def test_blocking_save_waits_for_queued_saves(tmp_path, state):
    """A periodic async save and the final blocking save of the same step
    (the launcher's last step on a checkpoint boundary) do not race."""
    cm = CheckpointManager(str(tmp_path), async_save=True)
    for _ in range(3):
        cm.save(state, 4)
        cm.save(state, 4, {"final": True}, block=True)
        with open(tmp_path / "step_4" / "meta.json") as f:
            assert json.load(f)["final"] is True
    assert cm.all_steps() == [4] and not os.path.exists(tmp_path / "step_4.tmp")


def test_keep_n_gc(tmp_path, state):
    cm = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in [1, 2, 3, 4]:
        cm.save(state, s)
    assert cm.all_steps() == [3, 4]


def test_atomicity_tmp_dirs_ignored(tmp_path, state):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(state, 1)
    # simulate a preemption mid-write: stale tmp dir + half-written step dir
    os.makedirs(tmp_path / "step_9.tmp")
    os.makedirs(tmp_path / "step_7")  # no meta.json -> incomplete
    assert cm.latest_step() == 1
    restored, meta = cm.restore(_template())
    assert meta["step"] == 1


def test_emergency_save_is_synchronous(tmp_path, state):
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save_on_warning(state, 3, {"data_step": 1})
    # must be on disk immediately, no wait() needed
    assert cm.latest_step() == 3
    with open(tmp_path / "step_3" / "meta.json") as f:
        meta = json.load(f)
    assert meta["emergency"] is True
    assert set(meta) >= {"step", "n_leaves", "written_at", "data_step"}


def test_leaf_count_mismatch_raises(tmp_path, state):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(state, 1)
    with pytest.raises(ValueError, match="leaves"):
        cm.restore({"just_one": torch.zeros(3)})


# ---------------------------------------------------------------------------
# compression and stragglers (tests/runtime/test_compression_straggler.py)
# ---------------------------------------------------------------------------
def test_quantize_dequantize_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (64, 64)).astype(
        np.float32))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7


def test_quantize_matches_reference():
    x = np.random.default_rng(1).normal(0, 3, (33, 17)).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = relastic.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)


def test_error_feedback_accumulates_residual():
    g = {"w": torch.tensor([[0.001, 1.0], [-0.5, 0.002]])}
    ef = init_error_feedback(g)
    out, ef2 = compressed_grad_combine(g, ef)
    torch.testing.assert_close(ef2["w"], g["w"] - out["w"], rtol=0, atol=1e-7)
    q, s, _ = compress_tree(g, ef)
    assert q["w"].dtype == torch.int8
    torch.testing.assert_close(decompress_tree(q, s, g)["w"], out["w"])


def test_ef_sgd_converges_like_uncompressed():
    """Quadratic convergence with int8+EF gradients ~ matches full precision."""
    target = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (16, 16)).astype(
        np.float32))

    def run(compressed):
        w = {"w": torch.zeros(16, 16)}
        ef = init_error_feedback(w)
        for _ in range(200):
            g = {"w": 2 * (w["w"] - target)}
            if compressed:
                g, ef = compressed_grad_combine(g, ef)
            w = {"w": w["w"] - 0.05 * g["w"]}
        return float(torch.mean((w["w"] - target) ** 2))

    full = run(False)
    comp = run(True)
    assert comp < 1e-3, comp
    assert comp < full * 10 + 1e-4


def test_compression_ratio_is_4x():
    q, s = quantize_int8(torch.zeros(1024))
    assert q.dtype == torch.int8  # 4x fewer bytes across the pod links


def test_masked_grad_mean_drops_stragglers():
    g = {"w": torch.stack([torch.full((4,), 1.0), torch.full((4,), 3.0),
                           torch.full((4,), 100.0)])}
    out = masked_grad_mean(g, torch.tensor([True, True, False]))
    torch.testing.assert_close(out["w"], torch.full((4,), 2.0))


def test_masked_grad_mean_all_arrived():
    g = {"w": torch.stack([torch.full((2,), 1.0), torch.full((2,), 2.0)])}
    out = masked_grad_mean(g, torch.tensor([True, True]))
    torch.testing.assert_close(out["w"], torch.full((2,), 1.5))


def test_straggler_detector_flags_persistent_slow_host():
    det = StragglerDetector(threshold=1.5, patience=2)
    for step in range(4):
        for h in range(4):
            det.observe(h, 1.0 if h != 3 else 3.0)
        flagged = det.stragglers()
    assert flagged == [3]


def test_straggler_detector_recovers():
    det = StragglerDetector(threshold=1.5, patience=2, alpha=1.0)
    for h in range(3):
        det.observe(h, 1.0)
    det.observe(0, 5.0)
    det.stragglers()
    det.observe(0, 1.0)  # back to normal -> strikes reset
    assert det.stragglers() == []


# ---------------------------------------------------------------------------
# placement (tests/runtime/test_placement.py), then against the reference
# ---------------------------------------------------------------------------
def test_jobs_placed_and_spread():
    cs = ClusterScheduler(n_slices=4, warning_s=0.0, device="cpu")
    for i in range(4):
        cs.submit(JobSpec(f"train-{i}", chips=128, hbm_gb=2048,
                          ici_gbps=10_000, host_ram_gb=6_000,
                          duration_h=2.0, preemptible=True))
    cs.run(until_h=0.01)
    placement = cs.placement()
    assert all(h >= 0 for h in placement.values())
    # adjusted HLEM spreads spot jobs across slices
    assert len(set(placement.values())) == 4


def test_reserved_job_preempts_spot():
    cs = ClusterScheduler(n_slices=1, warning_s=0.0, device="cpu")
    cs.submit(JobSpec("spot-a", chips=200, hbm_gb=3000, ici_gbps=20_000,
                      host_ram_gb=10_000, duration_h=10.0, preemptible=True))
    cs.submit(JobSpec("prod", chips=200, hbm_gb=3000, ici_gbps=20_000,
                      host_ram_gb=10_000, duration_h=1.0, preemptible=False),
              at=3600.0)  # after min_running_time
    cs.run(until_h=1.2)
    states = cs.states()
    assert states["prod"] in ("running", "finished")
    assert states["spot-a"] in ("hibernated", "waiting", "running")
    assert cs._jobs["spot-a"].interruptions >= 1


def _job_mix(n):
    rng = np.random.default_rng(5)
    for i in range(n):
        chips = int(rng.choice([32, 64, 128, 256]))
        yield (JobSpec(f"job-{i}", chips=chips, hbm_gb=chips * 16.0,
                       ici_gbps=chips * 80.0, host_ram_gb=chips * 40.0,
                       duration_h=float(rng.uniform(0.5, 4.0)),
                       preemptible=bool(rng.random() < 0.7)),
               float(rng.uniform(0, 3 * 3600)))


@pytest.mark.parametrize("alpha", [-0.5, 0.0])
def test_cluster_scheduler_matches_reference(alpha):
    got = ClusterScheduler(n_slices=6, alpha=alpha, device="cpu")
    want = relastic.ClusterScheduler(n_slices=6, alpha=alpha)
    for (job, at) in _job_mix(30):
        assert got.submit(job, at=at) == want.submit(
            relastic.JobSpec(**vars(job)), at=at)
    got.run(until_h=5.0)
    want.run(until_h=5.0)
    assert got.placement() == want.placement()
    assert got.states() == want.states()


@pytest.mark.parametrize("n,horizon,seed", [(1, 20, 3), (1, 60, 7), (8, 100, 0),
                                            (32, 500, 2)])
def test_worker_availability_matches_reference(n, horizon, seed):
    got = simulate_worker_availability(n, horizon=horizon, seed=seed,
                                       device="cpu")
    want = relastic.simulate_worker_availability(n, horizon=horizon, seed=seed)
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert got[0].kind == "start"


def test_worker_availability_defaults_to_cuda():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            simulate_worker_availability(2, horizon=10)


# ---------------------------------------------------------------------------
# the elastic trainer at width 1
# ---------------------------------------------------------------------------
def test_build_mesh_counts_devices():
    """A process alone is a one-rank group: a (1, 1) mesh over rank 0, and
    a wider one raises."""
    mesh = build_mesh(1, device="cpu")
    assert isinstance(mesh, DeviceMesh) and mesh.device_type == "cpu"
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    assert mesh.mesh.tolist() == [[0]] and tuple(mesh.get_coordinate()) == (0, 0)
    with pytest.raises(ValueError, match="need 2 devices"):
        build_mesh(2, device="cpu")


def test_elastic_trainer_matches_reference(tmp_path, monkeypatch):
    """The same events (two interruptions) and the same initial state through both trainers: emergency saves, no rescale
    at width 1, and the losses at ``rtol=1e-5``."""
    arch, seed = "deepseek_7b", 0
    rc, pc = rcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
    jstate = jax.tree.map(np.asarray, rinit(rc, jax.random.PRNGKey(seed)))
    monkeypatch.setattr(telastic_mod, "init_train_state",
                        lambda cfg, gen, device=None: train_state_from_jax(
                            cfg, jstate, device))
    events = relastic.simulate_worker_availability(1, horizon=20, seed=3)
    assert sum(e.kind == "interrupt" for e in events) == 2
    kw = dict(batch=4, seq_len=16, seed=0)
    ref = relastic.ElasticTrainer(rc, RDataConfig(**kw), str(tmp_path / "r"),
                                  max_workers=1, seed=seed)
    want = ref.train_elastic(20, events)
    tr = ElasticTrainer(pc, DataConfig(**kw), str(tmp_path / "t"),
                        max_workers=1, seed=seed, device="cpu")
    got = tr.train_elastic(20, [AvailabilityEvent(**vars(e)) for e in events])
    for k in ("steps_run", "rescales", "emergency_saves", "restores",
              "mesh_history"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.emergency_saves == 2 and got.mesh_history == [(0, 1)]
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert tr.ckpt.all_steps() == ref.ckpt.all_steps()


def test_elastic_trainer_restores_on_reconfigure(tmp_path):
    """A configure after the state was dropped restores the last save and
    the data cursor (the re-mesh path, here at width 1)."""
    cfg = tcfg.get_smoke_config("deepseek_7b")
    tr = ElasticTrainer(cfg, DataConfig(batch=2, seq_len=8, seed=0),
                        str(tmp_path), max_workers=1, device="cpu")
    tr.configure(1)
    tr.run_steps(3)
    tr.ckpt.save(tr.state, int(tr.state.step), {"data_step": tr.dataset.step},
                 block=True)
    before = [t.clone() for t in _flatten(tr.state.params)]
    tr.state = None
    tr.dataset.step = 0
    tr.configure(1)
    assert tr.report.restores == 1 and tr.state.step == 3
    assert tr.dataset.step == 3
    for a, b in zip(before, _flatten(tr.state.params)):
        assert torch.equal(a, b)


def test_elastic_trainer_wider_than_the_process_raises(tmp_path):
    cfg = tcfg.get_smoke_config("deepseek_7b")
    tr = ElasticTrainer(cfg, DataConfig(batch=2, seq_len=8, seed=0),
                        str(tmp_path), max_workers=2, device="cpu")
    with pytest.raises(ValueError, match="need 2 devices"):
        tr.configure(2)


def _elastic_rank(rank, world, jstate_path, ckpt_dir, out_path):
    """One of 8 ranks of ``test_elastic_trainer_rescales``."""
    with open(jstate_path, "rb") as f:
        jstate = pickle.load(f)
    telastic_mod.init_train_state = (
        lambda cfg, gen, device=None: train_state_from_jax(cfg, jstate, device))
    cfg = tcfg.get_smoke_config("deepseek_7b")
    tr = ElasticTrainer(cfg, DataConfig(batch=8, seq_len=16, seed=0),
                        ckpt_dir, max_workers=8, device="cpu")
    rep = tr.train_elastic(total_steps=30, events=RESCALE_EVENTS)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(dataclasses.asdict(rep), f)


RESCALE_EVENTS = [AvailabilityEvent(10.0, 4, "interrupt"),
                  AvailabilityEvent(20.0, 8, "resume")]


def test_elastic_trainer_rescales(tmp_path):
    """The reference's ``tests/test_system.py::test_elastic_trainer_rescales``
    on 8 gloo ranks: interrupted to 4 at t=10, resumed to 8 at t=20, 30
    steps.  The global batch is invariant, so the losses follow the
    reference trainer's width-1 trajectory from the same initial state."""
    arch = "deepseek_7b"
    rc = rcfg.get_smoke_config(arch)
    jstate = jax.tree.map(np.asarray, rinit(rc, jax.random.PRNGKey(0)))
    with open(tmp_path / "init.pkl", "wb") as f:
        pickle.dump(jstate, f)
    spawn(_elastic_rank, 8, "gloo", timeout=240,
          args=(str(tmp_path / "init.pkl"), str(tmp_path / "ck"),
                str(tmp_path / "report.json")))
    with open(tmp_path / "report.json") as f:
        got = json.load(f)
    assert got["steps_run"] == 30, got["steps_run"]
    assert got["emergency_saves"] >= 1
    widths = [w for _, w in got["mesh_history"]]
    assert 4 in widths and 8 in widths
    assert got["mesh_history"] == [[0, 8], [10, 4], [20, 8]]

    kw = dict(batch=8, seq_len=16, seed=0)
    want = relastic.ElasticTrainer(
        rc, RDataConfig(**kw), str(tmp_path / "r"), max_workers=1,
        seed=0).train_elastic(30, [relastic.AvailabilityEvent(**vars(e))
                                   for e in RESCALE_EVENTS])
    assert len(got["losses"]) == 30
    np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-4)

