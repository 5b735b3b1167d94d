"""The training slice on a card: the CUDA kernels refuse inputs that need a
gradient (a loss through them raises, naming ``impl="xla"``), a training
step on the card through the plain functions agrees with the same step on
the CPU, restarts continue exactly, and the MoE forward is bit-equal across
reruns.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_train_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.elastic import CheckpointManager
from repro_torch.kernels import ops
from repro_torch.models import model as tm
from repro_torch.train import (DataConfig, SyntheticDataset, init_train_state,
                               make_eval_step, make_loss_fn, make_train_step)
from repro_torch.train.train_step import batch_to_device


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(cfg, device, batch=2, seq_len=40, seed=0):
    return batch_to_device(SyntheticDataset(cfg, DataConfig(
        batch=batch, seq_len=seq_len, seed=seed)).next_batch(), device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_refuse_inputs_that_need_grad(cuda, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(
        cuda, dtype) for s in ((1, 4, 64, 64), (1, 2, 64, 64), (1, 2, 64, 64)))
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match='impl="xla"'):
        ops.attention(q, k, v)
    with torch.no_grad():
        assert ops.attention(q, k, v).shape == q.shape
    x = torch.randn(1, 16, 32, device=cuda, dtype=dtype)
    dt = torch.rand(1, 16, 32, device=cuda, dtype=dtype) * 0.1
    a = -torch.rand(32, 8, device=cuda, requires_grad=True)
    b, c = (torch.randn(1, 16, 8, device=cuda, dtype=dtype) for _ in range(2))
    d = torch.ones(32, device=cuda)
    with pytest.raises(RuntimeError, match='impl="xla"'):
        ops.selective_scan(x, dt, a, b, c, d)
    with torch.no_grad():
        assert ops.selective_scan(x, dt, a, b, c, d)[0].shape == x.shape


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba_1_5b", "granite_moe_3b_a800m",
                                  "falcon_mamba_7b"])
def test_loss_through_kernels_raises_and_eval_agrees(cuda, arch):
    cfg = tcfg.get_smoke_config(arch)
    state = init_train_state(cfg, torch.Generator(cuda).manual_seed(0), device=cuda)
    batch = _batch(cfg, cuda)
    with pytest.raises(RuntimeError, match='impl="xla"'):
        make_loss_fn(cfg, impl="kernel")(state.params, batch)
    got = make_eval_step(cfg, impl="kernel")(state.params, batch)
    want = make_eval_step(cfg)(state.params, batch)
    assert float(got) == pytest.approx(float(want), rel=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek_7b", "hymba_1_5b",
                                  "granite_moe_3b_a800m", "kimi_k2_1t_a32b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """Two f32 steps from the same weights on the card and on the CPU:
    losses and grad norms at ``rel=1e-4`` (other kernels, other sums)."""
    cfg = tcfg.get_smoke_config(arch)
    weights = init_train_state(cfg, torch.Generator().manual_seed(0)).params
    metrics = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(cfg, torch.Generator(dev).manual_seed(1),
                                 device=dev)
        state.params.load_state_dict(weights.state_dict())
        step = make_train_step(cfg, lr_kwargs={"warmup": 0, "peak": 1e-3})
        out = []
        for i in range(2):
            state, m = step(state, _batch(cfg, dev, seed=i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        metrics[dev] = out
    np.testing.assert_allclose(metrics["cuda"], metrics["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_restart_continues_exactly_on_card(cuda, tmp_path):
    cfg = tcfg.get_smoke_config("hymba_1_5b")
    dcfg = DataConfig(batch=4, seq_len=24, seed=0)
    step = make_train_step(cfg, lr_kwargs={"warmup": 2, "total": 50, "peak": 1e-3})

    def fresh(seed=0):
        return init_train_state(cfg, torch.Generator(cuda).manual_seed(seed),
                                device=cuda)

    state, ds, straight = fresh(), SyntheticDataset(cfg, dcfg), []
    for _ in range(8):
        state, m = step(state, batch_to_device(ds.next_batch(), cuda))
        straight.append(float(m["loss"]))
    state, ds, resumed = fresh(), SyntheticDataset(cfg, dcfg), []
    cm = CheckpointManager(str(tmp_path), async_save=False)
    for _ in range(4):
        state, m = step(state, batch_to_device(ds.next_batch(), cuda))
        resumed.append(float(m["loss"]))
    cm.save(state, 4, {"data_step": ds.step})
    state, meta = cm.restore(fresh(seed=1))
    ds = SyntheticDataset(cfg, dcfg)
    ds.load_state_dict({"step": meta["data_step"], "seed": 0})
    for _ in range(4):
        state, m = step(state, batch_to_device(ds.next_batch(), cuda))
        resumed.append(float(m["loss"]))
    np.testing.assert_allclose(resumed, straight, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_bit_equal_reruns(cuda, dtype):
    cfg = tcfg.get_smoke_config("granite_moe_3b_a800m").replace(dtype=dtype)
    model = tm.init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 100))).to(cuda)
    with torch.inference_mode():
        a = tm.forward(cfg, model, tokens)
        b = tm.forward(cfg, model, tokens)
    assert torch.isfinite(a).all() and torch.equal(a, b)
