"""The port's training stack (``repro_torch.train``) against the reference's
on the CPU: optimizer updates on the same trees, the schedule, the data
pipeline, the loss, and one ``make_train_step`` from the same state on every
family's smoke config, the state carried over with ``train_state_from_jax``
and the batches made by the (shared, numpy) dataset from a seed.

Tolerances: optimizer updates ``atol=1e-6`` (f32, one step, op order);
loss and ``grad_norm`` ``rel=1e-5`` and updated parameters and moments
``atol=2e-5``, those of ``tests/runtime/test_optimizer_and_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro import train as rt
import repro_torch.configs as tcfg
from repro_torch import train as tt
from repro_torch.models.weights import (_leaves, flatten_jax_params,
                                        param_leaves, train_state_from_jax)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.train.train_step import batch_to_device

OPT_ATOL = 1e-6
STEP_REL, STEP_ATOL = 1e-5, 2e-5


def test_exports_equal_the_reference_less_the_sharding_specs():
    assert set(tt.__all__) == set(rt.__all__)


@pytest.mark.parametrize("tq,tk,window,causal", [
    (100, 100, None, True), (70, 150, None, True), (100, 100, 24, True),
    (64, 64, None, True), (90, 130, None, False),
], ids=["ragged", "tq<tk", "window", "one-chunk", "no-mask"])
def test_mha_chunked_ref_matches_reference(tq, tk, window, causal):
    """Chunks of 32 keys, the last one padded (64 keys: the ``mha_ref``
    shortcut); values ``atol=2e-6``, and the gradient equals ``mha_ref``'s."""
    from repro.kernels import ref as jref

    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, s).astype(np.float32)
               for s in ((2, 4, tq, 16), (2, 2, tk, 16), (2, 2, tk, 16)))
    kw = dict(causal=causal, window=window)
    want = jref.mha_chunked_ref(*map(jnp.asarray, (q, k, v)), chunk=64 if tk == 64
                                else 32, **kw)
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tfa.mha_chunked_ref(tq_, tk_, tv_, chunk=64 if tk == 64 else 32, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6)
    g = torch.autograd.grad(got.square().sum(), (tq_, tk_, tv_))
    g_ref = torch.autograd.grad(tfa.mha_ref(tq_, tk_, tv_, **kw).square().sum(),
                                (tq_, tk_, tv_))
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (8, 6)).astype(np.float32),
            "b": rng.normal(0, 1, (6,)).astype(np.float32),
            "e": rng.normal(0, 1, (3, 4, 5)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("opt,kw", [
    ("adamw", {}), ("adamw", {"weight_decay": 0.0, "b2": 0.999}),
    ("adafactor", {}), ("adafactor", {"weight_decay": 0.05}),
])
def test_optimizer_updates_match(opt, kw):
    """Three updates on the same tree; Adafactor factors the 2-D and 3-D
    leaves (row (E, d), col (E, f) for the 3-D one)."""
    rinit, rupd = rt.make_optimizer(opt, **kw)[:2]
    tinit, tupd = tt.make_optimizer(opt, **kw)[:2]
    jp = {k: jnp.asarray(v) for k, v in _tree().items()}
    tp = _t(_tree())
    jst, tst = rinit(jp), tinit(tp)
    for i in range(3):
        g = _tree(10 + i)
        lr = 0.05 * (i + 1)
        jp, jst = rupd(jp, {k: jnp.asarray(v) for k, v in g.items()}, jst,
                       lr=jnp.float32(lr))
        tp, tst = tupd(tp, _t(g), tst, lr=torch.tensor(lr))
    assert tst.step == int(jst.step) == 3
    for k in jp:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=OPT_ATOL)
    for jm, tm in zip(jst[1:], tst[1:]):
        for k in jm:
            assert tuple(tm[k].shape) == jm[k].shape
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]),
                                       atol=OPT_ATOL)


def test_adafactor_factors_expert_weights():
    st = tt.adafactor_init({"w": torch.zeros(40, 16, 8)})
    assert st.row["w"].shape == (40, 16) and st.col["w"].shape == (40, 8)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_converge_on_quadratic(opt):
    target = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (8, 8)).astype(
        np.float32))
    w = torch.zeros(8, 8, requires_grad=True)
    init, upd = tt.make_optimizer(opt)[:2]
    st = init({"w": w})
    for _ in range(300):
        loss = torch.mean((w - target) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        _, st = upd({"w": w}, {"w": g}, st, lr=torch.tensor(0.05))
    assert float(torch.mean((w.detach() - target) ** 2)) < 0.02


@pytest.mark.parametrize("step", [0, 1, 7, 10, 55, 100, 150])
def test_lr_schedule_matches(step):
    kw = dict(peak=1.0, warmup=10, total=100, min_ratio=0.1)
    got = tt.lr_schedule(step, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(rt.lr_schedule(
        jnp.asarray(step), **kw)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["deepseek_7b", "musicgen_large"])
def test_data_batches_equal_reference(arch):
    dcfg_kw = dict(batch=3, seq_len=12, seed=4)
    rd = rt.SyntheticDataset(rcfg.get_smoke_config(arch), rt.DataConfig(**dcfg_kw))
    td = tt.SyntheticDataset(tcfg.get_smoke_config(arch), tt.DataConfig(**dcfg_kw))
    for _ in range(3):
        a, b = rd.next_batch(), td.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    st = td.state_dict()
    b_next = td.next_batch()
    again = tt.SyntheticDataset(tcfg.get_smoke_config(arch), tt.DataConfig(**dcfg_kw))
    again.load_state_dict(st)
    np.testing.assert_array_equal(again.next_batch()["tokens"], b_next["tokens"])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches(masked):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = rt.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = tt.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# one training step from the same state
# ---------------------------------------------------------------------------
def _states(arch, seed=0, **replace):
    rc = rcfg.get_smoke_config(arch).replace(**replace)
    pc = tcfg.get_smoke_config(arch).replace(**replace)
    jstate = rt.init_train_state(rc, jax.random.PRNGKey(seed))
    return rc, pc, jstate, train_state_from_jax(pc, jax.tree.map(np.asarray, jstate))


def _batch(cfg, batch=4, seq_len=16, seed=1):
    return rt.SyntheticDataset(cfg, rt.DataConfig(batch=batch, seq_len=seq_len,
                                                  seed=seed)).next_batch()


def _assert_states_close(pc, jstate, tstate):
    flat = flatten_jax_params(pc, jax.tree.map(np.asarray, jstate.params))
    sd = tstate.params.state_dict()
    for k, arr in flat.items():
        np.testing.assert_allclose(_np(sd[k]), arr, atol=STEP_ATOL, err_msg=k)
    leaves = param_leaves(pc, tstate.params)
    jopt = jax.tree.map(np.asarray, jstate.opt)
    assert tstate.opt.step == int(jopt.step)
    for jtree, ttree in zip(jopt[1:], tstate.opt[1:]):
        want = dict(_leaves(jtree))
        assert set(want) == set(ttree) == set(leaves)
        for k, arr in want.items():
            np.testing.assert_allclose(_np(ttree[k]), arr, atol=STEP_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("arch,accum", [
    ("deepseek_7b", 1), ("hymba_1_5b", 1), ("falcon_mamba_7b", 1),
    ("granite_moe_3b_a800m", 1), ("kimi_k2_1t_a32b", 2),
    ("musicgen_large", 1), ("starcoder2_15b", 1),
], ids=["deepseek", "hymba", "falcon-mamba", "granite-moe",
        "kimi-adafactor-bf16-accum", "musicgen", "starcoder2"])
def test_train_step_matches_reference(arch, accum):
    """kimi: Adafactor, and grad_accum 2 through its bf16 accumulator."""
    rc, pc, jstate, tstate = _states(arch)
    batch = _batch(rc)
    lr = {"warmup": 2, "total": 50, "peak": 1e-3}
    jstate, jm = jax.jit(rt.make_train_step(rc, lr_kwargs=lr, grad_accum=accum))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = tt.make_train_step(pc, lr_kwargs=lr, grad_accum=accum)(
        tstate, batch_to_device(batch, "cpu"))
    assert tstate.step == int(jstate.step) == 1
    for k in ("loss", "grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=STEP_REL), k
    # lr is 0 at step 0: take a second step so the parameters move
    batch = _batch(rc, seed=2)
    jstate, jm = jax.jit(rt.make_train_step(rc, lr_kwargs=lr, grad_accum=accum))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = tt.make_train_step(pc, lr_kwargs=lr, grad_accum=accum)(
        tstate, batch_to_device(batch, "cpu"))
    for k in ("loss", "grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=STEP_REL), k
    _assert_states_close(pc, jstate, tstate)


def test_train_step_with_list_layers_matches():
    """``scan_layers=False``: the reference's list of per-layer trees."""
    rc, pc, jstate, tstate = _states("kimi_k2_1t_a32b", scan_layers=False)
    batch = _batch(rc)
    lr = {"warmup": 0, "total": 50, "peak": 1e-3}
    jstate, jm = jax.jit(rt.make_train_step(rc, lr_kwargs=lr))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = tt.make_train_step(pc, lr_kwargs=lr)(tstate,
                                                       batch_to_device(batch, "cpu"))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=STEP_REL)
    _assert_states_close(pc, jstate, tstate)


def test_grad_accum_equivalent_to_full_batch():
    cfg = tcfg.get_smoke_config("deepseek_7b")
    batch = batch_to_device(tt.SyntheticDataset(cfg, tt.DataConfig(
        batch=8, seq_len=16, seed=1)).next_batch(), "cpu")
    lr = {"warmup": 0}
    s1 = tt.init_train_state(cfg, torch.Generator().manual_seed(0))
    s2 = tt.init_train_state(cfg, torch.Generator().manual_seed(0))
    s1, m1 = tt.make_train_step(cfg, grad_accum=1, lr_kwargs=lr)(s1, batch)
    s2, m2 = tt.make_train_step(cfg, grad_accum=4, lr_kwargs=lr)(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(s1.params.parameters(), s2.params.parameters()):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5)


def test_loss_decreases_over_training():
    cfg = tcfg.get_smoke_config("musicgen_large")
    state = tt.init_train_state(cfg, torch.Generator().manual_seed(0))
    ds = tt.SyntheticDataset(cfg, tt.DataConfig(batch=8, seq_len=32, seed=0))
    step = tt.make_train_step(cfg, lr_kwargs={"warmup": 3, "total": 60,
                                              "peak": 3e-3})
    losses = []
    for _ in range(30):
        state, m = step(state, batch_to_device(ds.next_batch(), "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_eval_step_kernel_path_equals_xla_on_cpu():
    cfg = tcfg.get_smoke_config("hymba_1_5b")
    state = tt.init_train_state(cfg, torch.Generator().manual_seed(0))
    batch = batch_to_device(tt.SyntheticDataset(cfg, tt.DataConfig(
        batch=2, seq_len=80, seed=0)).next_batch(), "cpu")   # S > chunk 64
    want = tt.make_eval_step(cfg)(state.params, batch)
    got = tt.make_eval_step(cfg, impl="kernel")(state.params, batch)
    assert not got.requires_grad
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_remat_gives_the_same_grads():
    cfg = tcfg.get_smoke_config("hymba_1_5b")
    batch = batch_to_device(tt.SyntheticDataset(cfg, tt.DataConfig(
        batch=2, seq_len=16, seed=0)).next_batch(), "cpu")
    grads = []
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        st = tt.init_train_state(c, torch.Generator().manual_seed(0))
        loss = tt.make_loss_fn(c)(st.params, batch)
        grads.append(torch.autograd.grad(loss, list(st.params.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_restart_continues_exactly(tmp_path):
    """8 steps straight equal 4 steps, a checkpoint, a restore into a fresh
    state and 4 more (``tests/test_system.py``'s case, ``rtol=1e-5``)."""
    from repro_torch.elastic import CheckpointManager

    cfg = tcfg.get_smoke_config("deepseek_7b")
    dcfg = tt.DataConfig(batch=4, seq_len=24, seed=0)
    step = tt.make_train_step(cfg, lr_kwargs={"warmup": 2, "total": 50,
                                              "peak": 1e-3})
    state = tt.init_train_state(cfg, torch.Generator().manual_seed(0))
    ds = tt.SyntheticDataset(cfg, dcfg)
    losses_a = []
    for _ in range(8):
        state, m = step(state, batch_to_device(ds.next_batch(), "cpu"))
        losses_a.append(float(m["loss"]))

    cm = CheckpointManager(str(tmp_path), async_save=False)
    state_b = tt.init_train_state(cfg, torch.Generator().manual_seed(0))
    ds_b = tt.SyntheticDataset(cfg, dcfg)
    losses_b = []
    for _ in range(4):
        state_b, m = step(state_b, batch_to_device(ds_b.next_batch(), "cpu"))
        losses_b.append(float(m["loss"]))
    cm.save(state_b, 4, {"data_step": ds_b.step})
    del state_b
    template = tt.init_train_state(cfg, torch.Generator().manual_seed(7))
    restored, meta = cm.restore(template)
    assert restored.step == 4 and restored.opt.step == 4
    ds_c = tt.SyntheticDataset(cfg, dcfg)
    ds_c.load_state_dict({"step": meta["data_step"], "seed": 0})
    for _ in range(4):
        restored, m = step(restored, batch_to_device(ds_c.next_batch(), "cpu"))
        losses_b.append(float(m["loss"]))
    np.testing.assert_allclose(losses_a, losses_b, rtol=1e-5)


def test_kernel_wrappers_refuse_inputs_that_need_grad():
    """The check the CUDA wrappers run before a launch (the CPU tensors
    here stand in for CUDA ones)."""
    from repro_torch.kernels import _build

    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match='impl="xla"'):
        _build.refuse_grad("ssm_scan", None, x)
    with torch.no_grad():
        _build.refuse_grad("ssm_scan", None, x)
    _build.refuse_grad("ssm_scan", torch.zeros(3), None)
