"""The port's model stack against the reference package on the CPU: the
layer modules, ``forward`` logits and ``greedy_generate`` tokens on the
smoke configs, with the reference's weights carried over by
``params_from_jax`` and inputs made by numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.models import layers as jl
from repro.models import model as jm
from repro.serve import engine as jeng
import repro_torch.configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models.weights import flatten_jax_params, params_from_jax
from repro_torch.serve import engine as teng
from repro_torch.serve.scheduler import Request, SpotServingScheduler

SLICE = ["hymba_1_5b", "deepseek_7b", "falcon_mamba_7b"]
LOGIT_ATOL = 2e-4    # f32 smoke configs, different op order
MODULE_ATOL = 1e-5   # f32, one layer


def _port_cfg(arch):
    return tcfg.get_smoke_config(arch)


def _params(arch, cfg=None, seed=0):
    cfg = cfg or rcfg.get_smoke_config(arch)
    jp = jm.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, jp, jax.tree.map(np.asarray, jp)


def _prompt(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", rcfg.ARCH_IDS)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ref = dataclasses.asdict(getattr(rcfg, get)(arch))
        port = dataclasses.asdict(getattr(tcfg, get)(arch))
        assert port == ref
    assert tcfg.get_config(arch).n_params() == rcfg.get_config(arch).n_params()


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("arch", SLICE + ["starcoder2_15b", "granite_moe_3b_a800m"])
def test_params_from_jax_round_trips_every_key(arch, scan_layers):
    cfg = rcfg.get_smoke_config(arch).replace(scan_layers=scan_layers)
    _, _, tree = _params(arch, cfg)
    model = params_from_jax(_port_cfg(arch).replace(scan_layers=scan_layers),
                            tree)
    flat = flatten_jax_params(cfg, tree)
    state = model.state_dict()
    assert set(state) == set(flat)
    for key, arr in flat.items():
        want = torch.float32 if arr.dtype == np.float32 else torch.bfloat16
        assert state[key].dtype == want, key
        np.testing.assert_array_equal(state[key].float().numpy(),
                                      arr.astype(np.float32), err_msg=key)


def test_params_from_jax_keeps_reference_dtypes_in_bf16():
    cfg = rcfg.get_smoke_config("hymba_1_5b").replace(dtype="bfloat16")
    _, _, tree = _params("hymba_1_5b", cfg)
    model = params_from_jax(_port_cfg("hymba_1_5b").replace(dtype="bfloat16"),
                            tree)
    blk = model.layers[1]
    for p in (blk.ln1, blk.ln2, blk.mixer.norm_a, blk.mixer.norm_s,
              blk.mixer.mamba.dt_bias, blk.mixer.mamba.a_log,
              blk.mixer.mamba.d_skip, model.final_ln):
        assert p.dtype == torch.float32
    for p in (blk.mixer.attn.wq, blk.mixer.mamba.in_proj, blk.mlp.w_down,
              model.embed, model.lm_head):
        assert p.dtype == torch.bfloat16


def test_params_from_jax_rejects_a_missing_key():
    _, _, tree = _params("deepseek_7b")
    del tree["layers"]["attn"]["wq"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(_port_cfg("deepseek_7b"), tree)


def test_init_params_follows_the_reference_recipe():
    cfg = _port_cfg("hymba_1_5b")
    gen = torch.Generator().manual_seed(0)
    model = tm.init_params(cfg, gen)
    again = tm.init_params(cfg, torch.Generator().manual_seed(0))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k
    m = model.layers[0].mixer.mamba
    assert torch.equal(m.dt_bias, torch.full_like(m.dt_bias, -4.0))
    assert torch.allclose(m.a_log[0], torch.log(torch.arange(1.0, 9.0)))
    wq = model.layers[0].mixer.attn.wq
    assert wq.abs().max() <= 2.0 * cfg.d_model ** -0.5 + 1e-6


# ---------------------------------------------------------------------------
# layer modules, f32, weights carried over
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def hymba():
    cfg, _, tree = _params("hymba_1_5b")
    return cfg, tree, params_from_jax(_port_cfg("hymba_1_5b"), tree)


@pytest.mark.parametrize("s,pos0", [(48, 0), (80, 5)])
def test_attention_fwd_matches(hymba, s, pos0):
    cfg, tree, model = hymba
    x = np.random.default_rng(2).normal(0, 1, (2, s, cfg.d_model)).astype(
        np.float32)
    p = _layer0(tree["layers"]["mixer"]["attn"])
    want, (wk, wv) = jl.attention_fwd(cfg, p, jnp.asarray(x), pos0=pos0)
    got, (gk, gv) = model.layers[0].mixer.attn(torch.from_numpy(x), pos0=pos0)
    _close(got, want, MODULE_ATOL)
    _close(gk, wk, MODULE_ATOL)
    _close(gv, wv, MODULE_ATOL)


@pytest.mark.parametrize("t_cache,pos", [(32, 40), (32, 7), (64, 40)])
def test_attention_decode_matches(hymba, t_cache, pos):
    """Ring buffer (W = 32 slots) and a plain cache of 64 slots."""
    cfg, tree, model = hymba
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.normal(0, 1, (2, cfg.n_kv_heads, t_cache, cfg.hd)).astype(
        np.float32) for _ in range(2))
    p = _layer0(tree["layers"]["mixer"]["attn"])
    want, (wk, wv) = jl.attention_decode(
        cfg, p, jnp.asarray(x), (jnp.asarray(kc), jnp.asarray(vc)),
        jnp.asarray(pos, jnp.int32))
    got, (gk, gv) = model.layers[0].mixer.attn.decode(
        torch.from_numpy(x), (torch.from_numpy(kc.copy()),
                              torch.from_numpy(vc.copy())), pos)
    _close(got, want, MODULE_ATOL)
    _close(gk, wk, MODULE_ATOL)
    _close(gv, wv, MODULE_ATOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_fwd_matches(hymba, with_state):
    cfg, tree, model = hymba
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.normal(0, 1, (2, cfg.dinner, cfg.ssm_state)).astype(np.float32),
                 rng.normal(0, 1, (2, cfg.conv_width - 1, cfg.dinner)).astype(
                     np.float32))
    p = _layer0(tree["layers"]["mixer"]["mamba"])
    want, (wh, wc) = jl.mamba_fwd(
        cfg, p, jnp.asarray(x),
        None if state is None else tuple(jnp.asarray(z) for z in state))
    got, (gh, gc) = model.layers[0].mixer.mamba(
        torch.from_numpy(x),
        None if state is None else tuple(torch.from_numpy(z) for z in state))
    _close(got, want, MODULE_ATOL)
    _close(gh, wh, MODULE_ATOL)
    _close(gc, wc, MODULE_ATOL)


def test_hymba_fwd_matches(hymba):
    cfg, tree, model = hymba
    x = np.random.default_rng(5).normal(0, 1, (2, 40, cfg.d_model)).astype(
        np.float32)
    p = _layer0(tree["layers"]["mixer"])
    want, (wk, wv), (wh, wc) = jl.hymba_fwd(cfg, p, jnp.asarray(x))
    got, (gk, gv), (gh, gc) = model.layers[0].mixer(torch.from_numpy(x))
    for g, w in ((got, want), (gk, wk), (gv, wv), (gh, wh), (gc, wc)):
        _close(g, w, MODULE_ATOL)


def test_mlp_gelu_matches():
    cfg, _, tree = _params("starcoder2_15b")
    model = params_from_jax(_port_cfg("starcoder2_15b"), tree)
    x = np.random.default_rng(6).normal(0, 1, (2, 8, cfg.d_model)).astype(
        np.float32)
    want = jl.mlp_fwd(cfg, _layer0(tree["layers"]["mlp"]), jnp.asarray(x))
    _close(model.layers[0].mlp(torch.from_numpy(x)), want, MODULE_ATOL)


# ---------------------------------------------------------------------------
# the whole slice: forward logits and greedy tokens
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SLICE)
def test_forward_logits_match(arch):
    cfg, jp, tree = _params(arch)
    model = params_from_jax(_port_cfg(arch), tree)
    tokens = _prompt(cfg, 2, 40)
    want = jm.forward(cfg, jp, jnp.asarray(tokens))
    got = tm.forward(_port_cfg(arch), model, torch.from_numpy(tokens).long())
    assert got.shape == (2, 40, cfg.vocab)
    _close(got, want, LOGIT_ATOL)


@pytest.mark.parametrize("arch,s,impl", [
    ("hymba_1_5b", 16, "xla"),
    ("hymba_1_5b", 16, "interp"),
    ("hymba_1_5b", 48, "xla"),     # S > W = 32, S mod W != 0: the ring quirk
    ("hymba_1_5b", 64, "xla"),     # S = 2W
    ("deepseek_7b", 16, "xla"),
    ("falcon_mamba_7b", 16, "xla"),
])
def test_greedy_generate_equals_reference(arch, s, impl):
    cfg, jp, tree = _params(arch)
    model = params_from_jax(_port_cfg(arch), tree)
    prompt = _prompt(cfg, 2, s)
    want = np.asarray(jeng.greedy_generate(cfg, jp, jnp.asarray(prompt), 6,
                                           impl=impl))
    got = teng.greedy_generate(_port_cfg(arch), model,
                               torch.from_numpy(prompt).long(), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_buffer_quirk_is_reproduced():
    """For S > W with S mod W != 0, prefill keeps the last W positions in
    slots 0..W-1 in order, while decode assumes position p sits in slot
    p mod W.  The port's prefill state equals the reference's, quirk
    included: at S = 48, W = 32, slot j holds position 16 + j."""
    arch = "hymba_1_5b"
    cfg, jp, tree = _params(arch)
    pcfg = _port_cfg(arch)
    model = params_from_jax(pcfg, tree)
    prompt = _prompt(cfg, 2, 48)
    _, want = jeng.make_prefill_step(cfg, 54)(jp, jnp.asarray(prompt))
    _, got = teng.make_prefill_step(pcfg, 54)(model, torch.from_numpy(prompt).long())
    assert got.pos == int(want.pos) == 48
    for g, w in ((got.kv_k, want.kv_k), (got.kv_v, want.kv_v),
                 (got.ssm_h, want.ssm_h), (got.ssm_conv, want.ssm_conv)):
        _close(g, w, MODULE_ATOL)
    _, (kv, _) = tm.forward(pcfg, model, torch.from_numpy(prompt).long(),
                            return_caches=True)
    assert torch.equal(got.kv_k, kv[0][:, :, :, 16:])
    assert got.kv_k.shape[3] == cfg.sliding_window == 32


def test_decode_state_shapes_and_in_place_update():
    cfg = _port_cfg("hymba_1_5b")
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    st = tm.init_decode_state(cfg, 2, cache_len=100)
    assert st.kv_k.shape == (cfg.n_layers, 2, cfg.n_kv_heads,
                             cfg.sliding_window, cfg.hd)
    assert st.ssm_h.dtype == torch.float32 and st.pos == 0
    logits, st2 = tm.decode_step(cfg, model, torch.zeros((2, 1), dtype=torch.long),
                                 st)
    assert logits.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert st2.pos == 1 and st2.kv_k is st.kv_k
    assert st.kv_k[:, :, :, 0].abs().sum() > 0


# ---------------------------------------------------------------------------
# serving: scheduler copy and the launcher on the CPU
# ---------------------------------------------------------------------------
def test_scheduler_hibernate_resume():
    s = SpotServingScheduler(batch_size=4, hibernate=True)
    for i in range(6):
        s.add(Request(i, 8, 10))
    assert len(s.fill_batch()) == 4
    s.step(5)
    s.interrupt()
    assert s.stats()["hibernated"] == 4
    batch = s.fill_batch()
    assert {r.id for r in batch[:4]} == {0, 1, 2, 3}
    assert all(r.generated == 5 for r in batch[:4])
    s.step(5)
    s.fill_batch()
    s.step(10)
    assert len(s.done) == 6 and s.stats()["interruptions"] == 4


@pytest.mark.parametrize("arch", SLICE)
def test_serve_launcher_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "5",
            "--batch", "2", "--prompt-len", "16", "--gen-tokens", "4",
            "--interrupt-at", "2"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 5/5 requests" in out and "interruption" in out
    r = tserve.run(argv)
    assert r["done"] == 5 and r["interruptions"] == 2
    # 2 + 2 interrupted after 2 steps, resumed 2, then 2 + 1
    assert [tuple(g.shape) for _, g in r["batches"]] == [(2, 3), (2, 4),
                                                         (2, 4), (1, 4)]
    for prompts, gen in r["batches"]:
        assert prompts.shape == (gen.shape[0], 16)
        assert int(gen.max()) < r["cfg"].vocab


def test_serve_launcher_defaults_to_cuda():
    args = tserve.parse_args(["--arch", "hymba_1_5b"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.run(["--arch", "hymba_1_5b", "--smoke"])
