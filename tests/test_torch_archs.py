"""Every architecture of the port against the reference on the CPU, at the
smoke configs: the port's counterpart of ``tests/models/test_archs_smoke.py``.

The reference's weights are carried over with ``params_from_jax`` and the
inputs are made by numpy from a seed (integer tokens for the text models,
float frontend embeddings for the vlm and audio backbones).  ``forward``
logits are held for the five architectures that no other port test holds
(Hymba, DeepSeek and Falcon-Mamba are in ``test_torch_models.py``,
granite-moe and Kimi in ``test_torch_moe.py``); ``decode_step`` from an
empty ``init_decode_state`` is held for all ten, two steps, so that the
second reads the caches the first wrote."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.models import model as jm
import repro_torch.configs as tcfg
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax

LOGIT_ATOL = 2e-4    # f32 smoke configs, different op order
B, S, CACHE_LEN = 2, 24, 64
FORWARD_ONLY_HERE = ["phi_3_vision_4_2b", "internlm2_20b", "llama3_405b",
                     "starcoder2_15b", "musicgen_large"]


def _setup(arch):
    cfg = rcfg.get_smoke_config(arch)
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg.get_smoke_config(arch),
                            jax.tree.map(np.asarray, jp))
    return cfg, tcfg.get_smoke_config(arch), jp, model


def _inputs(cfg, b, s, seed):
    """(numpy input, its torch tensor): tokens or frontend embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "text":
        x = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        return x, torch.from_numpy(x).long()
    x = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    return x, torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=LOGIT_ATOL)


def test_the_archs_are_the_reference_archs():
    assert list(tcfg.ARCH_IDS) == list(rcfg.ARCH_IDS)
    assert len(rcfg.ARCH_IDS) == 10
    assert set(FORWARD_ONLY_HERE) <= set(rcfg.ARCH_IDS)


@pytest.mark.parametrize("arch", FORWARD_ONLY_HERE)
def test_forward_logits_match(arch):
    cfg, pcfg, jp, model = _setup(arch)
    x, xt = _inputs(cfg, B, S, seed=1)
    want = jm.forward(cfg, jp, jnp.asarray(x))
    with torch.no_grad():
        got = tm.forward(pcfg, model, xt)
    assert got.shape == (B, S, cfg.vocab)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


@pytest.mark.parametrize("arch", rcfg.ARCH_IDS)
def test_decode_step_matches(arch):
    cfg, pcfg, jp, model = _setup(arch)
    jst = jm.init_decode_state(cfg, B, cache_len=CACHE_LEN)
    st = tm.init_decode_state(pcfg, B, cache_len=CACHE_LEN)
    for step in range(2):
        x, xt = _inputs(cfg, B, 1, seed=10 + step)
        want, jst = jm.decode_step(cfg, jp, jnp.asarray(x), jst)
        with torch.no_grad():
            got, st = tm.decode_step(pcfg, model, xt, st)
        assert got.shape == (B, 1, cfg.vocab)
        assert bool(torch.isfinite(got).all())
        _close(got, want)
        assert st.pos == int(jst.pos) == step + 1
    for g, w in ((st.kv_k, jst.kv_k), (st.kv_v, jst.kv_v),
                 (st.ssm_h, jst.ssm_h), (st.ssm_conv, jst.ssm_conv)):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w)
