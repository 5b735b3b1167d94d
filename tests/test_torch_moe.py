"""The port's MoE block and the two MoE configs (granite-moe-3b-a800m,
kimi-k2-1t-a32b) against the reference on the CPU, at their smoke sizes,
weights carried over with ``params_from_jax`` and inputs made by numpy from
a seed: ``moe_fwd`` (capacity overflow and dropped tokens included), the
router's slot assignment, forward logits, and greedy tokens (equal).

Tolerances: the MoE block ``rtol=atol=1e-5`` (f32, one layer, op order);
logits ``2e-4`` as ``tests/test_torch_models.py`` holds the other families.
"""
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
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import engine as teng

MOE = ["granite_moe_3b_a800m", "kimi_k2_1t_a32b"]
MOE_TOL = 1e-5
LOGIT_ATOL = 2e-4


def _params(arch, seed=0, **replace):
    cfg = rcfg.get_smoke_config(arch).replace(**replace)
    jp = jm.init_params(cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jp)
    return cfg, jp, tree, params_from_jax(
        tcfg.get_smoke_config(arch).replace(**replace), tree)


def _moe_inputs(cfg, b, s, seed=2):
    return np.random.default_rng(seed).normal(0, 1, (b, s, cfg.d_model)).astype(
        np.float32)


def _routing(cfg, block, x):
    """(keep, cap) of the port's router on x, for the overflow checks."""
    t = x.shape[0] * x.shape[1]
    g = min(cfg.moe_group_size, t)
    xt = torch.from_numpy(x).reshape(t, -1)
    xt = torch.nn.functional.pad(xt, (0, 0, 0, -(-t // g) * g - t)).reshape(-1, g, x.shape[2])
    probs = torch.softmax(xt @ block.router, dim=-1)
    _, eidx = tl._top_k(probs, cfg.top_k)
    cap = max(1, int(g * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    _, keep, _ = tl._moe_route(eidx, cfg.n_experts, cap)
    return keep, cap


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("b,s,cf", [(2, 80, None), (3, 64, None), (8, 1, None),
                                    (2, 80, 0.5)],
                         ids=["ragged-groups", "full-groups", "decode",
                              "overflow"])
def test_moe_fwd_matches(arch, b, s, cf):
    """B x S = 160 tokens in groups of 64 (the last one padded), 192 tokens
    in three full groups, the decode shape (g = B), and capacity factor 0.5,
    where every group overflows experts and drops tokens."""
    cfg, _, tree, model = _params(arch, **({} if cf is None else
                                           {"capacity_factor": cf}))
    block = model.layers[1].moe
    x = _moe_inputs(cfg, b, s)
    p = jax.tree.map(lambda a: a[1], tree["layers"]["moe"])
    want = np.asarray(jl.moe_fwd(cfg, p, jnp.asarray(x)))
    got = block(torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=MOE_TOL,
                               atol=MOE_TOL)
    if cf is not None:
        keep, _ = _routing(cfg, block, x)
        assert (~keep).any(-1).any(-1).all(), "every group should drop tokens"


@pytest.mark.parametrize("arch", MOE)
def test_moe_route_matches_reference(arch):
    """Slot positions, the slot -> token table and the kept gates equal the
    reference's ``_moe_route`` group by group."""
    cfg = rcfg.get_smoke_config(arch)
    rng = np.random.default_rng(7)
    g, k = 64, cfg.top_k
    probs = rng.dirichlet(np.ones(cfg.n_experts), size=(2, g)).astype(np.float32)
    probs[0, :, :2] = probs[0, :, :1]          # exact ties between experts 0, 1
    gate, eidx = tl._top_k(torch.from_numpy(probs), k)
    jgate, jeidx = jax.lax.top_k(jnp.asarray(probs), k)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jeidx))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    cap = max(1, int(g * k / cfg.n_experts * cfg.capacity_factor))
    slot, keep, table = tl._moe_route(eidx, cfg.n_experts, cap)
    for grp in range(2):
        want_table, want_gate = jl._moe_route(cfg, jgate[grp], jeidx[grp], cap, g)
        np.testing.assert_array_equal(
            table[grp].reshape(cfg.n_experts, cap).numpy(), np.asarray(want_table))
        gate_slot = np.zeros(cfg.n_experts * cap + 1, np.float32)
        gate_slot[slot[grp].numpy()] = np.where(keep[grp].reshape(-1).numpy(),
                                                gate[grp].reshape(-1).numpy(), 0)
        np.testing.assert_array_equal(gate_slot[:-1].reshape(cfg.n_experts, cap),
                                      np.asarray(want_gate))


def test_moe_grads_flow_to_router_and_experts():
    cfg, _, tree, model = _params("granite_moe_3b_a800m")
    block = model.layers[0].moe
    for p in block.parameters():
        p.requires_grad_(True)
    out = block(torch.from_numpy(_moe_inputs(cfg, 2, 40)))
    grads = torch.autograd.grad(out.square().sum(), list(block.parameters()))
    for name, g in zip(("router", "w_gate", "w_up", "w_down"), grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0, name


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_match(arch):
    cfg, jp, _, model = _params(arch)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    want = jm.forward(cfg, jp, jnp.asarray(tokens))
    got = tm.forward(tcfg.get_smoke_config(arch), model,
                     torch.from_numpy(tokens).long())
    assert got.shape == (2, 40, cfg.vocab)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("s", [16, 40])
def test_greedy_generate_equals_reference(arch, s):
    cfg, jp, _, model = _params(arch)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (2, s)).astype(np.int32)
    want = np.asarray(jeng.greedy_generate(cfg, jp, jnp.asarray(prompt), 6))
    got = teng.greedy_generate(tcfg.get_smoke_config(arch), model,
                               torch.from_numpy(prompt).long(), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_list_layers_build_and_match():
    cfg, jp, _, model = _params("granite_moe_3b_a800m", scan_layers=False)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (1, 24)).astype(np.int32)
    want = jm.forward(cfg, jp, jnp.asarray(tokens))
    got = tm.forward(tcfg.get_smoke_config("granite_moe_3b_a800m").replace(
        scan_layers=False), model, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


def test_moe_config_builds_and_serves_on_cpu(capsys):
    cfg = tcfg.get_smoke_config("granite_moe_3b_a800m")
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == cfg.n_params()
    assert model.layers[0].moe.w_gate.shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert tserve.main(["--arch", "granite_moe_3b_a800m", "--smoke", "--device",
                        "cpu", "--requests", "3", "--batch", "2",
                        "--prompt-len", "12", "--gen-tokens", "4"]) == 0
    assert "served 3/3 requests" in capsys.readouterr().out
