"""The port's core scoring and allocation (``repro_torch.core``) against the
JAX package's (``repro.core``) on the same seeded inputs: numpy oracles bit
for bit, the torch scorers (plain PyTorch in float64 on the CPU) against
the jitted JAX scorers and the reference's default (numpy) scorer, and
allocation decisions over a seeded stream of host pools."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.hlem as rh
import repro.core.hosts as rhosts
import repro.core.types as rtypes
import repro_torch.core as tc
import repro_torch.core.hlem as th
import repro_torch.core.hosts as thosts
import repro_torch.core.types as ttypes

BIG = 3.4e38


def _inputs(seed, n, d=4, p_mask=0.7):
    rng = np.random.default_rng(seed)
    free = rng.uniform(0, 100, (n, d))
    mask = rng.random(n) < p_mask
    spot = rng.uniform(0, 1, (n, d))
    return free, mask, spot


# ---------------------------------------------------------------------------
# numpy oracles: carried over verbatim, so bit-equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_numpy_oracles_bit_equal(seed):
    n = [1, 2, 7, 50, 300, 1000][seed]
    free, mask, spot = _inputs(seed, n)
    free[:, 2] = np.round(free[:, 2] / 25.0)   # coarse column: exact ties
    for alpha in (0.0, -0.5, 0.7):
        a = rh.hlem_scores_np(free, mask, spot, alpha)
        b = th.hlem_scores_np(free, mask, spot, alpha)
        assert np.array_equal(a, b)
        assert rh.hlem_pick_np(free, mask, spot, alpha) == \
            th.hlem_pick_np(free, mask, spot, alpha)
        idx = np.flatnonzero(mask)
        assert rh.hlem_pick_candidates_np(free, idx, spot, alpha) == \
            th.hlem_pick_candidates_np(free, idx, spot, alpha)
    rng = np.random.default_rng(100 + seed)
    masks = rng.random((5, n)) < 0.6
    alphas = rng.uniform(-0.5, 0.5, 5)
    for cut in (None, 0):   # broadcast core and the per-row path
        assert np.array_equal(
            rh.hlem_scores_batch_np(free, masks, spot, alphas, n_cutover=cut),
            th.hlem_scores_batch_np(free, masks, spot, alphas, n_cutover=cut))
    assert np.array_equal(rh.rsdiff_np(2.0, free[:, 0], free[:, 1] + 1.0),
                          th.rsdiff_np(2.0, free[:, 0], free[:, 1] + 1.0))


# ---------------------------------------------------------------------------
# torch scorers (plain PyTorch on the CPU) against the jitted JAX scorers
# and the reference's default float64 numpy scorer
# ---------------------------------------------------------------------------
# float64 on both sides; only the order of the sums differs
F64_RTOL, F64_ATOL = 1e-12, 1e-14


@pytest.mark.parametrize("n", [2, 5, 33, 200])
@pytest.mark.parametrize("alpha", [0.0, -0.5, 0.7])
def test_torch_scores_match_jax(n, alpha):
    free, mask, spot = _inputs(n, n)
    s_t = th.hlem_scores_torch(free, mask, spot, alpha, device="cpu").numpy()
    s_j = np.asarray(rh.hlem_scores_jax(
        jnp.asarray(free, jnp.float32), jnp.asarray(mask),
        jnp.asarray(spot, jnp.float32), jnp.float32(alpha)))
    assert s_t.dtype == np.float64
    if mask.any():
        np.testing.assert_allclose(s_t[mask], s_j[mask], rtol=2e-3, atol=2e-4)
        assert np.argmax(s_t) == np.argmax(s_j)
        np.testing.assert_allclose(
            s_t[mask], rh.hlem_scores_np(free, mask, spot, alpha)[mask],
            rtol=F64_RTOL, atol=F64_ATOL)
    assert np.all(s_t[~mask] <= -BIG / 2)


def test_torch_select_matches_jax():
    rng = np.random.default_rng(7)
    for trial in range(20):
        n = int(rng.integers(2, 50))
        free = rng.uniform(0, 10, (n, 4))
        mask = rng.random(n) < 0.5
        if trial == 0:
            mask[:] = False
        spot = rng.uniform(0, 1, (n, 4))
        want = int(rh.hlem_select_jax(
            jnp.asarray(free, jnp.float32), jnp.asarray(mask),
            jnp.asarray(spot, jnp.float32), jnp.float32(-0.5)))
        got = th.hlem_select_torch(free, mask, spot, -0.5, device="cpu")
        assert got == want
        assert (got == -1) == (not mask.any())


def test_torch_batch_scores_and_select_match_jax():
    rng = np.random.default_rng(3)
    n, b = 40, 8
    free = rng.uniform(0, 10, (n, 4))
    masks = rng.random((b, n)) < 0.6
    masks[2] = False
    spot = rng.uniform(0, 1, (n, 4))
    alphas = np.linspace(-0.5, 0.5, b)
    args = (jnp.asarray(free, jnp.float32), jnp.asarray(masks),
            jnp.asarray(spot, jnp.float32))
    s_j = np.asarray(rh.hlem_scores_batch_jax(
        *args, jnp.asarray(alphas, jnp.float32)))
    s_t = th.hlem_scores_batch_torch(free, masks, spot, alphas,
                                     device="cpu").numpy()
    for i in range(b):
        if masks[i].any():
            np.testing.assert_allclose(s_t[i][masks[i]], s_j[i][masks[i]],
                                       rtol=2e-3, atol=2e-4)
        assert np.all(s_t[i][~masks[i]] <= -BIG / 2)
    sel_j = np.asarray(rh.hlem_select_batch_jax(*args, jnp.float32(-0.5)))
    sel_t = th.hlem_select_batch_torch(free, masks, spot, -0.5, device="cpu")
    assert sel_t.tolist() == sel_j.tolist()
    assert sel_t[2] == -1


def test_torch_select_matches_numpy():
    """Picks equal the reference's default scorer's (``hlem_pick_np``), on
    pools with an exact tie (a coarse column) and without."""
    rng = np.random.default_rng(7)
    for trial in range(40):
        n = int(rng.integers(2, 50))
        free = rng.uniform(0, 10, (n, 4))
        if trial % 2:
            free[:, 1] = np.round(free[:, 1] / 5.0)
        mask = rng.random(n) < 0.5
        if trial == 0:
            mask[:] = False
        spot = rng.uniform(0, 1, (n, 4))
        for alpha in (0.0, -0.5):
            got = th.hlem_select_torch(free, mask, spot, alpha, device="cpu")
            want = rh.hlem_pick_np(free, mask, spot, alpha) if mask.any() else -1
            assert got == want == rh.hlem_select_np(free, mask, spot, alpha)


def test_torch_batch_scores_and_select_match_numpy():
    rng = np.random.default_rng(3)
    n, b = 40, 8
    free = rng.uniform(0, 10, (n, 4))
    masks = rng.random((b, n)) < 0.6
    masks[2] = False
    spot = rng.uniform(0, 1, (n, 4))
    alphas = np.linspace(-0.5, 0.5, b)
    s_t = th.hlem_scores_batch_torch(free, masks, spot, alphas,
                                     device="cpu").numpy()
    s_n = rh.hlem_scores_batch_np(free, masks, spot, alphas)
    for i in range(b):
        if masks[i].any():
            np.testing.assert_allclose(s_t[i][masks[i]], s_n[i][masks[i]],
                                       rtol=F64_RTOL, atol=F64_ATOL)
    sel_t = th.hlem_select_batch_torch(free, masks, spot, alphas, device="cpu")
    want = [rh.hlem_pick_np(free, masks[i], spot, alphas[i])
            if masks[i].any() else -1 for i in range(b)]
    assert sel_t.tolist() == want


# ---------------------------------------------------------------------------
# allocation decisions over a seeded stream of pools
# ---------------------------------------------------------------------------
def _loaded_pool(hosts_mod, types_mod, seed, n_hosts=40, n_running=90):
    """A pool with continuous per-host load: spot and on-demand VMs of
    uniform random size placed on random hosts."""
    rng = np.random.default_rng(seed)
    pool = hosts_mod.HostPool()
    for _ in range(n_hosts):
        cpu = float(rng.choice([8, 16, 32]))
        pool.add_host(types_mod.resources(cpu, cpu * 2048, 1_000, 100_000))
    for i in range(n_running):
        cpu = float(rng.uniform(0.5, 4.0))
        demand = types_mod.resources(cpu, cpu * float(rng.uniform(512, 2048)),
                                     float(rng.uniform(10, 100)), 5_000)
        make = types_mod.make_spot if i % 2 else types_mod.make_on_demand
        vm = make(1000 + i, demand, 100.0)
        for hid in rng.permutation(pool.n):
            if pool.fits(int(hid), vm.demand):
                pool.place(vm, int(hid), now=0.0)
                vm.state = types_mod.VmState.RUNNING
                vm.run_start = 0.0
                break
    return pool


def _queries(types_mod, seed, count=16):
    rng = np.random.default_rng(1000 + seed)
    out = []
    for i in range(count):
        cpu = float(rng.choice([1, 2, 4, 8, 16]))
        demand = types_mod.resources(cpu, cpu * 1024, 50, 5_000)
        make = types_mod.make_spot if i % 3 == 0 else types_mod.make_on_demand
        out.append(make(i, demand, 10.0))
    return out


def _decisions_match(policy_name, seed, **ref_kw):
    """find_host (direct and spot-clearing), find_direct and
    find_hosts_batch of the port's torch backend on the CPU equal the
    reference policy's (built with ``ref_kw``) on the same pools."""
    ref_pool = _loaded_pool(rhosts, rtypes, seed)
    port_pool = _loaded_pool(thosts, ttypes, seed)
    ref_pol = rc.make_policy(policy_name, **ref_kw)
    port_pol = tc.make_policy(policy_name, backend="torch", device="cpu")
    ref_vms, port_vms = _queries(rtypes, seed), _queries(ttypes, seed)
    for rv, pv in zip(ref_vms, port_vms):
        for clearing in (False, True):
            want = ref_pol.find_host(rv, ref_pool, 50.0, clearing)
            assert port_pol.find_host(pv, port_pool, 50.0, clearing) == want
        assert port_pol.find_direct(pv, port_pool) == \
            ref_pol.find_direct(rv, ref_pool)
    want = ref_pol.find_hosts_batch(ref_vms, ref_pool, 50.0)
    got = port_pol.find_hosts_batch(port_vms, port_pool, 50.0)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("policy_name", ["hlem-vmp", "hlem-vmp-adjusted"])
@pytest.mark.parametrize("seed", range(4))
def test_find_host_decisions_match_reference(policy_name, seed):
    _decisions_match(policy_name, seed, backend="jax")


@pytest.mark.parametrize("policy_name", ["hlem-vmp", "hlem-vmp-adjusted"])
@pytest.mark.parametrize("seed", range(4))
def test_find_host_decisions_match_reference_default(policy_name, seed):
    """Against the reference's default backend, numpy float64."""
    _decisions_match(policy_name, seed)


def test_policy_parameters_keep_reference_names_and_defaults():
    for name in ("hlem-vmp", "hlem-vmp-adjusted"):
        ref_pol = rc.make_policy(name)
        port_pol = tc.make_policy(name, device="cpu")
        for attr in ("rc", "threshold", "alpha", "adjust_spot_only"):
            assert getattr(port_pol, attr) == getattr(ref_pol, attr)
        assert port_pol.backend == "torch" and port_pol.device.type == "cpu"
    assert list(tc.POLICY_REGISTRY.names()) == list(rc.POLICY_REGISTRY.names())
    with pytest.raises(ValueError):
        tc.make_policy("hlem-vmp", backend="jax")
    assert tc.make_policy("hlem-vmp", backend="numpy").device is None
    assert torch.device("cpu") == th.resolve_device("cpu")
