"""The port's HLEM scoring is float64, as the reference's default scorer
(``repro.core.hlem``'s numpy oracle), so its picks and runs equal the
reference default's where float32 would part from them.

Near-tie pools: 64 hosts drawn from a seed, the float64 oracle's best host
moved to index 0, and host 1 made a copy of host 0 plus a small perturbation
in one dimension.  Float32 (the reference's JAX scorer) gives the two hosts
the same top score, so its argmax takes host 0; float64 tells them apart and
takes host 1.  The port's scorers, policies and batch path must take host 1.

An exact tie of two distinct hosts, which the port's compensated per-host
dot products keep a tie wherever a plain sum would split it.

The sweep: runs of the example ``migration_sweep.json``, among them
(correlated, migration none, seed 3), where a float32 scorer's ties change
the run's interruption counts; the port's torch backend on the CPU must give
the reference default's row, event streams and placements."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ra
import repro.core as rc
import repro.core.hlem as rh
import repro.core.hosts as rhosts
import repro.core.types as rtypes
import repro_torch.api as ta
import repro_torch.core as tc
import repro_torch.core.hlem as th
import repro_torch.core.hosts as thosts
import repro_torch.core.types as ttypes
from repro_torch.api.build import event_streams

N_HOSTS = 64
ALPHAS = (0.0, -0.5)
# (seed, dimension, perturbation of host 1 over host 0)
NEAR_TIES = [(1, 1, 1e-5), (1, 3, 1e-6), (3, 0, 1e-6), (3, 2, 1e-5)]
SWEEP = str(Path(__file__).resolve().parents[1] / "examples" / "specs"
            / "migration_sweep.json")


def _near_tie_pool(seed, dim, delta):
    rng = np.random.default_rng(seed)
    free = rng.uniform(0, 100, (N_HOSTS, 4))
    spot = rng.uniform(0, 1, (N_HOSTS, 4))
    best = rh.hlem_pick_np(free, np.ones(N_HOSTS, bool), spot, 0.0)
    free[[0, best]] = free[[best, 0]]
    spot[[0, best]] = spot[[best, 0]]
    free[1], spot[1] = free[0], spot[0]
    free[1, dim] += delta
    return free, spot


@pytest.mark.parametrize("seed,dim,delta", NEAR_TIES)
def test_near_tie_float32_ties_float64_separates(seed, dim, delta):
    """The pools are what they claim: a float32 tie at the top, which the
    float64 oracle breaks in favour of host 1."""
    free, spot = _near_tie_pool(seed, dim, delta)
    mask = np.ones(N_HOSTS, bool)
    for alpha in ALPHAS:
        s32 = np.asarray(rh.hlem_scores_jax(
            jnp.asarray(free, jnp.float32), jnp.asarray(mask),
            jnp.asarray(spot, jnp.float32), jnp.float32(alpha)))
        assert s32[0] == s32[1] == s32.max()
        s64 = rh.hlem_scores_np(free, mask, spot, alpha)
        assert s64[1] > s64[0] and int(np.argmax(s64)) == 1
        assert rh.hlem_pick_np(free, mask, spot, alpha) == 1


@pytest.mark.parametrize("seed,dim,delta", NEAR_TIES)
def test_near_tie_scorers_pick_as_reference_default(seed, dim, delta):
    free, spot = _near_tie_pool(seed, dim, delta)
    mask = np.ones(N_HOSTS, bool)
    idx = np.flatnonzero(mask)
    for alpha in ALPHAS:
        want = rh.hlem_pick_candidates_np(free, idx, spot, alpha)
        assert want == rh.hlem_pick_np(free, mask, spot, alpha) == 1
        scores = th.hlem_scores_torch(free, mask, spot, alpha, device="cpu")
        assert scores.dtype == torch.float64
        assert th.hlem_select_torch(free, mask, spot, alpha,
                                    device="cpu") == want
    masks = np.ones((len(ALPHAS), N_HOSTS), bool)
    got = th.hlem_select_batch_torch(free, masks, spot, np.array(ALPHAS),
                                     device="cpu")
    assert got.tolist() == [
        rh.hlem_pick_candidates_np(free, idx, spot, a) for a in ALPHAS]


def _pool(hosts_mod, free):
    pool = hosts_mod.HostPool()
    for cap in free:
        pool.add_host(cap)
    return pool


@pytest.mark.parametrize("policy_name", ["hlem-vmp", "hlem-vmp-adjusted"])
@pytest.mark.parametrize("seed,dim,delta", NEAR_TIES)
def test_near_tie_policy_places_as_reference_default(seed, dim, delta,
                                                     policy_name):
    """``find_host``, ``find_direct`` and ``find_hosts_batch`` of the
    port's torch backend on an empty pool of those capacities, against the
    reference policy at its default backend (numpy)."""
    free, _ = _near_tie_pool(seed, dim, delta)
    ref_pool, port_pool = _pool(rhosts, free), _pool(thosts, free)
    ref_pol = rc.make_policy(policy_name)
    port_pol = tc.make_policy(policy_name, backend="torch", device="cpu")
    demand = 1e-3
    ref_vms = [rtypes.make_spot(0, rtypes.resources(*[demand] * 4), 10.0),
               rtypes.make_on_demand(1, rtypes.resources(*[demand] * 4), 10.0)]
    port_vms = [ttypes.make_spot(0, ttypes.resources(*[demand] * 4), 10.0),
                ttypes.make_on_demand(1, ttypes.resources(*[demand] * 4), 10.0)]
    for rv, pv in zip(ref_vms, port_vms):
        want = ref_pol.find_host(rv, ref_pool, 0.0, False)
        assert want == (1, False)
        assert port_pol.find_host(pv, port_pool, 0.0, False) == want
        assert port_pol.find_direct(pv, port_pool) == \
            ref_pol.find_direct(rv, ref_pool) == 1
    want = ref_pol.find_hosts_batch(ref_vms, ref_pool, 0.0)
    got = port_pol.find_hosts_batch(port_vms, port_pool, 0.0)
    assert got.tolist() == want.tolist() == [1, 1]


# (volatile, gradient-aware, seed 12), placement #6677 of the example sweep:
# the four candidates' free capacity (spot fractions 0, alpha 0).  Hosts 0
# and 3 standardise to (0, 1, 1, 1) and (1, 1, 1/2, 1/2), and dimensions 0, 2
# and 3 get equal weights a, so both score b + 2a in exact arithmetic; a
# plain sum in the order k = 0..3 rounds host 3's a + b + a/2 + a/2 one ulp
# above host 0's b + a + a and picks it, where the oracle picks host 0.
EXACT_TIE = [[8.0, 28672.0, 9600.0, 360000.0],
             [8.0, 27648.0, 9400.0, 340000.0],
             [9.0, 27648.0, 9400.0, 340000.0],
             [10.0, 28672.0, 9500.0, 350000.0]]


def test_exact_tie_of_distinct_hosts_picks_as_reference_default():
    free = np.array(EXACT_TIE)
    spot = np.zeros_like(free)
    mask = np.ones(len(free), bool)
    want = rh.hlem_pick_np(free, mask, spot, 0.0)
    assert want == 0
    for alpha in ALPHAS:
        scores = th.hlem_scores_torch(free, mask, spot, alpha, device="cpu")
        assert scores[0].item() == scores[3].item() == scores.max().item()
        assert th.hlem_select_torch(free, mask, spot, alpha,
                                    device="cpu") == want
    got = th.hlem_select_batch_torch(free, np.ones((2, len(free)), bool),
                                     spot, np.array(ALPHAS), device="cpu")
    assert got.tolist() == [want, want]
    ref_vm = rtypes.make_on_demand(0, rtypes.resources(1.0, 1.0, 1.0, 1.0),
                                   10.0)
    vm = ttypes.make_on_demand(0, ttypes.resources(1.0, 1.0, 1.0, 1.0), 10.0)
    assert rc.make_policy("hlem-vmp").find_host(
        ref_vm, _pool(rhosts, free), 0.0, False) == (want, False)
    pol = tc.make_policy("hlem-vmp", backend="torch", device="cpu")
    assert pol.find_host(vm, _pool(thosts, free), 0.0, False) == (want, False)


def _sweep_cell(api, regime="correlated", migration="none", **params):
    exp = api.ExperimentSpec.load(SWEEP)
    cell = next(c for c in exp.cells()
                if c.scenario.regime == regime
                and c.migration.policy == migration)
    return cell.replace(policy=api.PolicySpec(
        cell.policy.name, dict(cell.policy.params, **params)))


def _run(api, hosts_mod, spec, seed, monkeypatch):
    """The run's row, its event streams and its placements, (VM id, host),
    in order.  The streams are read by the port's ``event_streams``, which
    takes plain attributes of either package's metrics."""
    placed, place = [], hosts_mod.HostPool.place

    def record(pool, vm, hid, now=0.0):
        placed.append((vm.id, int(hid)))
        return place(pool, vm, hid, now)

    with monkeypatch.context() as m:
        m.setattr(hosts_mod.HostPool, "place", record)
        sim = api.build(spec, seed)
        metrics = sim.run(until=api.resolve_horizon(spec.scenario))
    assert sim.policy.backend == spec.policy.params.get("backend", "numpy")
    return (api.collect_row(sim, metrics, spec, seed), event_streams(metrics),
            placed)


def _assert_run_equals_reference_default(regime, migration, seed,
                                         monkeypatch):
    want = _run(ra, rhosts, _sweep_cell(ra, regime, migration), seed,
                monkeypatch)
    got = _run(ta, thosts, _sweep_cell(ta, regime, migration,
                                       backend="torch", device="cpu"),
               seed, monkeypatch)
    assert got[0] == want[0]
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert got[1][k] == want[1][k], k
    assert got[2] == want[2]
    return want[0]


def test_sweep_cell_equals_reference_default(monkeypatch):
    """(correlated, none, seed 3) of the example sweep, at its horizon: the
    port's torch backend on the CPU against ``repro.api`` at its default
    scorer, row, event streams and placements (a float32 scorer gives 4175
    interruptions in 131 waves here)."""
    row = _assert_run_equals_reference_default("correlated", "none", 3,
                                               monkeypatch)
    assert (row["interruptions"], row["waves"]) == (4167, 133)


@pytest.mark.parametrize("regime,migration,seed", [
    ("correlated", "gradient-aware", 3), ("volatile", "none", 3),
    ("volatile", "gradient-aware", 3), ("correlated", "none", 12),
    ("correlated", "gradient-aware", 12), ("volatile", "none", 12),
    ("volatile", "gradient-aware", 12)])
def test_sweep_runs_equal_reference_default(regime, migration, seed,
                                            monkeypatch):
    """The example sweep's other cells at seed 3, and its four cells at
    seed 12, whose (volatile, gradient-aware) run meets ``EXACT_TIE`` at
    placement #6677 (a plain per-host sum picks the other host there, and
    the run's row parts from the reference's)."""
    _assert_run_equals_reference_default(regime, migration, seed,
                                         monkeypatch)
