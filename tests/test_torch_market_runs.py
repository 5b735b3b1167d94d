"""Market runs of the port end to end against the JAX package: the
reference launcher's ``--market`` grid (4 pools, 60 s ticks, advisor
volatility, randomized bids floored at 0.45, the ``market`` scenario of 170
hosts), cut to a 2,400 s horizon here (the full 14,400 s runs on the card in
``chip_smoke.py``).

Each run is one spec, built and run by ``repro_torch.api`` on the port's
numpy and torch-CPU backends and by ``repro.api`` in the reference; rows
(``collect_row``) and event streams (``repro_torch.api.build.
event_streams``) are held equal (``==``): the host side is the reference's
numpy float64.
"""
import math

import pytest

import repro.api as ra
import repro_torch.api as ta
from repro_torch.api.build import event_streams

N_POOLS, TICK, SEED = 4, 60.0, 0
UNTIL = 2400.0
# the first storm of the ``storm`` scenario fires at 3,600 s
UNTIL_STORM = 4200.0


def _spec(api, regime, policy, migration, fleet, faults, params):
    """The launcher's ``--market`` run as a spec of ``api``."""
    return api.RunSpec(
        scenario=api.ScenarioSpec(
            workload="market", regime=regime, n_pools=N_POOLS,
            tick_interval=TICK, from_advisor=True,
            bid=api.BidSpec("randomized", {"lo": 0.45})),
        policy=api.PolicySpec(policy, params),
        migration=api.MigrationSpec(migration),
        fleet=(api.FleetSpec(fleet, {"target_capacity": 64.0})
               if fleet else None),
        faults=api.FaultSpec(faults) if faults else None)


def _run(api, spec, until):
    sim = api.build(spec, SEED)
    metrics = sim.run(until=until)
    return api.collect_row(sim, metrics, spec, SEED), event_streams(metrics)


def _alpha(policy):
    return {"alpha": -0.5} if policy == "hlem-vmp-adjusted" else {}


def reference_run(regime, policy, until, migration="none", fleet=None,
                  faults=None, backend=None):
    """``repro.api`` for the launcher's ``--market`` spec."""
    params = _alpha(policy)
    if backend is not None:
        params["backend"] = backend
    return _run(ra, _spec(ra, regime, policy, migration, fleet, faults,
                          params), until)


def port_run(regime, policy, until, migration="none", fleet=None,
             faults=None, backend="numpy", device="cpu"):
    """The same spec through ``repro_torch.api``: the wiring the card runs
    (``chip_smoke.py`` and ``python -m repro_torch.launch.market_sim``)."""
    params = _alpha(policy)
    if policy.startswith("hlem"):
        params.update(backend=backend, device=device)
    return _run(ta, _spec(ta, regime, policy, migration, fleet, faults,
                          params), until)


def _check(port, ref):
    (row, ev), (rrow, rev) = port, ref
    assert row == rrow
    assert ev.keys() == rev.keys()
    for k in rev:
        assert ev[k] == rev[k], k
    assert row["allocations"] > 0 and row["interruptions"] > 0
    assert all(not isinstance(v, float) or math.isfinite(v)
               for v in row.values())


@pytest.mark.parametrize("policy", ["first-fit", "hlem-vmp-adjusted"])
@pytest.mark.parametrize("regime", ["calm", "volatile", "correlated"])
def test_market_grid_row_equals_reference(regime, policy):
    _check(port_run(regime, policy, UNTIL), reference_run(regime, policy, UNTIL))


@pytest.mark.parametrize("migration", ["none", "greedy-cheapest",
                                       "gradient-aware", "risk-budgeted"])
def test_migration_row_equals_reference(migration):
    args = ("volatile", "hlem-vmp-adjusted", UNTIL, migration)
    port, ref = port_run(*args), reference_run(*args)
    _check(port, ref)
    if migration != "none":
        assert port[0]["migrations"] > 0


def test_fleet_and_storm_row_equals_reference():
    args = ("volatile", "first-fit", UNTIL_STORM, "none", "diversified",
            "storm")
    port, ref = port_run(*args), reference_run(*args)
    _check(port, ref)
    assert port[0]["faults_fired"] == 1 and port[0]["fleet_launches"] > 0


def test_torch_cpu_row_equals_reference_jax():
    """The port's torch backend (plain PyTorch on the CPU) against the
    reference's jitted JAX scorer: same placements, rows and streams."""
    args = ("volatile", "hlem-vmp-adjusted", UNTIL, "gradient-aware")
    _check(port_run(*args, backend="torch", device="cpu"),
           reference_run(*args, backend="jax"))


@pytest.mark.parametrize("regime,migration", [
    ("calm", "none"), ("volatile", "none"), ("correlated", "none"),
    ("volatile", "gradient-aware")])
def test_torch_cpu_row_equals_reference_default(regime, migration):
    """The port's torch backend (plain PyTorch in float64 on the CPU)
    against the reference at its default (numpy) scorer: same placements,
    rows and streams."""
    args = (regime, "hlem-vmp-adjusted", UNTIL, migration)
    _check(port_run(*args, backend="torch", device="cpu"),
           reference_run(*args))
