"""Market runs of the port end to end against the JAX package's
``repro.api.run_one`` wiring: the reference launcher's ``--market`` grid
(4 pools, 60 s ticks, advisor volatility, randomized bids floored at 0.45,
the ``market`` scenario of 170 hosts), cut to a 2,400 s horizon here (the
full 14,400 s runs on the card in ``chip_smoke.py``).

The port has no ``api`` package yet, so ``chip_smoke.py`` wires each run by
hand as ``repro.api.build`` wires a ``market`` workload and assembles the
row as ``repro.api.build.collect_row`` does; these tests hold that wiring,
on the port's numpy and torch-CPU backends, against ``repro``.  Rows and
event streams are held equal (``==``): the host side is the reference's
numpy float64.
"""
import math
import sys
from pathlib import Path

import pytest

import repro_torch.core as tc
import repro_torch.market as tm
from repro.api import (BidSpec, FaultSpec, FleetSpec, MigrationSpec,
                       PolicySpec, RunSpec, ScenarioSpec)
from repro.api.build import build, collect_row

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

N_POOLS, TICK, SEED = cs.MARKET_POOLS, cs.MARKET_TICK, cs.MARKET_SEED
UNTIL = 2400.0
# the first storm of the ``storm`` scenario fires at 3,600 s
UNTIL_STORM = 4200.0


def _policy_params(policy):
    return {"alpha": -0.5} if policy == "hlem-vmp-adjusted" else {}


def reference_run(regime, policy, until, migration="none", fleet=None,
                  faults=None, backend=None):
    """``repro.api.run_one`` for the launcher's ``--market`` spec, keeping
    the simulator so its event streams can be read too."""
    params = _policy_params(policy)
    if backend is not None:
        params["backend"] = backend
    spec = RunSpec(
        scenario=ScenarioSpec(
            workload="market", regime=regime, n_pools=N_POOLS,
            tick_interval=TICK, from_advisor=True,
            bid=BidSpec("randomized", {"lo": 0.45})),
        policy=PolicySpec(policy, params),
        migration=MigrationSpec(migration),
        fleet=(FleetSpec(fleet, {"target_capacity": 64.0})
               if fleet else None),
        faults=FaultSpec(faults) if faults else None)
    sim = build(spec, SEED)
    metrics = sim.run(until=until)
    return collect_row(sim, metrics, spec, SEED), cs.market_events(metrics)


def port_run(regime, policy, until, migration="none", fleet=None,
             faults=None, backend="numpy", device="cpu"):
    """The same run from ``repro_torch``, wired by hand by ``chip_smoke.py``
    (the wiring the card runs), its row keyed as ``collect_row`` keys it."""
    sim = cs.market_sim(tc, tm, regime, policy, migration, fleet, faults,
                        backend, device)
    metrics = sim.run(until=until)
    row, events = cs.market_row(tm, sim, metrics)
    row = {"policy": policy, "regime": regime, "migration": migration,
           "seed": SEED, **row}
    return row, events


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
