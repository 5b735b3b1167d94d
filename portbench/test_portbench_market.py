"""CPU tests of the benchmark's market cells (``portbench/drivers/market.py``
and the plain reference ``portbench/refs/market.py``).

Short replays of the ``--market`` scenario with the policy's plain
PyTorch scorer on the CPU: the frozen generator and the reference's
advisor volatility against the program's, a sound run, planted faults and
the float32 control.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import harness  # noqa: E402
from portbench.control import control_run  # noqa: E402
from portbench.gen import market as frozen  # noqa: E402
from portbench.refs.market import advisor_sigmas  # noqa: E402
from portbench.test_portbench_harness import (  # noqa: E402
    _alter_answer, _half_left_out, _state_unchanged)

CELLS = ["market-volatile-migrate", "market-correlated"]
SHORT = {"horizon_s": 1800.0, "replay_seeds": [0, 1]}
#: the benchmark's market cell, and each traffic mix of its configuration
#: run through it: ``market-correlated``'s mix is kept as data for a later
#: cell (``portbench/workloads/market-correlated-14400s.json``)
CELL = "market-volatile-migrate"


def traffic(cell):
    """The short traffic of ``cell``'s mix, as overrides of ``CELL``'s."""
    if cell == CELL:
        return dict(SHORT)
    mix = json.loads((ROOT / "portbench" / "workloads"
                      / f"{cell}-14400s.json").read_text())
    return {**mix, **SHORT}


def short_run(cell, break_sim=None, seconds=6.0, seed=4):
    out = harness.run(CELL, seed, seconds, False, device="cpu",
                      traffic_overrides=traffic(cell), break_sim=break_sim)
    out.pop("_judged")
    return out, out.pop("_record")


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_frozen_market_equals_program(seed):
    from repro_torch.core.workload import MarketScenarioConfig, market_scenario
    from repro_torch.market.bids import assign_bids, make_bid_strategy
    from repro_torch.market.pools import make_market
    hosts, pools, vms = market_scenario(
        MarketScenarioConfig(seed=seed, n_pools=4))
    pool = make_market("correlated", 4, seed=seed).pools[0]
    strat = make_bid_strategy("randomized", pool_cfg=pool, seed=seed,
                              lo=0.45)
    assign_bids(vms, strat, seed=seed)
    got_hosts, got_vms = frozen.generate(
        seed, 4, 1.7, (7200.0, 10800.0), 600.0, 300.0, 3600.0,
        (1200.0, 4800.0), 600.0, 2400.0, 2400.0, 0.45, 1.0, 1.0)
    assert [(c.tolist(), p) for c, p in got_hosts] == \
        [(c.tolist(), p) for c, p in zip(hosts, pools)]
    assert [(v["id"], v["kind"] == "spot", v["demand"].tolist(),
             v["duration"], v["submit"], v["pool"], v["bid"],
             v["min_running_time"], v["hibernation_timeout"])
            for v in got_vms] == \
        [(v.id, v.is_spot, v.demand.tolist(), v.duration, v.submit_time,
          v.pool, v.bid, v.min_running_time, v.hibernation_timeout)
         for v in vms]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_reference_volatility_equals_program(seed):
    from repro_torch.market.risk import advisor_pool_volatility
    np.testing.assert_array_equal(advisor_sigmas(4, seed),
                                  advisor_pool_volatility(4, seed=seed))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out, rec = short_run(cell)
    assert out["correct"] is True, out["checks"]
    assert sum(r["completed"] for r in rec.replays) >= 1
    assert any(r["observed"]["interruptions"] for r in rec.replays)
    assert out["checks"]["price_gap_max"]["value"] == 0
    migrated = any(r["observed"]["migrations"] for r in rec.replays)
    assert migrated == (cell == CELL)


def test_window_closing_on_unrun_replays_is_correct():
    """A window that closes between a replay's build and its first chunk
    judges only what was simulated: the unrun replay has no time 0 tick."""
    for seconds in (1e-4, 0.05):
        out, rec = short_run("market-correlated", seconds=seconds)
        assert out["correct"] is True, out["checks"]
        assert all(r["reached"] > 0 for r in rec.replays)
        assert len(rec.build_s) >= len(rec.replays)


def _alter_price(sim):
    """Every tick's clearing prices raised by one part in a million."""
    engine = sim.engine
    tick = engine.tick

    def dearer(*args, **kwargs):
        engine.prices = tick(*args, **kwargs) * (1 + 1e-6)
        return engine.prices
    engine.tick = dearer


def _alter_destination(sim):
    """Each migration's destination host moved to the first that fits."""
    policy = sim.policy
    pick = policy._pick_direct

    def first(mask, vm, pool):
        hid = pick(mask, vm, pool)
        if hid >= 0 and vm.state.name == "RUNNING" and vm.is_spot:
            return int(np.flatnonzero(mask)[0])
        return hid
    policy._pick_direct = first


@pytest.mark.parametrize("cell,fault", [
    *[(c, f) for c in CELLS for f in (_alter_answer, _alter_price,
                                      _state_unchanged, _half_left_out)],
    ("market-volatile-migrate", _alter_destination)])
def test_check_fails_on_a_broken_timed_path(cell, fault):
    out, _ = short_run(cell, break_sim=fault)
    assert out["correct"] is False
    assert out["failed"] > 0 or \
        out["checks"]["price_gap_max"]["value"] > \
        out["checks"]["price_gap_max"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(cell):
    """The reference in the program's place at float32 fails the check
    (its prices part from the float64 reference's); at float64 it
    passes."""
    low = control_run(CELL, 1, 1, "float32", None, traffic(cell))
    assert low["correct"] is False
    assert low["checks"]["price_gap_max"]["value"] > \
        low["checks"]["price_gap_max"]["limit"]
    same = control_run(CELL, 1, 1, "float64", None, traffic(cell))
    assert same["correct"] is True
