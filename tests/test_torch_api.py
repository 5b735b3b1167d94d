"""The port's declarative run layer (``repro_torch.api``: specs, registries,
workloads, the builder and the sweep runner) against the JAX package's
(``repro.api``) on the same inputs.

* Specs: every case of ``tests/api/test_api_specs.py`` is built in both
  packages; the dicts and JSON are equal, round trips are the identity, and
  each invalid spec fails with the reference's own message.
* Runs: ``run_one`` rows and event streams of the serving acceptance
  scenario (``serve-diurnal`` with ``target-tracking``) at seeds 0, 1 and
  2 equal the reference's.
* Sweeps: ``run_experiment`` reports of a 2-seed spec cut to 2,400 s have
  the reference's cells, serially and on two worker processes.

The host side is the reference's numpy float64, so everything is held
equal (``==``).  HLEM policies run on the port's numpy backend and on its
torch backend on the CPU (the plain version of the HLEM kernel).
"""
import json

import pytest

import repro.api as ra
import repro_torch.api as ta
import repro_torch.core as tc
from repro_torch.api.build import event_streams

SERVE_SEEDS = (0, 1, 2)
REGISTRIES = ["POLICY_REGISTRY", "BID_REGISTRY", "MIGRATION_REGISTRY",
              "PRICE_PROCESS_REGISTRY", "WORKLOAD_REGISTRY",
              "AUTOSCALE_REGISTRY"]


def _market_scenario(a):
    return a.ScenarioSpec(workload="market", regime="volatile", n_pools=3,
                          tick_interval=30.0, from_advisor=False,
                          bid=a.BidSpec("randomized", {"lo": 0.45}),
                          horizon=1800.0)


def _grid(a, **kw):
    base = dict(name="grid", scenario=_market_scenario(a),
                policies=(a.PolicySpec("first-fit"),), seeds=(0, 1))
    base.update(kw)
    return a.ExperimentSpec(**base)


def _raises_same(port_fn, ref_fn):
    """Both calls raise ValueError with one message."""
    with pytest.raises(ValueError) as want:
        ref_fn()
    with pytest.raises(ValueError) as got:
        port_fn()
    assert str(got.value) == str(want.value)


def test_exports_equal_reference():
    assert ta.__all__ == ra.__all__


@pytest.mark.parametrize("registry", REGISTRIES)
def test_registry_names_equal_reference(registry):
    got, want = getattr(ta, registry), getattr(ra, registry)
    assert got.names() == want.names() and got.kind == want.kind
    _raises_same(lambda: got.get("definitely-not-registered"),
                 lambda: want.get("definitely-not-registered"))


def test_workload_metadata_equals_reference():
    for name in ra.WORKLOAD_REGISTRY.names():
        got = ta.WORKLOAD_REGISTRY.get(name)
        want = ra.WORKLOAD_REGISTRY.get(name)
        for field in ("default_horizon", "supports_bids", "requires_market",
                      "reserved_params", "provides_demand"):
            assert getattr(got, field) == getattr(want, field), (name, field)
        assert got.config_cls.__name__ == want.config_cls.__name__


# ---------------------------------------------------------------------------
# specs: the cases of tests/api/test_api_specs.py
# ---------------------------------------------------------------------------
SPECS = [
    lambda a: a.BidSpec(),
    lambda a: a.BidSpec("percentile", {"pct": 85.0}),
    lambda a: a.PolicySpec("first-fit"),
    lambda a: a.PolicySpec("hlem-vmp-adjusted", {"alpha": -0.4, "rc": 0.9}),
    lambda a: a.MigrationSpec(),
    lambda a: a.MigrationSpec("gradient-aware",
                              {"downtime": 20.0, "hysteresis": 0.1}),
    lambda a: a.RebidSpec(),
    lambda a: a.RebidSpec(bump_lo=1.1, bump_hi=1.5),
    lambda a: a.ScenarioSpec(workload="synthetic"),
    lambda a: a.ScenarioSpec(workload="trace", workload_params={
        "n_machines": 30, "sim_days": 0.05}),
    _market_scenario,
    lambda a: a.RunSpec(scenario=_market_scenario(a),
                        policy=a.PolicySpec("hlem-vmp-adjusted",
                                            {"alpha": -0.5}),
                        migration=a.MigrationSpec("risk-budgeted"),
                        rebid=a.RebidSpec()),
    lambda a: a.RunSpec(scenario=a.ScenarioSpec(
        workload="synthetic",
        sim_params={"interruption_selector": "max_progress"}),
        policy=a.PolicySpec("best-fit")),
    lambda a: a.ExperimentSpec(
        name="grid", scenario=_market_scenario(a),
        policies=(a.PolicySpec("first-fit"),
                  a.PolicySpec("hlem-vmp-adjusted", {"alpha": -0.5})),
        migrations=(a.MigrationSpec(), a.MigrationSpec("gradient-aware")),
        regimes=("calm", "volatile"), seeds=(0, 1, 2), rebid=a.RebidSpec()),
    lambda a: a.ExperimentSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=(a.PolicySpec("first-fit"),),
                               seeds=(7,)),
    # the grid axes: bids, workload ladders, fleets and faults
    lambda a: _grid(a, bids=(a.BidSpec("randomized", {"lo": 0.35}),
                             a.BidSpec("on-demand-cap", {"fraction": 0.8}))),
    lambda a: _grid(a, workload_grid={"fleet_scale": (1.0, 2.0),
                                      "spot_submit_window": (300.0,)}),
    lambda a: _grid(a, regimes=("calm", "volatile"),
                    migrations=(a.MigrationSpec(),
                                a.MigrationSpec("gradient-aware")),
                    bids=(a.BidSpec("randomized"),
                          a.BidSpec("on-demand-cap")),
                    workload_grid={"fleet_scale": (1.0, 2.0)}),
    lambda a: _grid(a, bids=({"strategy": "on-demand-cap",
                              "params": {"fraction": 0.9}},)),
    lambda a: a.FleetSpec(),
    lambda a: a.FleetSpec("single-pool", {
        "target_capacity": 8.0, "pool_weights": [1.0, 0.5],
        "ladder": [["same-pool", 3], ["on-demand", 1]]}),
    lambda a: a.FaultSpec(),
    lambda a: a.FaultSpec("random-storms", {"rate_per_hour": 1.5,
                                            "fraction": 0.3}),
    lambda a: a.RunSpec(scenario=_market_scenario(a),
                        policy=a.PolicySpec("first-fit"),
                        fleet=a.FleetSpec(params={"target_capacity": 16.0}),
                        faults=a.FaultSpec("storm", {"count": 2})),
    lambda a: a.ExperimentSpec(
        name="resilience", scenario=_market_scenario(a),
        policies=(a.PolicySpec("first-fit"),),
        fleets=(None, a.FleetSpec(params={"target_capacity": 16.0})),
        faults=a.FaultSpec("pool-outage", {"pool": 1}), seeds=(0, 1)),
    lambda a: _grid(a, fleets=(None, a.FleetSpec(
        params={"target_capacity": 8.0})),
        faults=a.FaultSpec("storm", {"count": 2})),
    lambda a: _grid(a, bids=(a.BidSpec("randomized"),
                             a.BidSpec("on-demand-cap")),
                    fleets=(None, a.FleetSpec())),
    lambda a: _grid(a, fleets=({"strategy": "lowest-price", "params": {}},
                               None),
                    faults={"scenario": "price-spike",
                            "params": {"magnitude": 1.5}}),
    lambda a: a.ObsSpec(trace=True, counters_every=600, events=True),
]


@pytest.mark.parametrize("case", range(len(SPECS)))
def test_spec_equals_reference_and_round_trips(case):
    got, want = SPECS[case](ta), SPECS[case](ra)
    d = got.to_dict()
    assert d == want.to_dict()
    assert got.to_json() == want.to_json()
    assert json.loads(json.dumps(d)) == d
    assert type(got).from_dict(d) == got
    clone = type(got).from_json(got.to_json())
    assert clone == got and clone.to_json() == got.to_json()
    if hasattr(got, "cells"):
        assert [c.to_dict() for c in got.cells()] == \
            [c.to_dict() for c in want.cells()]
        assert [(i, s) for i, _, s in got.runs()] == \
            [(i, s) for i, _, s in want.runs()]


def test_experiment_save_load_equals_reference(tmp_path):
    got, want = SPECS[13](ta), SPECS[13](ra)
    got.save(str(tmp_path / "port.json"))
    want.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    assert ta.ExperimentSpec.load(str(tmp_path / "ref.json")) == got


INVALID = [
    lambda a: a.ScenarioSpec(workload="nope"),
    lambda a: a.ScenarioSpec(workload="synthetic", regime="wild"),
    lambda a: a.ScenarioSpec(workload="market"),
    lambda a: a.ScenarioSpec(workload="synthetic", regime="calm", n_pools=0),
    lambda a: a.ScenarioSpec(workload="synthetic", regime="calm",
                             tick_interval=0.0),
    lambda a: a.ScenarioSpec(workload="synthetic", horizon=-5.0),
    lambda a: a.ScenarioSpec(workload="synthetic", bid=a.BidSpec()),
    lambda a: a.ScenarioSpec(workload="trace", regime="calm",
                             bid=a.BidSpec()),
    lambda a: a.ScenarioSpec(workload="synthetic",
                             workload_params={"seed": 1}),
    lambda a: a.ScenarioSpec(workload="market", regime="calm",
                             workload_params={"n_pools": 2}),
    lambda a: a.ScenarioSpec(workload="synthetic",
                             workload_params={"typo": 1}),
    lambda a: a.ScenarioSpec(workload="synthetic", sim_params={"typo": 1}),
    lambda a: a.PolicySpec("nope"),
    lambda a: a.PolicySpec("first-fit", {"alpha": 1.0}),
    lambda a: a.MigrationSpec("nope"),
    lambda a: a.MigrationSpec("gradient-aware", {"typo": 1}),
    lambda a: a.BidSpec("nope"),
    lambda a: a.BidSpec("randomized", {"typo": 1}),
    lambda a: a.RebidSpec(bump_lo=2.0, bump_hi=1.0),
    lambda a: a.RunSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                        policy=a.PolicySpec("first-fit"),
                        migration=a.MigrationSpec("gradient-aware")),
    lambda a: a.RunSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                        policy=a.PolicySpec("first-fit"),
                        rebid=a.RebidSpec()),
    lambda a: a.RunSpec(scenario=_market_scenario(a),
                        policy=a.PolicySpec("first-fit"), rebid=5),
    lambda a: a.RunSpec(scenario=_market_scenario(a), policy="first-fit"),
    lambda a: a.ExperimentSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=("first-fit",), seeds=(0,)),
    lambda a: a.ExperimentSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=(a.PolicySpec("first-fit"),),
                               migrations=("none",), seeds=(0,)),
    lambda a: a.ExperimentSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=(), seeds=(0,)),
    lambda a: a.ExperimentSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=(a.PolicySpec("first-fit"),),
                               seeds=()),
    lambda a: a.ExperimentSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=(a.PolicySpec("first-fit"),),
                               seeds=(0, 0)),
    lambda a: a.ExperimentSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=(a.PolicySpec("first-fit"),),
                               seeds=(0,), regimes=("wild",)),
    lambda a: a.ExperimentSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=(a.PolicySpec("first-fit"),),
                               migrations=(a.MigrationSpec("gradient-aware"),),
                               seeds=(0,)),
    lambda a: _grid(a, bids=()),
    lambda a: _grid(a, workload_grid={"fleet_scale": ()}),
    lambda a: a.ExperimentSpec(
        name="x", scenario=_market_scenario(a).replace(
            workload_params={"fleet_scale": 1.0}),
        policies=(a.PolicySpec("first-fit"),), seeds=(0,),
        workload_grid={"fleet_scale": (1.0, 2.0)}),
    lambda a: _grid(a, workload_grid={"not_a_param": (1,)}),
    lambda a: _grid(a, workload_grid={"fleet_scale": 2.0}),
    lambda a: _grid(a, workload_grid={"fleet_scale": "1.0"}),
    lambda a: a.ExperimentSpec(name="x",
                               scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=(a.PolicySpec("first-fit"),),
                               seeds=(0,), bids=(a.BidSpec("randomized"),)),
    lambda a: a.FleetSpec("nope"),
    lambda a: a.FleetSpec(params={"typo": 1}),
    lambda a: a.FleetSpec(params={"target_capacity": -1.0}),
    lambda a: a.FleetSpec(params={"pool_weights": [1.0, -1.0]}),
    lambda a: a.FleetSpec(params={"ladder": [["teleport", 1]]}),
    lambda a: a.FaultSpec("nope"),
    lambda a: a.FaultSpec(params={"typo": 1}),
    lambda a: a.RunSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                        policy=a.PolicySpec("first-fit"), fleet=a.FleetSpec()),
    lambda a: a.RunSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                        policy=a.PolicySpec("first-fit"),
                        faults=a.FaultSpec()),
    lambda a: a.RunSpec(scenario=_market_scenario(a),
                        policy=a.PolicySpec("first-fit"),
                        fleet=a.FleetSpec(
                            params={"pool_weights": [1.0, 1.0]})),
    lambda a: a.RunSpec(scenario=_market_scenario(a),
                        policy=a.PolicySpec("first-fit"),
                        fleet=a.FleetSpec(params={"ladder": [["pool:9", 1]]})),
    lambda a: a.RunSpec(scenario=_market_scenario(a),
                        policy=a.PolicySpec("first-fit"),
                        faults=a.FaultSpec("pool-outage", {"pool": 7})),
    lambda a: a.RunSpec(scenario=_market_scenario(a),
                        policy=a.PolicySpec("first-fit"), fleet="diversified"),
    lambda a: a.RunSpec(scenario=_market_scenario(a),
                        policy=a.PolicySpec("first-fit"), faults=5),
    lambda a: a.ExperimentSpec(scenario=_market_scenario(a),
                               policies=(a.PolicySpec("first-fit"),),
                               seeds=(0,), fleets=()),
    lambda a: a.ExperimentSpec(scenario=_market_scenario(a),
                               policies=(a.PolicySpec("first-fit"),),
                               seeds=(0,), fleets=("diversified",)),
    lambda a: a.ExperimentSpec(scenario=_market_scenario(a),
                               policies=(a.PolicySpec("first-fit"),),
                               seeds=(0,), faults=5),
    lambda a: a.ExperimentSpec(scenario=a.ScenarioSpec(workload="synthetic"),
                               policies=(a.PolicySpec("first-fit"),),
                               seeds=(0,), fleets=(a.FleetSpec(),)),
    lambda a: a.ObsSpec(counters_every=-1.0),
    lambda a: a.ObsSpec(counters_every="often"),
]


@pytest.mark.parametrize("case", range(len(INVALID)))
def test_validation_error_equals_reference(case):
    _raises_same(lambda: INVALID[case](ta), lambda: INVALID[case](ra))


def test_hlem_policy_params_are_the_ports():
    """The port's HLEM policies take ``backend`` (torch or numpy) and
    ``device``; the reference's ``"jax"`` backend is refused with the
    port's own error when the policy is built."""
    for params in ({"backend": "numpy"}, {"device": "cuda"},
                   {"backend": "torch", "device": "cpu"}):
        spec = ta.PolicySpec("hlem-vmp", params)
        assert ta.PolicySpec.from_json(spec.to_json()) == spec
    with pytest.raises(ValueError, match="unknown allocation policy"):
        ra.PolicySpec("hlem-vmp", {"device": "cpu"})
    spec = ta.RunSpec(scenario=_market_scenario(ta),
                      policy=ta.PolicySpec("hlem-vmp", {"backend": "jax"}))
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        ta.build(spec, 0)


def test_custom_plugins_plug_into_the_ports_specs():
    @ta.register_policy("test-port-first-fit-clone")
    class FirstFitClone(tc.FirstFit):
        name = "test-port-first-fit-clone"

    @ta.register_workload("test-port-tiny")
    def _populate(sim, scenario, seed):
        sim.add_host(tc.resources(8, 16_384, 5_000, 200_000))
        sim.submit(tc.make_on_demand(0, tc.resources(1, 1024, 100, 10_000),
                                     50.0))

    try:
        assert isinstance(tc.make_policy("test-port-first-fit-clone"),
                          FirstFitClone)
        spec = ta.RunSpec(scenario=ta.ScenarioSpec(workload="test-port-tiny"),
                          policy=ta.PolicySpec("test-port-first-fit-clone"))
        assert ta.RunSpec.from_json(spec.to_json()) == spec
        assert ta.build(spec, seed=0).run().allocations == 1
        with pytest.raises(ValueError, match="already registered"):
            ta.register_policy("test-port-first-fit-clone")(FirstFitClone)
    finally:
        ta.POLICY_REGISTRY.entries.pop("test-port-first-fit-clone")
        ta.WORKLOAD_REGISTRY.entries.pop("test-port-tiny")
    assert "test-port-first-fit-clone" not in ra.POLICY_REGISTRY


# ---------------------------------------------------------------------------
# runs: the serving acceptance scenario, and the other workloads
# ---------------------------------------------------------------------------
def _serve_spec(a, policy="first-fit", params=None):
    return a.RunSpec(
        scenario=a.ScenarioSpec(workload="serve-diurnal", regime="volatile",
                                horizon=14400.0),
        policy=a.PolicySpec(policy, params or {}),
        fleet=a.FleetSpec(params={"target_capacity": 24.0}),
        serve=a.ServeSpec(), autoscale=a.AutoscaleSpec("target-tracking"))


def _run(a, spec, seed, until=None):
    sim = a.build(spec, seed)
    horizon = until if until is not None else a.resolve_horizon(spec.scenario)
    metrics = sim.run(until=horizon)
    return a.collect_row(sim, metrics, spec, seed), event_streams(metrics)


@pytest.mark.parametrize("seed", SERVE_SEEDS)
def test_serve_run_one_equals_reference(seed):
    got = ta.run_one(_serve_spec(ta), seed)
    assert got == ra.run_one(_serve_spec(ra), seed)
    assert got["requests_done"] > 0 and got["autoscale_actions"] > 0
    row, events = _run(ta, _serve_spec(ta), seed)
    assert row == got
    assert events == _run(ra, _serve_spec(ra), seed)[1]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("seed", SERVE_SEEDS)
def test_serve_hlem_run_equals_reference(seed, backend):
    params = {"alpha": -0.5, "backend": backend}
    if backend == "torch":
        params["device"] = "cpu"
    got = _run(ta, _serve_spec(ta, "hlem-vmp-adjusted", params), seed)
    want = _run(ra, _serve_spec(ra, "hlem-vmp-adjusted", {"alpha": -0.5}),
                seed)
    assert got == want


@pytest.mark.parametrize("scenario", [
    dict(workload="synthetic"),
    dict(workload="synthetic", regime="calm", bid={"strategy": "percentile",
                                                   "params": {}}),
    dict(workload="trace", workload_params={"n_machines": 30,
                                            "sim_days": 0.05}),
])
def test_workload_run_equals_reference(scenario):
    def spec(a):
        return a.RunSpec(scenario=a.ScenarioSpec(**scenario),
                         policy=a.PolicySpec("best-fit"))
    got = _run(ta, spec(ta), 3, until=2400.0)
    assert got == _run(ra, spec(ra), 3, until=2400.0)
    assert got[0]["allocations"] > 0


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------
def _sweep_spec(a, params):
    return a.ExperimentSpec(
        name="mini", scenario=_market_scenario(a).replace(horizon=None),
        policies=(a.PolicySpec("hlem-vmp-adjusted", params),),
        migrations=(a.MigrationSpec(), a.MigrationSpec("gradient-aware")),
        seeds=(0, 1))


@pytest.fixture(scope="module")
def reference_report():
    return ra.run_experiment(_sweep_spec(ra, {"alpha": -0.5}), processes=1,
                             until=2400.0)


@pytest.mark.parametrize("processes", [1, 2])
def test_run_experiment_cells_equal_reference(processes, reference_report):
    want = reference_report
    got = ta.run_experiment(
        _sweep_spec(ta, {"alpha": -0.5, "backend": "torch", "device": "cpu"}),
        processes=processes, until=2400.0, manifest=True)
    assert got["cells"] == want["cells"]
    assert (got["name"], got["horizon"], got["n_runs"]) == \
        (want["name"], want["horizon"], want["n_runs"])
    assert got["manifest"]["device"] is None   # the CPU initialises no CUDA
    assert ta.format_report(got) == ra.format_report(want)
