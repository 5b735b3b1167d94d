"""The serving layer's market side (``repro_torch.serve``: ``demand``,
``autoscale``, ``slo``, ``service``) against the JAX package's
(``repro.serve``), function by function and class by class, on the cases
of ``tests/serve/test_{demand,autoscale,slo,service}.py``.

These modules are pure Python and numpy carried over from the reference,
so every result is held equal (``==``), error messages included.  The
service cases run whole serving scenarios through each package's own spec
layer (``repro_torch.api`` / ``repro.api``) at the reference tests'
horizons.
"""
import math

import pytest

import repro.api as ra
import repro.serve as rs
import repro.serve.autoscale as rauto
import repro.serve.demand as rdem
import repro.serve.slo as rslo
import repro_torch.api as ta
import repro_torch.serve as ts
import repro_torch.serve.autoscale as tauto
import repro_torch.serve.demand as tdem
import repro_torch.serve.slo as tslo

T_GRID = [i * 61.0 for i in range(500)] + [i * 17.0 for i in range(2000)]


def _raises_same(port_fn, ref_fn):
    """Both calls raise ValueError with one message."""
    with pytest.raises(ValueError) as want:
        ref_fn()
    with pytest.raises(ValueError) as got:
        port_fn()
    assert str(got.value) == str(want.value)


def test_exports_equal_reference():
    assert ts.__all__ == rs.__all__


# ---------------------------------------------------------------------------
# demand curves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    dict(base_rate=0.2, amplitude=0.1, period=86400.0),
    dict(base_rate=0.1, amplitude=0.5, period=3600.0),
    dict(base_rate=0.2, amplitude=0.1, period=3600.0),
    dict(base_rate=0.2, amplitude=0.1, period=3600.0, phase=900.0),
    dict(),
])
def test_diurnal_equals_reference(kwargs):
    got, want = tdem.make_diurnal(**kwargs), rdem.make_diurnal(**kwargs)
    assert [got(t) for t in T_GRID] == [want(t) for t in T_GRID]


@pytest.mark.parametrize("kwargs", [
    {"base_rate": -0.1}, {"amplitude": -1.0}, {"period": 0.0},
])
def test_diurnal_validation_equals_reference(kwargs):
    _raises_same(lambda: tdem.make_diurnal(**kwargs),
                 lambda: rdem.make_diurnal(**kwargs))


@pytest.mark.parametrize("kwargs", [
    dict(horizon=36000.0, seed=7), dict(horizon=36000.0, seed=0),
    dict(horizon=36000.0, seed=1),
    dict(base_rate=0.25, horizon=36000.0, seed=3),
    dict(horizon=36000.0, seed=5), dict(),
])
def test_bursty_equals_reference(kwargs):
    got, want = tdem.make_bursty(**kwargs), rdem.make_bursty(**kwargs)
    assert [got(t) for t in T_GRID] == [want(t) for t in T_GRID]
    # evaluation order is irrelevant (the spikes are drawn up front)
    assert [got(t) for t in reversed(T_GRID)] == \
        [want(t) for t in T_GRID][::-1]


@pytest.mark.parametrize("kwargs", [
    {"base_rate": -1.0}, {"spike_every": 0.0}, {"spike_alpha": 0.0},
    {"spike_duration": -5.0}, {"horizon": 0.0},
])
def test_bursty_validation_equals_reference(kwargs):
    _raises_same(lambda: tdem.make_bursty(**kwargs),
                 lambda: rdem.make_bursty(**kwargs))


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------
def _signals(mod, t=0.0, rate=1.0, queue=0, p95=float("nan"), live=4,
             target=4, per_unit=0.5, ahead=0.0):
    return mod.DemandSignals(t=t, rate_ewma=rate, queue_depth=queue,
                             p95_latency=p95, live_units=live,
                             target_units=target, unit_throughput=per_unit,
                             rate_ahead=ahead)


# (signals, config) cases of the reference's policy tests
POLICY_CASES = [
    (dict(rate=99.0, target=4), {}),
    (dict(rate=1.0, per_unit=0.5), dict(headroom=1.2)),
    (dict(rate=4.0, per_unit=0.5), dict(headroom=1.2)),
    (dict(rate=1.0, queue=100, per_unit=0.5),
     dict(headroom=1.0, queue_drain=100.0)),
    (dict(queue=20, live=4, target=4),
     dict(step_units=2, queue_hi=4.0, queue_lo=0.5)),
    (dict(queue=8, live=4, target=4),
     dict(step_units=2, queue_hi=4.0, queue_lo=0.5)),
    (dict(queue=1, live=4, target=4),
     dict(step_units=2, queue_hi=4.0, queue_lo=0.5)),
    (dict(rate=1.0, ahead=3.0, per_unit=0.5), dict(headroom=1.0)),
    (dict(rate=3.0, ahead=1.0, per_unit=0.5), dict(headroom=1.0)),
    (dict(queue=3, live=0, target=0, per_unit=0.0), {}),
]


def test_registry_names_equal_reference():
    assert tauto.AUTOSCALE_REGISTRY.names() == rauto.AUTOSCALE_REGISTRY.names()
    assert tauto.AUTOSCALE_REGISTRY.kind == rauto.AUTOSCALE_REGISTRY.kind


@pytest.mark.parametrize("policy", ["static", "target-tracking", "step",
                                    "predictive-from-curve"])
@pytest.mark.parametrize("case", range(len(POLICY_CASES)))
def test_policy_equals_reference(policy, case):
    sig, cfg = POLICY_CASES[case]
    got = tauto.AUTOSCALE_REGISTRY.get(policy)(
        _signals(tauto, **sig), tauto.AutoscaleConfig(**cfg))
    want = rauto.AUTOSCALE_REGISTRY.get(policy)(
        _signals(rauto, **sig), rauto.AutoscaleConfig(**cfg))
    assert got == want and type(got) is type(want)


# (policy, config, [signals ...]) decision sequences of the reference's
# clamp, no-change, hysteresis and cooldown tests
DECIDE_CASES = [
    ("target-tracking", dict(min_units=2, max_units=6, cooldown=0.0,
                             hysteresis=0.0),
     [dict(rate=100.0, target=4), dict(t=1e6, rate=0.0, target=4)]),
    ("static", dict(cooldown=0.0), [dict(target=4)]),
    ("target-tracking", dict(hysteresis=0.25, cooldown=0.0, headroom=1.0,
                             max_units=100),
     [dict(rate=5.5, per_unit=0.5, target=10),
      dict(rate=8.0, per_unit=0.5, target=10)]),
    ("target-tracking", dict(hysteresis=0.0, cooldown=600.0, headroom=1.0,
                             max_units=100),
     [dict(t=0.0, rate=5.0, per_unit=0.5, target=4),
      dict(t=300.0, rate=20.0, per_unit=0.5, target=10),
      dict(t=700.0, rate=20.0, per_unit=0.5, target=10)]),
    ("step", dict(cooldown=100.0),
     [dict(t=float(k * 60), queue=q, target=4)
      for k, q in enumerate((40, 40, 0, 0, 10, 40))]),
]


@pytest.mark.parametrize("case", range(len(DECIDE_CASES)))
def test_autoscaler_decisions_equal_reference(case):
    policy, cfg, seq = DECIDE_CASES[case]
    got = tauto.make_autoscaler(policy, **cfg)
    want = rauto.Autoscaler(policy, rauto.AutoscaleConfig(**cfg))
    assert got.policy_name == want.policy_name
    assert [got.decide(_signals(tauto, **s)) for s in seq] == \
        [want.decide(_signals(rauto, **s)) for s in seq]


@pytest.mark.parametrize("bad", [
    {}, {"cadence": 0.0}, {"min_units": -1},
    {"max_units": 0, "min_units": 4}, {"hysteresis": 1.0},
    {"cooldown": -1.0}, {"headroom": 0.0}, {"ewma_alpha": 0.0},
    {"latency_window": 0.0}, {"queue_drain": 0.0}, {"lead": -1.0},
    {"step_units": 0}, {"queue_hi": 0.2, "queue_lo": 0.5},
])
def test_config_validation_equals_reference(bad):
    if not bad:   # the defaults validate in both
        tauto.validate_autoscale_config(tauto.AutoscaleConfig())
        rauto.validate_autoscale_config(rauto.AutoscaleConfig())
        return
    _raises_same(
        lambda: tauto.validate_autoscale_config(tauto.AutoscaleConfig(**bad)),
        lambda: rauto.validate_autoscale_config(rauto.AutoscaleConfig(**bad)))


def test_unknown_policy_equals_reference():
    _raises_same(lambda: tauto.make_autoscaler("no-such-policy"),
                 lambda: rauto.make_autoscaler("no-such-policy"))


# ---------------------------------------------------------------------------
# SLO and cost metrics
# ---------------------------------------------------------------------------
_DONE = [float(i) for i in range(200)]
SLO_CASES = [
    ("latency_percentiles", ([],), {}),
    ("latency_percentiles", (list(range(1, 101)),), {}),
    ("latency_percentiles", ([0.3, 7.0, 2.5],), dict(qs=(10.0, 90.0))),
    ("slo_attainment", ([], 1.0), {}),
    ("slo_attainment", ([0.5, 1.0, 2.0, 3.0], 1.0), {}),
    ("slo_attainment", ([0.1, 0.2], 1.0), {}),
    ("error_budget_burn", (_DONE[:100],
                           [2.0 if i < 10 else 0.5 for i in range(100)]),
     dict(threshold=1.0, objective=0.95, window=1000.0, horizon=100.0)),
    ("error_budget_burn", ([], [], 1.0, 0.95, 100.0, 1000.0), {}),
    ("error_budget_burn", (_DONE, [2.0 if i < 100 else 0.5
                                   for i in range(200)]),
     dict(threshold=1.0, objective=0.95, window=100.0, horizon=200.0)),
    ("cost_per_request", (10.0, 100), {}),
    ("cost_per_request", (10.0, 0), {}),
    ("cost_forecast", (5.0, 3600.0, 7200.0), {}),
    ("cost_forecast", (5.0, 0.0, 7200.0), {}),
]


@pytest.mark.parametrize("case", range(len(SLO_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SLO_CASES)])
def test_slo_function_equals_reference(case):
    name, args, kwargs = SLO_CASES[case]
    assert getattr(tslo, name)(*args, **kwargs) == \
        getattr(rslo, name)(*args, **kwargs)


# ---------------------------------------------------------------------------
# the serve manager, through each package's spec layer
# ---------------------------------------------------------------------------
def _serve_spec(api, workload="serve-diurnal", autoscale=None,
                horizon=7200.0, fleet_capacity=8.0, serve_params=None,
                faults=None, policy="first-fit", **wl):
    return api.RunSpec(
        scenario=api.ScenarioSpec(workload=workload, regime="volatile",
                                  n_pools=4, horizon=horizon,
                                  workload_params=wl),
        policy=api.PolicySpec(policy),
        fleet=api.FleetSpec(params={"target_capacity": fleet_capacity}),
        faults=api.FaultSpec(faults) if faults else None,
        serve=api.ServeSpec(params=serve_params or {}),
        autoscale=(api.AutoscaleSpec(*autoscale)
                   if autoscale is not None else None))


# the reference's service cases: (spec kwargs, seed, horizon)
SERVICE_CASES = [
    (dict(base_rate=0.3, amplitude=0.1), 0, 7200.0),
    (dict(workload="serve-bursty", spike_every=900.0), 1, 7200.0),
    (dict(workload="serve-bursty",
          autoscale=("target-tracking", {"cadence": 600.0, "max_units": 16})),
     5, 7200.0),
    (dict(base_rate=0.6, amplitude=0.4, period=3600.0, fleet_capacity=4.0,
          autoscale=("target-tracking", {"cadence": 300.0, "cooldown": 300.0,
                                         "max_units": 24})), 0, 7200.0),
    (dict(base_rate=0.6, amplitude=0.4,
          autoscale=("static", {"cadence": 300.0})), 0, 7200.0),
    (dict(horizon=14400.0, fleet_capacity=24.0, faults="storm",
          base_rate=0.2, amplitude=0.05,
          serve_params={"hibernate_requests": True}), 0, 14400.0),
    (dict(horizon=14400.0, fleet_capacity=24.0, faults="storm",
          base_rate=0.2, amplitude=0.05,
          serve_params={"hibernate_requests": False}), 0, 14400.0),
    (dict(autoscale=("step", {"step_units": 3}),
          serve_params={"tick": 120.0, "slots_per_vm": 8}), 2, 7200.0),
    (dict(workload="serve-bursty", base_rate=0.4,
          autoscale=("predictive-from-curve", {"cadence": 600.0})), 3,
     7200.0),
]


def _serve_run(api, kwargs, seed, until):
    sim = api.build(_serve_spec(api, **kwargs), seed)
    m = sim.run(until=until)
    serve = sim.serve
    return {
        "row": api.collect_row(sim, m, _serve_spec(api, **kwargs), seed),
        "arrived": m.requests_arrived, "done": m.requests_done,
        "requeued": m.requests_requeued,
        "latencies": list(m.request_latencies),
        "decisions": list(m.autoscale_decisions),
        "queue": serve.queue_depth(),
        "running": {vid: len(s.running) for vid, s in serve._scheds.items()},
        "target_units": sim.fleet.target_units,
        "override": sim.fleet._units_override,
    }


@pytest.mark.parametrize("case", range(len(SERVICE_CASES)))
def test_serve_manager_run_equals_reference(case):
    kwargs, seed, until = SERVICE_CASES[case]
    got, want = _serve_run(ta, kwargs, seed, until), \
        _serve_run(ra, kwargs, seed, until)
    assert got == want
    assert got["arrived"] > 0 and got["done"] > 0
    assert all(math.isfinite(v) for v in got["row"].values()
               if isinstance(v, float))


def test_serve_manager_direct_equals_reference():
    """``make_serve_manager`` and ``validate_serve_config`` outside a run:
    one config, the same fields and the same signals before any tick."""
    got = ts.make_serve_manager(ts.ServeConfig(slots_per_vm=8), seed=3)
    want = rs.make_serve_manager(rs.ServeConfig(slots_per_vm=8), seed=3)
    assert vars(got.config) == vars(want.config)
    assert got.config.unit_throughput == want.config.unit_throughput
    assert got.queue_depth() == want.queue_depth() == 0
    assert got.pending() is want.pending() is False
    # the token-length stream is seeded the same way
    assert (got._rng.exponential(240.0, 8)
            == want._rng.exponential(240.0, 8)).all()
    for bad in ({"tick": 0.0}, {"slots_per_vm": 0}, {"tokens_per_s": 0.0},
                {"slo_objective": 1.5}):
        _raises_same(lambda: ts.validate_serve_config(ts.ServeConfig(**bad)),
                     lambda: rs.validate_serve_config(rs.ServeConfig(**bad)))


@pytest.mark.parametrize("factory", [
    lambda a: a.RunSpec(scenario=a.ScenarioSpec(workload="market",
                                                regime="volatile"),
                        policy=a.PolicySpec("first-fit"),
                        fleet=a.FleetSpec(), serve=a.ServeSpec()),
    lambda a: a.RunSpec(scenario=a.ScenarioSpec(workload="serve-diurnal",
                                                regime="volatile"),
                        policy=a.PolicySpec("first-fit")),
    lambda a: a.RunSpec(scenario=a.ScenarioSpec(workload="market",
                                                regime="volatile"),
                        policy=a.PolicySpec("first-fit"), fleet=a.FleetSpec(),
                        autoscale=a.AutoscaleSpec()),
    lambda a: a.RunSpec(scenario=a.ScenarioSpec(workload="serve-diurnal",
                                                regime="volatile"),
                        policy=a.PolicySpec("first-fit"), serve=a.ServeSpec(),
                        autoscale=a.AutoscaleSpec()),
    lambda a: a.ServeSpec(params={"nope": 1}),
    lambda a: a.AutoscaleSpec(policy="target-tracking", params={"nope": 1}),
])
def test_serve_spec_validation_equals_reference(factory):
    _raises_same(lambda: factory(ta), lambda: factory(ra))


def test_serve_experiment_axis_equals_reference():
    def exp(a):
        return a.ExperimentSpec(
            scenario=a.ScenarioSpec(workload="serve-diurnal",
                                    regime="volatile", horizon=3600.0),
            policies=(a.PolicySpec("first-fit"),), seeds=(0,),
            fleets=(a.FleetSpec(params={"target_capacity": 8.0}),),
            serve=a.ServeSpec(),
            autoscales=(None, a.AutoscaleSpec("static"),
                        a.AutoscaleSpec("target-tracking")))
    got, want = exp(ta), exp(ra)
    assert got.to_dict() == want.to_dict()
    assert [c.to_dict() for c in got.cells()] == \
        [c.to_dict() for c in want.cells()]


def test_serve_events_and_trace_equal_reference():
    def run(api):
        spec = _serve_spec(api, base_rate=0.4, amplitude=0.2).replace(
            obs={"events": True, "trace": True})
        sim = api.build(spec, seed=0)
        sim.run(until=7200.0)
        return (list(sim.events.records()),
                [(s[0], s[1], s[4]) for s in sim.obs.spans])
    got, want = run(ta), run(ra)
    assert got == want
    kinds = {r[1] for r in got[0]}
    assert {"request-arrive", "request-done", "serve-sample"} <= kinds
    assert "tick/serve" in {s[1] for s in got[1]}
