"""The port's simulator slice end to end against the JAX package: the seeded
trace, the synthetic §VII-E scenario under all five policies, and the
trace-driven §VII-D run with HLEM-VMP-adjusted on every backend."""
import copy

import pytest

import repro.core as rc
import repro.market.trace as rt
import repro_torch.core as tc
import repro_torch.market.trace as tt

POLICIES = ["first-fit", "best-fit", "worst-fit", "hlem-vmp",
            "hlem-vmp-adjusted"]
QUICK = dict(seed=0, n_machines=60, sim_days=0.08, n_spot=300,
             load_per_machine=30.0, spot_durations_h=(1.0, 2.0))
QUICK_PINNED = {"vms": 2582, "allocations": 3205, "interruptions": 623,
                "max_interruption_s": 364, "redeployed": 249}


def _fingerprint(sim, metrics):
    s = metrics.spot_stats(sim.vms)
    return {
        "vms": len(sim.vms),
        "allocations": metrics.allocations,
        "resubmissions": metrics.resubmissions,
        "spot_stats": s,
        "events": [(e.vm_id, e.time, e.host, e.kind, str(e.cause))
                   for e in metrics.interruption_events],
    }


def _pinned(fp):
    s = fp["spot_stats"]
    return {"vms": fp["vms"], "allocations": fp["allocations"],
            "interruptions": s["interruptions"],
            "max_interruption_s": round(s["max_interruption_time"]),
            "redeployed": s["spot_finished_after_interruption"]}


@pytest.mark.parametrize("cfg_kw", [QUICK, dict(seed=3, n_machines=40,
                                                sim_days=0.5, n_spot=50)])
def test_generate_trace_equals_reference(cfg_kw, tmp_path):
    ref = rt.generate_trace(rt.TraceConfig(**cfg_kw))
    port = tt.generate_trace(tt.TraceConfig(**cfg_kw))
    assert port.machine_events == ref.machine_events
    assert port.task_events == ref.task_events
    # the CSV interchange crosses between the packages both ways
    tt.write_trace_csv(port, str(tmp_path / "port"))
    rt.write_trace_csv(ref, str(tmp_path / "ref"))
    back_ref = rt.load_trace(str(tmp_path / "port"))
    back_port = tt.load_trace(str(tmp_path / "ref"))
    assert back_ref.machine_events == back_port.machine_events
    assert back_ref.task_events == back_port.task_events


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("policy_name", POLICIES)
def test_synthetic_scenario_equals_reference(seed, policy_name):
    out = []
    for core, kw in ((rc, {}), (tc, {"backend": "numpy"})):
        hosts, vms = core.synthetic_scenario(core.ScenarioConfig(seed=seed))
        kwargs = kw if policy_name.startswith("hlem") else {}
        sim = core.MarketSimulator(policy=core.make_policy(policy_name, **kwargs),
                                   config=core.SimConfig(record_timeline=False))
        for cap in hosts:
            sim.add_host(cap)
        for v in vms:
            sim.submit(copy.deepcopy(v))
        out.append(_fingerprint(sim, sim.run()))
    assert out[1] == out[0]
    assert out[0]["allocations"] > 0


def _quick_run(trace_mod, core_mod, policy):
    cfg = trace_mod.TraceConfig(**QUICK)
    sim, metrics = trace_mod.simulate_trace(
        trace_mod.generate_trace(cfg), policy=policy, cfg=cfg,
        sim_config=core_mod.SimConfig(record_timeline=False))
    return _fingerprint(sim, metrics)


def test_quick_trace_numpy_backend_equals_reference():
    ref = _quick_run(rt, rc, rc.make_policy("hlem-vmp-adjusted"))
    port = _quick_run(tt, tc, tc.make_policy("hlem-vmp-adjusted",
                                             backend="numpy"))
    assert port == ref
    assert _pinned(port) == QUICK_PINNED


def test_quick_trace_torch_cpu_equals_reference_default():
    ref = _quick_run(rt, rc, rc.make_policy("hlem-vmp-adjusted"))
    port = _quick_run(tt, tc, tc.make_policy("hlem-vmp-adjusted",
                                             backend="torch", device="cpu"))
    assert port == ref
    assert _pinned(port) == QUICK_PINNED


def test_quick_trace_torch_cpu_equals_reference_jax():
    ref = _quick_run(rt, rc, rc.make_policy("hlem-vmp-adjusted",
                                            backend="jax"))
    port = _quick_run(tt, tc, tc.make_policy("hlem-vmp-adjusted",
                                             backend="torch", device="cpu"))
    assert port == ref
    assert _pinned(port) == QUICK_PINNED
