"""The port's spans and counters inside the placement decision, on the CPU.

Each decision (the policy's outermost host-selection entry) is a
``policy/<entry>`` span carrying the VM's id, holding ``policy/filter``,
``policy/feasibility``, ``policy/stage``, ``policy/launch`` and
``policy/select``; the scorer counts ``hlem/*``, the batched flush
``flush/*``, and the builds are ``build/*`` spans.  Without a tracer the
policy makes no tracer call, and the tracer's clock maps onto the real-time
clock of the CUDA profiler's trace.
"""
import time

import numpy as np
import pytest

import repro_torch.api as ta
from repro_torch.core.allocation import make_policy
from repro_torch.core.simulator import MarketSimulator, SimConfig
from repro_torch.market.trace import TraceConfig, generate_trace, wire_trace
from repro_torch.obs.tracer import Tracer

ENTRIES = ("find_host", "find_direct", "find_first_direct",
           "find_hosts_batch", "_pick_direct")
CHILDREN = ("policy/filter", "policy/feasibility", "policy/stage",
            "policy/launch", "policy/select")
N_HOSTS = 120


def _trace_sim(policy, tracer=None, seed=1):
    sim = MarketSimulator(policy=policy,
                          config=SimConfig(record_timeline=False), obs=tracer)
    if tracer is not None:
        policy.tracer = tracer
    cfg = TraceConfig(seed=seed, n_machines=N_HOSTS, sim_days=0.02,
                      n_spot=150)
    wire_trace(sim, generate_trace(cfg), cfg)
    return sim


def _market_sim(obs, policy="hlem-vmp-adjusted", params=None):
    if params is None:
        params = {"backend": "torch", "device": "cpu"}
    spec = ta.RunSpec(
        scenario=ta.ScenarioSpec(workload="market", regime="volatile"),
        policy=ta.PolicySpec(policy, params),
        migration=ta.MigrationSpec("gradient-aware"), obs=obs)
    return ta.build(spec, 0)


def _placements(sim):
    return sorted((v.id, v.host) for v in sim.vms.values()
                  if getattr(v, "host", None) is not None)


@pytest.fixture(scope="module")
def traced():
    """A traced trace replay on the HLEM policy's CPU scorer."""
    tr = Tracer(keep_records=True, profile=True)
    sim = _trace_sim(make_policy("hlem-vmp-adjusted", device="cpu"), tr)
    sim.run(until=0.02 * 86_400)
    return sim, tr


def test_children_nest_under_the_decision_with_its_vm(traced):
    _, tr = traced
    policy = [s for s in tr.spans if s[0] == "policy"]
    decisions = [s for s in policy if s[1][len("policy/"):] in ENTRIES]
    children = [s for s in policy if s[1] in CHILDREN]
    assert decisions and len(decisions) + len(children) == len(policy)
    assert {s[1] for s in children} >= {"policy/filter", "policy/stage",
                                        "policy/launch", "policy/select"}
    starts = np.array([s[2] for s in decisions])
    order = np.argsort(starts)
    for _cat, _name, t0, dur, sim_t, _self, args in children:
        k = order[np.searchsorted(starts[order], t0, side="right") - 1]
        parent = decisions[k]
        assert parent[2] <= t0 and t0 + dur <= parent[2] + parent[3]
        assert args == parent[6] and sim_t == parent[4]
    assert all(isinstance(s[6]["vm"], int) for s in decisions)
    # the decisions are dispatches' children, stamped with their sim time
    assert {s[4] for s in decisions} <= {s[4] for s in tr.spans
                                         if s[0] == "event-loop"}


def test_policy_self_time_sums_to_the_decisions(traced):
    """The ``policy`` category's self time is the decisions' wall time: a
    wrapper's span around each decision (the benchmark's) keeps its sum."""
    _, tr = traced
    prof = tr.profile()
    self_s = sum(v[2] for (cat, _), v in prof.items() if cat == "policy")
    total = sum(v[1] for (cat, name), v in prof.items()
                if cat == "policy" and name[len("policy/"):] in ENTRIES)
    assert self_s == pytest.approx(total, rel=1e-9)
    assert self_s > 0


def test_scoring_counters_match_the_spans(traced):
    _, tr = traced
    c = tr.counters.values
    count = {name: v[0] for (cat, name), v in tr.profile().items()
             if cat == "policy"}
    assert c["hlem/calls"] == count["policy/launch"] \
        == count["policy/select"] == count["policy/stage"]
    # the CPU path counts the bytes it hands over: free and spot (n, 4)
    # float64 and one bool row a call
    per_call = N_HOSTS * (2 * 4 * 8 + 1)
    assert c["hlem/staged_bytes"] == c["hlem/calls"] * per_call
    decisions = sum(count.get("policy/" + e, 0) for e in ENTRIES)
    assert 0 < c["hlem/calls"] <= decisions
    assert 0 <= c.get("hlem/rescored", 0) <= c["hlem/calls"]
    assert "alloc/find_host" not in c and "alloc/batch_calls" not in c


def test_rescored_counts_each_relaxed_filter():
    """No host passes an unreachable RsDiff threshold: every scoring call
    is the relaxed list's, counted once by ``hlem/rescored``."""
    tr = Tracer(keep_records=False, profile=True)
    sim = _trace_sim(make_policy("hlem-vmp", threshold=1e9, device="cpu"),
                     tr)
    sim.run(until=0.01 * 86_400)
    c = tr.counters.values
    assert c["hlem/calls"] > 0
    assert c["hlem/rescored"] == c["hlem/calls"]


def test_flush_counters_and_build_spans():
    sim = _market_sim(ta.ObsSpec(trace=True, profile=True))
    sim.run(until=3600.0)
    c = sim.obs.counters.values
    assert c["flush/passes"] > 0
    assert 0 < c["flush/rows_tested"] <= c["flush/rows_scanned"]
    # a pass hands one row to find_direct, or several to find_first_direct
    count = {name: v[0] for (_, name), v in sim.obs.profile().items()}
    assert c["flush/rows_tested"] == \
        c.get("alloc/batch_rows", 0) + count.get("policy/find_direct", 0)
    assert [s[1] for s in sim.obs.spans if s[0] == "build"] == \
        ["build/populate"]
    wired = Tracer(keep_records=True)
    _trace_sim(make_policy("first-fit"), wired)
    assert [s[1] for s in wired.spans if s[0] == "build"] == \
        ["build/wire_trace"]


class _Raising:
    """A tracer that is off and fails on any other use."""

    enabled = False

    def __getattr__(self, name):
        raise AssertionError(f"tracer.{name} used on the untraced path")


@pytest.mark.parametrize("policy,params", [
    ("hlem-vmp-adjusted", {"backend": "torch", "device": "cpu"}),
    ("hlem-vmp-adjusted", {"backend": "numpy"}),
    ("first-fit", {}),
])
def test_untraced_policy_makes_no_tracer_call(policy, params):
    pol = make_policy(policy, **params)
    pol.tracer = _Raising()
    sim = _trace_sim(pol)
    sim.run(until=0.01 * 86_400)
    market = _market_sim(None, policy, params)
    market.policy.tracer = _Raising()
    market.run(until=3600.0)
    assert market.metrics.allocations > 0
    # the batch entry as well
    vms = list(sim.vms.values())[:8]
    pol.find_hosts_batch(vms, sim.pool, sim.now)
    # and the same decisions as a traced replay's
    again = _trace_sim(make_policy(policy, **params),
                       Tracer(keep_records=False, profile=True))
    again.run(until=0.01 * 86_400)
    assert _placements(again) == _placements(sim)


def test_batch_entry_is_one_decision():
    tr = Tracer(keep_records=True, profile=True)
    sim = _trace_sim(make_policy("hlem-vmp-adjusted", device="cpu"), tr)
    sim.run(until=0.005 * 86_400)
    vms = list(sim.vms.values())[:6]
    calls = tr.counters.values["hlem/calls"]
    n = len(tr.spans)
    picks = sim.policy.find_hosts_batch(vms, sim.pool, sim.now)
    assert [s[1] for s in tr.spans[n:]] == [
        "policy/feasibility", "policy/filter", "policy/stage",
        "policy/launch", "policy/select", "policy/find_hosts_batch"]
    assert all(s[6] == {"vm": vms[0].id} for s in tr.spans[n:])
    # one scoring call for the whole batch
    assert tr.counters.values["hlem/calls"] == calls + 1
    assert (picks >= 0).any()


def test_to_unix_ns_agrees_with_the_real_time_clock():
    tr = Tracer()
    for _ in range(3):
        got = tr.to_unix_ns(tr.wall_elapsed())
        assert abs(got - time.time_ns()) < 1_000_000
        time.sleep(0.01)
    assert 0 <= tr.anchor_s < 1e-3
