"""The port's observability layer (``repro_torch.obs``: diff, analyze,
report, export, profile, manifest and sanitize) against the JAX package's
(``repro.obs``), on logs and traces recorded from one spec by both
packages, and the cross-package parity harness: the reference's own
``repro.obs.diff`` finds no divergence between the two packages' NDJSON
event logs of one spec.

The spec is a volatile ``hlem-vmp-adjusted`` market run with gradient-aware
migration, a diversified fleet and a storm (every event family fires),
cut to 4,200 s, plus one serving run.  The port's HLEM policy scores on its
torch backend on the CPU (the plain version of the HLEM kernel).
Everything computed from sim time is held equal (``==``); wall-clock
fields (span durations, the manifest's duration) are the only parts left
out.
"""
import json
import random
import time

import numpy as np
import pytest

import repro.api as ra
import repro.obs as ro
import repro_torch.api as ta
import repro_torch.obs as to

UNTIL = 4200.0   # past the first storm, which fires at 3,600 s


def _market_spec(a, port):
    params = {"alpha": -0.5}
    if port:
        params.update(backend="torch", device="cpu")
    return a.RunSpec(
        scenario=a.ScenarioSpec(workload="market", regime="volatile",
                                bid=a.BidSpec("randomized", {"lo": 0.45})),
        policy=a.PolicySpec("hlem-vmp-adjusted", params),
        migration=a.MigrationSpec("gradient-aware"),
        fleet=a.FleetSpec(params={"target_capacity": 64.0}),
        faults=a.FaultSpec("storm"),
        obs=a.ObsSpec(trace=True, profile=True, counters_every=600.0,
                      events=True))


def _serve_spec(a):
    return a.RunSpec(
        scenario=a.ScenarioSpec(workload="serve-diurnal", regime="volatile",
                                horizon=7200.0,
                                workload_params={"base_rate": 0.4,
                                                 "amplitude": 0.2}),
        policy=a.PolicySpec("first-fit"),
        fleet=a.FleetSpec(params={"target_capacity": 8.0}),
        serve=a.ServeSpec(),
        autoscale=a.AutoscaleSpec("target-tracking"),
        obs=a.ObsSpec(events=True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' market and serve runs, their event logs saved as
    NDJSON and ``.npz`` with one shared manifest."""
    d = tmp_path_factory.mktemp("obs")
    out = {}
    for name, api, port in (("port", ta, True), ("ref", ra, False)):
        sim = api.build(_market_spec(api, port), 0)
        sim.run(until=UNTIL)
        serve = api.build(_serve_spec(api), 1)
        serve.run(until=7200.0)
        man = {"seed": 0, "spec_hash": "shared"}
        paths = {}
        for ext in ("ndjson", "npz"):
            paths[ext] = str(d / f"{name}.{ext}")
            sim.events.save(paths[ext], manifest=man)
        paths["serve"] = str(d / f"{name}_serve.ndjson")
        serve.events.save(paths["serve"], manifest=man)
        out[name] = {"sim": sim, "serve": serve, "paths": paths, "man": man}
    return out


def test_exports_equal_reference():
    assert to.__all__ == ro.__all__


# ---------------------------------------------------------------------------
# diff, and the cross-package parity harness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ext", ["ndjson", "npz"])
def test_reference_diff_finds_no_divergence_across_packages(runs, ext):
    a, b = runs["ref"]["paths"][ext], runs["port"]["paths"][ext]
    assert ro.first_divergence(a, b) is None
    assert to.first_divergence(a, b) is None
    assert to.first_divergence(runs["port"]["sim"].events,
                               runs["ref"]["sim"].events.records()) is None
    assert ro.first_divergence(runs["ref"]["paths"]["serve"],
                               runs["port"]["paths"]["serve"]) is None
    assert to.read_manifest(a) == ro.read_manifest(b)


def test_event_log_covers_every_family(runs):
    kinds = {r[1] for r in runs["port"]["sim"].events.records()}
    assert {"interrupt", "wave", "migrate-start", "fault",
            "fleet-launch"} <= kinds
    assert to.validate_event_log(runs["port"]["paths"]["ndjson"]) == []


@pytest.mark.parametrize("cut", ["change", "truncate"])
def test_divergence_report_equals_reference(runs, cut):
    recs = list(to.iter_event_records(runs["port"]["paths"]["ndjson"]))
    i = len(recs) // 3
    other = list(recs)
    if cut == "change":
        t, kind, vm, pool, host, a, b, aux = other[i]
        other[i] = (t, kind, vm, pool, host, a + 1.0, b, aux)
    else:
        other = other[:i]
    got = to.first_divergence(recs, other, context=4)
    want = ro.first_divergence(recs, other, context=4)
    assert got is not None and got.index == want.index == i
    assert (got.record_a, got.record_b, got.context, got.time) == \
        (want.record_a, want.record_b, want.context, want.time)
    assert to.format_divergence(got, "A", "B") == \
        ro.format_divergence(want, "A", "B")
    assert to.format_divergence(None) == ro.format_divergence(None)


def test_bisect_divergence_equals_reference(runs):
    recs = list(runs["port"]["sim"].events.records())
    t_bad = recs[len(recs) // 2][0]

    def make_logs(t0, t1):
        a = [r for r in recs if t0 <= r[0] < t1]
        b = [r if r[0] < t_bad else (r[0] + 1.0,) + r[1:] for r in a]
        return a, b

    got = to.bisect_divergence(make_logs, UNTIL, min_window=300.0)
    want = ro.bisect_divergence(make_logs, UNTIL, min_window=300.0)
    assert got[1] == want[1]
    assert (got[0].index, got[0].record_a, got[0].record_b) == \
        (want[0].index, want[0].record_a, want[0].record_b)


# ---------------------------------------------------------------------------
# analyze and report
# ---------------------------------------------------------------------------
def _equal(got, want):
    if isinstance(want, tuple):
        return len(got) == len(want) and all(map(_equal, got, want))
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(_equal(got[k], want[k])
                                                 for k in want)
    if isinstance(want, list):
        return len(got) == len(want) and all(map(_equal, got, want))
    if isinstance(want, np.ndarray):
        return np.array_equal(got, want)
    return got == want


@pytest.mark.parametrize("query", [
    ("interruption_intensity", (), {}),
    ("interruption_intensity", (), {"window": 120.0}),
    ("storm_intervals", (), {}),
    ("storm_intervals", (), {"window": 300.0, "threshold": 0.01}),
    ("pool_risk_series", (0,), {}),
    ("pool_risk_series", (2,), {}),
    ("victim_rate", (), {}),
    ("victim_rate", (), {"pool": 1}),
    ("vm_lifecycle", (5,), {}),
    ("cohort_summary", (), {}),
    ("serve_series", (), {}),
], ids=lambda q: q[0])
@pytest.mark.parametrize("log", ["ndjson", "serve"])
def test_analyze_equals_reference(runs, query, log):
    name, args, kwargs = query
    got = getattr(to, name)(runs["port"]["paths"][log], *args, **kwargs)
    want = getattr(ro, name)(runs["ref"]["paths"][log], *args, **kwargs)
    assert _equal(got, want), name


@pytest.mark.parametrize("log", ["ndjson", "npz", "serve"])
def test_html_report_and_summary_equal_reference(runs, log, tmp_path):
    port, ref = runs["port"], runs["ref"]
    got = to.render_report(port["paths"][log], manifest=port["man"])
    assert got == ro.render_report(ref["paths"][log], manifest=ref["man"])
    assert got.startswith("<!doctype html>") and "<svg" in got
    assert to.report_summary_json(port["paths"][log]) == \
        ro.report_summary_json(ref["paths"][log])
    path = to.write_html_report(port["sim"].events, str(tmp_path / "r.html"),
                                manifest=port["man"])
    assert open(path).read() == ro.render_report(ref["sim"].events,
                                                 manifest=ref["man"])


def test_sweep_report_equals_reference(tmp_path):
    def exp(a):
        return a.ExperimentSpec(
            name="mini", scenario=a.ScenarioSpec(
                workload="market", regime="volatile", n_pools=3,
                tick_interval=30.0, from_advisor=False,
                bid=a.BidSpec("randomized", {"lo": 0.45})),
            policies=(a.PolicySpec("first-fit"),),
            migrations=(a.MigrationSpec("gradient-aware"),),
            fleets=(None, a.FleetSpec(params={"target_capacity": 16.0})),
            seeds=(0, 1))
    got = ta.run_experiment(exp(ta), processes=1, until=1800.0)
    want = ra.run_experiment(exp(ra), processes=1, until=1800.0)
    assert got == want
    html = to.render_sweep_report(got)
    assert html == ro.render_sweep_report(want)
    path = to.write_html_report(got, str(tmp_path / "sweep.html"))
    assert open(path).read() == html


# ---------------------------------------------------------------------------
# export, profile and manifest: the wall-clock parts are left out
# ---------------------------------------------------------------------------
#: span categories only the port records: the policy's decisions (inside
#: the dispatch and flush spans) and the builds
PORT_CATS = {"policy", "build"}
#: counters only the port keeps (scoring calls, rows, bytes; flush rows),
#: and the two the port dropped: its decision spans' counts give them
PORT_COUNTERS = ("hlem/", "flush/")
REF_COUNTERS = {"alloc/find_host", "alloc/batch_calls"}


def _on_reference_names(doc, port):
    """A Chrome trace's events under the names both packages record: the
    port's own categories and counters, or the reference's dropped
    counters, taken out; tids (first-seen order) replaced by their
    category's name."""
    names = {ev["tid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["name"] == "thread_name"}
    out = []
    for ev in doc["traceEvents"]:
        cat = names.get(ev["tid"])
        if ev["ph"] == "C":
            if (ev["name"].startswith(PORT_COUNTERS) if port
                    else ev["name"] in REF_COUNTERS):
                continue
        elif port and cat in PORT_CATS:
            continue
        out.append({**ev, "tid": cat})
    return out


def _sim_track(events):
    """The sim-time track of a Chrome trace without its wall-clock fields."""
    out = []
    for ev in events:
        if ev.get("pid") == to.export.PID_WALL and ev["ph"] != "M":
            continue
        ev = dict(ev)
        ev["args"] = {k: v for k, v in ev.get("args", {}).items()
                      if k not in ("wall_ms", "self_us")}
        out.append(ev)
    return out


def test_chrome_trace_valid_and_equal_to_reference(runs, tmp_path):
    port, ref = runs["port"]["sim"].obs, runs["ref"]["sim"].obs
    doc = to.write_chrome_trace(port, str(tmp_path / "t.json"),
                                manifest={"seed": 0})
    assert to.validate_chrome_trace(doc) == []
    assert ro.validate_chrome_trace(json.load(open(tmp_path / "t.json"))) == []
    assert doc["otherData"] == {"seed": 0}
    want = ro.chrome_trace(ref)
    got = _on_reference_names(doc, port=True)
    assert _sim_track(got) == _sim_track(_on_reference_names(want, False))
    assert len(got) == len(_on_reference_names(want, False))
    assert any(ev["ph"] == "C" for ev in doc["traceEvents"])
    # the port's own: each decision a policy span with the vm's id, its
    # children stamped with the same id and sim time
    spans = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"
             and ev["pid"] == to.export.PID_SIM and ev["cat"] == "policy"]
    names = {ev["name"] for ev in spans}
    assert {"policy/find_host", "policy/filter", "policy/stage",
            "policy/launch", "policy/select"} <= names
    assert all(isinstance(ev["args"]["vm"], int) for ev in spans)
    counters = {ev["name"] for ev in doc["traceEvents"] if ev["ph"] == "C"}
    assert {"hlem/calls", "hlem/staged_bytes",
            "flush/passes"} <= counters
    assert not counters & REF_COUNTERS
    bad = {"traceEvents": [{"ph": "X", "pid": 9, "ts": -1}]}
    assert to.validate_chrome_trace(bad) == ro.validate_chrome_trace(bad)


def test_profile_equals_reference_but_for_wall_times(runs, tmp_path):
    port, ref = runs["port"]["sim"].obs, runs["ref"]["sim"].obs
    key = lambda rows: sorted((r["cat"], r["name"], r["count"]) for r in rows
                              if r["cat"] not in PORT_CATS)
    rows = to.profile_table(port)
    assert key(rows) == key(ro.profile_table(ref))
    # the port's decisions: find_host spans as many as the reference's
    # find_host counter, and as many launches as scoring calls
    count = {r["name"]: r["count"] for r in rows if r["cat"] == "policy"}
    assert count["policy/find_host"] == ref.counters.values["alloc/find_host"]
    assert count["policy/find_first_direct"] == \
        ref.counters.values["alloc/batch_calls"]
    assert count["policy/launch"] == count["policy/select"] == \
        port.counters.values["hlem/calls"]
    assert [r["self_ms"] for r in rows] == sorted(
        (r["self_ms"] for r in rows), reverse=True)
    assert sum(r["self_pct"] for r in rows) == pytest.approx(100.0, abs=0.01)
    doc = to.write_profile(port, str(tmp_path / "p.json"),
                           manifest={"seed": 0})
    assert json.load(open(tmp_path / "p.json")) == doc
    assert doc["dominant"]["cat"] in {r["cat"] for r in rows}
    table = to.format_profile_table(port, top=5).splitlines()
    assert table[0] == ro.format_profile_table(ref, top=5).splitlines()[0]
    assert len(table) == 1 + 5 + 1


def test_manifest_records_torch_and_no_card_on_the_cpu():
    spec = _market_spec(ta, True).to_dict()
    got = to.run_manifest(spec_dict=spec, seed=3, duration_s=1.25,
                          extra={"x": 1})
    want = ro.run_manifest(spec_dict=spec, seed=3, duration_s=1.25,
                           extra={"x": 1})
    assert to.spec_hash(spec) == ro.spec_hash(spec) == got["spec_hash"]
    import torch
    assert got["versions"]["torch"] == torch.__version__
    assert got["versions"]["cuda"] == torch.version.cuda
    assert "jax" not in got["versions"]
    assert got["device"] is None        # CUDA is not initialised here
    same = set(want) - {"versions"}
    assert {k: got[k] for k in same} == {k: want[k] for k in same}


# ---------------------------------------------------------------------------
# sanitize
# ---------------------------------------------------------------------------
def test_sanitizer_vocabulary_equals_reference():
    from repro.obs import sanitize as rsan
    from repro_torch.obs import sanitize as tsan
    for attr in ("TIME_ATTRS", "RANDOM_ATTRS", "NP_RANDOM_ATTRS", "__all__"):
        assert getattr(tsan, attr) == getattr(rsan, attr)


def test_sanitized_blocks_clocks_and_global_rng():
    t_before = time.time
    with to.sanitized():
        for fn, what in ((time.time, "time.time"),
                         (time.perf_counter, "perf_counter"),
                         (random.random, "random.random"),
                         (lambda: np.random.rand(2), "np.random.rand")):
            with pytest.raises(to.SanitizerViolation, match=what):
                fn()
        assert np.random.default_rng(7).standard_normal(3).shape == (3,)
    assert time.time is t_before


def test_sanitized_port_run_equals_reference():
    """A whole port run through the torch scorer inside the sanitizer: no
    clock or global RNG on the sim path, and the reference's row."""
    def spec(a, params):
        return a.RunSpec(
            scenario=a.ScenarioSpec(workload="market", regime="volatile",
                                    bid=a.BidSpec("randomized", {"lo": 0.45})),
            policy=a.PolicySpec("hlem-vmp-adjusted", params))
    tspec = spec(ta, {"alpha": -0.5, "backend": "torch", "device": "cpu"})
    sim = ta.build(tspec, 0)
    with to.sanitized():
        metrics = sim.run(until=2400.0)
    got = ta.collect_row(sim, metrics, tspec, 0)
    assert got == ra.run_one(spec(ra, {"alpha": -0.5}), 0, until=2400.0)
