"""Tests of ``portbench/spans.py``: the program's decision spans and
counters read per decision, idle gaps named by the span over them, and the
causal check of the clock mapping.  The CPU runs are small (the policy's
plain PyTorch scorer, ``device="cpu"``); the card's case skips here.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import spans  # noqa: E402

SMALL = {"n_machines": 300, "n_spot": 200}
SHORT = {"sim_days": 0.004, "replays_prepared": 2}
READINGS = ("filter_us_per_decide", "stage_us_per_decide",
            "launch_us_per_call", "select_us_per_call", "scores_per_decide",
            "staged_kb_per_call")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device trace is the card's")
    return torch.device("cuda")


@pytest.mark.parametrize("cell,config,traffic", [
    ("gtrace-fill", SMALL, SHORT),
    ("market-volatile-migrate", None, {"horizon_s": 3600.0}),
])
def test_traced_window_reads_the_decision_split(cell, config, traffic):
    out = spans.measure(cell, 5, 2.0, "cpu", config, traffic)
    assert out["correct"]
    got = out["readings"]
    assert set(READINGS) <= set(got)
    # the program's build span lies inside the harness's timing of a build
    assert 0 < got["build_ms_per_replay"] <= out["harness_replay_build_ms"]
    # the program's decisions are the harness's, one span each
    assert got["decisions"] == out["harness_decisions"] > 0
    # a decision's self times add up to its span, inside the harness's
    # wrapper around it
    assert 0.8 < out["split_over_harness_mean"] <= 1.0
    assert 0 < got["scores_per_decide"] <= 1.0
    n = (config or {}).get("n_machines")
    if n is not None:
        # free and spot (n, 4) float64 and one bool row, handed over a call
        assert got["staged_kb_per_call"] == pytest.approx(n * 65 / 1024)
    if out["counters"].get("flush/passes"):
        # (a short window on a loaded CPU may end before the first queue)
        assert got["flush_rows_per_pass"] >= got[
            "flush_rows_tested_per_pass"]
    assert "causal" not in out       # no device trace on the CPU


def test_readings_from_profile_and_counters():
    prof = {("policy", "policy/find_host"): [4, 40e-6, 8e-6],
            ("policy", "policy/find_first_direct"): [1, 10e-6, 1e-6],
            ("policy", "policy/filter"): [5, 5e-6, 5e-6],
            ("policy", "policy/feasibility"): [1, 2e-6, 2e-6],
            ("policy", "policy/stage"): [4, 12e-6, 12e-6],
            ("policy", "policy/launch"): [4, 8e-6, 8e-6],
            ("policy", "policy/select"): [4, 14e-6, 14e-6],
            ("policy", "find_host"): [4, 41e-6, 1e-6],
            ("build", "build/populate"): [2, 6e-3, 5e-3],
            ("build", "build/wire_trace"): [2, 1e-3, 1e-3]}
    counters = {"hlem/calls": 4, "hlem/staged_bytes": 4 * 2048,
                "hlem/rescored": 1, "flush/passes": 2,
                "flush/rows_scanned": 10, "flush/rows_tested": 6}
    got = spans.readings(prof, counters, replays=2)
    assert got["decisions"] == 5
    assert got["build_ms_per_replay"] == pytest.approx(3.0)
    assert "build_ms_per_replay" not in spans.readings(prof, counters)
    assert got["filter_us_per_decide"] == pytest.approx(7 / 5)
    assert got["stage_us_per_decide"] == pytest.approx(12 / 5)
    assert got["launch_us_per_call"] == pytest.approx(2.0)
    assert got["select_us_per_call"] == pytest.approx(3.5)
    assert got["scores_per_decide"] == pytest.approx(0.8)
    assert got["staged_kb_per_call"] == pytest.approx(2.0)
    assert got["flush_rows_per_pass"] == 5.0
    assert got["split_us_per_decide"] == pytest.approx(50 / 5)
    # the harness's own span (name without the prefix) is not a decision
    assert spans.readings({}, {}) == {"decisions": 0}


def test_innermost_segments_of_nested_spans():
    segs = spans.innermost([("outer", 0, 100), ("a", 10, 20),
                            ("b", 30, 60), ("c", 40, 50)])
    assert segs == [(0, 10, "outer"), (10, 20, "a"), (20, 30, "outer"),
                    (30, 40, "b"), (40, 50, "c"), (50, 60, "b"),
                    (60, 100, "outer")]


def test_idle_gaps_named_by_the_span_over_them():
    events = [("Memcpy DtoH (Device -> Pinned)", 0, 10),
              ("Memcpy HtoD (Pinned -> Device)", 100, 110),
              ("void (anonymous namespace)::hlem_score_kernel<4>(x)", 150,
               160),
              ("Memcpy DtoH (Device -> Pinned)", 165, 170),
              ("Memcpy HtoD (Pinned -> Device)", 300, 305),
              ("Memcpy HtoD (Pinned -> Device)", 400, 405)]
    tree = [("event-loop/dispatch/vm-submit", 5, 290),
            ("policy/find_host", 20, 175), ("policy/filter", 20, 95),
            ("policy/stage", 95, 112), ("policy/launch", 112, 140),
            ("policy/select", 140, 175)]
    gaps, moved = spans.label_idle_gaps(events, tree, builds=[(320, 390)])
    s = 1e-9
    assert gaps == pytest.approx({
        # 10-100: filter covers 75 of the 90 ns
        "host: policy/filter": 90 * s,
        # 110-150: launch 28, select 10, stage 2
        "host: policy/launch": 40 * s,
        # 160-165: select
        "host: policy/select": 5 * s,
        # 170-300: the dispatch outlives the decision; then nothing
        "host: event-loop/dispatch/vm-submit": 130 * s,
        # 305-400: a build
        "host: replay build (between replays)": 95 * s})
    assert moved["host: after Memcpy DtoH before Memcpy HtoD"] == \
        pytest.approx({"host: policy/filter": 90 * s,
                       "host: event-loop/dispatch/vm-submit": 130 * s})
    # no span and no build: the device operations around the gap
    gaps, _ = spans.label_idle_gaps(events[:3], [])
    assert set(gaps) == {"host: after Memcpy DtoH before Memcpy HtoD",
                         "host: after Memcpy HtoD before hlem_score_kernel"}


def test_causal_check_bounds_the_mapping():
    events = [("Memcpy HtoD", 0, 10), ("hlem_score_kernel", 20, 30),
              ("Memcpy DtoH", 32, 35), ("Memcpy HtoD", 100, 110),
              ("hlem_score_kernel", 125, 130), ("Memcpy DtoH", 131, 133)]
    tree = [("policy/launch", 12, 15), ("policy/select", 15, 40),
            ("policy/launch", 111, 113), ("policy/select", 113, 134)]
    got = spans.causal_check(events, tree)
    assert got["paired"] and got["failures"] == 0
    assert got["kernel_after_launch_min_us"] == pytest.approx(8e-3)
    assert got["d2h_before_select_end_min_us"] == pytest.approx(1e-3)
    # the program's clock 2 ns early: a D2H ends after its select span
    early = [(n, a - 2, b - 2) for n, a, b in tree]
    assert spans.causal_check(events, early)["failures"] == 1
    assert spans.causal_check(events, tree[:3])["paired"] is False


def test_clock_fit_recovers_an_offset():
    """Runtime calls drawn inside their launch spans on a clock 40 us
    ahead: the closed-form fit finds the offset with a margin, and holds
    out of sample; a call drawn outside its span fails the held-out check."""
    import numpy as np
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 30e9, 2000)).astype(np.int64)
    launch = [(int(x), int(x) + 120_000) for x in t]
    calls = []
    for lo, hi in launch:
        at = lo + 40_000 + int(rng.uniform(20_000, 90_000))
        calls.append((at, at + 8_000))
    fit = spans.fit_offset(launch, calls)
    assert fit["margin_ns"] > 0
    assert fit["a_ns"] == pytest.approx(40_000, abs=2_000)
    moved = spans.shift([("policy/launch", lo, hi) for lo, hi in launch],
                        fit["a_ns"])
    assert all(s0 <= r0 and r1 <= s1
               for (_, s0, s1), (r0, r1) in zip(moved, calls))
    held = spans.holdout_check(launch, calls)
    assert held["checked"] == 1000 and held["failures"] == 0
    assert held["min_slack_us"] > 0
    late = list(calls)
    late[1] = (launch[1][1] + 200_000, launch[1][1] + 208_000)
    assert spans.holdout_check(launch, late)["failures"] == 1
    assert spans.fit_offset(launch, late)["margin_ns"] < 0
    assert spans.fit_offset(launch, calls[:-1]) is None


def test_device_records_moved_onto_their_runtime_calls():
    """Device times 500 ns behind their host records in the first scoring
    call; in the second, the kernel is seen before its own launch call
    and the copy after the synchronize: a jump no shift undoes."""
    api = [("cudaMemcpyAsync", 0, 10, 1), ("cudaLaunchKernelExC", 50, 60, 2),
           ("cudaMemcpyAsync", 70, 75, 3),
           ("cudaStreamSynchronize", 76, 120, 4),
           ("cudaMemcpyAsync", 200, 210, 5),
           ("cudaLaunchKernelExC", 250, 260, 6),
           ("cudaMemcpyAsync", 270, 275, 7),
           ("cudaStreamSynchronize", 276, 320, 8)]
    true = [("Memcpy HtoD", 15, 40, 1), ("hlem_score_kernel", 65, 100, 2),
            ("Memcpy DtoH", 105, 110, 3)]
    dev = [(n, a - 500, b - 500, c) for n, a, b, c in true]
    dev += [("Memcpy HtoD", 215, 240, 5), ("hlem_score_kernel", 100, 130, 6),
            ("Memcpy DtoH", 400, 405, 7)]
    moved, faulty, stats = spans.device_on_host(dev, api)
    first = [r for r in moved if r not in faulty]
    assert [r[0] for r in first] == [r[0] for r in true]
    for (_, a, b), (_, ta, tb, _) in zip(first, true):
        assert abs(a - ta) <= 13 and abs(b - tb) <= 13
    assert stats["faulty_groups"] == 1 and len(faulty) == 3
    assert stats["groups"] == 2


def test_card_mapping_holds_and_names_the_idle_time(card):
    """A short traced ``gtrace-fill`` run on the card: the clock offset
    fitted on half the launches holds on the other half, and every pick's
    D2H ends before its select span ends; nearly all the idle time between a pick and the
    next staging is named by a program span."""
    out = spans.measure("gtrace-fill", 7, 8.0, "cuda")
    causal = out["causal"]
    assert out["correct"]
    assert out["anchor"] == "runtime" and out["clock_fit"]["margin_ns"] > 0
    # the offset fitted on every other launch holds on the rest (a kernel
    # inside its launch span holds by construction in sample)
    assert out["holdout"]["failures"] == 0
    assert causal["paired"] and causal["failures"] == 0
    assert causal["left_out"] <= 0.001 * causal["kernels"]
    assert causal["d2h_before_select_end_min_us"] >= 0
    old = out["relabelled"]["host: after Memcpy DtoH before Memcpy HtoD"]
    assert old["named_s"] >= 0.9 * old["total_s"]
    assert out["split_over_harness_mean"] == pytest.approx(1.0, abs=0.05)
    # free, spot (n, 4) float64, one alpha, one mask row: 817,911 B at
    # n = 12,583
    assert out["readings"]["staged_kb_per_call"] == pytest.approx(
        817_911 / 1024, rel=0.01)
