"""CPU tests of the benchmark harness (``portbench/``).

They run the harness at small sizes with the policy's plain PyTorch
scorer on the CPU (``device="cpu"``): the frozen generator against the
program's, the metric arithmetic, discovery of cells and metrics by name,
the result line, and the correctness check against a sound run, planted
faults and the float32 control.  What needs the card skips here.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import harness, roofline  # noqa: E402
from portbench.control import control_run  # noqa: E402
from portbench.gen import trace as frozen  # noqa: E402

SMALL = {"n_machines": 300, "n_spot": 200}
SHORT = {"sim_days": 0.004, "replays_prepared": 2}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def small_run(seconds=3.0, trace=False, break_sim=None, seed=5):
    out = harness.run("gtrace-fill", seed, seconds, trace, device="cpu",
                      config_overrides=SMALL, traffic_overrides=SHORT,
                      break_sim=break_sim)
    out.pop("_judged")
    return out, out.pop("_record")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card")
    return torch.device("cuda")


# -- the frozen generator ----------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 2**31 + 7])
def test_frozen_trace_equals_program(seed):
    from repro_torch.market.trace import TraceConfig, generate_trace
    cfg = TraceConfig(seed=seed, n_machines=60, sim_days=0.05,
                      load_per_machine=4.0, machine_churn_per_day=2.0,
                      n_spot=30)
    want = generate_trace(cfg)
    machines, tasks = frozen.generate(seed, 60, 0.05, 4.0, 2.0, 30,
                                      (20.0, 40.0))
    assert any(ev[2] == "remove" for ev in machines)   # churn exercised
    assert [tuple(map(str, e)) for e in machines] == \
        [tuple(map(str, e)) for e in want.machine_events]
    assert tasks == [tuple(e) for e in want.task_events]


# -- metric arithmetic -------------------------------------------------------
def test_decision_percentiles_cover_every_decision():
    rec = harness.Record(decide_ns=list(range(1, 1001)))   # 1..1000 ns
    p95 = harness.load_reader("decide_p95_us")(rec)
    p50 = harness.load_reader("decide_p50_us")(rec)
    assert p95 == pytest.approx(np.percentile(np.arange(1, 1001), 95) / 1e3)
    assert p50 == pytest.approx(0.5005)
    assert harness.load_reader("decide_p95_us")(harness.Record()) is None


def test_sim_seconds_over_wall_seconds():
    rec = harness.Record(sim_s=216.0 * 2 + 54.0, window_s=20.25)
    assert harness.load_reader("sim_s_per_s")(rec) == pytest.approx(24.0)


def test_roofline_bytes_and_bound():
    n, d = 12_583, 4
    assert roofline.hlem_bytes(n, d, 1) == 2 * n * d * 8 + n + 8 + 8 * n
    least, by = roofline.hlem_least_s(n, d, 1)
    assert by == "bytes"
    assert least == pytest.approx(918_567 / 3.35e12)
    # the operations bound a call only past 29*d + 2 operations per byte
    assert roofline.hlem_least_s(1, d, 1, candidates=10**6)[1] == "operations"


def test_device_readers():
    ev = [("hlem_score_kernel<4, true>", 0.0, 30.0),
          ("Memcpy HtoD (Pinned -> Device)", 40.0, 66.0),
          ("hlem_score_kernel<4, true>", 60.0, 90.0)]   # overlaps the copy
    rec = harness.Record(device_events=ev, profiled_s=1e-3,
                         decide_ns=[1, 2], kernel_calls=[(12_583, 4, 1)] * 2)
    assert harness.busy_s(ev) == pytest.approx(80e-6)
    assert harness.load_reader("device_idle_pct")(rec) == pytest.approx(92.0)
    assert harness.load_reader("h2d_us_per_decide")(rec) == pytest.approx(13.0)
    roof = harness.load_reader("hlem_roofline")(rec)
    assert roof == pytest.approx(100 * 2 * 918_567 / 3.35e12 / 60e-6)
    rec.kernel_calls = rec.kernel_calls[:1]      # calls and kernels unpaired
    assert harness.load_reader("hlem_roofline")(rec) is None


# -- discovery by name -------------------------------------------------------
def test_every_cell_and_metric_has_its_files():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        for name in ("horizon", "prepare", "build", "observe",
                     "program_counts", "judge", "control"):
            assert callable(getattr(cell.driver, name))
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    """A later change adds a traffic mix, a cell, its limits and a metric as
    new files and entries alone: the harness finds them."""
    root = tmp_path / "repo"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = bench["workloads"][0]
    traffic = json.loads((ROOT / "portbench" / "workloads"
                          / f"{base['traffic']}.json").read_text())
    (root / "portbench/workloads/fill-60s.json").write_text(
        json.dumps({**traffic, "name": "fill-60s", "sim_days": 60 / 86400}))
    shutil.copy(ROOT / "portbench/limits" / f"{base['name']}.json",
                root / "portbench/limits/gtrace-fill-60s.json")
    (root / "portbench/metrics/replays_per_window.py").write_text(
        "def read(rec):\n    return float(len(rec.replays))\n")
    bench["workloads"].append({**base, "name": "gtrace-fill-60s",
                               "traffic": "fill-60s"})
    bench["per_layer"].append(
        {"name": "replays_per_window", "unit": "replays", "better": "higher",
         "source": "host_clock", "layer": "sim entry",
         "moves": "sim_s_per_s", "workloads": ["gtrace-fill-60s"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("gtrace-fill-60s", root)
    assert cell.driver.horizon(cell) == pytest.approx(60.0)
    assert "replays_per_window" in [m["name"] for m in cell.per_layer]
    assert "replays_per_window" not in [
        m["name"] for m in harness.load_cell("gtrace-fill", root).per_layer]
    rec = harness.Record(replays=[{}, {}])
    assert harness.load_reader("replays_per_window", root)(rec) == 2.0


# -- a run, its result line and its check -----------------------------------
def test_result_line_schema():
    out, rec = small_run()
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == len(rec.decide_ns) > 0
    assert set(line["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert sum(r["completed"] for r in rec.replays) >= 1
    assert rec.replays[-1]["reached"] > 0


def test_traced_run_reports_per_layer_metrics():
    out, rec = small_run(trace=True)
    names = set(out["metrics"])
    # the device's metrics need the card's trace; the rest read on the CPU
    assert {"replay_build_ms", "event_loop_self_pct", "flush_self_pct",
            "policy_self_pct", "decide_p50_us"} <= names
    assert out["correct"] is True
    assert 0 < out["metrics"]["event_loop_self_pct"]["value"] < 100
    # the decisions are the policy's own spans, not the event loop's
    policy = out["metrics"]["policy_self_pct"]["value"]
    assert policy > 0
    assert policy == pytest.approx(
        100 * sum(rec.decide_ns) * 1e-9 / rec.window_s, rel=0.05)
    assert sum(out["metrics"][m]["value"] for m in (
        "event_loop_self_pct", "flush_self_pct", "policy_self_pct")) < 100


def test_fixed_replay_set_is_ordered_by_seed():
    """Where the traffic fixes its replays, every seed runs the same set,
    in an order of its own; otherwise the replays are a seed sweep."""
    fixed = {"replay_seeds": [0, 1, 2, 3, 4]}
    orders = {tuple(harness.run_replay_seeds(fixed, s))
              for s in (1, 2, 3, 2**31 + 5)}
    assert all(sorted(o) == [0, 1, 2, 3, 4] for o in orders)
    assert len(orders) > 1
    assert harness.run_replay_seeds(fixed, 7) == \
        harness.run_replay_seeds(fixed, 7)
    assert harness.run_replay_seeds({"replays_prepared": 3}, 5) == \
        [15, 16, 17]


def _alter_answer(sim):
    """Each decision's host replaced by the first host that fits."""
    policy = sim.policy
    find = policy.find_host

    def first_fit(vm, pool, now, allow_spot_clearing):
        hid, clear = find(vm, pool, now, allow_spot_clearing)
        if hid >= 0 and not clear:
            return int(np.flatnonzero(pool.direct_mask_into(
                vm.demand, vm.bid, vm.pool))[0]), False
        return hid, clear
    policy.find_host = first_fit


def _state_unchanged(sim):
    """Placements leave the host pool's free capacity as it was."""
    pool = sim.pool
    place = pool.place

    def place_no_state(vm, hid, now=0.0):
        place(vm, hid, now=now)
        pool.used[hid] -= vm.demand
        pool._refresh_row(hid)
    pool.place = place_no_state


def _half_left_out(sim):
    """Every other arrival is never placed."""
    on_submit = sim._on_submit

    def submit(vm):
        if vm.id % 2 == 0:
            on_submit(vm)
    sim._on_submit = submit


@pytest.mark.parametrize("fault", [_alter_answer, _state_unchanged,
                                   _half_left_out])
def test_check_fails_on_a_broken_timed_path(fault):
    out, _ = small_run(break_sim=fault)
    assert out["correct"] is False
    assert out["failed"] > 0


def test_control_reads_not_correct():
    """The reference in the program's place at float32 fails the check;
    at float64 it passes (n = 2,000 hosts, two 173 s replays of seed 1)."""
    over = {"n_machines": 2000, "n_spot": 1000}
    traffic = {"sim_days": 0.002, "replays_prepared": 2}
    low = control_run("gtrace-fill", 1, 2, "float32", over, traffic)
    assert low["correct"] is False
    assert low["checks"]["gap_max"]["value"] > \
        low["checks"]["gap_max"]["limit"]
    same = control_run("gtrace-fill", 1, 2, "float64", over, traffic)
    assert same["correct"] is True


def test_run_on_the_card(card):
    """One short run of the cell as committed, on the card."""
    out = harness.run("gtrace-fill", 11, 2.0, False, device="cuda")
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
