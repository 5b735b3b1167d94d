"""The port's launcher (``python -m repro_torch.launch.market_sim``) against
the reference's (``repro.launch.market_sim``), mode by mode, on the CPU.

Each case runs both ``main`` functions on the same flags, the port's with
``--device cpu`` (its HLEM policies score through the plain PyTorch version
of the kernel), and holds the printed rows and the sweep reports' cells
equal.  Left out of the comparison are the fields that cannot agree: the
wall-clock ``wall_s``, the manifests (versions, device, timings) and the
spec's ``device`` parameter, which only the port has.  On a machine
without a card, the default ``--device cuda`` raises.
"""
import json

import pytest
import torch

from repro.launch.market_sim import main as rmain
from repro_torch.launch.market_sim import main as tmain

ROOT_SPEC = "examples/specs/migration_sweep.json"
CUT_HORIZON = 2400.0


def _json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def _rows(doc):
    return [{k: v for k, v in r.items() if k != "wall_s"}
            for r in doc["rows"]]


def _both(argv, capsys):
    got = _json(tmain, argv + ["--device", "cpu", "--json"], capsys)
    want = _json(rmain, argv + ["--json"], capsys)
    return got, want


@pytest.mark.parametrize("argv", [
    ["--market", "--until", "2400"],
    ["--market", "--regimes", "volatile", "--migration", "all",
     "--until", "1800"],
    ["--market", "--regimes", "volatile", "--policy", "first-fit",
     "--fleet", "diversified", "--faults", "storm", "--until", "4200"],
    ["--scenario", "synthetic", "--until", "1200"],
    ["--serve", "diurnal", "--autoscale", "target-tracking",
     "--fleet-target", "24", "--policy", "hlem-vmp-adjusted",
     "--until", "7200"],
    ["--serve", "bursty", "--regimes", "volatile,calm", "--until", "3600"],
], ids=["market", "migration-all", "fleet-storm", "synthetic", "serve",
        "serve-bursty"])
def test_rows_equal_reference(argv, capsys):
    got, want = _both(argv, capsys)
    assert _rows(got) == _rows(want)
    assert got["rows"] and all(r["allocations"] > 0 for r in got["rows"])
    assert got["manifest"]["spec"]["device"] == "cpu"
    assert got["manifest"]["versions"]["torch"] == torch.__version__


def test_trace_and_observed_run_equal_reference(capsys, tmp_path):
    argv = ["--scenario", "trace", "--machines", "30", "--days", "0.05",
            "--spot", "200"]
    got, want = _both(argv, capsys)
    drop = ("wall_s", "manifest")
    assert {k: v for k, v in got.items() if k not in drop} == \
        {k: v for k, v in want.items() if k not in drop}
    argv = ["--market", "--regimes", "volatile", "--policy",
            "hlem-vmp-adjusted", "--until", "1800", "--counters-every", "600",
            "--profile-out", str(tmp_path / "p.json"),
            "--trace-out", str(tmp_path / "t.json")]
    got, want = _both(argv, capsys)
    assert _rows(got) == _rows(want)
    assert got["counters"] == want["counters"]
    assert json.load(open(tmp_path / "p.json"))["rows"]


def test_sanitized_run_equals_reference(capsys):
    argv = ["--sanitize", "--market", "--regimes", "volatile", "--policy",
            "hlem-vmp-adjusted", "--until", "1800"]
    got, want = _both(argv, capsys)
    assert got == want and got["rows"][0]["sanitized"] is True


def _cut_spec(tmp_path):
    """``examples/specs/migration_sweep.json`` with seeds cut to [0, 1] and
    the horizon to 2,400 s: 2 regimes x 2 migrations x 2 seeds."""
    spec = json.load(open(ROOT_SPEC))
    spec["seeds"] = [0, 1]
    spec["scenario"]["horizon"] = CUT_HORIZON
    path = tmp_path / "cut.json"
    path.write_text(json.dumps(spec))
    return str(path)


def test_spec_sweep_report_equals_reference(capsys, tmp_path):
    """Each package writes its own report, from scratch (``--fresh``): the
    port's file is what it printed, and its cells are the reference's."""
    spec = _cut_spec(tmp_path)
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    argv = ["--spec", spec, "--workers", "2", "--fresh", "--json"]
    got = _json(tmain, argv + ["--device", "cpu", "--report", str(port)],
                capsys)
    want = _json(rmain, argv + ["--report", str(ref)], capsys)
    assert got["cells"] == want["cells"] and len(got["cells"]) == 4
    assert json.load(open(port)) == got
    assert json.load(open(ref))["cells"] == got["cells"]
    assert [p["params"]["device"] for p in got["experiment"]["policies"]] \
        == ["cpu"]
    assert got["manifest"]["device"] is None
    # the numpy oracle's report has the same cells
    doc = json.load(open(spec))
    doc["policies"][0]["params"]["backend"] = "numpy"
    (tmp_path / "numpy.json").write_text(json.dumps(doc))
    got_np = _json(tmain, ["--spec", str(tmp_path / "numpy.json"),
                           "--workers", "0", "--json"], capsys)
    assert got_np["cells"] == got["cells"]


def test_spec_file_device_wins_over_the_flag(capsys, tmp_path):
    """A ``--spec`` file that states ``"device": "cpu"`` runs on the CPU
    under the default ``--device cuda``; the flag only fills in a policy
    that states no device."""
    doc = json.load(open(_cut_spec(tmp_path)))
    doc["seeds"] = [0]
    doc["scenario"]["horizon"] = 1200.0
    doc["policies"][0]["params"]["device"] = "cpu"
    path = tmp_path / "cpu.json"
    path.write_text(json.dumps(doc))
    got = _json(tmain, ["--spec", str(path), "--workers", "0", "--json"],
                capsys)
    assert [p["params"]["device"] for p in got["experiment"]["policies"]] \
        == ["cpu"]
    assert got["cells"] and got["manifest"]["device"] is None


def test_market_sweep_report_equals_reference(capsys):
    argv = ["--market", "--regimes", "volatile", "--sweep", "2",
            "--until", "1200", "--workers", "0"]
    got, want = _both(argv, capsys)
    assert got["cells"] == want["cells"] and len(got["cells"]) == 2


def test_diff_of_recorded_logs(capsys, tmp_path):
    """``--events-out`` logs of one run from both packages: each package's
    ``--diff`` finds them identical (exit 0), and both report a changed log
    the same way (exit 1)."""
    argv = ["--market", "--regimes", "volatile", "--policy",
            "hlem-vmp-adjusted", "--until", "1800"]
    port, ref = str(tmp_path / "port.ndjson"), str(tmp_path / "ref.ndjson")
    assert tmain(argv + ["--device", "cpu", "--events-out", port]) == 0
    assert rmain(argv + ["--events-out", ref]) == 0
    capsys.readouterr()
    for main in (tmain, rmain):
        assert main(["--diff", ref, port]) == 0
        assert "zero divergence" in capsys.readouterr().out
    lines = open(port).read().splitlines()
    i = len(lines) // 2
    rec = json.loads(lines[i])
    rec["a"] += 1.0
    lines[i] = json.dumps(rec)
    bad = str(tmp_path / "bad.ndjson")
    open(bad, "w").write("\n".join(lines) + "\n")
    outs = []
    for main in (tmain, rmain):
        assert main(["--diff", ref, bad]) == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "first divergence" in outs[0]


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["--market", "--regimes", "volatile", "--policy",
               "hlem-vmp-adjusted", "--until", "600", "--json"])
