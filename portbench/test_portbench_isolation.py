"""The benchmark imports neither JAX nor the JAX package, and reads nothing
of the pre-port ``benchmarks/`` folder.

Module names are compared by their top-level name as a whole word, so the
program under test, ``repro_torch``, is allowed and ``repro`` is not.  The
run is made in a fresh interpreter: the test process's own modules (other
tests import JAX) say nothing about what the harness loads.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_PROBE = r"""
import json, os, sys
root = sys.argv[1]
opened = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        opened.append(os.path.abspath(os.fsdecode(args[0])))

sys.addaudithook(hook)
sys.path[:0] = [root, os.path.join(root, "src")]
from portbench import harness
out = harness.run("gtrace-fill", 9, 1.0, True, device="cpu",
                  config_overrides={"n_machines": 200, "n_spot": 100},
                  traffic_overrides={"sim_days": 0.002})
bench = os.path.join(root, "benchmarks") + os.sep
print(json.dumps({
    "correct": out["correct"],
    "modules": sorted({m.split(".")[0] for m in sys.modules}),
    "benchmarks_read": sorted({p for p in opened if p.startswith(bench)}),
}))
"""


def _imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_nor_the_jax_package():
    for path in sorted((ROOT / "portbench").rglob("*.py")):
        bad = set(_imported_top_levels(path)) & FORBIDDEN
        assert not bad, f"{path} imports {sorted(bad)}"


def test_a_run_loads_no_jax_and_reads_no_old_benchmark():
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "repro_torch" in got["modules"]
    assert not set(got["modules"]) & FORBIDDEN
    assert got["benchmarks_read"] == []


def test_forbidden_names_compare_whole(monkeypatch):
    """``repro_torch`` is the program; ``repro`` is the JAX package."""
    from portbench import harness
    for name in [m for m in sys.modules
                 if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.loaded_forbidden() == ["repro"]
