"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
JAX nor the reference package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.obs, repro_torch.market, repro_torch.market.trace\n"
        "import repro_torch.market.pools, repro_torch.market.advisor\n"
        "import repro_torch.market.correlation\n"
        "import repro_torch.market.price_process, repro_torch.market.engine\n"
        "import repro_torch.market.bids, repro_torch.market.pricing\n"
        "import repro_torch.market.risk, repro_torch.market.migration\n"
        "import repro_torch.market.faults, repro_torch.market.fleet\n"
        "import repro_torch.models.model, repro_torch.models.weights\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.configs\n"
        "repro_torch.configs.get_config('hymba_1_5b')\n"
        "import repro_torch.serve.demand, repro_torch.serve.autoscale\n"
        "import repro_torch.serve.slo, repro_torch.serve.service\n"
        "import repro_torch.api, repro_torch.api.registry\n"
        "import repro_torch.api.workloads, repro_torch.api.specs\n"
        "import repro_torch.api.build, repro_torch.api.sweep\n"
        "import repro_torch.obs.manifest, repro_torch.obs.diff\n"
        "import repro_torch.obs.analyze, repro_torch.obs.report\n"
        "import repro_torch.obs.export, repro_torch.obs.profile\n"
        "import repro_torch.obs.sanitize, repro_torch.launch.market_sim\n"
        "import repro_torch.train, repro_torch.train.optimizer\n"
        "import repro_torch.train.train_step, repro_torch.train.data\n"
        "import repro_torch.elastic, repro_torch.elastic.checkpoint\n"
        "import repro_torch.elastic.compression, repro_torch.elastic.straggler\n"
        "import repro_torch.elastic.placement, repro_torch.elastic.elastic\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.models.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.launch.specs, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.hlo_analyzer, repro_torch.launch.hlo_stats\n"
        "import repro_torch.launch.reanalyze\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module or "")
    bad = [m for m in found if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serve_package_leaves_the_model_stack_unloaded():
    """The serve market side, the spec layer and the launcher import
    without the model stack: ``serve.engine`` loads on first use only."""
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.api\n"
        "import repro_torch.launch.market_sim\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith(('repro_torch.models',\n"
        "                              'repro_torch.serve.engine'))))\n"
        "repro_torch.serve.make_serve_step\n"
        "print('repro_torch.models.model' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["[]", "True"]
