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
