"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

An AST scan of every module under ``src/repro_torch/`` and of
``chip_smoke.py`` finds no import of ``jax`` or ``repro``; the public API
imports in a process where ``jax`` cannot be imported; and
``chip_smoke.py`` fails without printing a result where there is no card
or no repository beside it.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_api_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.api as api\n"
            "import repro_torch.core.batch, repro_torch.core.store\n"
            "import repro_torch.core.lifecycle, repro_torch.launch.serve\n"
            "import repro_torch.serve.engine, repro_torch.models.registry\n"
            "import repro_torch.distributed.sharding\n"
            "import repro_torch.distributed.ctx, repro_torch.kernels._meta\n"
            "import repro_torch.distributed.collectives\n"
            "import repro_torch.distributed.fault\n"
            "import repro_torch.optim.compression\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "from repro_torch.config import get_arch\n"
            "rec = repro_torch.launch.dryrun.run_cell('llama3_2_1b', "
            "'decode_32k', 'single')\n"
            "assert rec['status'] == 'OK', rec\n"
            "db = api.Uruv(api.UruvConfig(leaf_cap=8, max_leaves=64), "
            "device='cpu')\n"
            "db.insert([3, 1, 2], [30, 10, 20])\n"
            "assert db.live_items() == [(1, 10), (2, 20), (3, 30)]\n"
            "assert 'jax' not in {m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None}\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """Here (no CUDA) and alone in a directory, the script exits non-zero
    and prints no result line."""
    import torch

    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [(tmp_path, tmp_path / "chip_smoke.py")]
    if not torch.cuda.is_available():
        runs.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in runs:
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
