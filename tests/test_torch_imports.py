"""Import guard: the port (and its chip smoke script) imports neither JAX
nor the JAX package, and imports on a machine without a CUDA device."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    ROOT)))
def test_module_imports_no_jax_and_no_jax_package(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_a_card():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, "
            "repro_torch.serving.engine, repro_torch.convert, "
            "repro_torch.models.rglru, repro_torch.kernels.rglru_scan, "
            "repro_torch.configs.recurrentgemma_9b, "
            "repro_torch.kernels.autodiff, repro_torch.training.trainer, "
            "repro_torch.optim.optimizer, repro_torch.data.pipeline, "
            "repro_torch.checkpoint.manager, "
            "repro_torch.distributed.fault, repro_torch.launch.train; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    env = {"PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "",
           "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
