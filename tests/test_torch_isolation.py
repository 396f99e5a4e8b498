"""The PyTorch port stands alone: no module of ``photon_ml_tpu_torch`` and
not ``chip_smoke.py`` imports ``jax`` or the JAX package ``photon_ml_tpu``.

The import check runs in a subprocess, because this test process has
already imported jax (tests/conftest.py)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "photon_ml_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "photon_ml_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import photon_ml_tpu_torch
names = [m.name for m in pkgutil.walk_packages(photon_ml_tpu_torch.__path__,
                                               "photon_ml_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "photon_ml_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module of the port


def _forbidden_imports(path: pathlib.Path) -> list[str]:
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "photon_ml_tpu"):
                bad.append(name)
    return bad


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    assert _forbidden_imports(path) == []
