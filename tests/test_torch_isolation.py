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


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_chip_smoke_imports_no_other_module_of_the_repo():
    """Not even one it puts on ``sys.path`` itself, inside a function: the
    repo's tools and scripts may import the JAX package (``tools/
    perf_report.py`` does), which the card's run must not load."""
    repo = ({p.stem for d in (ROOT, ROOT / "tools", ROOT / "examples")
             for p in d.glob("*.py")}
            | {p.name for p in ROOT.iterdir() if (p / "__init__.py").exists()})
    repo -= {"photon_ml_tpu_torch", "chip_smoke"}
    assert sorted(_imported_roots(ROOT / "chip_smoke.py") & repo) == []


_IMPORT_SMOKE = r"""
import importlib.util, sys
for name in ("jax", "jaxlib", "photon_ml_tpu"):
    sys.modules[name] = None
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert smoke.main is not None
"""


def test_chip_smoke_loads_with_the_jax_package_blocked():
    out = subprocess.run([sys.executable, "-c", _IMPORT_SMOKE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_pyproject_lists_every_subpackage_of_the_port():
    # ``[tool.setuptools] packages`` is an explicit list: a subpackage left
    # out of it is missing from a non-editable install
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as f:
        listed = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    packages = {".".join(p.parent.relative_to(ROOT).parts)
                for p in PORT.rglob("__init__.py")}
    assert {"photon_ml_tpu_torch.resilience",
            "photon_ml_tpu_torch.analysis"} <= packages
    assert sorted(packages - listed) == []


def test_crc32_has_one_home_in_the_port():
    """Identity bucketing (shard placement, request-log sampling, probe
    selection, fault-plan seeding) hashes through
    ``photon_ml_tpu_torch/fleet/sharding.py`` alone; ``io/avro.py``'s
    container checksums are data integrity and stay where they are."""
    allowed = {PORT / "fleet" / "sharding.py", PORT / "io" / "avro.py"}
    users = sorted(str(p.relative_to(ROOT)) for p in PORT_FILES
                   if "zlib.crc32" in p.read_text() and p not in allowed)
    assert users == []
    assert "zlib.crc32" in (PORT / "fleet" / "sharding.py").read_text()
