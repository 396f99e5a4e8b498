"""The import guard, the look for a card, and a run from a folder that
holds only the benchmark: each ends without a result line."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def test_guard_compares_whole_top_level_names():
    mods = {"photon_ml_tpu_torch": 1, "photon_ml_tpu_torch.ops": 1,
            "numpy": 1, "jaxtyping": 1, "flaxen": 1}
    assert harness.forbidden_modules(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "photon_ml_tpu", "photon_ml_tpu.ops.pallas_glm"):
        assert harness.forbidden_modules({**mods, bad: 1}) == [bad]


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, devtrace, calibrate\n"
            "from benchmark.reference import glm, glmix\n"
            "for k in ('glmix', 'glm_sweep'):\n"
            "    harness.load_module('drivers', k)\n"
            "import photon_ml_tpu_torch.game, photon_ml_tpu_torch.glm\n"
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "glm_epsilon.tron", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env={k: v for k, v in os.environ.items()
                      if k != "PYTHONPATH"})


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    if lines:
        try:
            json.loads(lines[-1])
        except ValueError:
            return True
        return False
    return True


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return  # the look for a card passes on a card
    out = _run(ROOT)
    assert out.returncode != 0 and _no_result(out)
    assert "CUDA card" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out)
