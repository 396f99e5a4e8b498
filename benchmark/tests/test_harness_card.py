"""On the card: one short run of a cell through the command, and the
control at the cell's own size, which must come out not correct.

    python -m pytest benchmark/tests -m gpu
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card():
    _need_card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "glm_epsilon.lbfgs_batched", "--seed", "2147483999", "--seconds",
         "2", "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]


@pytest.mark.gpu
def test_control_fails_on_the_card(tmp_path):
    _need_card()
    log = tmp_path / "calib.jsonl"
    out = subprocess.run(
        [sys.executable, "benchmark/calibrate.py", "--workload",
         "glm_epsilon.lbfgs_batched", "--control-seeds", "2147483998",
         "--out", str(log)], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    (line,) = [json.loads(x) for x in log.read_text().splitlines()]
    assert line["side"] == "control" and not line["correct"]
