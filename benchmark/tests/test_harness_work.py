"""The frozen count functions and peaks equal the program's at this
commit: a later drift shows here instead of moving the yardstick."""

import itertools
import re
from pathlib import Path

import pytest

from benchmark.work import counts, peaks
from photon_ml_tpu_torch.ops import fused_glm, fused_hvp, fused_re

ROOT = Path(__file__).resolve().parents[2]
SHAPES = list(itertools.product((0, 1, 777, 400000), (8, 33, 2000),
                                (2, 4)))


@pytest.mark.parametrize("n,d,isz", SHAPES)
def test_counts_equal_the_programs(n, d, isz):
    for n_out, lanes in ((1, 1), (4, 4), (5, 1)):
        assert tuple(counts.fused_glm(n, n + 3, d, isz, n_out, lanes)) == \
            tuple(fused_glm.work(n, n + 3, d, isz, n_out, lanes=lanes))
    assert tuple(counts.fused_re(n, 7, 11, d, isz)) == \
        tuple(fused_re.work(n, 7, 11, d, isz))
    assert tuple(counts.fused_hvp(n, n + 5, d, isz)) == \
        tuple(fused_hvp.work(n, n + 5, d, isz))


def test_peaks_equal_the_smoke_scripts():
    text = (ROOT / "chip_smoke.py").read_text()
    hbm = float(re.search(r"^HBM_BYTES_PER_S = ([0-9.e]+)", text,
                          re.M).group(1))
    f32 = float(re.search(r"^F32_OPS_PER_S = ([0-9.e]+)", text,
                          re.M).group(1))
    assert (hbm, f32) == (peaks.HBM_BYTES_PER_S, peaks.F32_OPS_PER_S)


def test_least_seconds():
    assert peaks.least_seconds(0.0, 3.35e12) == (1.0, "bytes")
    assert peaks.least_seconds(67e12 * 2, 3.35e12) == (2.0, "operations")
