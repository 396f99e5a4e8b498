"""Kernels 3 and 4's plain PyTorch versions against the Pallas kernels run in
interpret mode, and their wrappers' CPU dispatch and argument checks.

- kernel 3: photon_ml_tpu_torch.ops.fused_hvp vs
  photon_ml_tpu.ops.pallas_glm.fused_hvp(..., interpret=True);
- kernel 4: photon_ml_tpu_torch.ops.fused_glm.fused_value_and_grad_multi's
  plain version vs
  photon_ml_tpu.ops.pallas_glm.fused_value_and_grad_multi(...,
  interpret=True).

All four losses, f32 and bf16 designs, ragged sizes and weight-0 rows with
x = 60. The CUDA kernels themselves run only on the card (chip_smoke.py
holds them against these plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu_torch.ops import cuda_build, fused_glm, fused_hvp
from photon_ml_tpu_torch.ops import losses as tl

LOSSES = {"logistic": (jl.LogisticLoss, tl.LogisticLoss),
          "squared": (jl.SquaredLoss, tl.SquaredLoss),
          "poisson": (jl.PoissonLoss, tl.PoissonLoss),
          "smoothed_hinge": (jl.SmoothedHingeLoss, tl.SmoothedHingeLoss)}
#: the plain versions round exactly where the Pallas kernels do (bf16 v and
#: d2w·t in kernel 3; bf16 ws rows and wt·d1 in kernel 4), so in f32 and in
#: bf16 (against the interpreted kernel, not against a closed form) only the
#: f32 summation order differs: 1e-5 of the largest output, as for kernels
#: 1 and 2
RTOL = 1e-5
SHAPES = [(48, 33, None), (37, 9, 16)]
SHAPE_IDS = ["even", "ragged"]


def _labels(name, rng, shape):
    if name == "poisson":
        return rng.poisson(1.5, size=shape).astype(np.float32)
    if name == "squared":
        return rng.normal(size=shape).astype(np.float32)
    return (rng.uniform(size=shape) < 0.5).astype(np.float32)


def _cast(x32, dtype):
    if dtype == "bfloat16":
        return jnp.asarray(x32, jnp.bfloat16), \
            torch.as_tensor(x32).to(torch.bfloat16)
    return jnp.asarray(x32), torch.as_tensor(x32)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _design(n, d, rng):
    x = rng.normal(size=(n, d)).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    wt[::4] = 0.0  # weight-0 (padding) rows
    x[4] = 60.0  # a padded row whose raw margin would overflow exp()
    return x, wt


@pytest.mark.parametrize("n,d,block_rows", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_hvp_plain_matches_pallas(name, dtype, n, d, block_rows):
    """d2w is each loss's curvature at a random w, zero on padded rows —
    what GLMObjective.hvp_operator hands the kernel."""
    rng = np.random.default_rng(n * d)
    x, wt = _design(n, d, rng)
    w = (0.3 * rng.normal(size=d)).astype(np.float32)
    m = np.where(wt > 0, x @ w, 0.0)
    d2 = np.asarray(LOSSES[name][1].d2(torch.as_tensor(m),
                                       torch.as_tensor(_labels(name, rng, n))))
    d2w = np.where(wt > 0, wt * d2, 0.0).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    jx, tx = _cast(x, dtype)
    want = pallas_glm.fused_hvp(jx, jnp.asarray(v), jnp.asarray(d2w),
                                block_rows=block_rows, interpret=True)
    got = fused_hvp.fused_hvp_plain(tx, torch.as_tensor(v),
                                    torch.as_tensor(d2w))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _close(got.numpy(), np.asarray(want), RTOL)


def test_hvp_row_without_curvature_contributes_exactly_zero():
    """A row whose d2w is 0 adds nothing, even where its x·v overflows: the
    result equals that of the same design with the row zeroed, bit for
    bit."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(10, 4)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=4).astype(np.float32))
    d2w = torch.rand(10)
    d2w[3] = 0.0
    x[3] = 0.0
    want = fused_hvp.fused_hvp_plain(x, v, d2w)
    x[3] = 3e38
    got = fused_hvp.fused_hvp_plain(x, v, d2w)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,d,block_rows,lanes",
                         [(48, 33, None, 3), (37, 9, 16, 1)],
                         ids=["even-3-lanes", "ragged-1-lane"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_multi_plain_matches_pallas(name, dtype, n, d, block_rows, lanes):
    jloss, tloss = LOSSES[name]
    rng = np.random.default_rng(n + d + lanes)
    x, wt = _design(n, d, rng)
    ws = (0.3 * rng.normal(size=(lanes, d))).astype(np.float32)
    y = _labels(name, rng, n)
    off = (0.2 * rng.normal(size=n)).astype(np.float32)
    jx, tx = _cast(x, dtype)
    jv, jg = pallas_glm.fused_value_and_grad_multi(
        jloss, jx, jnp.asarray(ws), jnp.asarray(y), jnp.asarray(off),
        jnp.asarray(wt), block_rows=block_rows, interpret=True)
    tv, tg = fused_glm.fused_value_and_grad_plain(
        tloss, tx, torch.as_tensor(ws), torch.as_tensor(y),
        torch.as_tensor(off), torch.as_tensor(wt))
    assert tv.shape == (lanes,) and tg.shape == (lanes, d)
    assert tv.dtype == torch.float32 and torch.isfinite(tg).all()
    for m in range(lanes):  # each lane against its own scale
        _close(float(tv[m]), float(jv[m]), RTOL)
        _close(tg[m].numpy(), np.asarray(jg[m]), RTOL)


def test_multi_lane_is_the_one_lane_function():
    """Lane m of the M-lane plain version is kernel 1's plain version at
    ws[m] (bf16 rounding included)."""
    rng = np.random.default_rng(7)
    x, wt = _design(30, 6, rng)
    tx = torch.as_tensor(x).to(torch.bfloat16)
    ws = torch.as_tensor(rng.normal(size=(4, 6)).astype(np.float32))
    y = torch.as_tensor(_labels("poisson", rng, 30))
    off, twt = torch.zeros(30), torch.as_tensor(wt)
    values, grads = fused_glm.fused_value_and_grad_plain(
        tl.PoissonLoss, tx, ws, y, off, twt)
    for m in range(4):
        v, g = fused_glm.fused_value_and_grad_plain(
            tl.PoissonLoss, tx, ws[m], y, off, twt)
        torch.testing.assert_close(values[m], v, rtol=1e-6, atol=0)
        torch.testing.assert_close(grads[m], g, rtol=1e-6, atol=1e-6)


def test_wrappers_run_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(1)
    x, wt = (torch.as_tensor(a) for a in _design(20, 5, rng))
    v, d2w = torch.randn(5), torch.rand(20)
    before = fused_hvp.fused_hvp.launches
    assert torch.equal(fused_hvp.fused_hvp(x, v, d2w),
                       fused_hvp.fused_hvp_plain(x, v, d2w))
    assert fused_hvp.fused_hvp.launches == before
    ws, y, off = torch.randn(3, 5), torch.rand(20).round(), torch.zeros(20)
    before = fused_glm.fused_value_and_grad_multi.launches
    got = fused_glm.fused_value_and_grad_multi(tl.LogisticLoss, x, ws, y, off,
                                               wt)
    want = fused_glm.fused_value_and_grad_plain(tl.LogisticLoss, x, ws, y,
                                                off, wt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fused_glm.fused_value_and_grad_multi.launches == before


def test_row_width_limit_falls_with_the_lane_count():
    """Kernel 4's shared memory holds one M x d gradient accumulator and at
    least two staged chunks (of unaligned rows, the widest staging), so the
    widest row it takes falls as M grows; no limit is below the earlier
    plan's (one gradient partial per row group), and the one-lane kernels
    keep theirs."""
    widths = [cuda_build.max_row_width(m) for m in (1, 2, 5, 11)]
    assert cuda_build.MAX_ROW_WIDTH == 29_055
    assert widths == [40_968, 20_480, 8_184, 3_712]
    assert widths == sorted(widths, reverse=True)
    for m, earlier in ((1, 29_055), (5, 5_810), (11, 2_640)):
        assert cuda_build.max_row_width(m) >= earlier
    for m, d in zip((1, 2, 5, 11), widths):
        # two f32 stages of unaligned 1024-column chunks fit at the limit,
        # not beyond; aligned rows stage in less
        assert cuda_build.multi_smem_bytes(d, m, 1024, 2, 4) \
            <= cuda_build.MAX_BLOCK_SMEM_BYTES
        assert cuda_build.multi_smem_bytes(d + 8, m, 1024, 2, 4) \
            > cuda_build.MAX_BLOCK_SMEM_BYTES
        assert cuda_build.multi_smem_bytes(d, m, 1024, 2, 4, aligned=True) \
            < cuda_build.multi_smem_bytes(d, m, 1024, 2, 4)


@pytest.mark.parametrize("lanes,d,match", [
    (5, 8_185, "8184-column shared-memory plan for 5"),
    (1, 40_969, "40968-column"),
], ids=["five-lanes", "one-lane"])
def test_kernel_argument_check_refuses_rows_too_wide_for_the_lanes(
        lanes, d, match):
    x = torch.zeros((2, d))
    rows = torch.zeros(2)
    with pytest.raises(ValueError, match=match):
        cuda_build.check_args(
            "fused_value_and_grad_multi", x, "nd", lanes=lanes,
            ws=(torch.zeros((lanes, d)), "md"), labels=(rows, "n"),
            offsets=(rows, "n"), weights=(rows, "n"))
    # one column fewer passes
    assert cuda_build.check_args(
        "fused_value_and_grad_multi", x[:, :-1].contiguous(), "nd",
        lanes=lanes, ws=(torch.zeros((lanes, d - 1)), "md"),
        labels=(rows, "n"), offsets=(rows, "n"),
        weights=(rows, "n")) == (2, d - 1)


def test_multi_wrapper_refuses_a_one_dimensional_ws():
    x, rows = torch.zeros((4, 3)), torch.zeros(4)
    for ws in (torch.zeros(3), torch.zeros((0, 3))):
        with pytest.raises(ValueError, match=r"ws must be \(M, d\)"):
            fused_glm.fused_value_and_grad_multi(tl.LogisticLoss, x, ws, rows,
                                                 rows, rows)
