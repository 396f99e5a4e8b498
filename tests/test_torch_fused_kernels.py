"""The fused kernels' plain PyTorch versions against the Pallas kernels run
in interpret mode, and the wrappers' CPU dispatch.

- kernel 1: photon_ml_tpu_torch.ops.fused_glm vs
  photon_ml_tpu.ops.pallas_glm.fused_value_and_grad(..., interpret=True);
- kernel 2: photon_ml_tpu_torch.ops.fused_re vs
  photon_ml_tpu.ops.pallas_re.fused_entity_value_and_grad(..., interpret=True).

All four losses, f32 and bf16 designs, ragged sizes and weight-0 rows. The
CUDA kernels themselves run only on the card (chip_smoke.py holds them
against these plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops import pallas_glm, pallas_re
from photon_ml_tpu_torch.ops import cuda_build, fused_glm, fused_re
from photon_ml_tpu_torch.ops import losses as tl

LOSSES = {"logistic": (jl.LogisticLoss, tl.LogisticLoss),
          "squared": (jl.SquaredLoss, tl.SquaredLoss),
          "poisson": (jl.PoissonLoss, tl.PoissonLoss),
          "smoothed_hinge": (jl.SmoothedHingeLoss, tl.SmoothedHingeLoss)}
#: the plain versions round exactly where the Pallas kernels do (bf16 w and
#: wt·d1 in kernel 1, nothing after the load in kernel 2), so in f32 and in
#: bf16 only the f32 summation order differs: 1e-5 of the largest output,
#: the bound the reference's own kernel tests use (measured: ~2e-7)
RTOL = 1e-5


def _labels(name, rng, shape):
    if name == "poisson":
        return rng.poisson(1.5, size=shape).astype(np.float32)
    if name == "squared":
        return rng.normal(size=shape).astype(np.float32)
    return (rng.uniform(size=shape) < 0.5).astype(np.float32)


def _cast(x32, dtype):
    if dtype == "bfloat16":
        jx = jnp.asarray(x32, jnp.bfloat16)
        return jx, torch.as_tensor(x32).to(torch.bfloat16)
    return jnp.asarray(x32), torch.as_tensor(x32)


def _glm_case(name, n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = (0.3 * rng.normal(size=d)).astype(np.float32)
    y = _labels(name, rng, n)
    off = (0.2 * rng.normal(size=n)).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    wt[::4] = 0.0  # weight-0 (padding) rows
    x[4] = 60.0  # a padded row whose raw margin would overflow exp()
    return x, w, y, off, wt


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("n,d,block_rows", [(48, 33, None), (37, 9, 16)],
                         ids=["even", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_glm_plain_matches_pallas(name, dtype, n, d, block_rows):
    jloss, tloss = LOSSES[name]
    x, w, y, off, wt = _glm_case(name, n, d, seed=n + d)
    jx, tx = _cast(x, dtype)
    jv, jg = pallas_glm.fused_value_and_grad(
        jloss, jx, jnp.asarray(w), jnp.asarray(y), jnp.asarray(off),
        jnp.asarray(wt), block_rows=block_rows, interpret=True)
    tv, tg = fused_glm.fused_value_and_grad_plain(
        tloss, tx, torch.as_tensor(w), torch.as_tensor(y),
        torch.as_tensor(off), torch.as_tensor(wt))
    assert tv.dtype == torch.float32 and tg.dtype == torch.float32
    assert np.isfinite(float(tv)) and torch.isfinite(tg).all()
    _close(float(tv), float(jv), RTOL)
    _close(tg.numpy(), np.asarray(jg), RTOL)


def _re_case(name, e, s, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, s, d)).astype(np.float32)
    w = (0.3 * rng.normal(size=(e, d))).astype(np.float32)
    y = _labels(name, rng, (e, s))
    off = (0.2 * rng.normal(size=(e, s))).astype(np.float32)
    wt = (rng.uniform(size=(e, s)) > 0.3).astype(np.float32)
    wt[1] = 0.0  # an all-dead entity
    x[0, 0] = 60.0
    wt[0, 0] = 0.0  # a padded row whose raw margin would overflow exp()
    return x, w, y, off, wt


@pytest.mark.parametrize("e,s,d", [(8, 16, 4), (13, 11, 5)],
                         ids=["even", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_entity_plain_matches_pallas(name, dtype, e, s, d):
    jloss, tloss = LOSSES[name]
    x, w, y, off, wt = _re_case(name, e, s, d, seed=e * s)
    jx, tx = _cast(x, dtype)
    jv, jg = pallas_re.fused_entity_value_and_grad(
        jloss, jx, jnp.asarray(w), jnp.asarray(y), jnp.asarray(off),
        jnp.asarray(wt), interpret=True)
    tv, tg = fused_re.fused_entity_value_and_grad_plain(
        tloss, tx, torch.as_tensor(w), torch.as_tensor(y),
        torch.as_tensor(off), torch.as_tensor(wt))
    assert tv.shape == (e,) and tg.shape == (e, d)
    assert tv.dtype == torch.float32 and torch.isfinite(tg).all()
    # the all-dead entity contributes exactly nothing
    assert float(tv[1]) == 0.0 and not tg[1].any()
    for k in range(e):
        _close(float(tv[k]), float(jv[k]), RTOL)
        _close(tg[k].numpy(), np.asarray(jg[k]), RTOL)


def test_wrappers_run_plain_version_for_cpu_tensors():
    x, w, y, off, wt = (torch.as_tensor(a) for a in
                        _glm_case("logistic", 20, 5, 0))
    before = fused_glm.fused_value_and_grad.launches
    got = fused_glm.fused_value_and_grad(tl.LogisticLoss, x, w, y, off, wt)
    want = fused_glm.fused_value_and_grad_plain(tl.LogisticLoss, x, w, y,
                                                off, wt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # no kernel was launched for CPU tensors
    assert fused_glm.fused_value_and_grad.launches == before
    xe, we, ye, oe, wte = (torch.as_tensor(a) for a in
                           _re_case("logistic", 4, 6, 3, 0))
    before = fused_re.fused_entity_value_and_grad.launches
    got = fused_re.fused_entity_value_and_grad(tl.LogisticLoss, xe, we, ye,
                                               oe, wte)
    want = fused_re.fused_entity_value_and_grad_plain(tl.LogisticLoss, xe, we,
                                                      ye, oe, wte)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fused_re.fused_entity_value_and_grad.launches == before


def _kernel1_args(**change):
    args = dict(x=torch.zeros((4, 3)), w=torch.zeros(3),
                labels=torch.zeros(4), offsets=torch.zeros(4),
                weights=torch.zeros(4))
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    ({"x": torch.zeros((4, 3), dtype=torch.float64)}, "float32 or bfloat16"),
    ({"x": torch.zeros((4, 3, 1))}, r"x must be \(n, d\)"),
    ({"x": torch.zeros((3, 4)).t()}, "x must be contiguous"),
    ({"x": torch.zeros((4, cuda_build.MAX_ROW_WIDTH + 1))},
     "shared-memory plan"),
    ({"w": torch.zeros(4)}, r"w must be float32 \(3,\)"),
    ({"labels": torch.zeros(4, dtype=torch.bfloat16)}, "labels must be"),
    ({"weights": torch.zeros(4, device="meta")}, "weights must be contiguous"),
], ids=["dtype", "rank", "strided", "too-wide", "w-shape", "labels-dtype",
        "other-device"])
def test_kernel_argument_check_rejects_what_the_kernels_do_not_take(
        change, match):
    """The wrappers' shared check, run before every launch on the card."""
    a = _kernel1_args(**change)
    with pytest.raises(ValueError, match=match):
        cuda_build.check_args(
            "fused_value_and_grad", a["x"], "nd", w=(a["w"], "d"),
            labels=(a["labels"], "n"), offsets=(a["offsets"], "n"),
            weights=(a["weights"], "n"))


def test_kernel_argument_check_returns_the_design_shape():
    x = torch.zeros((2, 5, 3), dtype=torch.bfloat16)
    rows = torch.zeros((2, 5))
    assert cuda_build.check_args(
        "fused_entity_value_and_grad", x, "esd", ws=(torch.zeros((2, 3)), "ed"),
        labels=(rows, "es"), offsets=(rows, "es"),
        weights=(rows, "es")) == (2, 5, 3)
