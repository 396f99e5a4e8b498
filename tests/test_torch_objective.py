"""Port objective (photon_ml_tpu_torch.ops.objective) against the JAX
package's GLMObjective, in float64: the closed-form value and gradient with
weight-0 rows and non-identity normalization, the L2 mask, and the kernel
dispatch of a dense identity-normalization objective on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops.design import DenseDesign as JDense
from photon_ml_tpu.ops.normalization import build_normalization as j_norm
from photon_ml_tpu.ops.objective import GLMData as JData
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.types import NormalizationType as JNT
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops.design import DenseDesign as TDense
from photon_ml_tpu_torch.ops.normalization import build_normalization as t_norm
from photon_ml_tpu_torch.ops.objective import GLMData as TData
from photon_ml_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.types import NormalizationType as TNT

LOSSES = {"logistic": (jl.LogisticLoss, tl.LogisticLoss),
          "squared": (jl.SquaredLoss, tl.SquaredLoss),
          "poisson": (jl.PoissonLoss, tl.PoissonLoss),
          "smoothed_hinge": (jl.SmoothedHingeLoss, tl.SmoothedHingeLoss)}
NORMS = ["NONE", "SCALE_WITH_STANDARD_DEVIATION", "SCALE_WITH_MAX_MAGNITUDE",
         "STANDARDIZATION"]


def _problem(name, n=41, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, 0] = 1.0  # intercept column (STANDARDIZATION needs one)
    w = 0.3 * rng.normal(size=d)
    if name == "poisson":
        y = rng.poisson(1.5, size=n).astype(np.float64)
    elif name == "squared":
        y = rng.normal(size=n)
    else:
        y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    off = 0.1 * rng.normal(size=n)
    wt = rng.uniform(0.5, 2.0, size=n)
    wt[::5] = 0.0  # padding rows
    # a padded row with a huge raw margin: must contribute exactly nothing
    x[5, 1:] = 400.0
    return x, w, y, off, wt


def _both(name, norm, x, w, y, off, wt, reg_mask=None):
    jloss, tloss = LOSSES[name]
    stats = dict(mean=x.mean(0), variance=x.var(0),
                 max_magnitude=np.abs(x).max(0), intercept_index=0)
    jn = j_norm(getattr(JNT, norm), dtype=jnp.float64, **stats)
    tn = t_norm(getattr(TNT, norm), dtype=torch.float64, device="cpu",
                **stats)
    jobj = JObjective(loss=jloss, normalization=jn,
                      reg_mask=None if reg_mask is None
                      else jnp.asarray(reg_mask))
    tobj = TObjective(loss=tloss, normalization=tn,
                      reg_mask=None if reg_mask is None
                      else torch.as_tensor(reg_mask))
    jdata = JData(design=JDense(jnp.asarray(x)), labels=jnp.asarray(y),
                  offsets=jnp.asarray(off), weights=jnp.asarray(wt))
    tdata = TData(design=TDense(torch.as_tensor(x)), labels=torch.as_tensor(y),
                  offsets=torch.as_tensor(off), weights=torch.as_tensor(wt))
    return jobj, tobj, jdata, tdata


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_closed_value_and_grad_matches_jax(name, norm):
    x, w, y, off, wt = _problem(name)
    jobj, tobj, jdata, tdata = _both(name, norm, x, w, y, off, wt)
    jv, jg = jobj._closed_value_and_grad(jnp.asarray(w), jdata, 0.7)
    tv, tg = tobj._closed_value_and_grad(torch.as_tensor(w), tdata, 0.7)
    assert np.isfinite(float(tv)) and np.all(np.isfinite(tg.numpy()))
    # f64 on both sides; only the summation order differs
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-11)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-10)
    # value() (the double-where objective itself) agrees too
    np.testing.assert_allclose(
        float(tobj.value(torch.as_tensor(w), tdata, 0.7)),
        float(jobj.value(jnp.asarray(w), jdata, 0.7)), rtol=1e-11)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_kernel_dispatch_on_cpu_matches_jax_closed_form(name):
    """Dense + identity normalization goes through the fused wrapper, which
    runs its plain version for CPU tensors: same function, f64 here."""
    x, w, y, off, wt = _problem(name, seed=3)
    mask = np.ones(x.shape[1])
    mask[0] = 0.0  # exempt the intercept from L2
    jobj, tobj, jdata, tdata = _both(name, "NONE", x, w, y, off, wt, mask)
    assert tobj.uses_kernel(tdata)
    tv, tg = tobj.value_and_grad(torch.as_tensor(w), tdata, 0.3)
    jv, jg = jobj._closed_value_and_grad(jnp.asarray(w), jdata, 0.3)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-11)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-10)


def test_batched_objective_is_per_lane():
    """An (E, S, D) design with (E, D) coefficients is E objectives."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 4))
    w = rng.normal(size=(3, 4))
    y = (rng.uniform(size=(3, 7)) < 0.5).astype(np.float64)
    off = rng.normal(size=(3, 7))
    wt = (rng.uniform(size=(3, 7)) > 0.3).astype(np.float64)
    obj = TObjective(loss=tl.LogisticLoss)
    data = TData(design=TDense(torch.as_tensor(x)), labels=torch.as_tensor(y),
                 offsets=torch.as_tensor(off), weights=torch.as_tensor(wt))
    v, g = obj.value_and_grad(torch.as_tensor(w), data, 0.5)
    for e in range(3):
        one = TData(design=TDense(torch.as_tensor(x[e])),
                    labels=torch.as_tensor(y[e]),
                    offsets=torch.as_tensor(off[e]),
                    weights=torch.as_tensor(wt[e]))
        ve, ge = obj._closed_value_and_grad(torch.as_tensor(w[e]), one, 0.5)
        np.testing.assert_allclose(float(v[e]), float(ve), rtol=1e-12)
        np.testing.assert_allclose(g[e].numpy(), ge.numpy(), rtol=1e-11,
                                   atol=1e-12)


def test_reg_mask_must_be_zero_one():
    with pytest.raises(ValueError, match="0/1"):
        TObjective(loss=tl.LogisticLoss, reg_mask=torch.tensor([0.5, 1.0]))
