"""Port losses (photon_ml_tpu_torch.ops.losses) against the JAX package's
(photon_ml_tpu.ops.losses), loss/d1/d2/mean, margins up to |m| = 1e3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu_torch.ops import losses as tl

PAIRS = {
    "logistic": (jl.LogisticLoss, tl.LogisticLoss),
    "squared": (jl.SquaredLoss, tl.SquaredLoss),
    "poisson": (jl.PoissonLoss, tl.PoissonLoss),
    "smoothed_hinge": (jl.SmoothedHingeLoss, tl.SmoothedHingeLoss),
}


def _inputs(name):
    rng = np.random.default_rng(7)
    m = np.concatenate([rng.normal(scale=3.0, size=64),
                        [-1e3, -50.0, -1.0, 0.0, 0.5, 1.0, 50.0, 1e3]])
    if name == "poisson":  # exp(m) must stay finite in f64
        m = np.clip(m, -700.0, 700.0)
        y = rng.poisson(2.0, size=m.shape).astype(np.float64)
    elif name == "squared":
        y = rng.normal(size=m.shape)
    else:
        y = (rng.uniform(size=m.shape) < 0.5).astype(np.float64)
    return m, y


@pytest.mark.parametrize("part", ["loss", "d1", "d2"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_matches_jax(name, part):
    jloss, tloss = PAIRS[name]
    m, y = _inputs(name)
    want = np.asarray(getattr(jloss, part)(jnp.asarray(m), jnp.asarray(y)))
    got = getattr(tloss, part)(torch.as_tensor(m), torch.as_tensor(y)).numpy()
    assert np.all(np.isfinite(got))
    # f64 on both sides; the stable softplus and sigmoid are written
    # differently in the two frameworks, so allow a few ulps
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_mean_and_task_mapping(name):
    from photon_ml_tpu_torch.types import TaskType

    jloss, tloss = PAIRS[name]
    m = np.linspace(-5, 5, 11)
    np.testing.assert_allclose(tloss.mean(torch.as_tensor(m)).numpy(),
                               np.asarray(jloss.mean(jnp.asarray(m))),
                               rtol=1e-12)
    task = {"logistic": TaskType.LOGISTIC_REGRESSION,
            "squared": TaskType.LINEAR_REGRESSION,
            "poisson": TaskType.POISSON_REGRESSION,
            "smoothed_hinge": TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM}[name]
    assert tl.loss_for_task(task) is tloss
