"""The port's hyperparameter tuning (``photon_ml_tpu_torch.hyperparameter``,
a host numpy/scipy copy) against the JAX package's: kernels, the GP
posterior, expected improvement, the slice sampler and both searches on one
deterministic numpy objective, point sequences equal bit for bit."""

import numpy as np
import pytest

from photon_ml_tpu import hyperparameter as jh
from photon_ml_tpu.hyperparameter import search as js
from photon_ml_tpu_torch import hyperparameter as th
from photon_ml_tpu_torch.hyperparameter import search as ts


def _objective(config):
    """Smooth and unimodal in log space, two dimensions, optimum at
    (1e-2, 10)."""
    return float(-(np.log10(config["a"]) + 2.0) ** 2
                 - 0.5 * (np.log10(config["b"]) - 1.0) ** 2)


@pytest.mark.parametrize("kernel", ["RBF", "Matern52"])
def test_kernels_equal_jax(kernel):
    rng = np.random.default_rng(0)
    x1, x2 = rng.normal(size=(7, 3)), rng.normal(size=(5, 3))
    ls = np.array([0.5, 1.0, 2.0])
    a = getattr(th, kernel)(amplitude=1.7, lengthscales=ls)
    b = getattr(jh, kernel)(amplitude=1.7, lengthscales=ls)
    np.testing.assert_array_equal(a(x1, x2), b(x1, x2))
    np.testing.assert_allclose(np.diag(a(x1, x1)), 1.7, rtol=1e-12)


def test_slice_sampler_equals_jax():
    def logp(x):
        return float(-0.5 * ((x[0] - 1.5) / 0.7) ** 2 - 0.5 * x[1] ** 2)

    a = th.slice_sample(logp, np.zeros(2), np.random.default_rng(3), 200,
                        burn_in=20)
    b = jh.slice_sample(logp, np.zeros(2), np.random.default_rng(3), 200,
                        burn_in=20)
    np.testing.assert_array_equal(a, b)
    assert abs(a[:, 0].mean() - 1.5) < 0.3


def test_gp_posterior_equals_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(9, 2))
    y = np.sin(6 * x[:, 0]) + x[:, 1]
    cand = rng.uniform(size=(50, 2))
    got = th.GaussianProcessEstimator(n_kernel_samples=4).fit(x, y)
    want = jh.GaussianProcessEstimator(n_kernel_samples=4).fit(x, y)
    for a, b in zip(got.predict(cand), want.predict(cand)):
        np.testing.assert_array_equal(a, b)
    mean, var = got.predict(x)
    np.testing.assert_allclose(mean, y, atol=0.2)
    assert (var > 0).all()


@pytest.mark.parametrize("maximize", [True, False])
def test_expected_improvement_equals_jax(maximize):
    rng = np.random.default_rng(2)
    mean, var = rng.normal(size=20), rng.uniform(0.01, 1, size=20)
    np.testing.assert_array_equal(
        th.expected_improvement(mean, var, 0.3, maximize=maximize),
        jh.expected_improvement(mean, var, 0.3, maximize=maximize))


def test_param_range_equals_jax():
    a, b = ts.ParamRange(1e-4, 1e2), js.ParamRange(1e-4, 1e2)
    for u in (0.0, 0.37, 1.0, 1.5):
        assert a.from_unit(u) == b.from_unit(u)
    assert a.to_unit(0.03) == b.to_unit(0.03)
    with pytest.raises(ValueError):
        ts.ParamRange(1.0, 0.5)


def _space(mod):
    return {"a": mod.ParamRange(1e-6, 1e2), "b": mod.ParamRange(1e-3, 1e3)}


def test_random_search_equals_jax():
    got = ts.RandomSearch(_space(ts), seed=5).find(_objective, 12)
    want = js.RandomSearch(_space(js), seed=5).find(_objective, 12)
    assert got.configs == want.configs and got.values == want.values
    for cfg in got.configs:
        assert 1e-6 <= cfg["a"] <= 1e2 and 1e-3 <= cfg["b"] <= 1e3
    assert got.best(True) == want.best(True)


@pytest.mark.parametrize("prior", [False, True], ids=["seeded", "prior"])
def test_gp_search_equals_jax(prior):
    obs = ([({"a": 10.0 ** (e - 4), "b": 10.0 ** (e - 1)},
             _objective({"a": 10.0 ** (e - 4), "b": 10.0 ** (e - 1)}))
            for e in range(3)] if prior else [])
    kw = dict(maximize=True, n_seed_points=0 if prior else 3,
              n_candidates=256, seed=3)
    got = ts.GaussianProcessSearch(_space(ts), **kw).find(
        _objective, 6, prior_observations=obs)
    want = js.GaussianProcessSearch(_space(js), **kw).find(
        _objective, 6, prior_observations=obs)
    assert got.configs == want.configs and got.values == want.values
    assert len(got.configs) == 6 + len(obs)
    if not prior:
        # the GP's picks beat the random seed points
        assert max(got.values[3:]) >= max(got.values[:3])
