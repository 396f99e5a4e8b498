"""Batched OWL-QN (photon_ml_tpu_torch.optimize.owlqn) against the JAX
package's minimize_owlqn, one lane and under jax.vmap, in float64: the same
algorithm, so the same iterates, values, pseudo-gradient norms and exact
zeros after every number of iterations, not only the same optimum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.optimize import minimize_owlqn as j_minimize
from photon_ml_tpu.optimize.owlqn import pseudo_gradient as j_pseudo
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.optimize import OptimizerConfig as TConfig
from photon_ml_tpu_torch.optimize import minimize_owlqn as t_minimize
from photon_ml_tpu_torch.optimize.owlqn import pseudo_gradient as t_pseudo

#: f64 on both sides, the same algorithm: only summation order differs
RTOL = 1e-10


def _logistic(n=120, d=8, seed=0):
    """Logistic data with an intercept column 0 and features of mixed
    scale, some of them pure noise so that L1 zeroes them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * np.geomspace(0.2, 4.0, d)
    x[:, 0] = 1.0
    w_true = rng.normal(size=d)
    w_true[[2, 5]] = 0.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ w_true / 2))).astype(
        np.float64)
    return x, y


def _jax_fun(x, y, l2):
    def fun(w):
        m = x @ w
        v = jnp.sum(jl.LogisticLoss.loss(m, y)) + 0.5 * l2 * w @ w
        return v, x.T @ jl.LogisticLoss.d1(m, y) + l2 * w
    return fun


def _torch_fun(x, y, l2):
    """Lanes (L, d) over a shared design; ``l2`` a number or (L,)."""
    l2 = torch.as_tensor(l2, dtype=torch.float64)

    def fun(w):
        m = w @ x.t()
        lam = l2[:, None] if l2.dim() else l2
        v = tl.LogisticLoss.loss(m, y).sum(-1) + 0.5 * (lam * w * w).sum(-1)
        return v, tl.LogisticLoss.d1(m, y) @ x + lam * w
    return fun


def _assert_same(t, j, lane=None):
    """One lane of a port result against a JAX result."""
    pick = (lambda a: a) if lane is None else (lambda a: a[lane])
    tw = t.w.numpy()[0 if lane is None else lane]
    jw = np.asarray(pick(j.w))
    assert int(t.iterations[0 if lane is None else lane]) == int(
        pick(j.iterations))
    assert bool(t.converged[0 if lane is None else lane]) == bool(
        pick(j.converged))
    np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=1e-12)
    np.testing.assert_array_equal(tw == 0.0, jw == 0.0)  # the same zeros
    k = 0 if lane is None else lane
    np.testing.assert_allclose(float(t.value[k]), float(pick(j.value)),
                               rtol=RTOL)
    np.testing.assert_allclose(float(t.grad_norm[k]),
                               float(pick(j.grad_norm)), rtol=RTOL,
                               atol=1e-13)
    # the f32 traces of every iteration
    np.testing.assert_allclose(t.values.numpy()[k],
                               np.asarray(pick(j.values)), rtol=1e-6)
    np.testing.assert_allclose(t.grad_norms.numpy()[k],
                               np.asarray(pick(j.grad_norms)), rtol=1e-6,
                               atol=1e-12)


def test_pseudo_gradient_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=40)
    w[::3] = 0.0
    g = rng.normal(size=40)
    l1 = rng.uniform(0, 1.5, size=40)
    l1[0] = 0.0
    np.testing.assert_array_equal(
        t_pseudo(torch.as_tensor(w), torch.as_tensor(g),
                 torch.as_tensor(l1)).numpy(),
        np.asarray(j_pseudo(jnp.asarray(w), jnp.asarray(g),
                            jnp.asarray(l1))))


@pytest.mark.parametrize("max_iterations", [1, 2, 3, 5, 9, 200])
def test_elastic_net_iterates_match_jax(max_iterations):
    """Logistic elastic net with an L1 weight per coordinate (0 on the
    intercept), stopped after each number of iterations."""
    x, y = _logistic()
    d = x.shape[1]
    l1 = np.full(d, 3.0)
    l1[0] = 0.0
    l2 = 0.5
    jres = j_minimize(_jax_fun(jnp.asarray(x), jnp.asarray(y), l2),
                      jnp.zeros(d), jnp.asarray(l1),
                      JConfig(max_iterations=max_iterations))
    tres = t_minimize(_torch_fun(torch.as_tensor(x), torch.as_tensor(y), l2),
                      torch.zeros((1, d), dtype=torch.float64),
                      torch.as_tensor(l1),
                      TConfig(max_iterations=max_iterations))
    _assert_same(tres, jres)
    if max_iterations == 200:
        assert bool(tres.converged[0])
        w = tres.w.numpy()[0]
        assert w[0] != 0.0  # the exempt intercept
        assert (w == 0.0).sum() >= 2  # exact zeros, not small values


def test_orthogonal_soft_threshold():
    """On 0.5·||w − c||² + l1·||w||₁ the solution is the soft-threshold of
    c, with exact zeros (tests/test_optimizers.py's case), as in JAX."""
    rng = np.random.default_rng(0)
    d = 10
    center = rng.normal(size=d) * 2.0
    l1 = 0.7

    def jfun(w):
        return 0.5 * jnp.sum((w - center) ** 2), w - center

    def tfun(w):
        c = torch.as_tensor(center)
        return 0.5 * ((w - c) ** 2).sum(-1), w - c

    jres = j_minimize(jfun, jnp.zeros(d), l1, JConfig(max_iterations=150))
    tres = t_minimize(tfun, torch.zeros((1, d), dtype=torch.float64), l1,
                      TConfig(max_iterations=150))
    expected = np.sign(center) * np.maximum(np.abs(center) - l1, 0.0)
    np.testing.assert_allclose(tres.w.numpy()[0], expected, rtol=1e-4,
                               atol=1e-5)
    assert np.all(tres.w.numpy()[0][np.abs(center) < l1] == 0.0)
    _assert_same(tres, jres)


@pytest.mark.parametrize("max_iterations,history", [(200, 10), (7, 3)])
def test_lanes_match_vmap_of_jax(max_iterations, history):
    """One lambda per lane, split by elastic-net alpha 0.5 into an L1 and
    an L2 weight per lane, against jax.vmap(minimize_owlqn)."""
    x, y = _logistic(seed=1)
    d = x.shape[1]
    lams = np.array([20.0, 5.0, 1.0, 0.1])
    jcfg = JConfig(max_iterations=max_iterations, history=history)
    tcfg = TConfig(max_iterations=max_iterations, history=history)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def solve_one(lam):
        return j_minimize(_jax_fun(xj, yj, 0.5 * lam), jnp.zeros(d),
                          0.5 * lam, jcfg)

    jres = jax.vmap(solve_one)(jnp.asarray(lams))
    tres = t_minimize(_torch_fun(torch.as_tensor(x), torch.as_tensor(y),
                                 0.5 * lams),
                      torch.zeros((len(lams), d), dtype=torch.float64),
                      torch.as_tensor(0.5 * lams)[:, None], tcfg)
    for lane in range(len(lams)):
        _assert_same(tres, jres, lane)
    if max_iterations == 200:
        zeros = (tres.w.numpy() == 0.0).sum(-1)
        assert zeros[0] > zeros[-1]  # sparser at the larger lambda
        assert len(set(np.asarray(jres.iterations).tolist())) > 1
