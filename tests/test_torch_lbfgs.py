"""Batched L-BFGS (photon_ml_tpu_torch.optimize.lbfgs) against the JAX
package's minimize_lbfgs, one lane and under jax.vmap, in float64: the same
algorithm, so the same iteration count per lane, not only the same optimum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.optimize import minimize_lbfgs as j_minimize
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.optimize import OptimizerConfig as TConfig
from photon_ml_tpu_torch.optimize import minimize_lbfgs as t_minimize


def _lanes(n_lanes=4, n=60, d=5, seed=0):
    """Per-lane logistic problems of different conditioning, so lanes
    converge at different iterations."""
    rng = np.random.default_rng(seed)
    scales = np.array([0.5, 1.0, 3.0, 8.0, 2.0, 0.2])[:n_lanes]
    x = rng.normal(size=(n_lanes, n, d)) * scales[:, None, None]
    y = (rng.uniform(size=(n_lanes, n)) < 0.5).astype(np.float64)
    lam = np.array([0.1, 1.0, 0.01, 0.5, 2.0, 0.05])[:n_lanes]
    return x, y, lam


def _jax_fun(x, y, lam):
    def fun(w):
        m = x @ w
        v = jnp.sum(jl.LogisticLoss.loss(m, y)) + 0.5 * lam * w @ w
        g = x.T @ jl.LogisticLoss.d1(m, y) + lam * w
        return v, g
    return fun


def _torch_fun(x, y, lam):
    def fun(w):  # w (L, d)
        m = torch.einsum("lnd,ld->ln", x, w)
        v = tl.LogisticLoss.loss(m, y).sum(-1) + 0.5 * lam * (w * w).sum(-1)
        g = torch.einsum("ln,lnd->ld", tl.LogisticLoss.d1(m, y), x) \
            + lam[:, None] * w
        return v, g
    return fun


@pytest.mark.parametrize("max_iterations,history", [(80, 10), (6, 3)])
def test_batched_matches_vmap_of_jax_lbfgs(max_iterations, history):
    x, y, lam = _lanes()
    d = x.shape[2]
    jcfg = JConfig(max_iterations=max_iterations, history=history,
                   track_states=False)
    tcfg = TConfig(max_iterations=max_iterations, history=history,
                   track_states=False)

    def solve_one(xe, ye, le):
        return j_minimize(_jax_fun(xe, ye, le), jnp.zeros(d), jcfg)

    jres = jax.vmap(solve_one)(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(lam))
    tres = t_minimize(_torch_fun(torch.as_tensor(x), torch.as_tensor(y),
                                 torch.as_tensor(lam)),
                      torch.zeros((x.shape[0], d), dtype=torch.float64), tcfg)
    its = np.asarray(jres.iterations)
    assert len(set(its.tolist())) > 1 or max_iterations < 10  # lanes differ
    np.testing.assert_array_equal(tres.iterations.numpy(), its)
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    # f64 on both sides: the iterates differ only by summation order
    np.testing.assert_allclose(tres.w.numpy(), np.asarray(jres.w),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(tres.value.numpy(), np.asarray(jres.value),
                               rtol=1e-12)


def test_single_lane_matches_jax_with_trace():
    x, y, lam = _lanes(n_lanes=1, seed=4)
    d = x.shape[2]
    jres = j_minimize(_jax_fun(jnp.asarray(x[0]), jnp.asarray(y[0]), lam[0]),
                      jnp.zeros(d), JConfig(max_iterations=30))
    tres = t_minimize(_torch_fun(torch.as_tensor(x), torch.as_tensor(y),
                                 torch.as_tensor(lam)),
                      torch.zeros((1, d), dtype=torch.float64),
                      TConfig(max_iterations=30))
    assert int(tres.iterations[0]) == int(jres.iterations)
    np.testing.assert_allclose(tres.w[0].numpy(), np.asarray(jres.w),
                               rtol=1e-9, atol=1e-10)
    # the per-iteration trace: the same values, +inf past the last iterate
    np.testing.assert_allclose(tres.values[0].numpy(),
                               np.asarray(jres.values), rtol=1e-6)
    np.testing.assert_allclose(tres.grad_norms[0].numpy(),
                               np.asarray(jres.grad_norms), rtol=1e-5)


def test_finished_lane_keeps_its_state():
    """A lane converged at w0 never moves, and its count stays 0, however
    long the other lanes run."""
    x, y, lam = _lanes(n_lanes=3, seed=2)
    x[1] = 0.0
    y[1] = 0.5  # zero data, logistic gradient 0 at w = 0: converged at start
    tres = t_minimize(_torch_fun(torch.as_tensor(x), torch.as_tensor(y),
                                 torch.as_tensor(lam)),
                      torch.zeros((3, x.shape[2]), dtype=torch.float64),
                      TConfig(max_iterations=50, track_states=False))
    assert int(tres.iterations[1]) == 0 and bool(tres.converged[1])
    assert not tres.w[1].any()
    assert int(tres.iterations[0]) > 0 and int(tres.iterations[2]) > 0
