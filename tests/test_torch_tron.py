"""Batched TRON (photon_ml_tpu_torch.optimize.tron) against the JAX package's
minimize_tron, one lane and under jax.vmap, in float64: the same algorithm,
so the same iteration count per lane, not only the same optimum — lanes
that stop at different iterations, a lane whose first trial value
overflows, and the per-iteration trace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.optimize import OptimizerConfig as JConfig
from photon_ml_tpu.optimize import minimize_tron as j_minimize
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.optimize import OptimizerConfig as TConfig
from photon_ml_tpu_torch.optimize import minimize_tron as t_minimize

#: f64 on both sides: the iterates differ only by summation order
W_TOL = dict(rtol=1e-9, atol=1e-10)


def _lanes(name, n_lanes=4, n=60, d=5, seed=0):
    """Per-lane problems of different conditioning, so lanes converge at
    different iterations. For Poisson, lane 0's counts are ~800: the first
    Newton step aims its margins near log-scale 800 and exp() overflows."""
    rng = np.random.default_rng(seed)
    scales = np.array([0.5, 1.0, 3.0, 8.0, 2.0, 0.2])[:n_lanes]
    x = rng.normal(size=(n_lanes, n, d)) * scales[:, None, None]
    if name == "poisson":
        y = rng.poisson(1.0, size=(n_lanes, n)).astype(np.float64)
        y[0] = rng.poisson(800.0, size=n)
    else:
        y = (rng.uniform(size=(n_lanes, n)) < 0.5).astype(np.float64)
    lam = np.array([0.1, 1.0, 0.01, 0.5, 2.0, 0.05])[:n_lanes]
    return x, y, lam


def _jax_fns(loss, x, y, lam):
    def fun(w):
        m = x @ w
        return (jnp.sum(loss.loss(m, y)) + 0.5 * lam * w @ w,
                x.T @ loss.d1(m, y) + lam * w)

    def hvp(w, v):
        return x.T @ (loss.d2(x @ w, y) * (x @ v)) + lam * v
    return fun, hvp


def _torch_fns(loss, x, y, lam):
    """``fun`` and the operator builder ``hvp_at(w) -> (v -> Hv)``, the
    port's TRON interface."""
    def fun(w):  # w (L, d)
        m = torch.einsum("lnd,ld->ln", x, w)
        return (loss.loss(m, y).sum(-1) + 0.5 * lam * (w * w).sum(-1),
                torch.einsum("ln,lnd->ld", loss.d1(m, y), x)
                + lam[:, None] * w)

    def hvp(w, v):
        d2 = loss.d2(torch.einsum("lnd,ld->ln", x, w), y)
        t = torch.einsum("lnd,ld->ln", x, v)
        return torch.einsum("ln,lnd->ld", d2 * t, x) + lam[:, None] * v
    return fun, lambda w: lambda v: hvp(w, v)


LOSSES = {"logistic": (jl.LogisticLoss, tl.LogisticLoss),
          "poisson": (jl.PoissonLoss, tl.PoissonLoss)}


@pytest.mark.parametrize("max_iterations,cg", [(80, 30), (4, 2)],
                         ids=["to-convergence", "capped"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_batched_matches_vmap_of_jax_tron(name, max_iterations, cg):
    jloss, tloss = LOSSES[name]
    x, y, lam = _lanes(name)
    d = x.shape[2]
    jcfg = JConfig(max_iterations=max_iterations, cg_max_iterations=cg,
                   track_states=False)
    tcfg = TConfig(max_iterations=max_iterations, cg_max_iterations=cg,
                   track_states=False)

    def solve_one(xe, ye, le):
        fun, hvp = _jax_fns(jloss, xe, ye, le)
        return j_minimize(fun, hvp, jnp.zeros(d), jcfg)

    jres = jax.vmap(solve_one)(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(lam))
    fun, hvp_at = _torch_fns(tloss, torch.as_tensor(x), torch.as_tensor(y),
                             torch.as_tensor(lam))
    tres = t_minimize(fun, hvp_at, torch.zeros((x.shape[0], d),
                                            dtype=torch.float64), tcfg)
    its = np.asarray(jres.iterations)
    if max_iterations == 80:
        assert len(set(its.tolist())) > 1  # lanes stop at different steps
        assert np.asarray(jres.converged).all()
    np.testing.assert_array_equal(tres.iterations.numpy(), its)
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_allclose(tres.w.numpy(), np.asarray(jres.w), **W_TOL)
    np.testing.assert_allclose(tres.value.numpy(), np.asarray(jres.value),
                               rtol=1e-12)


def test_overflowing_trial_step_shrinks_the_radius_and_recovers():
    """Poisson lane 0's first trial value is +inf: the step is refused (the
    trace repeats the start value), the radius shrinks, and the lane still
    converges — iteration for iteration with the JAX package."""
    x, y, lam = _lanes("poisson", n_lanes=1)
    d = x.shape[2]
    fun, hvp_at = _torch_fns(tl.PoissonLoss, torch.as_tensor(x),
                             torch.as_tensor(y), torch.as_tensor(lam))
    finite = []

    def watched(w):
        v, g = fun(w)
        finite.append(bool(torch.isfinite(v).all()))
        return v, g

    jfun, jhvp = _jax_fns(jl.PoissonLoss, jnp.asarray(x[0]), jnp.asarray(y[0]),
                          lam[0])
    jres = j_minimize(jfun, jhvp, jnp.zeros(d), JConfig(max_iterations=80))
    tres = t_minimize(watched, hvp_at,
                      torch.zeros((1, d), dtype=torch.float64),
                      TConfig(max_iterations=80))
    assert finite[0] and not finite[1]  # start finite, first trial overflows
    assert bool(tres.converged[0]) and bool(jres.converged)
    assert int(tres.iterations[0]) == int(jres.iterations)
    jv = np.asarray(jres.values)
    assert jv[1] == jv[0]  # the refused first step
    np.testing.assert_allclose(tres.w[0].numpy(), np.asarray(jres.w),
                               **W_TOL)
    # the per-iteration trace (f32 in both): the same values, +inf past the
    # last iterate
    np.testing.assert_allclose(tres.values[0].numpy(), jv, rtol=1e-6)
    np.testing.assert_allclose(tres.grad_norms[0].numpy(),
                               np.asarray(jres.grad_norms), rtol=1e-5)


def test_hvp_at_builds_the_operator_once_per_newton_step():
    """The operator is built once per outer iteration (the curvature pass),
    and building it per Newton step gives the iterates of the JAX package's
    per-product ``hvp`` under ``jax.vmap``."""
    x, y, lam = _lanes("logistic", n_lanes=2)
    d = x.shape[2]
    fun, hvp_at = _torch_fns(tl.LogisticLoss, torch.as_tensor(x),
                             torch.as_tensor(y), torch.as_tensor(lam))
    built = []

    def counted(w):
        built.append(1)
        return hvp_at(w)

    res = t_minimize(fun, counted, torch.zeros((2, d), dtype=torch.float64),
                     TConfig())

    def solve_one(xe, ye, le):
        jfun, jhvp = _jax_fns(jl.LogisticLoss, xe, ye, le)
        return j_minimize(jfun, jhvp, jnp.zeros(d), JConfig())

    jres = jax.vmap(solve_one)(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(lam))
    assert len(built) == int(res.iterations.max())
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jres.iterations))
    np.testing.assert_allclose(res.w.numpy(), np.asarray(jres.w), **W_TOL)


def test_finished_lane_keeps_its_state():
    """A lane converged at w0 never moves, and its count stays 0, however
    long the other lanes run."""
    x, y, lam = _lanes("logistic", n_lanes=3, seed=2)
    x[1] = 0.0
    y[1] = 0.5  # zero data, logistic gradient 0 at w = 0: converged at start
    fun, hvp_at = _torch_fns(tl.LogisticLoss, torch.as_tensor(x),
                             torch.as_tensor(y), torch.as_tensor(lam))
    tres = t_minimize(fun, hvp_at,
                      torch.zeros((3, x.shape[2]), dtype=torch.float64),
                      TConfig(max_iterations=50, track_states=False))
    assert int(tres.iterations[1]) == 0 and bool(tres.converged[1])
    assert not tres.w[1].any()
    assert int(tres.iterations[0]) > 0 and int(tres.iterations[2]) > 0
