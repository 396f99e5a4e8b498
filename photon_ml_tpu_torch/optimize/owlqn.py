"""OWL-QN (orthant-wise L-BFGS) for L1 / elastic net, batched over lanes.

Counterpart of ``photon_ml_tpu/optimize/owlqn.py`` (Andrew & Gao, 2007)
with the same algorithm, iteration for iteration: the smooth part of the
objective goes through the L-BFGS machinery (curvature pairs from smooth
gradients), and the L1 term enters only through

- the pseudo-gradient, the sub-gradient that steepest-descends the full
  objective,
- the direction's alignment: the quasi-Newton direction is zeroed where it
  disagrees with the pseudo-gradient's descent orthant,
- the orthant projection of every line-search trial point: a coordinate
  that crosses zero is clamped to zero, which is what makes exact zeros.

As :func:`~photon_ml_tpu_torch.optimize.lbfgs.minimize_lbfgs`, every lane
steps together and a lane whose loop has ended keeps its whole state
(``jax.vmap``'s semantics), so the lambdas of a batched sweep share each
evaluation (kernel 4 on a dense design). The two-loop recursion and the
line-search constants are L-BFGS's, and as there the host reads are handed
to a driver (:func:`owlqn_steps`).
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.optimize.common import (
    OptimizerConfig,
    OptimizerResult,
    Steps,
    armijo_backtracking,
    init_trace,
    record_trace,
    run_alone,
    update_history,
)
from photon_ml_tpu_torch.optimize.lbfgs import (
    _ARMIJO_C1,
    _EPS,
    _dot,
    two_loop_direction,
)

Tensor = torch.Tensor


def pseudo_gradient(w: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """Sub-gradient selection for f(w) + ||l1 * w||_1 (Andrew & Gao eq. 4)."""
    right = g + l1  # derivative moving toward +
    left = g - l1  # derivative moving toward -
    zero = torch.zeros_like(g)
    pg_zero = torch.where(right < 0, right, torch.where(left > 0, left, zero))
    return torch.where(w > 0, right, torch.where(w < 0, left, pg_zero))


def _l1_norm(w: Tensor, l1: Tensor) -> Tensor:
    return (l1 * w.abs()).sum(-1)


def minimize_owlqn(fun, w0: Tensor, l1_weight,
                   config: OptimizerConfig = OptimizerConfig()
                   ) -> OptimizerResult:
    """Minimize ``fun(w) + ||l1_weight * w||_1`` on every lane from ``w0``
    ``(L, d)``.

    ``fun(w (L, d)) -> (values (L,), grads (L, d))`` is the smooth part
    only (loss + L2), lane l's depending on ``w[l]`` alone. ``l1_weight``
    broadcasts against ``w0``: a number, a ``(d,)`` weight per coordinate
    (0 exempts one, e.g. the intercept), an ``(L, 1)`` weight per lane (one
    lambda per lane) or a full ``(L, d)``. ``grad_norm``/``grad_norms`` are
    the pseudo-gradient's norms.
    """
    return run_alone(owlqn_steps(fun, w0, l1_weight, config))


def owlqn_steps(fun, w0: Tensor, l1_weight,
                config: OptimizerConfig = OptimizerConfig()) -> Steps:
    """:func:`minimize_owlqn` as a member of
    :func:`~photon_ml_tpu_torch.optimize.common.drive`."""
    m, d = config.history, w0.shape[-1]
    lanes = w0.shape[0]
    dev, dt = w0.device, w0.dtype
    l1 = torch.broadcast_to(torch.as_tensor(l1_weight, dtype=dt, device=dev),
                            w0.shape)

    f0_s, g0 = fun(w0)
    f0 = f0_s + _l1_norm(w0, l1)
    pg0 = pseudo_gradient(w0, g0, l1)
    pgnorm0 = torch.linalg.vector_norm(pg0, dim=-1)
    values, gnorms = init_trace(config, f0, pgnorm0)
    tol = config.tolerance * torch.clamp(pgnorm0, min=1.0)
    state = dict(
        w=w0, f=f0, g=g0, pg=pg0,
        s_hist=torch.zeros((lanes, m, d), dtype=dt, device=dev),
        y_hist=torch.zeros((lanes, m, d), dtype=dt, device=dev),
        rho=torch.zeros((lanes, m), dtype=dt, device=dev),
        n_pairs=torch.zeros(lanes, dtype=torch.int64, device=dev),
        it=torch.zeros(lanes, dtype=torch.int64, device=dev),
        converged=pgnorm0 <= tol,
        failed=torch.zeros(lanes, dtype=torch.bool, device=dev),
        stalls=torch.zeros(lanes, dtype=torch.int64, device=dev),
        values=values, grad_norms=gnorms)

    while True:
        s = state
        active = (~s["converged"]) & (~s["failed"]) & (
            s["it"] < config.max_iterations)
        if not (yield active.any()):
            break
        w, pg = s["w"], s["pg"]
        d_dir = two_loop_direction(pg, s["s_hist"], s["y_hist"], s["rho"],
                                   s["n_pairs"], m)
        # align with the pseudo-gradient's descent orthant: keep the
        # components where d and -pg agree in sign
        d_dir = torch.where(d_dir * pg < 0, d_dir, torch.zeros_like(d_dir))
        # steepest descent on a degenerate direction
        degenerate = _dot(d_dir, pg) >= 0
        d_dir = torch.where(degenerate[:, None], -pg, d_dir)
        # the orthant of each coordinate: sign(w), or sign(-pg) at a zero
        xi = torch.where(w != 0, torch.sign(w), torch.sign(-pg))
        dnorm = torch.linalg.vector_norm(d_dir, dim=-1)
        alpha0 = torch.where(s["n_pairs"] > 0, torch.ones_like(dnorm),
                             1.0 / torch.clamp(dnorm, min=1.0))

        def trial(alpha):
            w_t = w + alpha[:, None] * d_dir
            # orthant projection
            w_t = torch.where(torch.sign(w_t) == xi, w_t,
                              torch.zeros_like(w_t))
            f_s, g_t = fun(w_t)
            return w_t, f_s + _l1_norm(w_t, l1), g_t

        def sufficient(alpha, w_t, f_t):
            # Armijo on the projected step, directional derivative pg·(w_t - w)
            return f_t <= s["f"] + _ARMIJO_C1 * _dot(pg, w_t - w)

        _, w_new, f_new, g_new, ok = yield from armijo_backtracking(
            trial, sufficient, alpha0, config.max_line_search, active)
        # curvature pairs from smooth-gradient differences
        s_hist, y_hist, rho, n_pairs = update_history(
            s["s_hist"], s["y_hist"], s["rho"], s["n_pairs"], w_new - w,
            g_new - s["g"], ok, _EPS)
        pg_new = pseudo_gradient(w_new, g_new, l1)
        pgnorm = torch.linalg.vector_norm(pg_new, dim=-1)
        it = s["it"] + 1
        values, gnorms = record_trace(
            s["values"], s["grad_norms"], it,
            torch.where(ok, f_new, s["f"]),
            torch.where(ok, pgnorm, torch.linalg.vector_norm(pg, dim=-1)))
        # stall: two accepted steps in a row without representable decrease
        stalls = torch.where(ok & (f_new >= s["f"]), s["stalls"] + 1,
                             torch.zeros_like(s["stalls"]))
        okc = ok[:, None]
        new = dict(
            w=torch.where(okc, w_new, w),
            f=torch.where(ok, f_new, s["f"]),
            g=torch.where(okc, g_new, s["g"]),
            pg=torch.where(okc, pg_new, pg),
            s_hist=s_hist, y_hist=y_hist, rho=rho, n_pairs=n_pairs, it=it,
            converged=ok & (pgnorm <= tol),
            failed=(~ok) | (stalls >= 2),
            stalls=stalls, values=values, grad_norms=gnorms)
        # vmap semantics: a lane whose loop has ended keeps its whole state
        state = {k: torch.where(active.view((-1,) + (1,) * (v.dim() - 1)),
                                v, s[k])
                 for k, v in new.items()}

    s = state
    return OptimizerResult(
        w=s["w"], value=s["f"],
        grad_norm=torch.linalg.vector_norm(s["pg"], dim=-1),
        iterations=s["it"], converged=s["converged"],
        values=s["values"], grad_norms=s["grad_norms"])
