"""L-BFGS batched over a leading lane dimension.

Counterpart of ``photon_ml_tpu/optimize/lbfgs.py`` with the same algorithm,
not only the same optimum: a masked two-loop recursion over an m-pair ring
buffer with the curvature test, first-step scaling by ``1/max(||d||, 1)``,
a steepest-descent safeguard on a non-descent direction, Armijo halving,
and exit after two consecutive accepted steps without decrease.

The JAX package runs one ``lax.while_loop`` per lane under ``jax.vmap``;
here every lane steps together and a lane whose loop condition is false
keeps its whole state, its iteration count included — vmap's semantics. A
fixed-effect solve is one lane; a random-effect bucket is one lane per
entity. The loop tests on the host whether any lane is still running: one
device sync per iteration (and per extra line-search step).
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.optimize.common import (
    OptimizerConfig,
    OptimizerResult,
    armijo_backtracking,
    init_trace,
    record_trace,
    update_history,
)

Tensor = torch.Tensor

_EPS = 1e-10
_ARMIJO_C1 = 1e-4


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def two_loop_direction(g: Tensor, s_hist: Tensor, y_hist: Tensor,
                       rho: Tensor, n_pairs: Tensor, history: int) -> Tensor:
    """Masked two-loop recursion per lane; returns ``-H g`` ``(L, d)``."""
    m = history
    lanes = torch.arange(g.shape[0], device=g.device)
    valid = torch.clamp(n_pairs, max=m)
    q = g
    saved = []
    for k in range(m):  # k = 0 is the newest pair
        i = torch.remainder(n_pairs - 1 - k, m)
        s_i, y_i, rho_i = s_hist[lanes, i], y_hist[lanes, i], rho[lanes, i]
        use = k < valid
        a = torch.where(use, rho_i * _dot(s_i, q), torch.zeros_like(rho_i))
        q = q - a[:, None] * y_i
        saved.append((s_i, y_i, rho_i, use, a))
    # initial Hessian scaling gamma = s·y / y·y of the newest pair
    s0, y0 = saved[0][0], saved[0][1]
    yy, sy = _dot(y0, y0), _dot(s0, y0)
    gamma = torch.where((valid > 0) & (yy > _EPS),
                        sy / torch.clamp(yy, min=_EPS), torch.ones_like(yy))
    r = gamma[:, None] * q
    for s_i, y_i, rho_i, use, a in reversed(saved):
        b = torch.where(use, rho_i * _dot(y_i, r), torch.zeros_like(rho_i))
        r = r + (a - b)[:, None] * s_i
    return -r


def backtracking_line_search(fun, w: Tensor, f: Tensor, g: Tensor,
                             d: Tensor, alpha0: Tensor, max_steps: int,
                             active: Tensor):
    """Armijo backtracking per lane; ``(alpha, f_new, g_new, w_new, ok)``."""
    gd = _dot(g, d)

    def trial(alpha):
        w_t = w + alpha[:, None] * d
        f_t, g_t = fun(w_t)
        return w_t, f_t, g_t

    def sufficient(alpha, w_t, f_t):
        return f_t <= f + _ARMIJO_C1 * alpha * gd

    alpha, w_new, f_new, g_new, ok = armijo_backtracking(
        trial, sufficient, alpha0, max_steps, active)
    return alpha, f_new, g_new, w_new, ok


def minimize_lbfgs(fun, w0: Tensor,
                   config: OptimizerConfig = OptimizerConfig()
                   ) -> OptimizerResult:
    """Minimize every lane of ``fun`` from ``w0`` ``(L, d)``.

    ``fun(w (L, d)) -> (values (L,), grads (L, d))``; lane l's objective
    must depend on ``w[l]`` only.
    """
    m, d = config.history, w0.shape[-1]
    lanes = w0.shape[0]
    f0, g0 = fun(w0)
    gnorm0 = torch.linalg.vector_norm(g0, dim=-1)
    values, gnorms = init_trace(config, f0, gnorm0)
    tol = config.tolerance * torch.clamp(gnorm0, min=1.0)
    dev, dt = w0.device, w0.dtype
    state = dict(
        w=w0, f=f0, g=g0,
        s_hist=torch.zeros((lanes, m, d), dtype=dt, device=dev),
        y_hist=torch.zeros((lanes, m, d), dtype=dt, device=dev),
        rho=torch.zeros((lanes, m), dtype=dt, device=dev),
        n_pairs=torch.zeros(lanes, dtype=torch.int64, device=dev),
        it=torch.zeros(lanes, dtype=torch.int64, device=dev),
        converged=gnorm0 <= tol,
        failed=torch.zeros(lanes, dtype=torch.bool, device=dev),
        stalls=torch.zeros(lanes, dtype=torch.int64, device=dev),
        values=values, grad_norms=gnorms)

    while True:
        s = state
        active = (~s["converged"]) & (~s["failed"]) & (
            s["it"] < config.max_iterations)
        if not bool(active.any()):
            break
        d_dir = two_loop_direction(s["g"], s["s_hist"], s["y_hist"], s["rho"],
                                   s["n_pairs"], m)
        # safeguard: steepest descent on a non-descent direction
        descent = _dot(s["g"], d_dir) < 0
        d_dir = torch.where(descent[:, None], d_dir, -s["g"])
        # the first step scales by 1/||d||, later steps start at 1
        dnorm = torch.linalg.vector_norm(d_dir, dim=-1)
        alpha0 = torch.where(s["n_pairs"] > 0, torch.ones_like(dnorm),
                             1.0 / torch.clamp(dnorm, min=1.0))
        _, f_new, g_new, w_new, ok = backtracking_line_search(
            fun, s["w"], s["f"], s["g"], d_dir, alpha0,
            config.max_line_search, active)
        s_hist, y_hist, rho, n_pairs = update_history(
            s["s_hist"], s["y_hist"], s["rho"], s["n_pairs"], w_new - s["w"],
            g_new - s["g"], ok, _EPS)
        it = s["it"] + 1
        gnorm = torch.linalg.vector_norm(g_new, dim=-1)
        # record only accepted iterates
        values, gnorms = record_trace(
            s["values"], s["grad_norms"], it,
            torch.where(ok, f_new, s["f"]),
            torch.where(ok, gnorm,
                        torch.linalg.vector_norm(s["g"], dim=-1)))
        # stall: an accepted step without representable decrease; two in a
        # row end the lane (convergence is judged by the gradient alone)
        stalls = torch.where(ok & (f_new >= s["f"]), s["stalls"] + 1,
                             torch.zeros_like(s["stalls"]))
        okc = ok[:, None]
        new = dict(
            w=torch.where(okc, w_new, s["w"]),
            f=torch.where(ok, f_new, s["f"]),
            g=torch.where(okc, g_new, s["g"]),
            s_hist=s_hist, y_hist=y_hist, rho=rho, n_pairs=n_pairs, it=it,
            converged=ok & (gnorm <= tol),
            failed=(~ok) | (stalls >= 2),
            stalls=stalls, values=values, grad_norms=gnorms)
        # vmap semantics: a lane whose loop has ended keeps its whole state
        state = {k: torch.where(active.view((-1,) + (1,) * (v.dim() - 1)),
                                v, s[k])
                 for k, v in new.items()}

    s = state
    return OptimizerResult(
        w=s["w"], value=s["f"],
        grad_norm=torch.linalg.vector_norm(s["g"], dim=-1),
        iterations=s["it"], converged=s["converged"],
        values=s["values"], grad_norms=s["grad_norms"])
