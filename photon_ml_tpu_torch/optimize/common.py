"""Shared optimizer configuration, result, line search and curvature history.

Counterpart of ``photon_ml_tpu/optimize/common.py``, written BATCHED over a
leading lane dimension: a fixed-effect solve is one lane, a random-effect
bucket one lane per entity. This replaces ``jax.vmap`` over the JAX
package's ``lax.while_loop``s and keeps its semantics: a lane whose loop
condition is false keeps its whole state; an inner loop runs while any lane
still needs it, and only those lanes take its new values.

Convergence follows the reference: gradient-norm tolerance relative to the
initial gradient norm, and an iteration cap.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer settings (the reference's ``OptimizerConfig`` defaults:
    tolerance 1e-6 relative gradient norm, L-BFGS history 10)."""

    max_iterations: int = 80
    tolerance: float = 1e-6
    history: int = 10
    max_line_search: int = 25
    cg_max_iterations: int = 30  # TRON inner CG cap
    track_states: bool = True

    def __post_init__(self) -> None:
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        if self.history < 1:
            raise ValueError("history must be >= 1")
        if not self.tolerance > 0:
            raise ValueError("tolerance must be > 0")


@dataclasses.dataclass(frozen=True)
class OptimizerResult:
    """Per-lane results: ``w`` ``(L, d)``; ``value``, ``grad_norm``,
    ``iterations``, ``converged`` ``(L,)``; ``values``/``grad_norms`` the
    per-iteration traces ``(L, max_iterations + 1)`` padded with +inf (or
    ``(L, 0)`` with ``track_states`` off)."""

    w: Tensor
    value: Tensor
    grad_norm: Tensor
    iterations: Tensor
    converged: Tensor
    values: Tensor
    grad_norms: Tensor


def init_trace(config: OptimizerConfig, f0: Tensor, gnorm0: Tensor):
    lanes = f0.shape[0]
    width = config.max_iterations + 1 if config.track_states else 0
    values = torch.full((lanes, width), float("inf"), dtype=torch.float32,
                        device=f0.device)
    gnorms = values.clone()
    if width:
        values[:, 0] = f0.to(torch.float32)
        gnorms[:, 0] = gnorm0.to(torch.float32)
    return values, gnorms


def record_trace(values: Tensor, gnorms: Tensor, it: Tensor, f: Tensor,
                 gnorm: Tensor):
    if values.shape[1] == 0:  # tracking disabled
        return values, gnorms
    idx = it.long()[:, None]
    return (values.scatter(1, idx, f.to(torch.float32)[:, None]),
            gnorms.scatter(1, idx, gnorm.to(torch.float32)[:, None]))


def armijo_backtracking(trial, sufficient, alpha0: Tensor, max_steps: int,
                        active: Tensor):
    """Halving backtracking search over lanes.

    ``trial(alpha) -> (w_t, f_t, g_t)`` evaluates every lane at its step
    ``alpha`` ``(L,)``; ``sufficient(alpha, w_t, f_t) -> (L,) bool`` is the
    acceptance predicate and must be False for NaN trial values, so an
    overflowing step shrinks. Lanes outside ``active`` never search (the
    caller discards their results). Syncs with the device once per step to
    test whether any lane still searches.
    """
    w_t, f_t, g_t = trial(alpha0)
    alpha = alpha0
    steps = torch.zeros_like(alpha0, dtype=torch.int32)
    while True:
        searching = active & ~sufficient(alpha, w_t, f_t) & (steps < max_steps)
        if not bool(searching.any()):
            break
        half = alpha * 0.5
        w_n, f_n, g_n = trial(half)
        alpha = torch.where(searching, half, alpha)
        w_t = torch.where(searching[:, None], w_n, w_t)
        f_t = torch.where(searching, f_n, f_t)
        g_t = torch.where(searching[:, None], g_n, g_t)
        steps = steps + searching.to(steps.dtype)
    ok = sufficient(alpha, w_t, f_t) & torch.isfinite(f_t)
    return alpha, w_t, f_t, g_t, ok


def update_history(s_hist: Tensor, y_hist: Tensor, rho: Tensor,
                   n_pairs: Tensor, step: Tensor, y: Tensor, accept: Tensor,
                   eps: float = 1e-10):
    """Push each lane's (s, y) curvature pair into its ring buffer when the
    step was accepted and the curvature ``s·y`` is meaningfully positive."""
    m = s_hist.shape[1]
    sy = (step * y).sum(-1)
    store = accept & (sy > eps * torch.linalg.vector_norm(step, dim=-1)
                      * torch.linalg.vector_norm(y, dim=-1))
    pos = torch.remainder(n_pairs, m)
    slot = ((torch.arange(m, device=pos.device)[None, :] == pos[:, None])
            & store[:, None])
    s_hist = torch.where(slot[:, :, None], step[:, None, :], s_hist)
    y_hist = torch.where(slot[:, :, None], y[:, None, :], y_hist)
    inv = 1.0 / torch.clamp(sy, min=eps)
    rho = torch.where(slot, inv[:, None], rho)
    n_pairs = torch.where(store, n_pairs + 1, n_pairs)
    return s_hist, y_hist, rho, n_pairs
