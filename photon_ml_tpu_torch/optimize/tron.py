"""TRON: trust-region Newton with conjugate-gradient inner solves, batched
over a leading lane dimension.

Counterpart of ``photon_ml_tpu/optimize/tron.py`` (the reference's port of
LIBLINEAR's TRON) with the same algorithm, not only the same optimum: the
LIBLINEAR radius constants and update, a Steihaug CG that tracks the
model reduction ``prered`` incrementally (no extra Hessian-vector product
per Newton step), a NaN-safe actual reduction, ``delta = min(delta,
||s||)`` on the first iteration, and a ``stuck`` exit when the radius
vanishes.

The JAX package runs both loops as ``lax.while_loop``s under ``jax.vmap``;
here every lane steps together and keeps vmap's semantics. A lane whose
outer condition is false keeps its whole state; the CG loop runs while any
lane still iterates and only those lanes take the new values. One lane
serves a GLM or a GAME fixed effect, M lanes a batched lambda sweep, E
lanes a random-effect bucket. Both loops test on the host whether any lane
still runs: one read per CG step and per Newton step, handed to a driver
(:func:`tron_steps`).
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.optimize.common import (
    OptimizerConfig,
    OptimizerResult,
    Steps,
    init_trace,
    record_trace,
    run_alone,
)

Tensor = torch.Tensor

# LIBLINEAR tron.cpp trust-region update constants (mirrored by the
# reference's TRON.scala).
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
_CG_TOL = 0.1  # inner CG stops at ||r|| <= 0.1 * ||g||


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _norm(a: Tensor) -> Tensor:
    return torch.linalg.vector_norm(a, dim=-1)


def _nonzero(a: Tensor) -> Tensor:
    """``a`` where it is > 0, else 1: a safe divisor."""
    return torch.where(a > 0, a, torch.ones_like(a))


def _trcg(hvp, g: Tensor, delta: Tensor, max_cg: int, active: Tensor):
    """Steihaug truncated CG per lane: approximately solve ``H s = -g``
    within ``||s|| <= delta``. Returns ``(s, prered)`` with ``prered =
    -(g·s + 0.5 s·Hs)``, tracked from the CG internals (interior step:
    ``q -= 0.5·alpha·r·r``; boundary step: ``q += -tau·r·r +
    0.5·tau²·p·Hp``, using ``r·p = r·r``). Lanes outside ``active`` start
    done and keep ``s = 0``. A generator (``yield from`` it)."""
    cg_tol = _CG_TOL * _norm(g)
    r = -g
    rr = _dot(r, r)
    st = dict(s=torch.zeros_like(g), r=r, p=r, rr=rr,
              q=torch.zeros_like(rr),
              i=torch.zeros(g.shape[0], dtype=torch.int32, device=g.device),
              done=(_norm(r) <= cg_tol) | ~active)
    while True:
        running = ~st["done"] & (st["i"] < max_cg)
        if not (yield running.any()):
            break
        s, r, p, rr, q = st["s"], st["r"], st["p"], st["rr"], st["q"]
        hp = hvp(p)
        php = _dot(p, hp)
        alpha = rr / _nonzero(php)
        s_next = s + alpha[:, None] * p
        crossed = (_norm(s_next) > delta) | (php <= 0)

        # backtrack to the trust-region boundary along p
        ps, pp, ss = _dot(p, s), _dot(p, p), _dot(s, s)
        disc = ps * ps + pp * (delta * delta - ss)
        tau = (-ps + torch.sqrt(torch.clamp(disc, min=0.0))) / _nonzero(pp)
        s_bound = s + tau[:, None] * p

        q_interior = q - 0.5 * alpha * rr
        q_bound = q - tau * rr + 0.5 * tau * tau * php

        r_new = r - alpha[:, None] * hp
        rr_new = _dot(r_new, r_new)
        beta = rr_new / _nonzero(rr)
        c = crossed[:, None]
        new = dict(
            s=torch.where(c, s_bound, s_next),
            r=torch.where(c, r, r_new),
            p=r_new + beta[:, None] * p,
            rr=torch.where(crossed, rr, rr_new),
            q=torch.where(crossed, q_bound, q_interior),
            i=st["i"] + 1,
            done=crossed | (torch.sqrt(rr_new) <= cg_tol))
        st = {k: torch.where(running.view((-1,) + (1,) * (v.dim() - 1)),
                             v, st[k])
              for k, v in new.items()}
    return st["s"], -st["q"]


def minimize_tron(fun, hvp_at, w0: Tensor,
                  config: OptimizerConfig = OptimizerConfig()
                  ) -> OptimizerResult:
    """Trust-region Newton minimization of every lane of ``fun`` from
    ``w0`` ``(L, d)``.

    ``fun(w (L, d)) -> (values (L,), grads (L, d))``; lane l's objective
    must depend on ``w[l]`` only. ``hvp_at(w) -> (v -> Hv)`` returns the
    exact Hessian-vector operator at ``w`` (products ``(L, d)``). It is
    built once per Newton step, so work that depends only on ``w`` (a GLM's
    curvature pass over the design) runs once per step, not once per CG
    product; the JAX package's per-call ``hvp(w, v)`` is
    ``lambda w: lambda v: hvp(w, v)``.
    """
    return run_alone(tron_steps(fun, hvp_at, w0, config))


def tron_steps(fun, hvp_at, w0: Tensor,
               config: OptimizerConfig = OptimizerConfig()) -> Steps:
    """:func:`minimize_tron` as a member of
    :func:`~photon_ml_tpu_torch.optimize.common.drive`."""
    f0, g0 = fun(w0)
    gnorm0 = _norm(g0)
    values, gnorms = init_trace(config, f0, gnorm0)
    tol = config.tolerance * torch.clamp(gnorm0, min=1.0)
    lanes, dev = w0.shape[0], w0.device
    state = dict(
        w=w0, f=f0, g=g0, delta=gnorm0,
        it=torch.zeros(lanes, dtype=torch.int32, device=dev),
        converged=gnorm0 <= tol,
        failed=torch.zeros(lanes, dtype=torch.bool, device=dev),
        values=values, grad_norms=gnorms)

    while True:
        s = state
        active = (~s["converged"]) & (~s["failed"]) & (
            s["it"] < config.max_iterations)
        if not (yield active.any()):
            break
        w = s["w"]
        step, prered = yield from _trcg(hvp_at(w), s["g"], s["delta"],
                             config.cg_max_iterations, active)
        snorm = _norm(step)
        w_new = w + step
        f_new, g_new = fun(w_new)

        gs = _dot(s["g"], step)
        finite = torch.isfinite(f_new)
        # NaN-safe actual reduction: a non-finite trial value behaves like
        # "no reduction", so the radius shrinks and the lane recovers
        actred = torch.where(finite, s["f"] - f_new,
                             torch.full_like(f_new, -torch.inf))

        # LIBLINEAR step-size interpolation for the radius update
        denom = f_new - s["f"] - gs
        interp = torch.clamp(
            -0.5 * (gs / torch.where(denom == 0, torch.ones_like(denom),
                                     denom)), min=_SIGMA1)
        alpha = torch.where(
            torch.isfinite(denom) & (denom > 0), interp,
            torch.where(finite, torch.full_like(denom, _SIGMA3),
                        torch.full_like(denom, _SIGMA1)))
        delta = s["delta"]
        # on the very first iteration LIBLINEAR shrinks delta to min(delta, ||s||)
        delta = torch.where(s["it"] == 0, torch.minimum(delta, snorm), delta)
        a_s = alpha * snorm
        delta = torch.where(
            actred < _ETA0 * prered,
            torch.minimum(torch.clamp(alpha, min=_SIGMA1) * snorm,
                          _SIGMA2 * delta),
            torch.where(
                actred < _ETA1 * prered,
                torch.maximum(_SIGMA1 * delta,
                              torch.minimum(a_s, _SIGMA2 * delta)),
                torch.where(
                    actred < _ETA2 * prered,
                    torch.maximum(_SIGMA1 * delta,
                                  torch.minimum(a_s, _SIGMA3 * delta)),
                    torch.maximum(delta,
                                  torch.minimum(a_s, _SIGMA3 * delta)))))

        accept = (actred > _ETA0 * prered) & finite
        acc = accept[:, None]
        it = s["it"] + 1
        values, gnorms = record_trace(
            s["values"], s["grad_norms"], it,
            torch.where(accept, f_new, s["f"]),
            _norm(torch.where(acc, g_new, s["g"])))
        new = dict(
            w=torch.where(acc, w_new, w),
            f=torch.where(accept, f_new, s["f"]),
            g=torch.where(acc, g_new, s["g"]),
            delta=delta, it=it,
            converged=accept & (_norm(g_new) <= tol),
            # a vanishing radius means no further progress is possible
            failed=delta < 1e-12,
            values=values, grad_norms=gnorms)
        # vmap semantics: a lane whose loop has ended keeps its whole state
        state = {k: torch.where(active.view((-1,) + (1,) * (v.dim() - 1)),
                                v, s[k])
                 for k, v in new.items()}

    s = state
    return OptimizerResult(
        w=s["w"], value=s["f"], grad_norm=_norm(s["g"]),
        iterations=s["it"], converged=s["converged"],
        values=s["values"], grad_norms=s["grad_norms"])
