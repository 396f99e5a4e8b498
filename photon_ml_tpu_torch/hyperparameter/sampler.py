"""Univariate-step slice sampler over log-posterior densities
(reference ``photon-lib/.../hyperparameter/sampler/SliceSampler.scala``).

Coordinate-wise slice sampling with step-out: the standard scheme used to
marginalize GP kernel hyperparameters instead of point-optimizing them.

A copy of ``photon_ml_tpu/hyperparameter/sampler.py`` (host numpy; the port
imports nothing of the JAX package): both packages draw the same points for
the same seed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def slice_sample(
    log_density: Callable[[np.ndarray], float],
    x0: np.ndarray,
    rng: np.random.Generator,
    n_samples: int,
    *,
    width: float = 1.0,
    max_step_out: int = 8,
    burn_in: int = 10,
) -> np.ndarray:
    """Draw ``n_samples`` points (after ``burn_in``) from ``exp(log_density)``.

    Coordinate-wise: each scan updates every dimension once via step-out +
    shrink. Returns an ``(n_samples, d)`` array.
    """
    x = np.array(x0, np.float64)
    d = x.shape[0]
    fx = log_density(x)
    out = np.empty((n_samples, d))
    kept = 0
    for it in range(burn_in + n_samples):
        for j in range(d):
            log_y = fx + np.log(rng.uniform(1e-300, 1.0))
            lo = x[j] - width * rng.uniform()
            hi = lo + width
            for _ in range(max_step_out):
                if _eval_at(log_density, x, j, lo) <= log_y:
                    break
                lo -= width
            for _ in range(max_step_out):
                if _eval_at(log_density, x, j, hi) <= log_y:
                    break
                hi += width
            while True:
                xj = rng.uniform(lo, hi)
                f_new = _eval_at(log_density, x, j, xj)
                if f_new > log_y:
                    x[j] = xj
                    fx = f_new
                    break
                if xj < x[j]:
                    lo = xj
                else:
                    hi = xj
                if hi - lo < 1e-12:  # degenerate slice; keep current point
                    fx = log_density(x)
                    break
        if it >= burn_in:
            out[kept] = x
            kept += 1
    return out


def _eval_at(log_density, x, j, val) -> float:
    x2 = x.copy()
    x2[j] = val
    return log_density(x2)
