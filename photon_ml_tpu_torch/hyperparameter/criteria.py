"""Acquisition criteria (reference
``photon-lib/.../hyperparameter/criteria/ExpectedImprovement.scala``).

A copy of ``photon_ml_tpu/hyperparameter/criteria.py`` (host numpy; the port
imports nothing of the JAX package): both packages draw the same points for
the same seed.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm


def expected_improvement(mean: np.ndarray, var: np.ndarray,
                         best: float, *, maximize: bool = True) -> np.ndarray:
    """EI of candidate points given GP posterior (mean, var) and incumbent.

    ``maximize`` gives the metric direction (AUC ↑, RMSE ↓); EI itself is
    always maximized by the search.
    """
    std = np.sqrt(var)
    imp = (mean - best) if maximize else (best - mean)
    z = imp / std
    return imp * norm.cdf(z) + std * norm.pdf(z)
