"""Stationary GP covariance kernels (reference
``photon-lib/.../hyperparameter/kernels/{RBF, Matern52}.scala``).

Kernels carry an amplitude and per-dimension lengthscales; ``theta`` packs
``[log_amplitude, log_noise, log_lengthscale_1..d]`` for the slice sampler.

A copy of ``photon_ml_tpu/hyperparameter/kernels.py`` (host numpy; the port
imports nothing of the JAX package): both packages draw the same points for
the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _scaled_sqdist(x1: np.ndarray, x2: np.ndarray, ls: np.ndarray) -> np.ndarray:
    a = x1 / ls
    b = x2 / ls
    return np.maximum(
        (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T, 0.0)


@dataclasses.dataclass(frozen=True)
class RBF:
    amplitude: float = 1.0
    lengthscales: np.ndarray = None  # (d,)

    def __call__(self, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        ls = (np.ones(x1.shape[1]) if self.lengthscales is None
              else np.asarray(self.lengthscales))
        return self.amplitude * np.exp(-0.5 * _scaled_sqdist(x1, x2, ls))

    def with_params(self, amplitude: float, lengthscales: np.ndarray) -> "RBF":
        return RBF(amplitude=amplitude, lengthscales=lengthscales)


@dataclasses.dataclass(frozen=True)
class Matern52:
    """Matérn ν=5/2 — the reference's default tuning kernel."""

    amplitude: float = 1.0
    lengthscales: np.ndarray = None

    def __call__(self, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        ls = (np.ones(x1.shape[1]) if self.lengthscales is None
              else np.asarray(self.lengthscales))
        r2 = _scaled_sqdist(x1, x2, ls)
        r = np.sqrt(np.maximum(r2, 1e-32))
        s5r = np.sqrt(5.0) * r
        return self.amplitude * (1.0 + s5r + 5.0 * r2 / 3.0) * np.exp(-s5r)

    def with_params(self, amplitude: float, lengthscales: np.ndarray) -> "Matern52":
        return Matern52(amplitude=amplitude, lengthscales=lengthscales)
