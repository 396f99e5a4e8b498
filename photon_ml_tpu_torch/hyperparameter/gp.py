"""Gaussian-process surrogate with slice-sampled kernel hyperparameters.

Reference: ``photon-lib/.../hyperparameter/estimators/
{GaussianProcessEstimator, GaussianProcessModel}.scala`` — a GP posterior
over (config → metric) observations; kernel amplitude, noise, and per-dim
lengthscales are *marginalized* by slice sampling from their posterior (not
point-optimized), and predictions average over the sampled kernels.

A copy of ``photon_ml_tpu/hyperparameter/gp.py`` (host numpy; the port
imports nothing of the JAX package): both packages draw the same points for
the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.linalg import cho_solve, solve_triangular

from photon_ml_tpu_torch.hyperparameter.kernels import Matern52
from photon_ml_tpu_torch.hyperparameter.sampler import slice_sample

_JITTER = 1e-8


@dataclasses.dataclass(frozen=True)
class _Posterior:
    """One kernel draw's cached Cholesky factors."""

    kernel: object
    noise: float
    x: np.ndarray
    chol: np.ndarray  # lower
    alpha: np.ndarray  # K^-1 (y - mean)
    y_mean: float


@dataclasses.dataclass(frozen=True)
class GaussianProcessModel:
    """Averaged predictive distribution over sampled kernels."""

    posteriors: tuple[_Posterior, ...]

    def predict(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and variance at ``x`` (n, d), averaged over kernel
        samples (a Gaussian mixture; variance via the law of total variance)."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        means, varis = [], []
        for p in self.posteriors:
            k_star = p.kernel(p.x, x)  # (n_obs, n)
            mean = p.y_mean + k_star.T @ p.alpha
            sol = solve_triangular(p.chol, k_star, lower=True)
            # stationary kernel: prior variance is the amplitude everywhere
            prior_var = np.full(x.shape[0], p.kernel.amplitude)
            var = np.maximum(prior_var - (sol * sol).sum(0) + p.noise, 1e-12)
            means.append(mean)
            varis.append(var)
        means = np.stack(means)
        varis = np.stack(varis)
        mean = means.mean(0)
        var = varis.mean(0) + (means ** 2).mean(0) - mean ** 2
        return mean, np.maximum(var, 1e-12)


@dataclasses.dataclass(frozen=True)
class GaussianProcessEstimator:
    """Fits a :class:`GaussianProcessModel` to observed (x, y) points.

    ``theta`` packs ``[log_amp, log_noise, log_ls_1..d]``; the prior is a
    broad log-normal around unit scales (weakly informative on the
    standardized [0,1]^d search box, as in the reference).
    """

    kernel_factory: type = Matern52
    n_kernel_samples: int = 8
    seed: int = 0

    def fit(self, x: np.ndarray, y: np.ndarray) -> GaussianProcessModel:
        x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64).ravel()
        n, d = x.shape
        y_mean = float(y.mean()) if n else 0.0
        yc = y - y_mean
        rng = np.random.default_rng(self.seed + n)

        def factors(theta: np.ndarray):
            amp = np.exp(theta[0])
            noise = np.exp(theta[1])
            if not (1e-6 < amp < 1e6 and 1e-9 < noise < 1e3):
                return None
            kern = self.kernel_factory(amplitude=amp,
                                       lengthscales=np.exp(theta[2:]))
            k = kern(x, x) + (noise + _JITTER) * np.eye(n)
            try:
                chol = np.linalg.cholesky(k)
            except np.linalg.LinAlgError:
                return None
            return kern, noise, chol

        def log_posterior(theta: np.ndarray) -> float:
            f = factors(theta)
            if f is None:
                return -np.inf
            _, _, chol = f
            v = solve_triangular(chol, yc, lower=True)
            log_lik = (-0.5 * (v ** 2).sum() - np.log(np.diag(chol)).sum()
                       - 0.5 * n * np.log(2 * np.pi))
            log_prior = -0.5 * float(theta @ theta) / 4.0  # N(0, 2^2) on logs
            return float(log_lik) + log_prior

        theta0 = np.zeros(d + 2)
        theta0[1] = np.log(0.1)
        samples = slice_sample(log_posterior, theta0, rng,
                               self.n_kernel_samples, burn_in=20)

        posteriors = []
        for theta in samples:
            f = factors(theta)
            if f is None:
                continue
            kern, noise, chol = f
            alpha = cho_solve((chol, True), yc)
            posteriors.append(_Posterior(
                kernel=kern, noise=noise, x=x, chol=chol,
                alpha=alpha, y_mean=y_mean))
        if not posteriors:
            raise RuntimeError("GP fit failed: no valid kernel samples")
        return GaussianProcessModel(posteriors=tuple(posteriors))
