"""Bootstrap training diagnostic: coefficient confidence intervals.

Counterpart of ``photon_ml_tpu/diagnostics/bootstrap.py`` (the reference's
``BootstrapTrainingDiagnostic``): train B models on bootstrap resamples of
the training data and summarize the per-coefficient distribution (mean,
std, percentile confidence bounds, sign stability).

Each replicate is a multinomial reweighting of the samples (counts
``c ~ Multinomial(n, uniform over the live rows)`` multiply the original
weights), so the design is shared and the B solves run as B lanes of one
batched solve of :meth:`~photon_ml_tpu_torch.glm.problem.
OptimizationProblem.run`, warm-started from the point estimate. Each lane
carries its own weight vector, so on a dense design every objective
evaluation is one kernel-1 launch per lane (and under TRON every CG
product one kernel-3 launch per lane); kernel 4, which shares one weight
vector across its lanes, is not reached. The draws come from an explicit
``torch.Generator``; they cannot reproduce the JAX package's
``jax.random`` draws, so :func:`bootstrap_coefficients` also takes the
replicate weights as an argument.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.glm.problem import OptimizationProblem
from photon_ml_tpu_torch.ops.design import accumulation_dtype
from photon_ml_tpu_torch.ops.objective import GLMData


@dataclasses.dataclass(frozen=True)
class BootstrapReport:
    """Per-coefficient bootstrap distribution summary.

    All arrays are ``(d,)`` except ``coefficients``, which is ``(B, d)``
    (kept so callers can compute further statistics).
    """

    coefficients: np.ndarray
    mean: np.ndarray
    std: np.ndarray
    ci_lower: np.ndarray
    ci_upper: np.ndarray
    #: fraction of replicates whose coefficient sign matches the point
    #: estimate's sign
    sign_stability: np.ndarray
    confidence_level: float
    n_replicates: int

    def zero_crossing(self) -> np.ndarray:
        """True where the CI straddles zero (coefficient not significant)."""
        return (self.ci_lower <= 0.0) & (self.ci_upper >= 0.0)


def bootstrap_weights(base_weights: torch.Tensor, n_replicates: int,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """``(B, n)`` multinomial bootstrap reweighting of per-sample weights,
    drawn where ``base_weights`` lies. Padding rows (weight 0) never get a
    count: each replicate makes n draws over the live rows, so its counts
    sum to n (as the JAX package's draws do)."""
    n = base_weights.shape[0]
    live = (base_weights > 0).to(torch.float32)
    if generator is None:
        generator = torch.Generator(device=base_weights.device).manual_seed(0)
    draws = torch.multinomial(live.expand(n_replicates, n), n,
                              replacement=True, generator=generator)
    counts = torch.zeros((n_replicates, n), dtype=torch.float32,
                         device=base_weights.device)
    # integer counts: the scatter's order cannot change them
    counts.scatter_add_(1, draws, torch.ones_like(counts))
    return counts.to(base_weights.dtype) * base_weights


def bootstrap_coefficients(
    problem: OptimizationProblem,
    data: GLMData,
    w_point: torch.Tensor,
    lam=0.0,
    n_replicates: int = 16,
    confidence_level: float = 0.95,
    generator: Optional[torch.Generator] = None,
    transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    replicate_weights=None,
) -> BootstrapReport:
    """Run the bootstrap diagnostic: B reweighted solves as lanes of one
    batched solve, each from ``w_point`` (the trained point estimate:
    bootstrap optima are near it). ``transform`` maps each replicate
    solution (and the point estimate) to reporting space, e.g.
    ``NormalizationContext.model_to_original``. ``replicate_weights``
    ``(B, n)`` replaces the draw from ``generator``."""
    device = data.weights.device
    if replicate_weights is None:
        rep_weights = bootstrap_weights(data.weights, n_replicates,
                                        generator)
    else:
        if not isinstance(replicate_weights, torch.Tensor):
            replicate_weights = torch.from_numpy(
                np.array(replicate_weights, copy=True))
        rep_weights = replicate_weights.to(dtype=data.weights.dtype,
                                           device=device)
        n_replicates = int(rep_weights.shape[0])
    rep = dataclasses.replace(data, weights=rep_weights.contiguous())
    dt = accumulation_dtype(data.design.dtype)
    w0 = w_point.detach().to(dtype=dt, device=device)
    w0 = w0.expand(n_replicates, -1).contiguous()
    ws = problem.run(rep, w0, lam).w
    if transform is not None:
        ws = transform(ws)
        w_point = transform(w_point)
    ws = ws.detach().cpu().numpy()
    point = w_point.detach().cpu().numpy()

    alpha = (1.0 - confidence_level) / 2.0
    lo, hi = np.percentile(ws, [100 * alpha, 100 * (1 - alpha)], axis=0)
    stability = np.mean(np.sign(ws) == np.sign(point)[None, :], axis=0)
    return BootstrapReport(
        coefficients=ws,
        mean=ws.mean(axis=0),
        std=(ws.std(axis=0, ddof=1) if n_replicates > 1
             else np.zeros(ws.shape[1])),
        ci_lower=lo,
        ci_upper=hi,
        sign_stability=stability,
        confidence_level=confidence_level,
        n_replicates=n_replicates,
    )
