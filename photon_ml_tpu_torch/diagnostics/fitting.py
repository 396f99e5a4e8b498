"""Fitting (learning-curve) diagnostic: metric vs training-set fraction.

Counterpart of ``photon_ml_tpu/diagnostics/fitting.py`` (the reference's
``FittingDiagnostic``): train on growing portions of the training data and
report the training and validation objective at each portion (a widening
gap reads as variance, both flat and poor as bias).

A portion is a weight mask: the samples are shuffled once and portion p
keeps the first ``ceil(p·n)`` shuffled positions, so the portions are
nested prefixes of one permutation. The design is untouched and all
portions run as lanes of one batched solve, each lane with its own weight
vector (on a dense design: one kernel-1 launch per lane and evaluation;
kernel 4 is not reached). The shuffle comes from an explicit
``torch.Generator``; :func:`fitting_curve` also takes the masks as an
argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.glm.problem import OptimizationProblem
from photon_ml_tpu_torch.ops.design import accumulation_dtype
from photon_ml_tpu_torch.ops.objective import GLMData

DEFAULT_PORTIONS = (0.25, 0.5, 0.75, 1.0)


@dataclasses.dataclass(frozen=True)
class FittingReport:
    """Aligned arrays over the swept portions."""

    portions: np.ndarray          # (P,) fraction of training data used
    train_objective: np.ndarray   # (P,) mean per-weight training loss
    validation_objective: np.ndarray  # (P,) mean per-weight validation loss
    coefficients: np.ndarray      # (P, d)

    def generalization_gap(self) -> np.ndarray:
        return self.validation_objective - self.train_objective


def portion_masks(n: int, portions: Sequence[float] = DEFAULT_PORTIONS,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """``(P, n)`` keep masks: one uniform shuffle of the n samples, portion
    p keeping the first ``ceil(p·n)`` shuffled positions."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(7)
    u = torch.rand(n, generator=generator, device=device)
    rank = torch.argsort(torch.argsort(u))
    fractions = torch.as_tensor(list(portions), dtype=torch.float64,
                                device=device)
    return rank[None, :] < torch.ceil(fractions[:, None] * n)


def fitting_curve(
    problem: OptimizationProblem,
    train: GLMData,
    validation: GLMData,
    w0: torch.Tensor,
    lam=0.0,
    portions: Sequence[float] = DEFAULT_PORTIONS,
    generator: Optional[torch.Generator] = None,
    masks=None,
) -> FittingReport:
    """Train at each portion (lanes of one batched solve, from ``w0``) and
    evaluate the unregularized mean objective on the used training subset
    and on the whole validation set. ``masks`` ``(P, n)`` replaces the
    shuffle drawn from ``generator``."""
    device = train.weights.device
    n = train.n_samples
    if masks is None:
        keep = portion_masks(n, portions, generator, device)
    else:
        if not isinstance(masks, torch.Tensor):
            masks = torch.from_numpy(np.array(masks, copy=True))
        keep = masks.to(dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=train.weights.dtype, device=device)
    weights = torch.where(keep, train.weights[None, :], zero).contiguous()
    sub = dataclasses.replace(train, weights=weights)
    lanes = weights.shape[0]
    dt = accumulation_dtype(train.design.dtype)
    start = w0.detach().to(dtype=dt, device=device)
    start = start.expand(lanes, -1).contiguous()
    obj = problem.objective
    ws = problem.run(sub, start, lam).w
    wsum = torch.clamp(weights.sum(-1), min=1e-30)
    train_loss = obj.value(ws, sub, 0.0) / wsum
    vsum = torch.clamp(validation.weights.sum(), min=1e-30)
    val_loss = obj.value(ws, validation, 0.0) / vsum
    return FittingReport(
        portions=np.asarray(list(portions), np.float64),
        train_objective=train_loss.detach().cpu().numpy().astype(np.float64),
        validation_objective=val_loss.detach().cpu().numpy().astype(
            np.float64),
        coefficients=ws.detach().cpu().numpy(),
    )
