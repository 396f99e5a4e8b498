"""Pointwise GLM losses: ``l(margin, label)`` plus first/second margin derivatives.

Counterpart of ``photon_ml_tpu/ops/losses.py`` (the reference's
``PointwiseLossFunction`` family): each loss is an elementwise function of
``(margin, label)`` tensors with closed-form ``d1``/``d2`` and the inverse
link ``mean``. The CUDA kernels take the loss as a compile-time switch
(``kernel_id``), so all four are here.

Label conventions: logistic / smoothed hinge take labels in ``{0, 1}``,
linear takes real labels, Poisson non-negative counts (log link).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A per-sample loss ``l(margin, label)`` with margin derivatives.
    ``kernel_id`` is the loss's number in the CUDA kernels' switch."""

    name: str
    kernel_id: int
    loss: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    #: inverse link: margin -> prediction on the response scale
    mean: Callable[[Tensor], Tensor]

    def __repr__(self) -> str:
        return f"PointwiseLoss({self.name})"


def softplus(margin: Tensor) -> Tensor:
    """Stable ``log(1 + exp(m)) = max(m, 0) + log1p(exp(-|m|))`` — finite
    for every finite margin (``torch.nn.functional.softplus`` switches to
    the identity above a threshold instead)."""
    return torch.clamp(margin, min=0) + torch.log1p(torch.exp(-margin.abs()))


def _logistic_loss(margin: Tensor, label: Tensor) -> Tensor:
    return softplus(margin) - label * margin


def _logistic_d1(margin: Tensor, label: Tensor) -> Tensor:
    return torch.sigmoid(margin) - label


def _logistic_d2(margin: Tensor, label: Tensor) -> Tensor:
    s = torch.sigmoid(margin)
    return s * (1.0 - s)


LogisticLoss = PointwiseLoss(
    name="logistic", kernel_id=0, loss=_logistic_loss, d1=_logistic_d1,
    d2=_logistic_d2, mean=torch.sigmoid)


def _squared_loss(margin: Tensor, label: Tensor) -> Tensor:
    d = margin - label
    return 0.5 * d * d


SquaredLoss = PointwiseLoss(
    name="squared", kernel_id=1, loss=_squared_loss,
    d1=lambda margin, label: margin - label,
    d2=lambda margin, label: torch.ones_like(margin),
    mean=lambda margin: margin)


def _poisson_loss(margin: Tensor, label: Tensor) -> Tensor:
    # negative Poisson log-likelihood with exp link, up to the label-only
    # log(label!) constant
    return torch.exp(margin) - label * margin


PoissonLoss = PointwiseLoss(
    name="poisson", kernel_id=2, loss=_poisson_loss,
    d1=lambda margin, label: torch.exp(margin) - label,
    d2=lambda margin, label: torch.exp(margin),
    mean=torch.exp)


def _smoothed_hinge_loss(margin: Tensor, label: Tensor) -> Tensor:
    # Rennie's smoothed hinge on the signed margin t = (2*label - 1) * margin
    t = (2.0 * label - 1.0) * margin
    zero = torch.zeros_like(t)
    return torch.where(t <= 0.0, 0.5 - t,
                       torch.where(t < 1.0, 0.5 * torch.square(1.0 - t), zero))


def _smoothed_hinge_d1(margin: Tensor, label: Tensor) -> Tensor:
    z = 2.0 * label - 1.0
    t = z * margin
    dt = torch.where(t <= 0.0, -torch.ones_like(t),
                     torch.where(t < 1.0, t - 1.0, torch.zeros_like(t)))
    return z * dt


def _smoothed_hinge_d2(margin: Tensor, label: Tensor) -> Tensor:
    t = (2.0 * label - 1.0) * margin
    return ((t > 0.0) & (t < 1.0)).to(margin.dtype)


SmoothedHingeLoss = PointwiseLoss(
    name="smoothed_hinge", kernel_id=3, loss=_smoothed_hinge_loss,
    d1=_smoothed_hinge_d1, d2=_smoothed_hinge_d2,
    mean=lambda margin: margin)


def loss_for_task(task: TaskType) -> PointwiseLoss:
    """The pointwise loss of a :class:`TaskType`."""
    return {
        TaskType.LOGISTIC_REGRESSION: LogisticLoss,
        TaskType.LINEAR_REGRESSION: SquaredLoss,
        TaskType.POISSON_REGRESSION: PoissonLoss,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SmoothedHingeLoss,
    }[task]
