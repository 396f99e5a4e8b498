"""Evaluators, evaluator-string parsing and evaluation results.

Counterpart of ``photon_ml_tpu/evaluation/evaluator.py`` for whole-dataset
metrics: ``AUC``, ``RMSE``, ``LOGISTIC_LOSS``, ``SQUARED_LOSS``,
``POISSON_LOSS``, ``SMOOTHED_HINGE_LOSS``. The per-group evaluators
(``AUC:<idTag>``, ``PRECISION@k:<idTag>``) are not ported yet and raise
:class:`NotImplementedError`. The first validation evaluator is the
model-selection criterion; ``better_than`` encodes its direction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from photon_ml_tpu_torch.evaluation.metrics import (
    area_under_roc_curve,
    mean_pointwise_loss,
    root_mean_squared_error,
)
from photon_ml_tpu_torch.ops import losses as losses_mod

_LOSS_BY_NAME = {
    "LOGISTIC_LOSS": losses_mod.LogisticLoss,
    "SQUARED_LOSS": losses_mod.SquaredLoss,
    "POISSON_LOSS": losses_mod.PoissonLoss,
    "SMOOTHED_HINGE_LOSS": losses_mod.SmoothedHingeLoss,
}


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """A named metric over scored data; ``maximize`` gives the
    model-selection direction."""

    name: str
    maximize: bool

    def evaluate(self, scores, labels, weights=None) -> float:
        if self.name == "AUC":
            return area_under_roc_curve(scores, labels, weights)
        if self.name == "RMSE":
            return root_mean_squared_error(scores, labels, weights)
        if self.name in _LOSS_BY_NAME:
            return mean_pointwise_loss(_LOSS_BY_NAME[self.name], scores,
                                       labels, weights)
        raise ValueError(f"unknown evaluator {self.name!r}")

    def better_than(self, a: float, b: Optional[float]) -> bool:
        """Is score ``a`` better than ``b`` (None = no incumbent)?"""
        if b is None or math.isnan(b):
            return not math.isnan(a)
        return a > b if self.maximize else a < b


def parse_evaluator(spec: str) -> Evaluator:
    """Parse a reference-vocabulary evaluator string."""
    upper = spec.strip().upper()
    if ":" in upper or upper.startswith("PRECISION@"):
        raise NotImplementedError(
            f"evaluator {spec!r}: per-group evaluators are not ported")
    if upper == "AUC":
        return Evaluator(name="AUC", maximize=True)
    if upper == "RMSE" or upper in _LOSS_BY_NAME:
        return Evaluator(name=upper, maximize=False)
    raise ValueError(f"unknown evaluator spec {spec!r}")


def parse_evaluators(specs: Sequence[str]) -> list[Evaluator]:
    return [parse_evaluator(s) for s in specs]


@dataclasses.dataclass(frozen=True)
class EvaluationResults:
    """Ordered evaluator results; the first drives model selection."""

    results: tuple[tuple[Evaluator, float], ...]

    @property
    def primary(self) -> tuple[Evaluator, float]:
        return self.results[0]

    def as_dict(self) -> dict[str, float]:
        return {ev.name: val for ev, val in self.results}

    def __repr__(self) -> str:
        inner = ", ".join(f"{ev.name}={val:.6g}" for ev, val in self.results)
        return f"EvaluationResults({inner})"


def evaluate_all(evaluators: Sequence[Evaluator], scores, labels,
                 weights=None) -> EvaluationResults:
    return EvaluationResults(tuple(
        (ev, ev.evaluate(scores, labels, weights)) for ev in evaluators))
