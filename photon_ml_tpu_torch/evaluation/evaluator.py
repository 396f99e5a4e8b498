"""Evaluators, evaluator-string parsing and evaluation results.

Counterpart of ``photon_ml_tpu/evaluation/evaluator.py``, the same
vocabulary:

- ``AUC``, ``RMSE``, ``LOGISTIC_LOSS``, ``SQUARED_LOSS``, ``POISSON_LOSS``,
  ``SMOOTHED_HINGE_LOSS``: whole-dataset metrics;
- ``AUC:<idTag>``: per-group AUC averaged over groups (sharded AUC);
- ``PRECISION@<k>:<idTag>``: per-group precision at k.

The first validation evaluator is the model-selection criterion;
``better_than`` encodes its direction.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.evaluation.grouped import (
    grouped_auc,
    grouped_precision_at_k,
)
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

_PRECISION_RE = re.compile(r"^PRECISION@(\d+):(.+)$", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """A named metric over scored data.

    ``id_tag`` is the grouping column of a per-group metric (None for a
    whole-dataset one); ``maximize`` gives the model-selection direction.
    """

    name: str
    maximize: bool
    id_tag: Optional[str] = None
    k: Optional[int] = None  # PRECISION@k only

    def evaluate(self, scores, labels, weights=None,
                 id_tags: Optional[Mapping[str, np.ndarray]] = None) -> float:
        """Compute the metric. ``id_tags`` maps a tag name to each
        sample's group id (-1 where the sample has none)."""
        if self.id_tag is not None:
            if id_tags is None or self.id_tag not in id_tags:
                raise KeyError(
                    f"evaluator {self.name} needs id tag '{self.id_tag}' "
                    f"but scored data has {sorted(id_tags or {})}")
            groups = np.asarray(id_tags[self.id_tag])
            # rows without the tag (-1) take no part, as the reference
            # joins scores with present tags only
            present = groups >= 0 if np.issubdtype(groups.dtype, np.integer) \
                else np.ones(groups.shape, bool)
            scores = _host(scores)[present]
            labels = _host(labels)[present]
            groups = groups[present]
            if weights is not None:
                weights = _host(weights)[present]
            if self.k is not None:
                return grouped_precision_at_k(scores, labels, groups, self.k)
            return grouped_auc(scores, labels, groups, weights)
        base = self.name.split(":", 1)[0].upper()
        if base == "AUC":
            return area_under_roc_curve(scores, labels, weights)
        if base == "RMSE":
            return root_mean_squared_error(scores, labels, weights)
        if base in _LOSS_BY_NAME:
            return mean_pointwise_loss(_LOSS_BY_NAME[base], scores,
                                       labels, weights)
        raise ValueError(f"unknown evaluator {self.name!r}")

    def better_than(self, a: float, b: Optional[float]) -> bool:
        """Is score ``a`` better than ``b`` (None = no incumbent)?"""
        if b is None or math.isnan(b):
            return not math.isnan(a)
        return a > b if self.maximize else a < b


def parse_evaluator(spec: str) -> Evaluator:
    """Parse a reference-vocabulary evaluator string (see the module
    docstring)."""
    spec = spec.strip()
    m = _PRECISION_RE.match(spec)
    if m:
        k = int(m.group(1))
        if k < 1:
            raise ValueError(f"PRECISION@k needs k >= 1, got {spec!r}")
        return Evaluator(name=spec, maximize=True, id_tag=m.group(2), k=k)
    upper = spec.upper()
    if ":" in spec:
        base, tag = spec.split(":", 1)
        if base.upper() != "AUC":
            raise ValueError(
                f"only AUC and PRECISION@k support an id tag, got {spec!r}")
        return Evaluator(name=spec, maximize=True, id_tag=tag)
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
                 weights=None,
                 id_tags: Optional[Mapping[str, np.ndarray]] = None,
                 ) -> EvaluationResults:
    return EvaluationResults(tuple(
        (ev, ev.evaluate(scores, labels, weights, id_tags))
        for ev in evaluators))


def _host(a) -> np.ndarray:
    """A host numpy view of scores, labels or weights (tensors on any
    device, or arrays)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)
