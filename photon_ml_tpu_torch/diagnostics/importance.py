"""Feature-importance diagnostics.

Counterpart of ``photon_ml_tpu/diagnostics/importance.py`` (the reference's
``ExpectedMagnitudeFeatureImportanceDiagnostic`` and
``VarianceFeatureImportanceDiagnostic``): rank features by the expected
contribution of each coefficient to the margin —

- expected magnitude: ``|w_j| * E[|x_j|]``, with ``E|x_j|`` bounded from
  summary statistics as ``nnz_j/n * maxMagnitude_j`` (a stats-only pass cannot
  recover the exact mean absolute value), and
- variance: ``|w_j| * std(x_j)`` (how much margin variance the feature drives).

Pure NumPy over the already-computed :class:`FeatureDataStatistics` (the
coefficients come to the host once); a report-time diagnostic, not a
training-path op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.stat import FeatureDataStatistics


@dataclasses.dataclass(frozen=True)
class FeatureImportanceReport:
    """Ranked importance table (descending)."""

    kind: str                      # "EXPECTED_MAGNITUDE" | "VARIANCE"
    ranked_indices: np.ndarray     # (d,) feature indices, most important first
    importance: np.ndarray         # (d,) scores aligned with ranked_indices
    names: Optional[list[str]] = None  # aligned with ranked_indices when given

    def top(self, k: int) -> list[tuple[str, float]]:
        k = min(k, len(self.ranked_indices))
        names = (self.names if self.names is not None
                 else [str(i) for i in self.ranked_indices])
        return [(names[i], float(self.importance[i])) for i in range(k)]


def _abs64(coefficients) -> np.ndarray:
    if isinstance(coefficients, torch.Tensor):
        coefficients = coefficients.detach().cpu().numpy()
    return np.abs(np.asarray(coefficients, np.float64))


def _rank(kind: str, scores: np.ndarray, names: Optional[Sequence[str]]
          ) -> FeatureImportanceReport:
    order = np.argsort(-scores, kind="stable")
    return FeatureImportanceReport(
        kind=kind,
        ranked_indices=order,
        importance=scores[order],
        names=[names[i] for i in order] if names is not None else None,
    )


def expected_magnitude_importance(
    coefficients: np.ndarray,
    stats: FeatureDataStatistics,
    names: Optional[Sequence[str]] = None,
) -> FeatureImportanceReport:
    """``|w_j| * E[|x_j|]`` with ``E|x_j|`` bounded from summary statistics
    by ``nnz/n * maxMagnitude`` (tight for indicator features, the dominant
    kind in Photon-ML's name-term universe) — the stats-only estimate the
    reference's expected-magnitude diagnostic uses.
    """
    w = _abs64(coefficients)
    n = max(stats.count, 1)
    exp_abs = stats.num_nonzeros / n * stats.max_magnitude
    return _rank("EXPECTED_MAGNITUDE", w * exp_abs, names)


def variance_importance(
    coefficients: np.ndarray,
    stats: FeatureDataStatistics,
    names: Optional[Sequence[str]] = None,
) -> FeatureImportanceReport:
    """``|w_j| * std(x_j)`` — margin-variance contribution per feature."""
    w = _abs64(coefficients)
    return _rank("VARIANCE", w * np.sqrt(np.maximum(stats.variance, 0.0)), names)
