"""Generalized linear models: task-typed coefficient containers that score
data (counterpart of ``photon_ml_tpu/models/glm.py``)."""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.ops.design import DenseDesign
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """A trained GLM: coefficients plus the task that interprets them."""

    coefficients: Coefficients
    task: TaskType

    @property
    def dim(self) -> int:
        return self.coefficients.dim

    def score(self, design: DenseDesign, offsets=0.0) -> torch.Tensor:
        """Raw margins ``X @ w + offset``."""
        return design.matvec(self.coefficients.means) + offsets
