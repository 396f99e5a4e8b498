"""Model coefficients: means plus optional posterior variances (counterpart
of ``photon_ml_tpu/models/coefficients.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """GLM coefficients: ``means`` ``(d,)`` and, when variance computation
    is on (``VarianceComputationType`` SIMPLE or FULL), ``variances``
    ``(d,)``."""

    means: torch.Tensor
    variances: Optional[torch.Tensor] = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]
