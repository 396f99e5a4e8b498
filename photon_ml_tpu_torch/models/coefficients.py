"""Model coefficients (counterpart of
``photon_ml_tpu/models/coefficients.py``; variances are not ported yet)."""

from __future__ import annotations

import dataclasses
import torch


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """GLM coefficients: ``means`` ``(d,)``."""

    means: torch.Tensor

    @property
    def dim(self) -> int:
        return self.means.shape[-1]
