"""Feature normalization applied as an objective transform, never materialized.

Counterpart of ``photon_ml_tpu/ops/normalization.py``: the transformed-space
margin of a raw sample is ``(w * factor) . x - w . (factor * shift)``, so a
coefficient-space reparameterization reproduces normalization without
scaling the design. :meth:`NormalizationContext.model_to_original` maps
trained coefficients back to raw feature space for model output.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.types import NormalizationType


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Per-feature affine transform ``x' = (x - shift) * factor``; the
    intercept column, when present, has ``factor=1, shift=0``."""

    factors: Optional[torch.Tensor] = None
    shifts: Optional[torch.Tensor] = None
    intercept_index: Optional[int] = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def transform_coefficients(self, w: torch.Tensor):
        """``(w_eff, margin_shift)`` with transformed-space margin
        ``w_eff . x + margin_shift`` for a raw sample x."""
        w_eff = w if self.factors is None else w * self.factors
        if self.shifts is None:
            margin_shift = torch.zeros((), dtype=w.dtype, device=w.device)
        else:
            margin_shift = -(w_eff * self.shifts).sum(-1)
        return w_eff, margin_shift

    def model_to_original(self, w: torch.Tensor) -> torch.Tensor:
        """Map coefficients learned in transformed space back to original
        feature space (so a model scores raw features directly): scale by
        the factors, and move the shifts' margin into the intercept."""
        w_orig = w if self.factors is None else w * self.factors
        if self.shifts is not None:
            if self.intercept_index is None:
                raise ValueError("shifts require an intercept column")
            others = torch.ones_like(self.shifts)
            others[self.intercept_index] = 0.0
            correction = (w_orig * self.shifts * others).sum(-1)
            w_orig = w_orig.clone()
            w_orig[..., self.intercept_index] -= correction
        return w_orig

    def original_to_model(self, w_orig: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`model_to_original` (a warm start from a saved
        model when training with normalization)."""
        if self.shifts is not None:
            if self.intercept_index is None:
                raise ValueError("shifts require an intercept column")
            others = torch.ones_like(self.shifts)
            others[self.intercept_index] = 0.0
            correction = (w_orig * self.shifts * others).sum(-1)
            w_orig = w_orig.clone()
            w_orig[..., self.intercept_index] += correction
        return w_orig if self.factors is None else w_orig / self.factors


NoNormalization = NormalizationContext()


def build_normalization(norm_type: NormalizationType, *, mean: np.ndarray,
                        variance: np.ndarray, max_magnitude: np.ndarray,
                        intercept_index: Optional[int],
                        dtype=torch.float32, device=None
                        ) -> NormalizationContext:
    """A context from feature summary statistics (factor 1/std, 1/max|x|,
    or 1/std with shift = mean for STANDARDIZATION), on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    d = len(mean)
    std = np.sqrt(np.maximum(variance, 0.0))
    inv_std = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0)
    inv_mag = np.where(max_magnitude > 0,
                       1.0 / np.where(max_magnitude > 0, max_magnitude, 1.0),
                       1.0)
    if norm_type == NormalizationType.NONE:
        return NoNormalization
    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors, shifts = inv_std, None
    elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors, shifts = inv_mag, None
    elif norm_type == NormalizationType.STANDARDIZATION:
        if intercept_index is None:
            raise ValueError("STANDARDIZATION requires an intercept column")
        factors, shifts = inv_std, mean.astype(np.float64).copy()
    else:
        raise ValueError(f"unknown normalization type {norm_type}")
    factors = np.asarray(factors, dtype=np.float64).copy()
    if intercept_index is not None:
        factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0
    if len(factors) != d:
        raise ValueError(f"{len(factors)} factors for {d} features")
    return NormalizationContext(
        factors=torch.as_tensor(factors, dtype=dtype, device=device),
        shifts=None if shifts is None
        else torch.as_tensor(shifts, dtype=dtype, device=device),
        intercept_index=intercept_index)
