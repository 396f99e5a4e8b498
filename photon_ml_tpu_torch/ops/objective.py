"""GLM objective: value and gradient, through the fused kernels where they apply.

Counterpart of ``photon_ml_tpu/ops/objective.py``:

    value = Σ_i weight_i·l(margin_i, label_i) + 0.5·l2·||w_reg||²
    grad  = Xᵀ(weight·l'(margin)) + l2·w_reg

Dense designs with identity normalization go through the fused one-pass
kernels: :mod:`~photon_ml_tpu_torch.ops.fused_glm` for an ``(n, d)`` design
with ``w`` ``(d,)``, :mod:`~photon_ml_tpu_torch.ops.fused_re` for a
random-effect bucket ``(E, S, D)`` with one coefficient row per entity.
Each wrapper launches its CUDA kernel for a tensor on the card and runs its
plain version for a tensor on the CPU. Anything else takes the closed form
:meth:`GLMObjective._closed_value_and_grad`.

Weight-0 rows are padding: they are evaluated at margin 0 and zero-weighted
(the double-where guard), so they contribute exactly nothing and cannot
overflow. Normalization is a coefficient-space reparameterization
(:mod:`~photon_ml_tpu_torch.ops.normalization`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.ops.design import DenseDesign
from photon_ml_tpu_torch.ops.fused_glm import fused_value_and_grad
from photon_ml_tpu_torch.ops.fused_re import fused_entity_value_and_grad
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import (
    NoNormalization,
    NormalizationContext,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GLMData:
    """One batch of labeled GLM data: ``labels``, per-sample additive
    ``offsets`` (the residual scores of coordinate descent) and non-negative
    ``weights``, ``(..., n)`` each. A weight-0 row is padding."""

    design: DenseDesign
    labels: Tensor
    offsets: Tensor
    weights: Tensor


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """GLM objective: the pointwise loss, the normalization context and an
    optional 0/1 ``reg_mask`` selecting the coefficients the L2 term
    touches. ``w`` is ``(d,)``, or ``(E, D)`` against an ``(E, S, D)``
    bucket (one objective per entity lane)."""

    loss: PointwiseLoss
    normalization: NormalizationContext = NoNormalization
    reg_mask: Optional[Tensor] = None

    def __post_init__(self):
        # the closed forms use curvature l2·mask, which equals the true
        # curvature l2·mask² only for a 0/1 mask
        if self.reg_mask is not None:
            m = self.reg_mask
            if not bool(((m == 0) | (m == 1)).all()):
                raise ValueError("reg_mask must be a 0/1 selector vector")

    def margins(self, w: Tensor, data: GLMData) -> Tensor:
        w_eff, shift = self.normalization.transform_coefficients(w)
        return (data.design.matvec(w_eff) + shift[..., None]
                + data.offsets)

    def _reg_w(self, w: Tensor) -> Tensor:
        return w if self.reg_mask is None else w * self.reg_mask

    def _l2_term(self, w: Tensor, l2) -> Tensor:
        wr = self._reg_w(w)
        return 0.5 * l2 * (wr * wr).sum(-1)

    def value(self, w: Tensor, data: GLMData, l2=0.0) -> Tensor:
        live = data.weights > 0
        m = self.margins(w, data)
        zero = torch.zeros_like(m)
        m_safe = torch.where(live, m, zero)
        contrib = torch.where(live, data.weights * self.loss.loss(
            m_safe, data.labels), zero)
        return contrib.sum(-1) + self._l2_term(w, l2)

    def uses_kernel(self, data: GLMData) -> bool:
        """True when :meth:`value_and_grad` goes through a fused kernel
        wrapper: a dense design with identity normalization."""
        return (isinstance(data.design, DenseDesign)
                and self.normalization.is_identity)

    def value_and_grad(self, w: Tensor, data: GLMData, l2=0.0):
        if self.uses_kernel(data):
            x = data.design.x
            fused = (fused_entity_value_and_grad if x.dim() == 3
                     else fused_value_and_grad)
            value, grad = fused(self.loss, x, w, data.labels, data.offsets,
                                data.weights)
            return (value + self._l2_term(w, l2),
                    grad.to(w.dtype) + l2 * self._reg_w(w))
        return self._closed_value_and_grad(w, data, l2)

    def _closed_value_and_grad(self, w: Tensor, data: GLMData, l2):
        """Closed-form (value, grad): margins computed once, two passes over
        the design. Normalization enters by chain rule: the transformed
        column is ``f_j·(x_ij − s_j)``, so ``g = f ∘ (Xᵀdl − s·Σdl)``."""
        live = data.weights > 0
        m = self.margins(w, data)
        zero = torch.zeros_like(m)
        m_safe = torch.where(live, m, zero)
        lvec = self.loss.loss(m_safe, data.labels)
        value = (torch.where(live, data.weights * lvec, zero).sum(-1)
                 + self._l2_term(w, l2))
        dl = torch.where(live, data.weights * self.loss.d1(m_safe, data.labels),
                         zero)
        g = data.design.rmatvec(dl)
        norm = self.normalization
        if norm.shifts is not None:
            g = g - norm.shifts * dl.sum(-1, keepdim=True)
        if norm.factors is not None:
            g = g * norm.factors
        return value, g.to(w.dtype) + l2 * self._reg_w(w)
