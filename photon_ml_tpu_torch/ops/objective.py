"""GLM objective: value, gradient and second-order products, through the
fused kernels where they apply.

Counterpart of ``photon_ml_tpu/ops/objective.py``:

    value = Σ_i weight_i·l(margin_i, label_i) + 0.5·l2·||w_reg||²
    grad  = Xᵀ(weight·l'(margin)) + l2·w_reg
    Hv    = Xᵀ(weight·l''(margin) ∘ (X v)) + l2·v_reg

Dense designs with identity normalization go through the fused one-pass
kernels, chosen by shape (the JAX package's ``custom_vmap`` rules become
this explicit dispatch):

- ``x`` ``(E, S, D)``, ``w`` ``(E, D)``: a random-effect bucket, one
  objective per entity (:mod:`~photon_ml_tpu_torch.ops.fused_re`);
- ``x`` ``(n, d)``, ``w`` ``(d,)``: one objective
  (:func:`~photon_ml_tpu_torch.ops.fused_glm.fused_value_and_grad`);
- ``x`` ``(n, d)``, ``w`` ``(M, d)``: M lanes sharing the data, e.g. the
  lambdas of a batched sweep
  (:func:`~photon_ml_tpu_torch.ops.fused_glm.fused_value_and_grad_multi`);

and the Hessian-vector products of an ``(n, d)`` design through
:mod:`~photon_ml_tpu_torch.ops.fused_hvp`. Each wrapper launches its CUDA
kernel for a tensor on the card and runs its plain version for a tensor on
the CPU. Anything else takes the closed forms below.

``l2`` is a number or, for M lanes, an ``(M,)`` tensor (one lambda per
lane). Weight-0 rows are padding: they are evaluated at margin 0 and
zero-weighted (the double-where guard), so they contribute exactly nothing
and cannot overflow. Normalization is a coefficient-space
reparameterization (:mod:`~photon_ml_tpu_torch.ops.normalization`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.ops.design import DenseDesign, accumulation_dtype
from photon_ml_tpu_torch.ops.fused_glm import (
    fused_value_and_grad,
    fused_value_and_grad_multi,
)
from photon_ml_tpu_torch.ops.fused_hvp import fused_hvp
from photon_ml_tpu_torch.ops.fused_re import fused_entity_value_and_grad
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import (
    NoNormalization,
    NormalizationContext,
)

Tensor = torch.Tensor


def _per_lane(l2):
    """``l2`` shaped to scale ``(L, d)`` rows: an ``(L,)`` tensor of
    lambdas gets a trailing axis; a number or a 0-d tensor stays."""
    return l2[..., None] if isinstance(l2, Tensor) and l2.dim() else l2


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
    touches. ``w`` is ``(d,)``; ``(M, d)`` against an ``(n, d)`` design
    (M objectives sharing the data); or ``(E, D)`` against an
    ``(E, S, D)`` bucket (one objective per entity lane)."""

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

    def reg_curvature(self, l2):
        """The L2 term's Hessian diagonal, per lane: ``l2`` or
        ``l2·mask`` (the true curvature ``l2·mask²`` for a 0/1 mask)."""
        l2 = _per_lane(l2)
        return l2 if self.reg_mask is None else l2 * self.reg_mask

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
            if x.dim() == 3:
                fused = fused_entity_value_and_grad
            elif w.dim() == 1:
                fused = fused_value_and_grad
            else:
                fused = fused_value_and_grad_multi
            value, grad = fused(self.loss, x, w, data.labels, data.offsets,
                                data.weights)
            return (value + self._l2_term(w, l2),
                    grad.to(w.dtype) + _per_lane(l2) * self._reg_w(w))
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
        return value, g.to(w.dtype) + _per_lane(l2) * self._reg_w(w)

    def hvp(self, w: Tensor, v: Tensor, data: GLMData, l2=0.0) -> Tensor:
        """Exact Hessian-vector product: one-shot :meth:`hvp_operator`."""
        return self.hvp_operator(w, data, l2)(v)

    def hvp_operator(self, w: Tensor, data: GLMData, l2=0.0):
        """``v ↦ Hv`` at fixed ``w`` — the shape TRON's inner CG wants.

        The curvature weights ``d2w`` are computed once here (one pass
        over the design); each product is then one further pass: kernel 3
        for an ``(n, d)`` dense identity-normalization design (one launch
        per lane when ``v`` is ``(M, d)``, as the Pallas kernel's batching
        does), else the closed form ``X'ᵀ(d2w·(X'v)) + l2·v`` with the
        normalized column ``x'_ij = f_j·(x_ij − s_j)`` expanded by the
        chain rule."""
        norm = self.normalization
        d2w = self._d2_weights(w, data)
        reg = self.reg_curvature(l2)

        if self.uses_kernel(data) and data.design.x.dim() == 2:
            x = data.design.x

            def apply_fused(v: Tensor) -> Tensor:
                if v.dim() == 1:
                    hv = fused_hvp(x, v, d2w)
                else:
                    hv = torch.stack([fused_hvp(x, v[m], d2w[m])
                                      for m in range(v.shape[0])])
                return hv.to(w.dtype) + reg * v

            return apply_fused

        def apply(v: Tensor) -> Tensor:
            u = v if norm.factors is None else v * norm.factors
            t = data.design.matvec(u)
            if norm.shifts is not None:
                t = t - (u * norm.shifts).sum(-1, keepdim=True)
            d2t = d2w * t
            hv = data.design.rmatvec(d2t)
            if norm.shifts is not None:
                hv = hv - norm.shifts * d2t.sum(-1, keepdim=True)
            if norm.factors is not None:
                hv = hv * norm.factors
            return hv.to(w.dtype) + reg * v

        return apply

    # --- second-order contractions (TRON, variances) -----------------------
    def _d2_weights(self, w: Tensor, data: GLMData) -> Tensor:
        live = data.weights > 0
        zero = torch.zeros((), dtype=data.weights.dtype,
                           device=data.weights.device)
        m = torch.where(live, self.margins(w, data), zero)
        return torch.where(live, data.weights * self.loss.d2(m, data.labels),
                           zero)

    def _normalized_x(self, data: GLMData) -> Tensor:
        """The transformed dense design ``(x − s)·f``, in at least f32 — for
        the variance contractions only, which run once per solve."""
        x = data.design.x.to(accumulation_dtype(data.design.x.dtype))
        if self.normalization.shifts is not None:
            x = x - self.normalization.shifts
        if self.normalization.factors is not None:
            x = x * self.normalization.factors
        return x

    def hessian_diagonal(self, w: Tensor, data: GLMData, l2=0.0) -> Tensor:
        """Diagonal of the Hessian in transformed feature space,
        ``Σ_i d2w_i·x'_ij² + l2·mask`` (variance type SIMPLE; dense designs
        only, as the port has no sparse design yet)."""
        x = self._normalized_x(data)
        d2 = self._d2_weights(w, data).to(x.dtype)
        return (torch.einsum("...nd,...n->...d", x * x, d2)
                + self.reg_curvature(l2))

    def hessian_matrix(self, w: Tensor, data: GLMData, l2=0.0) -> Tensor:
        """The full ``(d, d)`` Hessian ``X'ᵀ diag(d2w) X' + diag(l2·mask)``
        (variance type FULL; small d only, as in the reference)."""
        x = self._normalized_x(data)
        d2 = self._d2_weights(w, data).to(x.dtype)
        h = torch.einsum("...nd,...n,...ne->...de", x, d2, x)
        reg = torch.broadcast_to(torch.as_tensor(
            self.reg_curvature(l2), dtype=h.dtype, device=h.device),
            h.shape[:-1])
        return h + torch.diag_embed(reg)
