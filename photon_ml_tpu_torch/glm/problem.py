"""GLM optimization problems: objective + optimizer + regularization in one box.

Counterpart of ``photon_ml_tpu/glm/problem.py``: the reference's
optimizer dispatch (TRON where asked for; OWL-QN where the regularization
has an L1 part, which the optimizer handles apart from the smooth
objective; L-BFGS otherwise) and per-coefficient variances (SIMPLE and
FULL).

Where the JAX package runs one solve per lane under ``jax.vmap`` (the
batched lambda sweep, the random-effect buckets), :meth:`
OptimizationProblem.run` takes the lanes as a leading dimension: ``w0``
``(M, d)`` with one lambda per lane against a shared ``(n, d)`` design, or
``w0`` ``(E, D)`` against an ``(E, S, D)`` bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective
from photon_ml_tpu_torch.ops.regularization import (
    NoRegularization,
    RegularizationContext,
)
from photon_ml_tpu_torch.optimize import (
    OptimizerConfig,
    OptimizerResult,
)
from photon_ml_tpu_torch.optimize.common import Steps, run_alone
from photon_ml_tpu_torch.optimize.lbfgs import lbfgs_steps
from photon_ml_tpu_torch.optimize.owlqn import owlqn_steps
from photon_ml_tpu_torch.optimize.tron import tron_steps
from photon_ml_tpu_torch.types import OptimizerType, VarianceComputationType


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfiguration:
    """Per-problem optimization settings (reference
    ``GLMOptimizationConfiguration.scala``)."""

    optimizer: OptimizerType = OptimizerType.LBFGS
    regularization: RegularizationContext = NoRegularization
    optimizer_config: OptimizerConfig = OptimizerConfig()
    variance_type: VarianceComputationType = VarianceComputationType.NONE

    def __post_init__(self) -> None:
        if self.optimizer == OptimizerType.TRON and self.regularization.has_l1:
            raise ValueError(
                "TRON needs a twice-differentiable objective; L1/elastic-net "
                "requires OWLQN (as in the reference)")


@dataclasses.dataclass(frozen=True)
class OptimizationProblem:
    """A ready-to-run GLM solve of
    ``Σ_i w_i·l(margin_i, y_i) + 0.5·l2·||w||² (+ l1·||w||₁)``, the
    lambda split into l1 and l2 by the regularization context."""

    objective: GLMObjective
    config: GLMOptimizationConfiguration = GLMOptimizationConfiguration()

    @staticmethod
    def _lam(lam, like: torch.Tensor):
        """``lam`` as a number, or for a tensor of lambdas (one per lane) in
        ``like``'s dtype and device."""
        if isinstance(lam, torch.Tensor):
            return lam.to(dtype=like.dtype, device=like.device)
        return float(lam)

    def _l2(self, lam, like: torch.Tensor):
        """The L2 weight of ``lam``, per lane for a tensor of lambdas."""
        return self.config.regularization.l2_weight(self._lam(lam, like))

    def _l1(self, lam, like: torch.Tensor):
        """The L1 weight of ``lam`` shaped to broadcast against the lanes
        ``(L, d)``: a number, or ``(L, 1)`` for a tensor of lambdas."""
        l1 = self.config.regularization.l1_weight(self._lam(lam, like))
        return l1[:, None] if isinstance(l1, torch.Tensor) and l1.dim() \
            else l1

    def run(self, data: GLMData, w0: torch.Tensor, lam=0.0) -> OptimizerResult:
        """Solve from ``w0`` at regularization ``lam``. ``w0`` ``(d,)`` solves
        one problem (the result keeps a lane dimension of 1); ``w0``
        ``(M, d)`` with ``lam`` ``(M,)`` solves one problem per lambda over
        a shared ``(n, d)`` design; ``w0`` ``(E, D)`` against an
        ``(E, S, D)`` design one problem per entity lane.

        TRON builds its Hessian-vector operator once per Newton step
        (:meth:`GLMObjective.hvp_operator`): the curvature pass over the
        design runs once per step and every CG product is one further pass
        (kernel 3 on the card for a dense design). With an L1 part the
        solve is OWL-QN's, the L1 weight per lane."""
        return run_alone(self.steps(data, w0, lam))

    def steps(self, data: GLMData, w0: torch.Tensor, lam=0.0) -> Steps:
        """:meth:`run` as a member of
        :func:`~photon_ml_tpu_torch.optimize.common.drive`: solves driven
        together share each host read, and each returns what it returns
        alone, bit for bit."""
        obj, cfg = self.objective, self.config.optimizer_config
        lanes = w0 if w0.dim() > 1 else w0[None, :]
        l2 = self._l2(lam, lanes)
        if w0.dim() == 1:
            def fun(w):
                v, g = obj.value_and_grad(w[0], data, l2)
                return v.reshape(1), g.reshape(1, -1)

            def hvp_at(w):
                op = obj.hvp_operator(w[0], data, l2)
                return lambda v: op(v[0]).reshape(1, -1)
        else:
            def fun(w):
                return obj.value_and_grad(w, data, l2)

            def hvp_at(w):
                return obj.hvp_operator(w, data, l2)

        if self.config.optimizer == OptimizerType.TRON:
            return tron_steps(fun, hvp_at, lanes, cfg)
        if self.config.regularization.has_l1:
            return owlqn_steps(fun, lanes, self._l1(lam, lanes), cfg)
        return lbfgs_steps(fun, lanes, cfg)

    # --- variance (reference VarianceComputationType SIMPLE / FULL) -------
    def compute_variances(self, w: torch.Tensor, data: GLMData,
                          lam=0.0) -> Optional[torch.Tensor]:
        """Per-coefficient variance approximations of the reference:

        - SIMPLE: elementwise inverse of the Hessian diagonal
          (``HessianDiagonalAggregator``),
        - FULL: diagonal of the full Hessian's pseudo-inverse
          (``HessianMatrixAggregator``; small dims only). ``pinv``, not
          ``inv``: an all-zero design column makes H singular, and the
          pseudo-inverse gives it variance 0 instead of NaN.
        """
        vt = self.config.variance_type
        if vt == VarianceComputationType.NONE:
            return None
        l2 = self._l2(lam, w)
        if vt == VarianceComputationType.SIMPLE:
            diag = self.objective.hessian_diagonal(w, data, l2)
            return 1.0 / torch.clamp(diag, min=torch.finfo(diag.dtype).tiny)
        h = self.objective.hessian_matrix(w, data, l2)
        # jnp.linalg.pinv's default cut-off, so both packages drop the same
        # directions
        rtol = 10.0 * max(h.shape[-2:]) * torch.finfo(h.dtype).eps
        return torch.diagonal(torch.linalg.pinv(h, rtol=rtol, hermitian=True),
                              dim1=-2, dim2=-1)

    def run_with_variances(self, data: GLMData, w0: torch.Tensor, lam=0.0
                           ) -> tuple[Coefficients, OptimizerResult]:
        """:meth:`run` from a ``(d,)`` start, then :meth:`compute_variances`
        at the solution."""
        result = self.run(data, w0, lam)
        w = result.w[0] if w0.dim() == 1 else result.w
        variances = self.compute_variances(w, data, lam)
        return Coefficients(means=w, variances=variances), result
