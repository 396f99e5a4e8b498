"""GLM optimization problems: objective + optimizer + regularization in one box.

Counterpart of ``photon_ml_tpu/glm/problem.py``. Only the L-BFGS branch of
:meth:`OptimizationProblem.run` is ported; OWL-QN (L1 / elastic net), TRON
and variance computation raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective
from photon_ml_tpu_torch.ops.regularization import (
    NoRegularization,
    RegularizationContext,
)
from photon_ml_tpu_torch.optimize import (
    OptimizerConfig,
    OptimizerResult,
    minimize_lbfgs,
)
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

    def check_ported(self) -> None:
        """Raise for the options this port does not run yet."""
        if self.optimizer != OptimizerType.LBFGS:
            raise NotImplementedError(
                f"optimizer {self.optimizer.value}: only LBFGS is ported")
        if self.regularization.has_l1:
            raise NotImplementedError(
                "L1 / elastic-net regularization (the OWLQN optimizer) is "
                "not ported")
        if self.variance_type != VarianceComputationType.NONE:
            raise NotImplementedError(
                f"variance_type {self.variance_type.value}: variance "
                "computation is not ported")


@dataclasses.dataclass(frozen=True)
class OptimizationProblem:
    """A ready-to-run GLM solve of
    ``Σ_i w_i·l(margin_i, y_i) + 0.5·l2·||w||²``."""

    objective: GLMObjective
    config: GLMOptimizationConfiguration = GLMOptimizationConfiguration()

    def __post_init__(self) -> None:
        self.config.check_ported()

    def run(self, data: GLMData, w0: torch.Tensor, lam=0.0) -> OptimizerResult:
        """Solve from ``w0`` at regularization ``lam``. ``w0`` ``(d,)`` solves
        one problem (the result keeps a lane dimension of 1); ``w0``
        ``(E, D)`` against an ``(E, S, D)`` design solves one problem per
        entity lane."""
        l2 = self.config.regularization.l2_weight(float(lam))
        cfg = self.config.optimizer_config
        if w0.dim() == 1:
            def fun(w):
                v, g = self.objective.value_and_grad(w[0], data, l2)
                return v.reshape(1), g.reshape(1, -1)

            return minimize_lbfgs(fun, w0[None, :], cfg)
        return minimize_lbfgs(
            lambda w: self.objective.value_and_grad(w, data, l2), w0, cfg)

