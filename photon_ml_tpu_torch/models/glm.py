"""Generalized linear models: task-typed coefficient containers that score
data (counterpart of ``photon_ml_tpu/models/glm.py``). Factory helpers
carry the reference's class names."""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.ops.design import DenseDesign
from photon_ml_tpu_torch.ops.losses import PointwiseLoss, loss_for_task
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """A trained GLM: coefficients plus the task that interprets them."""

    coefficients: Coefficients
    task: TaskType

    @property
    def dim(self) -> int:
        return self.coefficients.dim

    @property
    def loss(self) -> PointwiseLoss:
        return loss_for_task(self.task)

    def score(self, design: DenseDesign, offsets=0.0) -> torch.Tensor:
        """Raw margins ``X @ w + offset``."""
        return design.matvec(self.coefficients.means) + offsets

    def predict_mean(self, design: DenseDesign, offsets=0.0) -> torch.Tensor:
        """Response-scale predictions (sigmoid / identity / exp per task),
        the reference's ``computeMeanFunction``."""
        return self.loss.mean(self.score(design, offsets))

    def with_coefficients(self, coefficients: Coefficients
                          ) -> "GeneralizedLinearModel":
        return dataclasses.replace(self, coefficients=coefficients)


def logistic_regression_model(coefficients: Coefficients
                              ) -> GeneralizedLinearModel:
    """Reference: ``supervised/classification/LogisticRegressionModel.scala``."""
    return GeneralizedLinearModel(coefficients, TaskType.LOGISTIC_REGRESSION)


def linear_regression_model(coefficients: Coefficients
                            ) -> GeneralizedLinearModel:
    """Reference: ``supervised/regression/LinearRegressionModel.scala``."""
    return GeneralizedLinearModel(coefficients, TaskType.LINEAR_REGRESSION)


def poisson_regression_model(coefficients: Coefficients
                             ) -> GeneralizedLinearModel:
    """Reference: ``supervised/regression/PoissonRegressionModel.scala``."""
    return GeneralizedLinearModel(coefficients, TaskType.POISSON_REGRESSION)


def smoothed_hinge_loss_linear_svm_model(coefficients: Coefficients
                                         ) -> GeneralizedLinearModel:
    """Reference:
    ``supervised/classification/SmoothedHingeLossLinearSVMModel.scala``."""
    return GeneralizedLinearModel(coefficients,
                                  TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)
