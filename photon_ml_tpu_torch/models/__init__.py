"""GLM models and their coefficients."""

from photon_ml_tpu_torch.models.coefficients import Coefficients  # noqa: F401
from photon_ml_tpu_torch.models.glm import (  # noqa: F401
    GeneralizedLinearModel,
    linear_regression_model,
    logistic_regression_model,
    poisson_regression_model,
    smoothed_hinge_loss_linear_svm_model,
)
