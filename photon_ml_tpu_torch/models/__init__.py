"""GLM models and their coefficients."""

from photon_ml_tpu_torch.models.coefficients import Coefficients  # noqa: F401
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel  # noqa: F401
