"""GLM optimization problems and the regularization sweep."""

from photon_ml_tpu_torch.glm.problem import (  # noqa: F401
    GLMOptimizationConfiguration,
    OptimizationProblem,
)
from photon_ml_tpu_torch.glm.training import (  # noqa: F401
    TrainedModel,
    to_original_space,
    train_glm_sweep,
    train_glm_sweep_batched,
    validate_and_select,
)
