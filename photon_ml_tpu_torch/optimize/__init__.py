"""Optimizers batched over a leading lane dimension (L-BFGS)."""

from photon_ml_tpu_torch.optimize.common import (  # noqa: F401
    OptimizerConfig,
    OptimizerResult,
)
from photon_ml_tpu_torch.optimize.lbfgs import minimize_lbfgs  # noqa: F401
