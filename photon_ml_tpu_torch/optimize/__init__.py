"""Optimizers batched over a leading lane dimension (L-BFGS, TRON)."""

from photon_ml_tpu_torch.optimize.common import (  # noqa: F401
    OptimizerConfig,
    OptimizerResult,
)
from photon_ml_tpu_torch.optimize.lbfgs import minimize_lbfgs  # noqa: F401
from photon_ml_tpu_torch.optimize.tron import minimize_tron  # noqa: F401
