"""Bayesian hyperparameter tuning: GP surrogate + Expected Improvement.

Re-design of the reference's tuning stack (``photon-lib/.../hyperparameter/``:
``estimators/{GaussianProcessEstimator, GaussianProcessModel}.scala``,
``search/{GaussianProcessSearch, RandomSearch}.scala``,
``criteria/ExpectedImprovement.scala``, ``kernels/{Matern52, RBF}.scala``,
``sampler/SliceSampler.scala``, ``EvaluationFunction.scala``).

Pure host-side numpy (float64): the GP operates on at most dozens of observed
points, far from the device hot path — exactly as the reference runs it
driver-local between training runs.

A copy of ``photon_ml_tpu/hyperparameter/__init__.py`` (host numpy; the port
imports nothing of the JAX package): both packages draw the same points for
the same seed.
"""

from photon_ml_tpu_torch.hyperparameter.kernels import RBF, Matern52  # noqa: F401
from photon_ml_tpu_torch.hyperparameter.gp import (  # noqa: F401
    GaussianProcessEstimator,
    GaussianProcessModel,
)
from photon_ml_tpu_torch.hyperparameter.criteria import expected_improvement  # noqa: F401
from photon_ml_tpu_torch.hyperparameter.sampler import slice_sample  # noqa: F401
from photon_ml_tpu_torch.hyperparameter.search import (  # noqa: F401
    GaussianProcessSearch,
    RandomSearch,
)
