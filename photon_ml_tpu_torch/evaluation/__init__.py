"""Validation metrics and evaluators."""

from photon_ml_tpu_torch.evaluation.evaluator import (  # noqa: F401
    EvaluationResults,
    Evaluator,
    evaluate_all,
    parse_evaluator,
    parse_evaluators,
)
from photon_ml_tpu_torch.evaluation.metrics import (  # noqa: F401
    area_under_roc_curve,
    mean_pointwise_loss,
    root_mean_squared_error,
)
