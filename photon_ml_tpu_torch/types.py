"""Core enums and type aliases shared across the framework.

Mirrors the vocabulary of the reference's top-level enums
(``photon-api/src/main/scala/com/linkedin/photon/ml/TaskType.scala``,
``photon-lib/.../optimization/OptimizerType.scala``,
``photon-lib/.../optimization/RegularizationType.scala``,
``photon-api/.../normalization/NormalizationType.scala``,
``photon-api/.../optimization/VarianceComputationType.scala``).
"""

from __future__ import annotations

import enum


class TaskType(enum.Enum):
    """Supported training task (loss family + link function)."""

    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"


class OptimizerType(enum.Enum):
    LBFGS = "LBFGS"
    OWLQN = "OWLQN"  # selected implicitly by L1/elastic-net in the reference
    TRON = "TRON"


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


class NormalizationType(enum.Enum):
    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


class VarianceComputationType(enum.Enum):
    NONE = "NONE"
    SIMPLE = "SIMPLE"  # diagonal-Hessian inverse approximation
    FULL = "FULL"  # full-Hessian inverse (small feature dims only)


class DataValidationType(enum.Enum):
    """Row-level input validation policy.

    Reference: ``photon-client/.../DataValidators.scala``.
    """

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


# Reference constants (photon-client/.../Constants.scala).
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_TERM = ""
#: Delimiter joining (name, term) into a single feature key, as in the
#: reference's ``Constants.scala`` (the \x01 control char keeps keys injective over (name, term)
#: pairs; glyph pending mount verification).
NAME_TERM_DELIMITER = "\x01"


def feature_key(name: str, term: str = "") -> str:
    """Canonical string key for a ``(name, term)`` feature pair."""
    return f"{name}{NAME_TERM_DELIMITER}{term}"


INTERCEPT_KEY = feature_key(INTERCEPT_NAME, INTERCEPT_TERM)
