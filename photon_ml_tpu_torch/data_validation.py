"""Row-level input validation (counterpart of
``photon_ml_tpu/data_validation.py``): finite labels, offsets, weights and
feature values, task-legal labels and non-negative weights, checked on every
row, on a sample, or not at all (``DataValidationType``)."""

from __future__ import annotations

import numpy as np

from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.types import DataValidationType, TaskType


class DataValidationError(ValueError):
    pass


def validate_game_data(
    data: GameData,
    task: TaskType,
    validation_type: DataValidationType = DataValidationType.VALIDATE_FULL,
    *,
    sample_fraction: float = 0.1,
    seed: int = 0,
) -> None:
    """Raise :class:`DataValidationError` on the first violated check."""
    if validation_type == DataValidationType.VALIDATE_DISABLED:
        return
    n = data.n_samples
    if validation_type == DataValidationType.VALIDATE_SAMPLE and n:
        rng = np.random.default_rng(seed)
        rows = np.sort(rng.choice(n, size=max(1, int(n * sample_fraction)),
                                  replace=False))
    else:
        rows = np.arange(n)

    labels = data.labels[rows]
    weights = data.weights[rows]
    offsets = data.offsets[rows]

    if not np.isfinite(labels).all():
        raise DataValidationError("non-finite labels")
    if not np.isfinite(offsets).all():
        raise DataValidationError("non-finite offsets")
    if not np.isfinite(weights).all() or (weights < 0).any():
        raise DataValidationError("weights must be finite and non-negative")

    if task in (TaskType.LOGISTIC_REGRESSION,
                TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        if not np.isin(labels, (0.0, 1.0)).all():
            raise DataValidationError(
                f"binary task {task.value} needs 0/1 labels")
    elif task == TaskType.POISSON_REGRESSION:
        if (labels < 0).any():
            raise DataValidationError("Poisson regression needs labels >= 0")

    for name, shard in data.shards.items():
        vals = shard.vals
        if validation_type == DataValidationType.VALIDATE_SAMPLE:
            vals = vals[np.isin(shard.rows(), rows)]
        if not np.isfinite(vals).all():
            raise DataValidationError(f"non-finite feature values in shard {name!r}")
