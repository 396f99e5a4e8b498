"""GAME coordinates: one trainable block of the additive model.

Counterpart of ``photon_ml_tpu/game/coordinate.py``. A coordinate owns its
dataset and optimization problem; ``train(offsets, warm_start)`` fits
against the residual offsets coordinate descent supplies and returns
``(model, scores)``, ``scores`` being this coordinate's margin per global
sample as a device vector.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from photon_ml_tpu_torch.game.data import (
    FixedEffectDataset,
    GameData,
    RandomEffectDataset,
)
from photon_ml_tpu_torch.game.model import FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
from photon_ml_tpu_torch.glm.problem import (
    GLMOptimizationConfiguration,
    OptimizationProblem,
)
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.types import TaskType

CoordinateModel = Union[FixedEffectModel, RandomEffectModel]


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinate:
    """The global GLM solve (reference ``FixedEffectCoordinate.scala``):
    one-lane L-BFGS or TRON solve whose every evaluation is one launch of
    the fused fixed-effect kernel (:mod:`~photon_ml_tpu_torch.ops.fused_glm`)
    and, under TRON, every CG product one launch of the Hvp kernel
    (:mod:`~photon_ml_tpu_torch.ops.fused_hvp`)."""

    coordinate_id: str
    dataset: FixedEffectDataset
    task: TaskType
    config: GLMOptimizationConfiguration
    lam: float = 0.0

    def __post_init__(self):
        self.config.regularization.check_weight(self.lam)

    def train(self, offsets: torch.Tensor,
              warm_start: Optional[FixedEffectModel] = None
              ) -> tuple[FixedEffectModel, torch.Tensor]:
        data = self.dataset.glm_data(offsets)
        device = offsets.device
        w0 = (torch.zeros(self.dataset.dim, dtype=torch.float32, device=device)
              if warm_start is None
              else warm_start.model.coefficients.means.to(device))
        problem = OptimizationProblem(
            GLMObjective(loss=loss_for_task(self.task)), self.config)
        w = problem.run(data, w0, self.lam).w[0]
        scores = data.design.matvec(w)
        model = FixedEffectModel(
            model=GeneralizedLinearModel(
                coefficients=Coefficients(means=w), task=self.task),
            feature_shard_id=self.dataset.feature_shard_id)
        return model, scores


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinate:
    """Per-entity solves for one random-effect coordinate (reference
    ``RandomEffectCoordinate.scala``). Active samples are scored on the
    device in the bucket layout; passive samples (rows excluded from
    training by the active-data bounds) are scored by the trained model's
    host join."""

    coordinate_id: str
    dataset: RandomEffectDataset
    data: GameData
    task: TaskType
    config: GLMOptimizationConfiguration
    lam: float = 0.0
    design_dtype: str = "float32"

    def __post_init__(self):
        self.config.regularization.check_weight(self.lam)

    def train(self, offsets: torch.Tensor,
              warm_start: Optional[RandomEffectModel] = None
              ) -> tuple[RandomEffectModel, torch.Tensor]:
        solver = RandomEffectSolver(task=self.task, config=self.config,
                                    design_dtype=self.design_dtype,
                                    device=offsets.device)
        shard_dim = self.data.shards[self.dataset.config.feature_shard_id].dim
        model, scores = solver.train(self.dataset, offsets, self.lam,
                                     warm_start, dim=shard_dim)
        passive = self.dataset.passive_sample_idx
        if len(passive):
            scores[torch.as_tensor(passive, device=scores.device)] = \
                torch.as_tensor(model.score(self.data, sample_idx=passive),
                                device=scores.device)
        return model, scores


Coordinate = Union[FixedEffectCoordinate, RandomEffectCoordinate]
