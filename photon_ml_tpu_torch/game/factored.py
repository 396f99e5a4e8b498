"""Factored random-effect coordinate: per-entity latent factors through a
learned shared projection.

Counterpart of ``photon_ml_tpu/game/factored.py``. The coordinate's margin
for sample ``i`` of entity ``e`` is ``v_eᵀ (P x_i)``, with a shared
projection ``P`` (``latent_dim × shard_dim``) and per-entity latent
coefficients ``v_e``. Each factored iteration alternates:

1. **latent solve**: ``P`` fixed, the features projected (``z = P x``) and
   the latent random effect trained as a RANDOM-projected coordinate — the
   batched bucket solves of :mod:`~photon_ml_tpu_torch.game.random_effect`,
   each evaluation one launch of the entity kernel over an ``(E, S, L)``
   bucket;
2. **projection solve**: every ``v_e`` fixed, ``P`` is a GLM in ``vec(P)``
   (margins are bilinear: ``score_i = Σ_{l,d} P[l,d]·v_{e_i,l}·x_{i,d}``)
   over the implicit Khatri–Rao design ``v_{e_i} ⊗ x_i``;
   :class:`FactoredDesign` applies it as two dense matmuls and never
   materializes the ``n × (L·D)`` features.

The trained model is a projected
:class:`~photon_ml_tpu_torch.game.model.RandomEffectModel` whose projector
holds the learned ``P``: scoring, warm starts, ``to_shard_space`` and the
model files take the RANDOM projector's paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import (
    GameData,
    RandomEffectDataset,
    RandomEffectDatasetConfig,
)
from photon_ml_tpu_torch.game.model import RandomEffectModel
from photon_ml_tpu_torch.game.projector import ProjectorType, RandomProjector
from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
from photon_ml_tpu_torch.glm.problem import (
    GLMOptimizationConfiguration,
    OptimizationProblem,
)
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class FactoredDesign:
    """Implicit design of the projection solve: row ``i`` is
    ``vec(v_i ⊗ x_i)`` of dim ``L·D``, applied as two matmuls."""

    x: torch.Tensor  # (n, D) raw features
    v: torch.Tensor  # (n, L) each sample's entity latent coefficients
    latent_dim: int

    @property
    def n_samples(self) -> int:
        return self.x.shape[-2]

    @property
    def dim(self) -> int:
        return self.latent_dim * self.x.shape[-1]

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        p = w.reshape(self.latent_dim, self.x.shape[-1]).to(self.x.dtype)
        return ((self.x @ p.t()) * self.v).sum(-1)

    def rmatvec(self, g: torch.Tensor) -> torch.Tensor:
        return ((self.v * g[:, None]).t() @ self.x).reshape(-1)


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectCoordinate:
    """Alternating latent/projection training of one factored coordinate,
    with the coordinate-descent contract of the other coordinates:
    ``train(offsets, warm_start, sweep) -> (RandomEffectModel, scores)``."""

    coordinate_id: str
    data: GameData
    dataset_config: RandomEffectDatasetConfig  # projector_type RANDOM
    task: TaskType
    #: the latent (projected) random-effect solves
    config: GLMOptimizationConfiguration
    #: the projection-matrix solve
    projection_config: GLMOptimizationConfiguration = (
        GLMOptimizationConfiguration())
    lam: float = 0.0
    #: the projection solve's regularization weight on vec(P)
    lam_projection: float = 0.0
    #: alternations per call (reference numberOfFactoredIterations)
    n_factored_iterations: int = 2
    #: a mesh with an ``"entity"`` axis splits the latent solves' lanes
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.dataset_config.projector_type is not ProjectorType.RANDOM:
            raise ValueError(
                "factored coordinate requires a RANDOM-type dataset config "
                "(the projection is the trained object)")
        if self.dataset_config.projected_dim is None:
            raise ValueError("dataset_config.projected_dim (the latent dim) "
                             "is required")

    @property
    def latent_dim(self) -> int:
        return int(self.dataset_config.projected_dim)

    @property
    def _ds_config(self) -> RandomEffectDatasetConfig:
        """Each alternation's dataset serves one solve: its buckets stream
        rather than stay on the device."""
        return dataclasses.replace(self.dataset_config,
                                   cache_device_buckets=False)

    def _latent_table(self, latent: RandomEffectModel,
                      entities: np.ndarray) -> np.ndarray:
        """Per-sample latent coefficients from the entity table (0 for
        entities without a model: their rows contribute nothing)."""
        n_l = self.latent_dim
        uniq, inv = np.unique(np.maximum(entities, 0), return_inverse=True)
        ent = np.repeat(uniq, n_l)
        feat = np.tile(np.arange(n_l, dtype=np.int64), len(uniq))
        table = latent.lookup(ent, feat).reshape(len(uniq), n_l)
        v = table[inv]
        v[entities < 0] = 0.0
        return v

    def _projection_solve(self, problem: OptimizationProblem,
                          x: torch.Tensor, latent: RandomEffectModel,
                          offsets: torch.Tensor,
                          p0: np.ndarray) -> np.ndarray:
        """``v`` fixed: solve ``P`` over every sample."""
        device = offsets.device
        entities = self.data.id_columns[self.dataset_config.random_effect_type]
        v = self._latent_table(latent, entities)
        design = FactoredDesign(x=x, v=torch.as_tensor(v, device=device),
                                latent_dim=self.latent_dim)
        glm_data = GLMData(
            design=design, labels=self.data.device_labels(device),
            offsets=offsets, weights=self.data.device_weights(device))
        result = problem.run(
            glm_data, torch.as_tensor(p0.reshape(-1), device=device),
            self.lam_projection)
        return result.w[0].cpu().numpy().astype(np.float32).reshape(
            self.latent_dim, x.shape[1])

    def train(self, offsets: torch.Tensor,
              warm_start: Optional[RandomEffectModel] = None,
              sweep: int = 0) -> tuple[RandomEffectModel, torch.Tensor]:
        device = offsets.device
        shard_id = self.dataset_config.feature_shard_id
        shard = self.data.shards[shard_id]
        if warm_start is not None and warm_start.projector is not None:
            p = warm_start.projector.matrix
        else:
            p = RandomProjector.build(shard.dim, self.latent_dim,
                                      self.dataset_config.seed).matrix
        solver = RandomEffectSolver(task=self.task, config=self.config,
                                    device=device, mesh=self.mesh)
        problem = OptimizationProblem(
            GLMObjective(loss=loss_for_task(self.task)),
            self.projection_config)
        # the dense shard, built once on the device for every alternation
        x = self.data.device_dense_shard(shard_id, torch.float32, device)
        offsets = offsets.to(torch.float32)
        latent = warm_start
        for _ in range(max(1, self.n_factored_iterations)):
            dataset = RandomEffectDataset.build(
                self.coordinate_id, self.data, self._ds_config,
                projector=RandomProjector(matrix=p))
            latent, _ = solver.train(dataset, offsets, self.lam,
                                     warm_start=latent)
            p = self._projection_solve(problem, x, latent, offsets, p)
        # a last latent solve, so the returned (v, P) pair is consistent
        dataset = RandomEffectDataset.build(
            self.coordinate_id, self.data, self._ds_config,
            projector=RandomProjector(matrix=p))
        latent, _ = solver.train(dataset, offsets, self.lam,
                                 warm_start=latent)
        # active and passive rows scored by the model's host join
        scores = torch.as_tensor(latent.score(self.data), dtype=torch.float32,
                                 device=device)
        return latent, scores
