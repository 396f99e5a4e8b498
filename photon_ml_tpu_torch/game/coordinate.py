"""GAME coordinates: one trainable block of the additive model.

Counterpart of ``photon_ml_tpu/game/coordinate.py``. A coordinate owns its
dataset and optimization problem; ``train(offsets, warm_start)`` fits
against the residual offsets coordinate descent supplies and returns
``(model, scores)``, ``scores`` being this coordinate's margin per global
sample as a device vector. ``sweep`` is the coordinate-descent sweep, which
keys the fixed effect's down-sampling draw. The fixed-effect solve is
profiled as ``game.fixed_effect`` (``game.fixed_effect.dist`` on a data
mesh; :mod:`~photon_ml_tpu_torch.telemetry.profiling`), and under a trace
its optimizer trace is folded into telemetry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import (
    FixedEffectDataset,
    GameData,
    RandomEffectDataset,
)
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    RandomEffectModel,
    key_join,
)
from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
from photon_ml_tpu_torch.glm.problem import (
    GLMOptimizationConfiguration,
    OptimizationProblem,
)
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.objective import GLMObjective
from photon_ml_tpu_torch.sampling import DownSampler
from photon_ml_tpu_torch.telemetry import profiling, tracing
from photon_ml_tpu_torch.types import TaskType

CoordinateModel = Union[FixedEffectModel, RandomEffectModel]


def _fixed_effect_solve(problem: OptimizationProblem, data, w0, lam):
    """The fixed-effect train step: the solve, its variances and the
    offset-free margins."""
    result = problem.run(data, w0, lam)
    w = result.w[0]
    return (result, w, problem.compute_variances(w, data, lam),
            data.design.matvec(w))


_fixed_effect_solve_profiled = profiling.profile_fn(
    _fixed_effect_solve, "game.fixed_effect")


def _fixed_effect_solve_dist(problem: OptimizationProblem, data, w0, lam,
                             n_samples: int):
    """The sharded train step over a :class:`~photon_ml_tpu_torch.parallel.
    distributed.MeshGLMData`: the solve, its variances over every block and
    the offset-free margins (coordinate descent owns the offsets), cut to
    the ``n_samples`` real rows."""
    result = problem.run(data, w0, lam)
    w = result.w[0]
    no_off = data.replace_rows(offsets=torch.zeros(
        data.n_samples, dtype=torch.float32))
    scores = problem.objective.margins(w, no_off).reshape(-1)[:n_samples]
    return (result, w, problem.compute_variances(w, data, lam), scores)


_fixed_effect_solve_dist_profiled = profiling.profile_fn(
    _fixed_effect_solve_dist, "game.fixed_effect.dist")


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinate:
    """The global GLM solve (reference ``FixedEffectCoordinate.scala``):
    one-lane L-BFGS, OWL-QN (an L1 part) or TRON solve whose every
    evaluation on a dense design is one launch of the fused fixed-effect
    kernel (:mod:`~photon_ml_tpu_torch.ops.fused_glm`) and, under TRON,
    every CG product one launch of the Hvp kernel
    (:mod:`~photon_ml_tpu_torch.ops.fused_hvp`); a chunked sparse design
    takes the closed forms. Variances, when configured, are computed at the
    solution. With a ``downsampler`` each sweep trains on a fresh weight
    vector drawn on the host (rows dropped weigh 0, kept rows 1/rate): only
    the device weights change, the design stays. A dataset sharded over a
    data mesh trains through :class:`~photon_ml_tpu_torch.parallel.
    distributed.DistributedGLMObjective` (each evaluation a launch on every
    block); its scores come back to the device of ``offsets``."""

    coordinate_id: str
    dataset: FixedEffectDataset
    task: TaskType
    config: GLMOptimizationConfiguration
    lam: float = 0.0
    downsampler: Optional[DownSampler] = None

    def __post_init__(self):
        self.config.regularization.check_weight(self.lam)

    def train(self, offsets: torch.Tensor,
              warm_start: Optional[FixedEffectModel] = None,
              sweep: int = 0) -> tuple[FixedEffectModel, torch.Tensor]:
        data = self.dataset.glm_data(offsets)
        sharded = self.dataset.n_shards > 1
        # the solve's device: the first block's slot on a data mesh
        device = data.device if sharded else offsets.device
        if self.downsampler is not None:
            # keyed per (seed, sweep, row id): the same draw on any device
            # and any number of blocks (padding rows draw too, at weight 0)
            labels = (data.gather("labels") if sharded
                      else data.labels).cpu().numpy()
            old = (data.gather("weights") if sharded
                   else data.weights).cpu().numpy()
            weights = self.downsampler.downsample(
                labels, old, sweep=sweep,
                uids=np.arange(labels.size, dtype=np.int64))
            data = (data.replace_rows(weights=torch.as_tensor(weights))
                    if sharded else dataclasses.replace(
                        data, weights=torch.as_tensor(weights,
                                                      device=device)))
        w0 = (torch.zeros(self.dataset.dim, dtype=torch.float32, device=device)
              if warm_start is None
              else warm_start.model.coefficients.means.to(device))
        objective = GLMObjective(loss=loss_for_task(self.task))
        if sharded:
            from photon_ml_tpu_torch.parallel.distributed import (
                DistributedGLMObjective,
            )

            problem = OptimizationProblem(
                DistributedGLMObjective(objective, mesh=self.dataset.mesh),
                self.config)
            result, w, variances, scores = _fixed_effect_solve_dist_profiled(
                problem, data, w0, self.lam, self.dataset.n_samples)
            scores = scores.to(offsets.device)
        else:
            problem = OptimizationProblem(objective, self.config)
            result, w, variances, scores = _fixed_effect_solve_profiled(
                problem, data, w0, self.lam)
        if tracing.enabled():
            # the optimizer's (loss, |grad|) table into trace.jsonl and the
            # registry; gated, since reading it syncs the device
            from photon_ml_tpu_torch.glm.training import lane_result
            from photon_ml_tpu_torch.telemetry import record_optimizer_trace

            record_optimizer_trace(self.coordinate_id,
                                   lane_result(result, 0), sweep=sweep)
        model = FixedEffectModel(
            model=GeneralizedLinearModel(
                coefficients=Coefficients(means=w, variances=variances),
                task=self.task),
            feature_shard_id=self.dataset.feature_shard_id)
        return model, scores


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinate:
    """Per-entity solves for one random-effect coordinate (reference
    ``RandomEffectCoordinate.scala``). Active samples are scored on the
    device in the bucket layout; passive samples (rows excluded from
    training by the active-data bounds) are scored on the device too,
    from the model's ``coeffs_device`` through a cached join
    (:meth:`_passive_scores_device`), and by the model's host join where
    it has no device table (a projected, loaded or empty model). A
    ``mesh`` with an ``"entity"`` axis splits each bucket's lanes over its
    slots (:class:`~photon_ml_tpu_torch.game.random_effect.
    RandomEffectSolver`)."""

    coordinate_id: str
    dataset: RandomEffectDataset
    data: GameData
    task: TaskType
    config: GLMOptimizationConfiguration
    lam: float = 0.0
    design_dtype: str = "float32"
    mesh: Optional[object] = None

    def __post_init__(self):
        self.config.regularization.check_weight(self.lam)

    def train(self, offsets: torch.Tensor,
              warm_start: Optional[RandomEffectModel] = None,
              sweep: int = 0) -> tuple[RandomEffectModel, torch.Tensor]:
        solver = RandomEffectSolver(task=self.task, config=self.config,
                                    design_dtype=self.design_dtype,
                                    device=offsets.device, mesh=self.mesh)
        shard_dim = self.data.shards[self.dataset.config.feature_shard_id].dim
        model, scores = solver.train(self.dataset, offsets, self.lam,
                                     warm_start, dim=shard_dim)
        passive = self.dataset.passive_sample_idx
        if len(passive):
            if (model.coeffs_device is not None and len(model.keys)
                    and model.projector is None):
                self._passive_scores_device(model, scores)
            else:
                scores[torch.as_tensor(passive, device=scores.device)] = \
                    torch.as_tensor(model.score(self.data,
                                                sample_idx=passive),
                                    device=scores.device)
        return model, scores

    def _passive_scores_device(self, model: RandomEffectModel,
                               scores: torch.Tensor) -> None:
        """Score the passive rows into ``scores`` on the device: each
        row's nonzeros laid out densely, ``(rows, most nonzeros of a
        row)`` with 0 on padding, their positions in the model's key table
        and whether each was found, built once on the host and cached with
        the key table they join (a model of another key table rebuilds
        them). A sweep is then one gather from ``coeffs_device`` and a sum
        over each row in f32, whose order is fixed by the layout: the same
        bits on every run, where a scatter-add on the card adds in a
        varying order."""
        cache = self.dataset._device_cache
        key = ("passive", str(scores.device))
        entry = cache.get(key)
        if entry is not None and not (entry[0] is model.keys
                                      or np.array_equal(entry[0], model.keys)):
            entry = None
        if entry is None:
            passive = self.dataset.passive_sample_idx
            sub = self.data.shards[
                self.dataset.config.feature_shard_id].take(passive)
            counts = sub.row_counts()
            rows = sub.rows()
            slot = np.arange(sub.nnz) - np.repeat(sub.indptr[:-1], counts)
            ents = self.data.id_columns[
                self.dataset.config.random_effect_type][passive][rows]
            pos, found = key_join(model.keys, model.dim, ents, sub.cols)
            shape = (len(passive), max(int(counts.max(initial=0)), 1))
            vals_d = np.zeros(shape, np.float32)
            pos_d = np.zeros(shape, np.int64)
            found_d = np.zeros(shape, bool)
            vals_d[rows, slot] = sub.vals
            pos_d[rows, slot] = pos
            found_d[rows, slot] = found
            dev = scores.device
            entry = (model.keys, tuple(
                torch.as_tensor(a, device=dev)
                for a in (vals_d, pos_d, found_d, passive)))
            if self.dataset.config.cache_device_buckets:
                # a streaming dataset keeps nothing between sweeps
                cache[key] = entry
        vals, pos, found, rows = entry[1]
        scores[rows] = _passive_segment_scores(model.coeffs_device, vals, pos,
                                               found)


def _passive_segment_scores(coeffs_device: torch.Tensor, vals: torch.Tensor,
                            pos: torch.Tensor,
                            found: torch.Tensor) -> torch.Tensor:
    """Each passive row's margin: its nonzeros times their coefficients
    (0 where a slot is absent or padding), summed over the row in f32."""
    coeff = torch.where(found, coeffs_device.to(vals.device)[pos], 0.0)
    return (vals * coeff).sum(-1)


Coordinate = Union[FixedEffectCoordinate, RandomEffectCoordinate]
