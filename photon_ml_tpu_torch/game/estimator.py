"""GameEstimator: build datasets once, fit many configurations, pick the best.

Counterpart of ``photon_ml_tpu/game/estimator.py``. The estimator builds the
coordinate datasets once (fixed-effect device designs, random-effect
buckets), then runs coordinate descent for each hyperparameter point (a set
of per-coordinate regularization weights) and evaluates validation data.
The first validation evaluator is the model-selection criterion.

``device`` takes the place of the JAX version's ``mesh``: the fit runs on
one device, ``cuda`` unless the caller passes ``device="cpu"``. Not ported
yet (each raises :class:`NotImplementedError` naming the option): meshes,
factored random effects, down-sampling, coefficient variances, partial
retraining (``locked``), checkpoints, the divergence guard and
``on_result``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Optional, Sequence

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation import EvaluationResults, Evaluator
from photon_ml_tpu_torch.game.coordinate import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.game.data import (
    FixedEffectDataset,
    GameData,
    RandomEffectDataset,
    RandomEffectDatasetConfig,
    design_dtype_of,
)
from photon_ml_tpu_torch.game.model import GameModel
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

logger = logging.getLogger(__name__)


def _check_ported(optimization: GLMOptimizationConfiguration) -> None:
    optimization.check_ported()
    if optimization.variance_type != VarianceComputationType.NONE:
        raise NotImplementedError(
            f"variance_type {optimization.variance_type.value}: GAME "
            "coordinate variances are not ported")


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfig:
    """A fixed-effect coordinate: its feature shard, optimization settings
    and the dtype its dense design is stored in on the device
    (``"float32"`` or ``"bfloat16"``)."""

    feature_shard_id: str
    optimization: GLMOptimizationConfiguration = GLMOptimizationConfiguration()
    downsampler: Optional[object] = None
    design_dtype: str = "float32"

    def check_ported(self) -> None:
        _check_ported(self.optimization)
        design_dtype_of(self.design_dtype)
        if self.downsampler is not None:
            raise NotImplementedError("downsampler: down-sampling is not "
                                      "ported")


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfig:
    """A random-effect coordinate: its dataset settings, optimization
    settings and the dtype of its per-entity designs on the device."""

    dataset: RandomEffectDatasetConfig
    optimization: GLMOptimizationConfiguration = GLMOptimizationConfiguration()
    design_dtype: str = "float32"

    def check_ported(self) -> None:
        _check_ported(self.optimization)
        self.dataset.check_ported()
        design_dtype_of(self.design_dtype)


CoordinateConfig = FixedEffectCoordinateConfig | RandomEffectCoordinateConfig


@dataclasses.dataclass(frozen=True)
class GameOptimizationConfiguration:
    """One hyperparameter point: per-coordinate regularization weights."""

    regularization_weights: Mapping[str, float]

    def lam(self, coordinate_id: str) -> float:
        return float(self.regularization_weights.get(coordinate_id, 0.0))


@dataclasses.dataclass
class GameResult:
    """(model, validation evaluation, configuration) triple, plus the wall
    seconds of each coordinate step."""

    model: GameModel
    configuration: GameOptimizationConfiguration
    evaluation: Optional[EvaluationResults]
    validation_history: list[dict[str, float]]
    step_seconds: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GameEstimator:
    """Fits GAME models over a training set for many configurations."""

    task: TaskType
    coordinate_configs: Mapping[str, CoordinateConfig]
    update_sequence: Sequence[str]
    n_cd_iterations: int = 1
    #: the device every solve runs on (default ``"cuda"``)
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for cid in self.update_sequence:
            if cid not in self.coordinate_configs:
                raise KeyError(
                    f"update sequence names unknown coordinate {cid!r}")
            cfg = self.coordinate_configs[cid]
            if not isinstance(cfg, (FixedEffectCoordinateConfig,
                                    RandomEffectCoordinateConfig)):
                raise NotImplementedError(
                    f"coordinate {cid!r}: {type(cfg).__name__} is not ported")
            cfg.check_ported()

    def prepare(self, data: GameData) -> dict[str, object]:
        """Build every coordinate's dataset (once per training set)."""
        datasets: dict[str, object] = {}
        for cid in self.update_sequence:
            cfg = self.coordinate_configs[cid]
            if isinstance(cfg, FixedEffectCoordinateConfig):
                datasets[cid] = FixedEffectDataset.build(
                    cid, data, cfg.feature_shard_id, dtype=cfg.design_dtype,
                    device=self.device)
            else:
                ds = RandomEffectDataset.build(cid, data, cfg.dataset)
                datasets[cid] = ds
                logger.info("coordinate %s: %d active entities in %d buckets,"
                            " %d passive rows", cid, ds.n_active_entities,
                            len(ds.buckets), len(ds.passive_sample_idx))
        return datasets

    def _coordinates(self, data: GameData, datasets: Mapping[str, object],
                     config: GameOptimizationConfiguration):
        out = {}
        for cid in self.update_sequence:
            ccfg = self.coordinate_configs[cid]
            if isinstance(ccfg, FixedEffectCoordinateConfig):
                out[cid] = FixedEffectCoordinate(
                    coordinate_id=cid, dataset=datasets[cid], task=self.task,
                    config=ccfg.optimization, lam=config.lam(cid))
            else:
                out[cid] = RandomEffectCoordinate(
                    coordinate_id=cid, dataset=datasets[cid], data=data,
                    task=self.task, config=ccfg.optimization,
                    lam=config.lam(cid), design_dtype=ccfg.design_dtype)
        return out

    def fit(self, data: GameData,
            configurations: Sequence[GameOptimizationConfiguration],
            validation: Optional[tuple[GameData, Sequence[Evaluator]]] = None,
            datasets: Optional[Mapping[str, object]] = None,
            initial_models: Optional[Mapping[str, object]] = None,
            locked: Sequence[str] = (), checkpoint=None, resume: bool = False,
            guard=None, on_result=None) -> list[GameResult]:
        """One :class:`GameResult` per configuration. ``datasets`` (from
        :meth:`prepare`) lets repeated fits share the dataset builds;
        ``validation`` is ``(GameData, evaluators)``."""
        for name, value in (("initial_models", initial_models),
                            ("checkpoint", checkpoint), ("guard", guard),
                            ("on_result", on_result)):
            if value is not None:
                raise NotImplementedError(f"{name} is not ported")
        if locked:
            raise NotImplementedError("locked (partial retraining) is not "
                                      "ported")
        if resume:
            raise NotImplementedError("resume is not ported")
        if callable(validation):
            raise NotImplementedError("a deferred (callable) validation set "
                                      "is not ported")
        if datasets is None:
            datasets = self.prepare(data)
        cd = CoordinateDescent(update_sequence=self.update_sequence,
                               n_iterations=self.n_cd_iterations)
        results: list[GameResult] = []
        for config in configurations:
            coordinates = self._coordinates(data, datasets, config)
            cd_result = cd.run(coordinates, data, self.task, self.device,
                               validation=validation)
            results.append(GameResult(
                model=cd_result.model, configuration=config,
                evaluation=cd_result.final_evaluation,
                validation_history=cd_result.validation_history,
                step_seconds=cd_result.step_seconds))
            logger.info("configuration %s -> %s",
                        dict(config.regularization_weights),
                        cd_result.final_evaluation)
        return results

    @staticmethod
    def select_best(results: Sequence[GameResult]) -> GameResult:
        """Best by the first validation evaluator (reference ModelSelection)."""
        scored = [r for r in results if r.evaluation is not None]
        if not scored:
            return results[0]
        best = scored[0]
        for r in scored[1:]:
            ev, val = r.evaluation.primary
            if ev.better_than(val, best.evaluation.primary[1]):
                best = r
        return best
