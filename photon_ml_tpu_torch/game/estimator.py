"""GameEstimator: build datasets once, fit many configurations, pick the best.

Counterpart of ``photon_ml_tpu/game/estimator.py``. The estimator builds the
coordinate datasets once (fixed-effect device designs, random-effect
buckets), then runs coordinate descent for each hyperparameter point (a set
of per-coordinate regularization weights) and evaluates validation data.
The first validation evaluator is the model-selection criterion.

The fit runs on ``device``, ``cuda`` unless the caller passes
``device="cpu"``: the score decomposition lives there. ``mesh`` (a
:class:`~photon_ml_tpu_torch.parallel.mesh.Mesh` of this process's slots)
shards the work as in the JAX package: a ``"data"`` axis splits every
fixed-effect solve's rows into blocks, one a slot; an ``"entity"`` axis
splits every random-effect coordinate's bucket lanes. Before the bucket
builds, :meth:`GameEstimator.prepare` builds the device images the
coordinates will read (dense shard images, labels, weights; not under a
mesh, whose paths place their own), and after them it holds the resident
buckets of all coordinates together to
:data:`~photon_ml_tpu_torch.game.data.RE_FAT_CACHE_MAX_BYTES`, turning the
largest to streaming until they fit. Then it starts, for each resident
random-effect dataset, a thread that builds what its sweeps reuse
(:func:`_start_warm_compile`). Warm starts (``initial_models``),
partial retraining (``locked``), checkpoints and resume, the divergence
guard, ``on_result``, L1 / elastic-net coordinates (OWL-QN), coefficient
variances, the RANDOM projector, factored random effects, down-sampling,
streaming buckets, a deferred (callable) validation set and the
score-memory guard (``max_score_memory_bytes``) are ported.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
from typing import Mapping, Optional, Sequence

import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation import EvaluationResults, Evaluator
from photon_ml_tpu_torch.game.coordinate import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.game.data import (
    DENSE_DESIGN_MAX_BYTES,
    FixedEffectDataset,
    GameData,
    RandomEffectDataset,
    RandomEffectDatasetConfig,
    choose_dense_design,
    design_dtype_of,
)
from photon_ml_tpu_torch.game.projector import ProjectorType
from photon_ml_tpu_torch.game.factored import FactoredRandomEffectCoordinate
from photon_ml_tpu_torch.game.model import GameModel
from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
from photon_ml_tpu_torch.sampling import DownSampler
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfig:
    """A fixed-effect coordinate: its feature shard, optimization settings,
    an optional down-sampler (a fresh weight vector each sweep) and the
    dtype its dense design is stored in on the device (``"float32"`` or
    ``"bfloat16"``)."""

    feature_shard_id: str
    optimization: GLMOptimizationConfiguration = GLMOptimizationConfiguration()
    downsampler: Optional[DownSampler] = None
    design_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfig:
    """A random-effect coordinate: its dataset settings, optimization
    settings and the dtype of its per-entity designs on the device."""

    dataset: RandomEffectDatasetConfig
    optimization: GLMOptimizationConfiguration = GLMOptimizationConfiguration()
    design_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectCoordinateConfig:
    """A factored random-effect coordinate (:mod:`~photon_ml_tpu_torch.game.
    factored`): ``dataset.projector_type`` must be RANDOM, its
    ``projected_dim`` is the latent dim; the latent solves take
    ``optimization``, the projection solves ``projection_optimization``."""

    dataset: RandomEffectDatasetConfig
    optimization: GLMOptimizationConfiguration = GLMOptimizationConfiguration()
    projection_optimization: GLMOptimizationConfiguration = (
        GLMOptimizationConfiguration())
    lam_projection: float = 0.0
    n_factored_iterations: int = 2


CoordinateConfig = (FixedEffectCoordinateConfig | RandomEffectCoordinateConfig
                    | FactoredRandomEffectCoordinateConfig)


@dataclasses.dataclass(frozen=True)
class GameOptimizationConfiguration:
    """One hyperparameter point: per-coordinate regularization weights."""

    regularization_weights: Mapping[str, float]

    def lam(self, coordinate_id: str) -> float:
        return float(self.regularization_weights.get(coordinate_id, 0.0))


@dataclasses.dataclass
class GameResult:
    """(model, validation evaluation, configuration) triple, plus the wall
    seconds of each coordinate step and the regularization weight each
    trained coordinate ended with (raised by the divergence guard's
    rollbacks)."""

    model: GameModel
    configuration: GameOptimizationConfiguration
    evaluation: Optional[EvaluationResults]
    validation_history: list[dict[str, float]]
    step_seconds: list = dataclasses.field(default_factory=list)
    regularization_weights: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GameEstimator:
    """Fits GAME models over a training set for many configurations."""

    task: TaskType
    coordinate_configs: Mapping[str, CoordinateConfig]
    update_sequence: Sequence[str]
    n_cd_iterations: int = 1
    #: the device every solve runs on (default ``"cuda"``)
    device: object = None
    #: a mesh of slots: ``"data"`` shards the fixed effects' rows,
    #: ``"entity"`` the random effects' bucket lanes
    mesh: Optional[object] = None
    #: the score-memory guard's budget (None: half the device's memory;
    #: the guard's error names this knob)
    max_score_memory_bytes: Optional[int] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # a coordinate may lack a config only if it is locked at fit time
        # (partial retraining); prepare() and fit() check against locked
        for cid, cfg in self.coordinate_configs.items():
            if not isinstance(cfg, (FixedEffectCoordinateConfig,
                                    RandomEffectCoordinateConfig,
                                    FactoredRandomEffectCoordinateConfig)):
                raise NotImplementedError(
                    f"coordinate {cid!r}: {type(cfg).__name__} is not ported")
            design_dtype_of(getattr(cfg, "design_dtype", "float32"))

    def _check_sequence(self, locked: Sequence[str]) -> None:
        locked = set(locked)
        for cid in self.update_sequence:
            if cid not in self.coordinate_configs and cid not in locked:
                raise KeyError(
                    f"update sequence names unknown coordinate {cid!r} "
                    f"(not configured, not locked)")
        # a locked coordinate outside the update sequence would vanish from
        # the model and the residual accounting
        missing = locked - set(self.update_sequence)
        if missing:
            raise ValueError(
                f"locked coordinates {sorted(missing)} must appear in the "
                f"update sequence to stay part of the model")

    def _entity_shards(self) -> int:
        """The slots of the mesh's ``"entity"`` axis (1 without one)."""
        if self.mesh is None:
            return 1
        from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS

        return int(self.mesh.shape.get(ENTITY_AXIS, 1))

    def _prefetch_device_feed(self, data: GameData,
                              locked: Sequence[str]) -> None:
        """Build on the estimator's device, before the bucket builds, the
        images the coordinates will read: each dense shard image a fixed
        effect or a resident INDEX_MAP random effect reads, and the labels
        and weights. Not under a mesh, whose paths place their own."""
        if self.mesh is not None:
            return
        seen: set = set()
        for cid in self.update_sequence:
            if cid in locked:
                continue
            cfg = self.coordinate_configs.get(cid)
            if isinstance(cfg, FixedEffectCoordinateConfig):
                sid = cfg.feature_shard_id
            elif isinstance(cfg, RandomEffectCoordinateConfig):
                if (not cfg.dataset.cache_device_buckets
                        or cfg.dataset.projector_type
                        is ProjectorType.RANDOM):
                    continue  # the solver reads no shared image
                sid = cfg.dataset.feature_shard_id
            else:
                continue
            dtype = design_dtype_of(cfg.design_dtype)
            fixed = isinstance(cfg, FixedEffectCoordinateConfig)
            if (sid, dtype, fixed) in seen:
                continue
            seen.add((sid, dtype, fixed))
            # the rule of the coordinate that reads the image
            # (FixedEffectDataset.build's, or the random-effect solver's
            # cap), so every image a coordinate reads exists before the
            # build threads start
            shard = data.shards[sid]
            itemsize = torch.empty((), dtype=dtype).element_size()
            if (choose_dense_design(shard, itemsize=itemsize) if fixed else
                    shard.n_samples * shard.dim * itemsize
                    <= DENSE_DESIGN_MAX_BYTES):
                data.device_dense_shard(sid, dtype, self.device)
            data.device_labels(self.device)
            data.device_weights(self.device)

    def prepare(self, data: GameData,
                locked: Sequence[str] = ()) -> dict[str, object]:
        """Build every trained coordinate's dataset (once per training
        set); a locked coordinate gets none."""
        self._check_sequence(locked)
        self._prefetch_device_feed(data, locked)
        datasets: dict[str, object] = {}
        ep = self._entity_shards()
        for cid in self.update_sequence:
            if cid in locked:
                continue
            cfg = self.coordinate_configs[cid]
            if isinstance(cfg, FixedEffectCoordinateConfig):
                datasets[cid] = FixedEffectDataset.build(
                    cid, data, cfg.feature_shard_id, dtype=cfg.design_dtype,
                    device=self.device, mesh=self.mesh)
            elif isinstance(cfg, FactoredRandomEffectCoordinateConfig):
                # rebuilt each alternation around the learned projection
                datasets[cid] = None
            else:
                ds = RandomEffectDataset.build(cid, data, cfg.dataset,
                                               n_entity_shards=ep)
                datasets[cid] = ds
                logger.info("coordinate %s: %d active entities in %d buckets,"
                            " %d passive rows, %d entity shard(s)", cid,
                            ds.n_active_entities, len(ds.buckets),
                            len(ds.passive_sample_idx), ep)
        # after the residency budget: the threads build for the datasets
        # that stay resident
        self._apply_fat_budget(data, datasets)
        for cid, ds in datasets.items():
            if isinstance(ds, RandomEffectDataset):
                cfg = self.coordinate_configs[cid]
                _start_warm_compile(
                    RandomEffectSolver(
                        task=self.task, config=cfg.optimization,
                        design_dtype=cfg.design_dtype, device=self.device,
                        mesh=self.mesh),
                    ds, data.shards[cfg.dataset.feature_shard_id].dim)
        return datasets

    def _apply_fat_budget(self, data: GameData, datasets) -> None:
        """Hold the resident buckets of all coordinates together to the
        per-device cap (each build's guard sees only its own): turn the
        largest to streaming until the total fits, then drop the dense
        shard images that no fixed effect and no resident coordinate
        reads."""
        from photon_ml_tpu_torch.game import data as gdata

        ep = self._entity_shards()
        resident = [
            (cid, ds, gdata.resident_fat_bytes(ds.buckets) // ep)
            for cid, ds in datasets.items()
            if isinstance(ds, RandomEffectDataset)
            and ds.config.cache_device_buckets]
        total = sum(f for _, _, f in resident)
        for cid, ds, f in sorted(resident, key=lambda t: -t[2]):
            if total <= gdata.RE_FAT_CACHE_MAX_BYTES:
                break
            logger.warning(
                "coordinate %s: flipping to upload-and-drop streaming — "
                "the coordinates' combined resident fat tensors "
                "(%.1f GiB/device) exceed the %.1f GiB cap",
                cid, total / 2**30, gdata.RE_FAT_CACHE_MAX_BYTES / 2**30)
            datasets[cid] = dataclasses.replace(
                ds, config=dataclasses.replace(
                    ds.config, cache_device_buckets=False))
            total -= f
        keep = set()
        for cid, cfg in self.coordinate_configs.items():
            if isinstance(cfg, FixedEffectCoordinateConfig):
                keep.add(cfg.feature_shard_id)
            elif isinstance(cfg, RandomEffectCoordinateConfig):
                ds = datasets.get(cid)
                if (isinstance(ds, RandomEffectDataset)
                        and ds.config.cache_device_buckets):
                    keep.add(cfg.dataset.feature_shard_id)
        # keys are ("dense_shard", shard id, dtype, device)
        for key in list(data._device_cache):
            if key[0] == "dense_shard" and key[1] not in keep:
                del data._device_cache[key]

    def _coordinates(self, data: GameData, datasets: Mapping[str, object],
                     config: GameOptimizationConfiguration,
                     locked: Sequence[str] = ()):
        out = {}
        for cid in self.update_sequence:
            if cid in locked:
                continue
            ccfg = self.coordinate_configs[cid]
            if isinstance(ccfg, FixedEffectCoordinateConfig):
                out[cid] = FixedEffectCoordinate(
                    coordinate_id=cid, dataset=datasets[cid], task=self.task,
                    config=ccfg.optimization, lam=config.lam(cid),
                    downsampler=ccfg.downsampler)
            elif isinstance(ccfg, FactoredRandomEffectCoordinateConfig):
                out[cid] = FactoredRandomEffectCoordinate(
                    coordinate_id=cid, data=data,
                    dataset_config=ccfg.dataset, task=self.task,
                    config=ccfg.optimization,
                    projection_config=ccfg.projection_optimization,
                    lam=config.lam(cid), lam_projection=ccfg.lam_projection,
                    n_factored_iterations=ccfg.n_factored_iterations,
                    mesh=self.mesh)
            else:
                out[cid] = RandomEffectCoordinate(
                    coordinate_id=cid, dataset=datasets[cid], data=data,
                    task=self.task, config=ccfg.optimization,
                    lam=config.lam(cid), design_dtype=ccfg.design_dtype,
                    mesh=self.mesh)
        return out

    def fingerprint(self, data: GameData,
                    config: GameOptimizationConfiguration,
                    locked: Sequence[str] = ()) -> str:
        """The run-shape identity a checkpoint is saved and resumed under:
        the weights, the update sequence, the sweep count, the locked set,
        the sample count and every coordinate's full configuration (a
        deterministic dataclass ``repr``)."""
        return json.dumps({
            "weights": sorted(config.regularization_weights.items()),
            "update_sequence": list(self.update_sequence),
            "n_cd_iterations": self.n_cd_iterations,
            "locked": sorted(locked),
            "n_samples": data.n_samples,
            "configs": {c: repr(self.coordinate_configs.get(c))
                        for c in self.update_sequence},
        }, sort_keys=True)

    def fit(self, data: GameData,
            configurations: Sequence[GameOptimizationConfiguration],
            validation: Optional[tuple[GameData, Sequence[Evaluator]]] = None,
            datasets: Optional[Mapping[str, object]] = None,
            initial_models: Optional[Mapping[str, object]] = None,
            locked: Sequence[str] = (), checkpoint=None, resume: bool = False,
            guard=None, on_result=None) -> list[GameResult]:
        """One :class:`GameResult` per configuration. ``datasets`` (from
        :meth:`prepare`) lets repeated fits share the dataset builds;
        ``validation`` is ``(GameData, evaluators)``, or a zero-argument
        callable returning it, called where the first sweep's evaluation
        needs it (a driver can keep the validation read in flight while
        the first sweep trains).
        ``initial_models``/``locked`` are the partial-retrain path (warm
        start from a saved model; locked coordinates keep their model and
        never train). ``checkpoint``/``resume`` persist and restore
        coordinate-boundary state (one configuration only). ``guard`` is
        the divergence guard, shared by the configurations.
        ``on_result(index, result)`` fires as each configuration ends."""
        self._check_sequence(locked)
        if checkpoint is not None and len(configurations) != 1:
            raise ValueError(
                "checkpointing supports exactly one configuration")
        if datasets is None:
            datasets = self.prepare(data, locked=locked)
        cd = CoordinateDescent(
            update_sequence=self.update_sequence,
            n_iterations=self.n_cd_iterations,
            max_score_memory_bytes=self.max_score_memory_bytes)
        results: list[GameResult] = []
        for config in configurations:
            coordinates = self._coordinates(data, datasets, config, locked)
            cd_result = cd.run(
                coordinates, data, self.task, self.device,
                validation=validation, initial_models=initial_models,
                checkpoint=checkpoint, resume=resume, locked=locked,
                config_fingerprint=self.fingerprint(data, config, locked),
                guard=guard)
            results.append(GameResult(
                model=cd_result.model, configuration=config,
                evaluation=cd_result.final_evaluation,
                validation_history=cd_result.validation_history,
                step_seconds=cd_result.step_seconds,
                regularization_weights=cd_result.regularization_weights))
            logger.info("configuration %s -> %s",
                        dict(config.regularization_weights),
                        cd_result.final_evaluation)
            if on_result is not None:
                on_result(len(results) - 1, results[-1])
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


def _start_warm_compile(solver: RandomEffectSolver,
                        dataset: RandomEffectDataset, dim: int) -> None:
    """Start, on a daemon thread, the build of what every sweep of a
    resident random-effect dataset reuses (:meth:`~photon_ml_tpu_torch.
    game.random_effect.RandomEffectSolver._warm_compile`: statics, index
    uploads, joins, the key order), so it overlaps the fixed-effect stage.
    The JAX package compiles its sweep program there; the port has nothing
    to compile. ``solver`` is the one the coordinate builds (task,
    configuration, dtype, device, mesh), so its caches are the ones the
    sweeps read; ``train`` joins the thread before it reads them."""
    if not solver._fused_eligible(dataset):
        return
    th = threading.Thread(target=solver._warm_compile, args=(dataset, dim),
                          daemon=True,
                          name=f"photon-re-warm-{dataset.coordinate_id}")
    object.__setattr__(dataset, "_warm_thread", th)
    th.start()
