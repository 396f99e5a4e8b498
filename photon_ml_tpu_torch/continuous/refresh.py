"""The incremental refresh loop: warm-start everything, re-solve only
touched random-effect entities, carry the rest forward.

Counterpart of ``photon_ml_tpu/continuous/refresh.py``. Coordinate
descent's residual accounting replaces a coordinate's whole score vector
when the coordinate trains, so a random-effect coordinate restricted to
touched entities would lose the carried entities' scores. The refresh loop
keeps CD's discipline — ``total = offsets + Σ scores[c]``, train against
``total - scores[c]`` — but merges per coordinate: touched entities' rows
take the fresh solve's scores, carried entities' rows keep the prior
model's (seeded once from ``model.score(data)``, as CD seeds
``initial_models``). The score vectors live on the device.

The touched-only solve is the full path: the untouched entities are masked
to id ``-1`` (the reader's "missing id"), so
:meth:`~photon_ml_tpu_torch.game.data.RandomEffectDataset.build` gives them
no rows, no buckets and no solves, and the touched entities' buckets are
solved by the same :class:`~photon_ml_tpu_torch.game.coordinate.
RandomEffectCoordinate` as cold training (kernel 2), warm-started from the
prior model's table. Fixed effects always retrain (kernel 1). Carried
entities' coefficients pass through :meth:`RandomEffectModel.merge`
untouched, so they come back bit for bit.

Observability: the ``photon_refresh_*`` counters (touched / carried /
solved entities per coordinate, patch bytes at publish).
:func:`partition_patch_by_shard` splits a refresh's patch into the
per-host patches of an entity-sharded serving fleet. Each sweep is a
``refresh.sweep`` span, each coordinate step a ``refresh.step`` span and
each validation a ``refresh.validate`` span, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation import evaluate_all
from photon_ml_tpu_torch.game.coordinate import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.data import (
    FixedEffectDataset,
    GameData,
    RandomEffectDataset,
)
from photon_ml_tpu_torch.game.estimator import (
    FixedEffectCoordinateConfig,
    GameOptimizationConfiguration,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.fleet.sharding import shard_of_id
from photon_ml_tpu_torch.game.model import GameModel, RandomEffectModel
from photon_ml_tpu_torch.telemetry import metrics as tmetrics
from photon_ml_tpu_torch.telemetry import tracing
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


def _touched_counter():
    return tmetrics.counter(
        "photon_refresh_touched_entities_total",
        "Entities whose training data changed since the parent model "
        "(refit candidates), per refresh run", labels=("coordinate",))


def _carried_counter():
    return tmetrics.counter(
        "photon_refresh_carried_entities_total",
        "Entities whose coefficients carried forward untouched (unchanged "
        "or absent data)", labels=("coordinate",))


def _solved_counter():
    return tmetrics.counter(
        "photon_refresh_solved_entities_total",
        "Random-effect entities actually re-solved by the incremental "
        "refit (== touched entities surviving the active-data bounds, "
        "once per refresh sweep)", labels=("coordinate",))


def patch_bytes_counter():
    return tmetrics.counter(
        "photon_refresh_patch_bytes_total",
        "Bytes of published entity-level coefficient patches")


@dataclasses.dataclass
class CoordinateRefreshStats:
    """Per-coordinate accounting of one refresh run."""

    touched: int = 0
    carried: int = 0
    solved: int = 0


@dataclasses.dataclass
class RefreshResult:
    """One refresh run's outputs.

    ``model`` is the merged full model (touched entities fresh, carried
    entities bit-identical to the parent). ``patch`` holds only what
    changed: every fixed-effect coordinate's model plus, per touched
    random-effect coordinate, a partial model of just the re-solved
    entities. ``removed`` lists dense entity ids whose models vanished
    (touched entities that no longer clear the active-data bounds).
    """

    model: GameModel
    patch: dict[str, object]
    removed: dict[str, list[int]]
    stats: dict[str, CoordinateRefreshStats]
    validation_history: list[dict]
    final_evaluation: object = None


def partition_patch_by_shard(patch: Mapping[str, object],
                             removed_raw: Mapping[str, Sequence[str]],
                             vocabs: Mapping[str, Mapping[str, int]],
                             n_shards: int) -> list:
    """Split one refresh's coefficient patch into N per-host patches for
    an entity-sharded serving fleet (``refresh_game --fleet-shards N``).

    Shard ``i``'s patch carries every fixed-effect coordinate's model in
    full (the fixed effect is replicated on every host) and each
    random-effect coordinate's partial model restricted to the re-solved
    entities whose raw ids hash to shard ``i``
    (``fleet/sharding.py::shard_of_id``, the function the serving store
    packs by); ``removed_raw``'s raw ids partition the same way. Returns
    ``[(patch_models, removed), ...]`` indexed by shard. Every touched
    entity lands in exactly one shard's patch.
    """
    out = []
    for shard in range(int(n_shards)):
        models: dict[str, object] = {}
        removed: dict[str, list] = {}
        for cid, model in patch.items():
            if not isinstance(model, RandomEffectModel):
                models[cid] = model  # the fixed effect: on every host
                continue
            reverse = {int(d): raw
                       for raw, d in vocabs[model.random_effect_type].items()}
            keys = np.asarray(model.keys, np.int64)
            ent = keys // model.dim
            mask = (np.fromiter(
                (shard_of_id(reverse[int(e)], n_shards) == shard
                 for e in ent), bool, count=len(ent))
                if len(ent) else np.zeros(0, bool))
            models[cid] = dataclasses.replace(
                model, keys=keys[mask],
                coeffs=np.asarray(model.coeffs)[mask],
                variances=(None if model.variances is None
                           else np.asarray(model.variances)[mask]),
                coeffs_device=None)
        for cid, raws in (removed_raw or {}).items():
            mine = [raw for raw in raws
                    if shard_of_id(raw, n_shards) == shard]
            if mine:
                removed[cid] = mine
        out.append((models, removed))
    return out


def _masked_view(data: GameData, re_type: str,
                 touched: np.ndarray) -> tuple[GameData, np.ndarray]:
    """A view of ``data`` where every entity not in ``touched`` reads as
    absent (id ``-1``), so the dataset build buckets only touched
    entities. It shares the original's device cache; the fixed effect
    builds on ``data`` itself and the random-effect solver keeps its bucket
    images in its own dataset, so the view uploads nothing twice."""
    ids = data.id_columns[re_type]
    keep = np.isin(ids, touched)
    view = dataclasses.replace(
        data, id_columns={**data.id_columns,
                          re_type: np.where(keep, ids, np.int64(-1))})
    object.__setattr__(view, "_device_cache", data._device_cache)
    return view, keep


def refresh_game_model(
    task: TaskType,
    coordinate_configs: Mapping[str, object],
    update_sequence: Sequence[str],
    data: GameData,
    configuration: GameOptimizationConfiguration,
    initial_models: Mapping[str, object],
    touched_entities: Mapping[str, np.ndarray],
    *,
    n_sweeps: int = 1,
    validation=None,
    device=None,
) -> RefreshResult:
    """Run ``n_sweeps`` incremental refresh sweeps on ``device`` (``cuda``
    unless the caller passes ``device="cpu"``).

    ``initial_models`` must cover every coordinate of the update sequence.
    ``touched_entities`` maps random-effect coordinate ids to the dense
    entity ids whose data changed; a missing or empty entry carries the
    whole coordinate forward without a solve. Fixed-effect coordinates
    always retrain, warm-started from the prior coefficients.
    ``validation`` is ``(GameData, evaluators)`` or None.
    """
    device = resolve_device(device)
    seq = list(update_sequence)
    missing = [cid for cid in seq if cid not in initial_models]
    if missing:
        raise ValueError(
            f"refresh needs a prior model for every coordinate; missing "
            f"{missing} — run a full train_game for new coordinates")
    models: dict[str, object] = {cid: initial_models[cid] for cid in seq}
    prior_entities: dict[str, np.ndarray] = {}

    # --- build coordinates once (touched-only datasets for REs) -----------
    coords: dict[str, object] = {}
    touched_masks: dict[str, torch.Tensor] = {}
    stats = {cid: CoordinateRefreshStats() for cid in seq}
    for cid in seq:
        cfg = coordinate_configs.get(cid)
        if isinstance(cfg, FixedEffectCoordinateConfig):
            ds = FixedEffectDataset.build(cid, data, cfg.feature_shard_id,
                                          dtype=cfg.design_dtype,
                                          device=device)
            coords[cid] = FixedEffectCoordinate(
                coordinate_id=cid, dataset=ds, task=task,
                config=cfg.optimization, lam=configuration.lam(cid),
                downsampler=cfg.downsampler)
        elif isinstance(cfg, RandomEffectCoordinateConfig):
            prior = models[cid]
            prior_entities[cid] = (
                np.unique(prior.keys // prior.dim) if len(prior.keys)
                else np.zeros(0, np.int64))
            touched = np.asarray(touched_entities.get(cid, ()), np.int64)
            stats[cid].touched = len(touched)
            if not len(touched):
                continue  # whole coordinate carries forward
            view, keep = _masked_view(
                data, cfg.dataset.random_effect_type, touched)
            ds = RandomEffectDataset.build(cid, view, cfg.dataset)
            coords[cid] = RandomEffectCoordinate(
                coordinate_id=cid, dataset=ds, data=view, task=task,
                config=cfg.optimization, lam=configuration.lam(cid),
                design_dtype=cfg.design_dtype)
            touched_masks[cid] = torch.as_tensor(keep, device=device)
        else:
            raise ValueError(
                f"refresh does not support coordinate {cid!r} of type "
                f"{type(cfg).__name__} (factored coordinates re-learn a "
                f"projection — run a full retrain)")

    # --- seed the score decomposition from the prior model ----------------
    scores = {cid: torch.as_tensor(
        np.asarray(models[cid].score(data), np.float32), device=device)
        for cid in seq}
    total = torch.as_tensor(data.offsets, dtype=torch.float32, device=device)
    for cid in seq:
        total = total + scores[cid]

    patch: dict[str, object] = {}
    history: list[dict] = []
    final_evaluation = None
    for sweep in range(n_sweeps):
        with tracing.span("refresh.sweep", sweep=sweep):
            for cid in seq:
                coord = coords.get(cid)
                if coord is None:
                    continue  # carried random-effect coordinate
                with tracing.span("refresh.step", coordinate=cid,
                                  sweep=sweep):
                    residual = total - scores[cid]
                    with torch.profiler.record_function(
                            f"refresh.step[{cid}]"):
                        model, new_scores = coord.train(
                            residual, models.get(cid), sweep=sweep)
                    if isinstance(coord, RandomEffectCoordinate):
                        _solved_counter().labels(coordinate=cid).inc(
                            model.n_entities)
                        stats[cid].solved += model.n_entities
                        new_scores = torch.where(touched_masks[cid],
                                                 new_scores, scores[cid])
                        patch[cid] = model
                        model = models[cid].merge(
                            model,
                            drop_entities=touched_entities.get(cid, ()))
                    else:
                        patch[cid] = model
                    models[cid] = model
                    scores[cid] = new_scores
                    total = residual + new_scores
            if validation is not None:
                vdata, evaluators = validation
                with tracing.span("refresh.validate", sweep=sweep):
                    gm = GameModel(coordinates={c: models[c] for c in seq},
                                   task=task)
                    results = evaluate_all(
                        evaluators, gm.score(vdata), vdata.labels,
                        weights=vdata.weights, id_tags=vdata.id_columns)
                history.append(results.as_dict())
                final_evaluation = results
                logger.info("refresh sweep %d validation: %s", sweep,
                            results)

    # carried accounting + removals (touched entities that fell below the
    # active-data bounds: merge dropped their prior rows, and the patch
    # must tell serving to zero them)
    removed: dict[str, list[int]] = {}
    for cid in seq:
        cfg = coordinate_configs.get(cid)
        if not isinstance(cfg, RandomEffectCoordinateConfig):
            continue
        touched = np.asarray(touched_entities.get(cid, ()), np.int64)
        merged = models[cid]
        kept = (np.unique(merged.keys // merged.dim) if len(merged.keys)
                else np.zeros(0, np.int64))
        stats[cid].carried = int(
            len(np.setdiff1d(prior_entities[cid], touched)))
        gone = np.setdiff1d(
            np.intersect1d(touched, prior_entities[cid]), kept)
        if len(gone):
            removed[cid] = [int(e) for e in gone]
        _touched_counter().labels(coordinate=cid).inc(len(touched))
        _carried_counter().labels(coordinate=cid).inc(stats[cid].carried)
    return RefreshResult(
        model=GameModel(coordinates={cid: models[cid] for cid in seq},
                        task=task),
        patch=patch, removed=removed, stats=stats,
        validation_history=history, final_evaluation=final_evaluation)
