"""Continuous-training refresh (counterpart of ``photon_ml_tpu/cli/refresh_game.py``).

The periodic retrain of a continuously refreshing GLMix deployment:
warm-start every optimizer from a published model, re-solve only the
random-effect entities whose training data changed since that model's run
(the ``data-manifest.json`` diff), carry every other entity's coefficients
forward bit for bit, and publish a full merged model directory (the next
refresh's parent) and an entity-level coefficient patch in the JAX
package's format.

    python -m photon_ml_tpu_torch refresh_game --prior-dir run0 \\
        --training-data day2/ --output-dir run1 \\
        --feature-shards 'global=g|intercept,item=it|noIntercept' \\
        --coordinates 'global=fixed,shard=global,reg=L2' \\
            'perUser=random,entity=userId,shard=item,reg=L2' \\
        --update-sequence global,perUser --grid global=0.001 perUser=1

Feature indexes are preset from the prior run (a refresh lives in its
parent's feature space), while entity vocabularies extend: new entities
train and patch in as new rows. It runs on the card unless ``--device
cpu`` asks for the CPU; ``--design-dtype`` (port-only, default float32 as
in the reference) sets the dense designs' storage dtype. The merged model
(``best/``, staged and published by a rename with the ``io.model_save``
fault site in the crash window), the feature indexes, the manifest and
``quality-baseline.json`` (the refreshed model profiled on the validation
data, else the training data) are written by a background saver and
joined in "Save models"; the patch is published after them.
``--fleet-shards N`` also publishes the per-host patches of an N-host
serving fleet (``patch-shard-0`` … ``patch-shard-N-1``), each chained to
the same merged model. ``--telemetry-dir``, ``--telemetry-poll-s`` and
``--metrics-port`` work as in ``train_game``: the span tree is rooted at
``refresh_game``, with ``refresh.delta``, the ``refresh.sweep`` /
``refresh.step`` / ``refresh.validate`` spans and ``refresh.publish``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import logging
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.cli.config import (
    DriverTelemetry,
    add_resilience_flags,
    add_telemetry_flags,
    install_resilience,
    parse_coordinate_config,
    parse_feature_shard_config,
    parse_grid,
    resilience_from_args,
)
from photon_ml_tpu_torch.cli.train_game import preset_index_maps
from photon_ml_tpu_torch.data_validation import validate_game_data
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation import parse_evaluators
from photon_ml_tpu_torch.game.estimator import (
    GameOptimizationConfiguration,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.io.data_reader import AvroDataReader, parse_input_columns
from photon_ml_tpu_torch.io.model_io import (
    load_warm_start_model,
    model_lineage_id,
    resolve_game_model_dir,
)
from photon_ml_tpu_torch.io.pipeline import (
    BackgroundSaver,
    save_model_patch_atomic,
)
from photon_ml_tpu_torch.logging_util import RunLogger, timed
from photon_ml_tpu_torch.quality.baseline import (
    BASELINE_NAME,
    baseline_from_game,
    save_baseline,
)
from photon_ml_tpu_torch.telemetry import tracing
from photon_ml_tpu_torch.types import DataValidationType, TaskType

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch refresh_game",
        description="Incrementally refresh a published GAME model "
                    "(warm start + touched-entity refit + delta publish; "
                    "GPU)")
    p.add_argument("--prior-dir", required=True,
                   help="the previous run's output dir (train_game or "
                        "refresh_game; contains best/ or a "
                        "model-metadata.json directly) — the refresh "
                        "warm-starts from it, reuses its feature indexes, "
                        "and diffs against its data-manifest.json")
    p.add_argument("--training-data", required=True)
    p.add_argument("--validation-data")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.value for t in TaskType])
    p.add_argument("--feature-shards", required=True,
                   help="same shard specs used at training time")
    p.add_argument("--coordinates", required=True, nargs="+",
                   help="same coordinate specs used at training time")
    p.add_argument("--update-sequence", required=True)
    p.add_argument("--grid", nargs="*", default=[],
                   help="ONE per-coordinate lambda config "
                        "'coordId=lambda' (a refresh fits a single "
                        "configuration)")
    p.add_argument("--refresh-coordinates", nargs="+", default=None,
                   metavar="COORD",
                   help="restrict the touched-entity refit to these "
                        "random-effect coordinates: every other coordinate "
                        "carries its coefficients forward bit for bit with "
                        "no solve even when its data changed. Fixed effects "
                        "always retrain")
    p.add_argument("--refresh-sweeps", type=int, default=1,
                   help="refresh sweeps over the update sequence")
    p.add_argument("--evaluators", default="AUC")
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=[v.value for v in DataValidationType])
    p.add_argument("--model-sparsity-threshold", type=float, default=0.0)
    p.add_argument("--input-columns", default="")
    p.add_argument("--no-patch", action="store_true",
                   help="skip the coefficient-patch artifact (full model "
                        "dir only)")
    p.add_argument("--fleet-shards", type=int, default=0, metavar="N",
                   help="also publish N per-host patches "
                        "(patch-shard-0 .. patch-shard-N-1) for an "
                        "entity-sharded serving fleet: the touched set "
                        "partitioned by the hash the serving hosts pack "
                        "by (fleet/sharding.py), each patch naming its "
                        "shard (fleetShard/fleetShardCount), so a host "
                        "refuses any other shard's. 0 = none")
    p.add_argument("--design-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the dense designs on the device "
                        "(port-only)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solves run (default: the GPU; there is "
                        "no fall-back to the CPU)")
    add_resilience_flags(p)
    add_telemetry_flags(p)
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    from photon_ml_tpu_torch.continuous import delta as delta_mod
    from photon_ml_tpu_torch.continuous.refresh import (
        patch_bytes_counter,
        refresh_game_model,
    )

    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    task = TaskType(args.task)
    install_resilience(resilience_from_args(args))
    device = resolve_device(args.device)
    run_logger = RunLogger(args.output_dir)
    telemetry = DriverTelemetry(
        args, "refresh_game",
        started=dict(task=task.value, output_dir=args.output_dir))
    saver = None
    try:
        shard_configs = tuple(parse_feature_shard_config(s)
                              for s in args.feature_shards.split(","))
        coordinate_configs = dict(parse_coordinate_config(s)
                                  for s in args.coordinates)
        if args.design_dtype != "float32":
            coordinate_configs = {
                cid: dataclasses.replace(c, design_dtype=args.design_dtype)
                for cid, c in coordinate_configs.items()}
        update_sequence = [c for c in args.update_sequence.split(",") if c]
        grid = parse_grid(args.grid)
        if len(grid) != 1:
            raise SystemExit(
                f"refresh_game fits exactly one configuration "
                f"(got {len(grid)} --grid configs)")
        configuration = GameOptimizationConfiguration(grid[0])
        evaluators = parse_evaluators(
            [e for e in args.evaluators.split(",") if e])

        prior_model_dir = resolve_game_model_dir(args.prior_dir)
        re_types = sorted({
            c.dataset.random_effect_type
            for c in coordinate_configs.values()
            if isinstance(c, RandomEffectCoordinateConfig)})
        id_columns = tuple(dict.fromkeys(
            re_types + [e.id_tag for e in evaluators if e.id_tag]))

        reader = AvroDataReader(
            shard_configs=shard_configs,
            index_maps=preset_index_maps(prior_model_dir, shard_configs),
            input_columns=parse_input_columns(args.input_columns))
        with timed("Read training data", run_logger):
            data, index_maps, vocabs = reader.read(args.training_data,
                                                   id_columns=id_columns)
        # the union id universe: the prior model's entities extend the
        # data's vocabulary (read first: the reader freezes a vocabulary it
        # is given), so carried entities survive with no rows this run
        with timed("Load prior model", run_logger):
            prior, prior_lineage = load_warm_start_model(
                prior_model_dir, index_maps, vocabs, extend_vocabs=True,
                device=device)
            initial_models = dict(prior.coordinates)

        with timed("Validate data", run_logger):
            validate_game_data(data, task,
                               DataValidationType(args.data_validation))

        # --- change detection (host columns, before any upload) ----------
        re_coords = {
            cid: (c.dataset.random_effect_type, c.dataset.feature_shard_id)
            for cid, c in coordinate_configs.items()
            if isinstance(c, RandomEffectCoordinateConfig)}
        with timed("Compute delta", run_logger), \
                tracing.span("refresh.delta"):
            manifest = delta_mod.build_manifest(data, re_coords, vocabs)
            prior_manifest = delta_mod.load_manifest(
                delta_mod.manifest_path_for(prior_model_dir))
            deltas = delta_mod.coordinate_deltas(prior_manifest, manifest)
        touched_entities = {
            cid: np.asarray(
                sorted(vocabs[re_coords[cid][0]][raw]
                       for raw in d.touched), np.int64)
            for cid, d in deltas.items()}
        if args.refresh_coordinates:
            allowed = set(args.refresh_coordinates)
            unknown = sorted(allowed - set(re_coords))
            if unknown:
                raise SystemExit(
                    f"--refresh-coordinates names unknown random-effect "
                    f"coordinate(s) {unknown}; this model has "
                    f"{sorted(re_coords)}")
            # an empty touched array (not a missing entry) pins the
            # coordinate to a full carry
            touched_entities = {
                cid: (ids if cid in allowed else np.asarray([], np.int64))
                for cid, ids in touched_entities.items()}
        if prior_manifest is None:
            logger.warning(
                "prior run has no data-manifest.json — treating every "
                "entity as touched (cold-cost refresh; the output records "
                "a manifest, so the next refresh is incremental)")

        validation = None
        if args.validation_data:
            reader_v = AvroDataReader(shard_configs=shard_configs,
                                      index_maps=index_maps,
                                      input_columns=reader.input_columns)
            with timed("Read validation data", run_logger):
                vdata, _, _ = reader_v.read(args.validation_data,
                                            id_columns=id_columns,
                                            entity_vocabs=vocabs)
            validation = (vdata, evaluators)

        with timed("Refresh", run_logger):
            result = refresh_game_model(
                task, coordinate_configs, update_sequence, data,
                configuration, initial_models, touched_entities,
                n_sweeps=args.refresh_sweeps, validation=validation,
                device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        for cid, st in result.stats.items():
            run_logger.metric(stage="refresh", coordinate=cid,
                              touched=st.touched, carried=st.carried,
                              solved=st.solved)

        # --- publish: full model (next parent) + manifest + indexes ------
        trained_at = datetime.datetime.now(datetime.timezone.utc).isoformat()
        manifest_dig = delta_mod.manifest_digest(manifest)
        lineage = {"parentModel": prior_lineage, "trainedAt": trained_at,
                   "dataManifest": manifest_dig}
        best_dir = os.path.join(args.output_dir, "best")
        saver = BackgroundSaver()
        saver.submit_game_save(
            best_dir, result.model, index_maps, vocabs,
            sparsity_threshold=args.model_sparsity_threshold,
            lineage=lineage)
        for shard_id, imap in index_maps.items():
            saver.submit_file_write(
                imap.save, os.path.join(args.output_dir, "feature-indexes",
                                        f"{shard_id}.json"),
                label="io.save.index", shard=shard_id)
        saver.submit_file_write(
            lambda path: delta_mod.save_manifest(path, manifest),
            os.path.join(args.output_dir, delta_mod.MANIFEST_NAME),
            label="io.save.manifest")
        # the refreshed model's quality baseline, with the refresh's
        # lineage, at the run root: serving finds it for both best/ and the
        # sibling patch/
        bdata = validation[0] if validation is not None else data
        saver.submit_file_write(
            lambda path: save_baseline(path, baseline_from_game(
                result.model, bdata, task=task, lineage=lineage)),
            os.path.join(args.output_dir, BASELINE_NAME),
            label="quality.baseline")
        with timed("Save models", run_logger):
            saver.join()

        # --- publish: the entity-level coefficient patch ----------------
        patch_dir = None
        shard_patch_dirs: list = []
        if not args.no_patch:
            patch_dir = os.path.join(args.output_dir, "patch")
            reverse = {t: {v: k for k, v in vocabs[t].items()}
                       for t in vocabs}
            removed_raw = {
                cid: [reverse[re_coords[cid][0]][int(e)] for e in dense_ids]
                for cid, dense_ids in result.removed.items()}
            model_id = model_lineage_id(best_dir)
            patch_lineage = {"trainedAt": trained_at,
                             "dataManifest": manifest_dig}
            with timed("Publish patch", run_logger):
                patch_bytes = save_model_patch_atomic(
                    patch_dir, result.patch, index_maps, vocabs,
                    task=task, parent_model=prior_lineage,
                    model_id=model_id, removed=removed_raw,
                    lineage=patch_lineage,
                    sparsity_threshold=args.model_sparsity_threshold)
            patch_bytes_counter().inc(patch_bytes)
            run_logger.metric(stage="patch", bytes=patch_bytes,
                              coordinates=sorted(result.patch))
            if args.fleet_shards > 0:
                # per-host patches of an entity-sharded serving fleet: the
                # hash the hosts pack by partitions the touched set, and
                # every shard's patch chains to the same merged model, so
                # the fleet's lineage is uniform once each host applies
                # its own
                from photon_ml_tpu_torch.continuous.refresh import (
                    partition_patch_by_shard,
                )

                parts = partition_patch_by_shard(
                    result.patch, removed_raw, vocabs, args.fleet_shards)
                with timed("Publish fleet patches", run_logger):
                    for shard, (models, rm) in enumerate(parts):
                        sdir = os.path.join(args.output_dir,
                                            f"patch-shard-{shard}")
                        sbytes = save_model_patch_atomic(
                            sdir, models, index_maps, vocabs,
                            task=task, parent_model=prior_lineage,
                            model_id=model_id, removed=rm,
                            lineage=patch_lineage,
                            sparsity_threshold=(
                                args.model_sparsity_threshold),
                            fleet_shard=(shard, args.fleet_shards))
                        patch_bytes_counter().inc(sbytes)
                        shard_patch_dirs.append(sdir)
                        run_logger.metric(stage="patch", shard=shard,
                                          of=args.fleet_shards,
                                          bytes=sbytes)

        return {
            "output_dir": args.output_dir,
            "patch_dir": patch_dir,
            "shard_patch_dirs": shard_patch_dirs,
            "parent_model": prior_lineage,
            "touched": {cid: st.touched
                        for cid, st in result.stats.items()},
            "carried": {cid: st.carried
                        for cid, st in result.stats.items()},
            "solved": {cid: st.solved
                       for cid, st in result.stats.items()},
            "evaluation": (result.final_evaluation.as_dict()
                           if result.final_evaluation is not None
                           else None),
        }
    finally:
        if saver is not None:
            saver.close()
        telemetry.close()
        run_logger.close()


if __name__ == "__main__":
    run()
