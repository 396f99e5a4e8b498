"""GAME training from the command line (counterpart of ``photon_ml_tpu/cli/train_game.py``).

Read the training and validation Avro → feature shards, index maps and
entity vocabularies → build the coordinate datasets once → fit every grid
point on the GPU → select the best by the first validation evaluator →
write the best model (and, with ``--output-all-models``, every model) in
the reference's directory layout, with the index maps under
``feature-indexes/``. The directory loads in either package.

    python -m photon_ml_tpu_torch train_game --training-data train.avro \\
        --output-dir out --feature-shards 'global=g|intercept' \\
        --coordinates 'global=fixed,shard=global,reg=L2' \\
        --update-sequence global

It runs on the card unless ``--device cpu`` asks for the CPU. Saves run in
the calling thread (the reference's background saver only overlaps them:
the bytes are the same), and under ``--output-all-models`` ``best/`` is a
copy of the winner's directory whose metadata names it in ``aliasOf``, as
the reference's hardlinked alias does. Not written yet: the run root's
``data-manifest.json`` and quality baseline, and telemetry. Flags of the
reference that the port does not run yet are accepted by the parser and
raise :class:`NotImplementedError` naming the flag.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import shutil
import sys
from typing import Optional, Sequence

import torch

from photon_ml_tpu_torch.cli.config import (
    add_unported_flags,
    parse_coordinate_config,
    parse_feature_shard_config,
    parse_grid,
    refuse_unported,
)
from photon_ml_tpu_torch.data_validation import validate_game_data
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation import parse_evaluators
from photon_ml_tpu_torch.game.estimator import (
    GameEstimator,
    GameOptimizationConfiguration,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.io.data_reader import AvroDataReader, parse_input_columns
from photon_ml_tpu_torch.io.model_io import save_game_model
from photon_ml_tpu_torch.logging_util import RunLogger, timed
from photon_ml_tpu_torch.types import DataValidationType, TaskType

#: the reference's flags this command does not run yet, with their argparse
#: settings: each is accepted and raises NotImplementedError when given
_UNPORTED_FLAGS = {
    "--tuning-iterations": {"type": int},
    "--tuning-range": {},
    "--model-input-dir": {},
    "--locked-coordinates": {},
    "--checkpoint": {"action": "store_true"},
    "--resume": {"action": "store_true"},
    "--debug-nans": {"action": "store_true"},
    "--profile": {"action": "store_true"},
    "--multihost": {"action": "store_true"},
    "--mesh": {},
    "--max-retries": {"type": int},
    "--retry-deadline-s": {"type": float},
    "--on-divergence": {"choices": ["fail", "rollback", "freeze"]},
    "--supervise": {"type": int},
    "--max-restarts": {"type": int},
    "--heartbeat-timeout-s": {"type": float},
    "--restart-deadline-s": {"type": float},
    "--telemetry-dir": {},
    "--telemetry-poll-s": {"type": float},
    "--metrics-port": {"type": int},
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch train_game",
        description="Train a GAME mixed-effect model (GPU)")
    p.add_argument("--training-data", required=True)
    p.add_argument("--validation-data")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", default="LOGISTIC_REGRESSION",
                   choices=[t.value for t in TaskType])
    p.add_argument("--feature-shards", required=True,
                   help="comma-separated shard specs, e.g. "
                        "'global=fixed|intercept,user=user+item|noIntercept'")
    p.add_argument("--coordinates", required=True, nargs="+",
                   help="coordinate specs, e.g. "
                        "'global=fixed,shard=global,reg=L2' "
                        "'perUser=random,entity=userId,shard=user,reg=L2'")
    p.add_argument("--update-sequence", required=True,
                   help="comma-separated coordinate ids")
    p.add_argument("--cd-iterations", type=int, default=1)
    p.add_argument("--grid", nargs="*", default=[],
                   help="per-coordinate lambda lists 'coordId=0.1;1;10'")
    p.add_argument("--tuning", choices=["NONE", "RANDOM", "BAYESIAN"],
                   default="NONE",
                   help="only NONE (the grid) is ported")
    p.add_argument("--evaluators", default="AUC",
                   help="comma-separated; first drives model selection")
    p.add_argument("--output-all-models", action="store_true")
    p.add_argument("--data-validation", default="VALIDATE_FULL",
                   choices=[v.value for v in DataValidationType])
    p.add_argument("--design-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the dense designs (fixed-effect "
                        "and random-effect bucket tensors) on the device; "
                        "labels, weights and coefficients stay float32 and "
                        "margins accumulate in float32")
    p.add_argument("--model-sparsity-threshold", type=float, default=0.0,
                   help="drop |coefficient| <= threshold from written "
                        "models")
    p.add_argument("--input-columns", default="",
                   help="remap record fields, e.g. 'response=label,"
                        "weight=w'")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solves run (default: the GPU; there is "
                        "no fall-back to the CPU)")
    add_unported_flags(p, _UNPORTED_FLAGS)
    return p


def _refuse_unported(args) -> None:
    if args.tuning != "NONE":
        raise NotImplementedError(f"--tuning {args.tuning} is not ported")
    refuse_unported(args, _UNPORTED_FLAGS)


def _publish_copy(src_dir: str, dst_dir: str) -> None:
    """``dst_dir`` as a copy of the model at ``src_dir`` whose metadata
    names its source in ``aliasOf``: the file tree and metadata of the
    reference's hardlinked alias."""
    if os.path.exists(dst_dir):
        shutil.rmtree(dst_dir)
    shutil.copytree(src_dir, dst_dir)
    path = os.path.join(dst_dir, "model-metadata.json")
    with open(path) as f:
        metadata = json.load(f)
    metadata["aliasOf"] = os.path.relpath(
        os.path.normpath(src_dir),
        os.path.dirname(os.path.abspath(os.path.normpath(dst_dir))))
    with open(path, "w") as f:
        json.dump(metadata, f, indent=2)


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    _refuse_unported(args)
    task = TaskType(args.task)
    # fail before the reads when no card is present
    device = resolve_device(args.device)
    run_logger = RunLogger(args.output_dir)
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
        re_types = sorted({
            c.dataset.random_effect_type
            for c in coordinate_configs.values()
            if isinstance(c, RandomEffectCoordinateConfig)})
        evaluators = parse_evaluators(
            [e for e in args.evaluators.split(",") if e])
        # entity columns, then the grouped evaluators' id tags
        id_columns = tuple(dict.fromkeys(
            re_types + [e.id_tag for e in evaluators if e.id_tag]))
        # the estimator checks its configuration before the reads
        est = GameEstimator(task=task, coordinate_configs=coordinate_configs,
                            update_sequence=update_sequence,
                            n_cd_iterations=args.cd_iterations, device=device)
        grid = parse_grid(args.grid)
        unknown = {cid for g in grid for cid in g} - set(update_sequence)
        if unknown:
            raise SystemExit(
                f"--grid names unknown coordinates {sorted(unknown)}; "
                f"update sequence is {update_sequence}")
        configurations = [GameOptimizationConfiguration(g) for g in grid]

        reader = AvroDataReader(shard_configs=shard_configs,
                                input_columns=parse_input_columns(
                                    args.input_columns))
        with timed("Read training data", run_logger):
            data, index_maps, vocabs = reader.read(
                args.training_data, id_columns=id_columns)
        for shard_id, imap in index_maps.items():
            imap.save(os.path.join(args.output_dir, "feature-indexes",
                                   f"{shard_id}.json"))
        lineage = {
            "parentModel": None,
            "trainedAt": datetime.datetime.now(
                datetime.timezone.utc).isoformat(),
            "dataManifest": None,
        }
        with timed("Validate data", run_logger):
            validate_game_data(data, task,
                               DataValidationType(args.data_validation))

        validation = None
        if args.validation_data:
            reader_v = AvroDataReader(shard_configs=shard_configs,
                                      index_maps=index_maps,
                                      input_columns=reader.input_columns)
            with timed("Read validation data", run_logger):
                vdata, _, _ = reader_v.read(
                    args.validation_data, id_columns=id_columns,
                    entity_vocabs=vocabs)
            validation = (vdata, evaluators)

        with timed("Train (grid)", run_logger):
            results = est.fit(data, configurations, validation=validation)
            # the last solves finish inside this stage, not in "Save models"
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        best = GameEstimator.select_best(results)
        if best.evaluation is not None:
            run_logger.metric(stage="best", **best.evaluation.as_dict(),
                              config=dict(best.configuration.regularization_weights))

        best_dir = os.path.join(args.output_dir, "best")
        save = dict(sparsity_threshold=args.model_sparsity_threshold,
                    lineage=lineage)
        with timed("Save models", run_logger):
            if args.output_all_models:
                for i, r in enumerate(results):
                    save_game_model(
                        os.path.join(args.output_dir, "all", f"config-{i}"),
                        r.model, index_maps, vocabs, **save)
                best_i = next(i for i, r in enumerate(results) if r is best)
                _publish_copy(os.path.join(args.output_dir, "all",
                                           f"config-{best_i}"), best_dir)
            else:
                save_game_model(best_dir, best.model, index_maps, vocabs,
                                **save)
        return {
            "best_config": dict(best.configuration.regularization_weights),
            "best_evaluation": (best.evaluation.as_dict()
                                if best.evaluation else None),
            "n_configurations": len(results),
            "output_dir": args.output_dir,
        }
    finally:
        run_logger.close()


if __name__ == "__main__":
    run()
