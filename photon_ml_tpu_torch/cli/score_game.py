"""GAME batch scoring from the command line (counterpart of
``photon_ml_tpu/cli/score_game.py``).

Load a saved GAME model and data → sum the coordinate scores and offsets →
write ``ScoringResultAvro`` records to ``scores.avro``; optionally the
per-coordinate breakdown (``score-breakdown.json``) and the evaluation of
the scored output::

    python -m photon_ml_tpu_torch score_game --data valid.avro \\
        --model-dir run --output-dir scores \\
        --feature-shards 'global=g|intercept,item=it|noIntercept' \\
        --evaluators AUC --score-breakdown

The model join is host numpy, as in the JAX package (its f32 scores are
what the online engine matches bit for bit); the fixed-effect coefficients
load onto ``--device`` (the card unless ``--device cpu``). Under
``--multihost`` each process scores its share of the input files into
``scores-part-NNNNN.avro`` (concatenated in process order, the parts are
the single-process ``scores.avro``), and the evaluation runs on every
process over the gathered scores. ``--telemetry-dir``,
``--telemetry-poll-s`` and ``--metrics-port`` work as in the training
commands (the span tree is rooted at ``score_game``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import native
from photon_ml_tpu_torch.cli.config import (
    DriverTelemetry,
    add_telemetry_flags,
    parse_feature_shard_config,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation import parse_evaluators
from photon_ml_tpu_torch.game.transformer import GameTransformer
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.data_reader import (
    AvroDataReader,
    parse_input_columns,
)
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.io.model_io import (
    find_feature_index_dir,
    load_game_model,
    resolve_game_model_dir,
)
from photon_ml_tpu_torch.io.schemas import SCORING_RESULT_AVRO
from photon_ml_tpu_torch.logging_util import RunLogger, timed
from photon_ml_tpu_torch.parallel import multihost

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch score_game",
        description="Score data with a saved GAME model")
    p.add_argument("--data", required=True)
    p.add_argument("--model-dir", required=True,
                   help="a train_game output dir (containing best/ or a "
                        "model-metadata.json directly)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-shards", required=True,
                   help="same shard specs used at training time")
    p.add_argument("--evaluators", default="",
                   help="optional evaluation of the scored output")
    p.add_argument("--score-breakdown", action="store_true",
                   help="also write per-coordinate scores json")
    p.add_argument("--input-columns", default="",
                   help="remap record fields, e.g. 'response=label'")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the fixed-effect coefficients load "
                        "(default: the GPU; there is no fall-back to the "
                        "CPU)")
    p.add_argument("--multihost", action="store_true",
                   help="join the multi-process job of the PHOTON_* "
                        "environment: each process scores its share of "
                        "the input files into a part file")
    add_telemetry_flags(p)
    return p


def write_scores(path: str, scores: np.ndarray, labels: np.ndarray) -> None:
    """``scores.avro``: the native columnar writer, else the Python codec
    with the null codec, so both write the same container properties and
    records."""
    if native.write_scoring_results(path, np.asarray(scores, np.float64),
                                    np.asarray(labels, np.float64)):
        return
    records = ({"uid": str(i), "predictionScore": float(s),
                "label": float(y), "metadataMap": None}
               for i, (s, y) in enumerate(zip(scores, labels)))
    write_avro_file(path, records, SCORING_RESULT_AVRO, codec="null")


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    # fail before the reads when no card is present
    device = resolve_device(args.device)
    multiproc = False
    if args.multihost:
        multiproc = multihost.initialize(device=args.device)
        device = multihost.local_device()
    pid = multihost.process_index()
    worker_dir = os.path.join("workers", f"proc-{pid}")
    chief = multihost.is_chief()
    run_logger = RunLogger(
        args.output_dir if chief
        else os.path.join(args.output_dir, worker_dir))
    # telemetry before the first stage; a non-chief process traces under
    # its own workers/ directory
    telemetry = DriverTelemetry(args, "score_game",
                                subdir=None if chief else worker_dir)
    try:
        model_dir = resolve_game_model_dir(args.model_dir)
        index_dir = find_feature_index_dir(model_dir)
        shard_configs = tuple(parse_feature_shard_config(s)
                              for s in args.feature_shards.split(","))
        index_maps = {
            cfg.shard_id: IndexMap.load(
                os.path.join(index_dir, f"{cfg.shard_id}.json"))
            for cfg in shard_configs}
        with open(os.path.join(model_dir, "model-metadata.json")) as f:
            metadata = json.load(f)
        re_types = sorted({info["randomEffectType"]
                           for info in metadata["coordinates"].values()
                           if info["type"] == "random-effect"})
        evaluators = parse_evaluators(
            [e for e in args.evaluators.split(",") if e])
        id_columns = tuple(dict.fromkeys(
            re_types + [e.id_tag for e in evaluators if e.id_tag]))

        reader = AvroDataReader(shard_configs=shard_configs,
                                index_maps=index_maps,
                                input_columns=parse_input_columns(
                                    args.input_columns))
        with timed("Read data", run_logger):
            # the entity vocabularies come from the data; entities the
            # model never saw score 0 in its random effects
            if multiproc:
                from photon_ml_tpu_torch.game.multiprocess import (
                    process_file_share,
                    reconcile_vocabs,
                )

                data, _, vocabs = reader.read(
                    process_file_share(reader, args.data),
                    id_columns=id_columns)
                if evaluators:
                    # grouped metrics compare id tags across processes:
                    # one global id space for them (and the lookups)
                    data, vocabs = reconcile_vocabs(data, vocabs,
                                                    id_columns)
            else:
                data, _, vocabs = reader.read(args.data,
                                              id_columns=id_columns)

        with timed("Load model", run_logger):
            model = load_game_model(model_dir, index_maps, vocabs,
                                    device=device)

        transformer = GameTransformer(
            model=model, evaluators=() if multiproc else evaluators,
            score_breakdown=args.score_breakdown)
        with timed("Score", run_logger):
            result = transformer.transform(data)

        with timed("Write scores", run_logger):
            os.makedirs(args.output_dir, exist_ok=True)
            # one part file a process (the reference's part-NNNNN outputs)
            part = f"-part-{pid:05d}" if multiproc else ""
            write_scores(os.path.join(args.output_dir,
                                      f"scores{part}.avro"),
                         result.scores, data.labels)
            if result.by_coordinate is not None:
                with open(os.path.join(args.output_dir,
                                       f"score-breakdown{part}.json"),
                          "w") as f:
                    json.dump({k: v.tolist()
                               for k, v in result.by_coordinate.items()}, f)

        evaluation = None
        n_scored = data.n_samples
        if multiproc:
            n_scored = int(multihost.allreduce_sum(
                np.array([data.n_samples], np.int64))[0])
            if evaluators:
                # the evaluation of the gathered scores, the same on every
                # process
                from photon_ml_tpu_torch.evaluation import evaluate_all

                gather = multihost.allgather_concat
                evaluation = evaluate_all(
                    evaluators, gather(np.asarray(result.scores, np.float32)),
                    gather(np.asarray(data.labels, np.float32)),
                    weights=gather(np.asarray(data.weights, np.float32)),
                    id_tags={c: gather(data.id_columns[c])
                             for c in sorted(data.id_columns)}).as_dict()
        elif result.evaluation is not None:
            evaluation = result.evaluation.as_dict()
        if evaluation is not None:
            run_logger.metric(stage="evaluate", **evaluation)
        # every process returns once every part file is written
        multihost.barrier()
        return {"n_scored": n_scored, "evaluation": evaluation,
                "output_dir": args.output_dir}
    finally:
        telemetry.close()
        run_logger.close()


if __name__ == "__main__":
    run()
