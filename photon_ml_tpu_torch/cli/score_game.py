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
load onto ``--device`` (the card unless ``--device cpu``). Multi-process
scoring and telemetry are not ported: their flags raise
:class:`NotImplementedError` naming the flag.
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
    add_unported_flags,
    parse_feature_shard_config,
    refuse_unported,
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

#: the reference's flags this command does not run yet
_UNPORTED_FLAGS = {
    "--multihost": {"action": "store_true"},
    "--telemetry-dir": {},
    "--telemetry-poll-s": {"type": float},
    "--metrics-port": {"type": int},
}


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
    add_unported_flags(p, _UNPORTED_FLAGS)
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
    refuse_unported(args, _UNPORTED_FLAGS)
    # fail before the reads when no card is present
    device = resolve_device(args.device)
    run_logger = RunLogger(args.output_dir)
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
            data, _, vocabs = reader.read(args.data, id_columns=id_columns)

        with timed("Load model", run_logger):
            model = load_game_model(model_dir, index_maps, vocabs,
                                    device=device)

        transformer = GameTransformer(
            model=model, evaluators=evaluators,
            score_breakdown=args.score_breakdown)
        with timed("Score", run_logger):
            result = transformer.transform(data)

        with timed("Write scores", run_logger):
            os.makedirs(args.output_dir, exist_ok=True)
            write_scores(os.path.join(args.output_dir, "scores.avro"),
                         result.scores, data.labels)
            if result.by_coordinate is not None:
                with open(os.path.join(args.output_dir,
                                       "score-breakdown.json"), "w") as f:
                    json.dump({k: v.tolist()
                               for k, v in result.by_coordinate.items()}, f)

        evaluation = None
        if result.evaluation is not None:
            evaluation = result.evaluation.as_dict()
            run_logger.metric(stage="evaluate", **evaluation)
        return {"n_scored": data.n_samples, "evaluation": evaluation,
                "output_dir": args.output_dir}
    finally:
        run_logger.close()


if __name__ == "__main__":
    run()
