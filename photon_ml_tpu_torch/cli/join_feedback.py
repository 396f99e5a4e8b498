"""The feedback join: ``python -m photon_ml_tpu_torch join_feedback``
(counterpart of ``photon_ml_tpu/cli/join_feedback.py``).

The operator-facing (and cron-able) wrapper around
:func:`photon_ml_tpu_torch.feedback.joiner.join_feedback`: join one or more
request-log directories to a label source, write the joined rows as
``TrainingExampleAvro`` incremental training data, and print the full
accounting — joined / unjoined / late / duplicates — as JSON (nothing is
dropped silently; the same numbers land in the
``photon_feedback_*_total`` counters).

With ``--prior-dir`` (plus the training-time ``--feature-shards`` /
``--coordinates`` specs) the report additionally carries a
``data-manifest.json`` DELTA against the serving model's lineage: per
coordinate, how many entities the joined data would touch vs carry in a
refresh — the dry-run answer to "what would this feedback actually
retrain?". The autopilot (``feedback/autopilot.py``) runs the same join
in-process; this CLI is for offline/batch operation of the loop's first
leg. The join and the delta are host work: the command takes no
``--device``. Its report is the JAX command's, key for key.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from photon_ml_tpu_torch.cli.config import (
    add_resilience_flags,
    add_telemetry_flags,
    install_resilience,
    install_telemetry,
    parse_coordinate_config,
    parse_feature_shard_config,
    resilience_from_args,
    telemetry_from_args,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch join_feedback",
        description="Join request-log score records to labels and emit "
                    "incremental training data (+ optional manifest "
                    "delta vs a prior model)")
    p.add_argument("--reqlog-dir", required=True, action="append",
                   help="request-log directory (repeatable — a fleet "
                        "contributes one per host); segments scan in "
                        "sorted order so the join is deterministic")
    p.add_argument("--labels",
                   help="external label source: .avro (FeedbackLabelAvro) "
                        "or CSV 'request_id[,record_index],label'. "
                        "Omitted = inline labels only (the log schema's "
                        "nullable label field)")
    p.add_argument("--output", required=True,
                   help="joined TrainingExampleAvro path (written even "
                        "when zero rows join, so downstream min-rows "
                        "policy fails loudly instead of on a missing "
                        "file)")
    p.add_argument("--codec", default="deflate",
                   choices=["null", "deflate"])
    p.add_argument("--prior-dir",
                   help="prior run dir (train_game/refresh_game): report "
                        "a data-manifest delta of the joined data "
                        "against it (requires --feature-shards and "
                        "--coordinates)")
    p.add_argument("--feature-shards",
                   help="training-time shard specs (with --prior-dir)")
    p.add_argument("--coordinates", nargs="+",
                   help="training-time coordinate specs (with "
                        "--prior-dir)")
    p.add_argument("--report",
                   help="also write the JSON report here")
    add_resilience_flags(p)
    add_telemetry_flags(p)
    return p


def _manifest_delta(args, output_path: str) -> dict:
    """Per-coordinate touched/carried counts of the JOINED data vs the
    prior run's manifest — the refresh this feedback would drive."""
    from photon_ml_tpu_torch.continuous import delta as delta_mod
    from photon_ml_tpu_torch.game.estimator import RandomEffectCoordinateConfig
    from photon_ml_tpu_torch.io import AvroDataReader
    from photon_ml_tpu_torch.io.index import IndexMap
    from photon_ml_tpu_torch.io.model_io import (
        find_feature_index_dir,
        game_model_entity_vocabs,
        resolve_game_model_dir,
    )

    shard_configs = tuple(parse_feature_shard_config(s)
                          for s in args.feature_shards.split(","))
    coordinate_configs = dict(parse_coordinate_config(s)
                              for s in args.coordinates)
    re_coords = {
        cid: (c.dataset.random_effect_type, c.dataset.feature_shard_id)
        for cid, c in coordinate_configs.items()
        if isinstance(c, RandomEffectCoordinateConfig)}

    prior_model_dir = resolve_game_model_dir(args.prior_dir)
    index_dir = find_feature_index_dir(prior_model_dir)
    preset_maps = {
        cfg.shard_id: IndexMap.load(
            os.path.join(index_dir, f"{cfg.shard_id}.json"))
        for cfg in shard_configs}
    reader = AvroDataReader(shard_configs=shard_configs,
                            index_maps=preset_maps)
    id_columns = tuple(sorted({t for t, _ in re_coords.values()}))
    data, _, vocabs = reader.read(output_path, id_columns=id_columns)
    # same union-vocabulary rule as refresh_game: prior entities survive
    # with zero joined rows (they would carry, not vanish)
    for re_type, pv in game_model_entity_vocabs(prior_model_dir).items():
        tgt = vocabs.setdefault(re_type, {})
        for raw in pv:
            tgt.setdefault(raw, len(tgt))
    manifest = delta_mod.build_manifest(data, re_coords, vocabs)
    prior_manifest = delta_mod.load_manifest(
        delta_mod.manifest_path_for(prior_model_dir))
    deltas = delta_mod.coordinate_deltas(prior_manifest, manifest)
    return {
        cid: {"touched": len(d.touched), "carried": len(d.carried)}
        for cid, d in sorted(deltas.items())}


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    if args.prior_dir and not (args.feature_shards and args.coordinates):
        raise SystemExit("--prior-dir needs --feature-shards and "
                         "--coordinates (the training-time specs) to "
                         "compute the manifest delta")
    install_resilience(resilience_from_args(args))
    telemetry = install_telemetry(telemetry_from_args(args))
    try:
        from photon_ml_tpu_torch.feedback.joiner import join_feedback

        result = join_feedback(args.reqlog_dir, args.labels, args.output,
                               codec=args.codec)
        report = result.as_dict()
        if args.prior_dir:
            report["delta"] = _manifest_delta(args, args.output)
        if args.report:
            with open(args.report, "w") as f:
                json.dump(report, f, indent=2, sort_keys=True)
        return report
    finally:
        telemetry.close()


if __name__ == "__main__":
    run()
