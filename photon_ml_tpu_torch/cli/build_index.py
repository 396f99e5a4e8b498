"""Feature-indexing driver (a copy of ``photon_ml_tpu/cli/build_index.py``:
it is host-only).

Re-design of ``photon-client/.../index/FeatureIndexingDriver.scala``: scan
training data, build one feature index per shard, write them for later
training and scoring runs, one JSON file per shard (see
:mod:`photon_ml_tpu_torch.io.index`)::

    python -m photon_ml_tpu_torch build_index --data train.avro \\
        --output-dir indexes --feature-shards 'global=g|intercept'
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.io.avro import iter_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.logging_util import RunLogger, timed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch build_index",
        description="Build feature index maps from training data")
    p.add_argument("--data", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-shards", required=True)
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    run_logger = RunLogger(args.output_dir)
    try:
        shard_configs = tuple(parse_feature_shard_config(s)
                              for s in args.feature_shards.split(","))
        reader = AvroDataReader(shard_configs=shard_configs)
        with timed("Scan features", run_logger):
            records = (r for p in reader.paths(args.data)
                       for r in iter_avro_file(p))
            index_maps = reader.build_index_maps(records)
        sizes = {}
        with timed("Write indexes", run_logger):
            for shard_id, imap in index_maps.items():
                imap.save(os.path.join(args.output_dir, f"{shard_id}.json"))
                sizes[shard_id] = len(imap)
                run_logger.metric(stage="index", shard=shard_id,
                                  n_features=len(imap))
        return {"sizes": sizes, "output_dir": args.output_dir}
    finally:
        run_logger.close()


if __name__ == "__main__":
    run()
