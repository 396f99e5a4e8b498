"""Avro training data → columnar :class:`GameData` with feature shards.

Counterpart of ``photon_ml_tpu/io/data_reader.py``. Each record's feature
list is split into feature shards (named bags of features and an optional
intercept), feature keys map to dense ids through an :class:`IndexMap` per
shard, entity-id columns come from the record's metadata map, and it all
lands in the flat numpy arrays of the port's ``game/data.py``.

Both decoders of the reference are here: the native C++ decoder
(:mod:`photon_ml_tpu_torch.native`) when it builds and the file has
TrainingExampleAvro's layout, else the pure-Python codec. They give the
same arrays, index maps and vocabularies. Each file is read under the
resilience retry policy (``io.read:<basename>``), with the ``io.read``
fault site and a supervisor heartbeat in every attempt. The native path
carries the JAX package's ingest telemetry: an ``io.read.file`` span per
file decode (feeding ``photon_ingest_decode_seconds_total`` and
``photon_ingest_files_total``) and an ``io.read.assemble`` span per
decoded file merged.
"""

from __future__ import annotations

import dataclasses
import glob as globmod
import os
from typing import Iterable, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.game.data import FeatureShard, GameData
from photon_ml_tpu_torch.io.avro import iter_avro_file
from photon_ml_tpu_torch.io.index import IndexMap, build_index_map
from photon_ml_tpu_torch.types import (
    INTERCEPT_KEY,
    NAME_TERM_DELIMITER,
    feature_key,
)


@dataclasses.dataclass(frozen=True)
class FeatureShardConfig:
    """One shard: which feature bags it includes and whether it gets an
    intercept column. With ``feature_bags=None`` the shard takes every
    feature in the record."""

    shard_id: str
    feature_bags: Optional[Sequence[str]] = None
    has_intercept: bool = True


@dataclasses.dataclass(frozen=True)
class InputColumnsNames:
    """Logical → physical record-field names, so datasets whose fields are
    named differently (``label`` for ``response``) read without rewriting
    the files."""

    response: str = "response"
    offset: str = "offset"
    weight: str = "weight"
    #: accepted for parity with the reference's configs; the reader never
    #: reads uids, so remapping it changes nothing
    uid: str = "uid"
    features: str = "features"
    metadata_map: str = "metadataMap"

    #: the fields that drive decoding (uid excluded, see above)
    _DECODE_FIELDS = ("response", "offset", "weight", "features",
                      "metadata_map")

    @property
    def is_default(self) -> bool:
        default = InputColumnsNames()
        return all(getattr(self, f) == getattr(default, f)
                   for f in self._DECODE_FIELDS)


def parse_input_columns(spec: str) -> InputColumnsNames:
    """'response=label,weight=w' → :class:`InputColumnsNames` (the
    ``--input-columns`` flag)."""
    if not spec:
        return InputColumnsNames()
    overrides = {}
    valid = {f.name for f in dataclasses.fields(InputColumnsNames)}
    for part in spec.split(","):
        logical, _, physical = part.partition("=")
        logical = logical.strip()
        physical = physical.strip()
        if logical not in valid or not physical:
            raise SystemExit(
                f"bad --input-columns entry {part!r}; logical names: "
                f"{sorted(valid)}")
        overrides[logical] = physical
    return InputColumnsNames(**overrides)


def _read_records_with_retry(path: str) -> list:
    """One file's records, under the resilience retry policy: a transient
    read error (or an injected ``io.read`` fault) is retried with backoff,
    a persistent one re-raises unchanged."""
    from photon_ml_tpu_torch.resilience import fault_point, heartbeat, retry

    def attempt() -> list:
        heartbeat("io.read")
        fault_point("io.read", path=path)
        return list(iter_avro_file(path))

    return retry(attempt, name=f"io.read:{os.path.basename(path)}")


def _record_features(record: dict, bags: Optional[Sequence[str]],
                     features_field: str = "features"):
    """Yield (key, value) for the record's features, filtered by bag: the
    bag of a feature is its ``name`` before the first ``.``, or the whole
    name when it has none."""
    for f in record.get(features_field) or ():
        name = f["name"]
        if bags is not None:
            bag = name.split(".", 1)[0] if "." in name else name
            if bag not in bags:
                continue
        yield feature_key(name, f.get("term") or ""), float(f["value"])


@dataclasses.dataclass
class AvroDataReader:
    """Reads Avro container files into :class:`GameData`.

    Decoding prefers the native C++ path and falls back to the pure-Python
    codec when the library does not load, the file's schema is not
    TrainingExampleAvro's, or the input columns are remapped.
    """

    shard_configs: Sequence[FeatureShardConfig] = (
        FeatureShardConfig(shard_id="global"),)
    #: per-shard index maps; built from the data when absent (training) and
    #: passed for validation and scoring reads so ids line up
    index_maps: Optional[dict[str, IndexMap]] = None
    use_native: bool = True
    input_columns: InputColumnsNames = InputColumnsNames()

    def paths(self, input_path) -> list[str]:
        """Resolve a directory, a glob, a single file or a list of files."""
        if isinstance(input_path, (list, tuple)):
            found = [str(p) for p in input_path]
        elif os.path.isdir(input_path):
            found = sorted(globmod.glob(os.path.join(input_path, "*.avro")))
        else:
            found = sorted(globmod.glob(input_path)) or [input_path]
        if not found:
            raise FileNotFoundError(f"no avro files under {input_path!r}")
        return found

    def build_index_maps(self, records: Iterable[dict]) -> dict[str, IndexMap]:
        keys: dict[str, set] = {c.shard_id: set() for c in self.shard_configs}
        for rec in records:
            for cfg in self.shard_configs:
                for key, _ in _record_features(rec, cfg.feature_bags,
                                               self.input_columns.features):
                    keys[cfg.shard_id].add(key)
        return {
            cfg.shard_id: build_index_map(keys[cfg.shard_id],
                                          add_intercept=cfg.has_intercept)
            for cfg in self.shard_configs}

    def read(self, input_path: "str | Sequence[str]",
             id_columns: Sequence[str] = (),
             entity_vocabs: Optional[dict[str, dict[str, int]]] = None,
             ) -> tuple[GameData, dict[str, IndexMap], dict[str, dict[str, int]]]:
        """Read records → (GameData, index maps, entity vocabularies).

        ``id_columns`` names metadataMap keys to turn into entity-id
        columns. Vocabularies map raw string ids to dense ints in
        first-seen order; pass the training vocabularies when reading
        validation data, so entity ids align (an entity unseen in training
        gets id -1).
        """
        files = self.paths(input_path)
        if self.use_native and self.input_columns.is_default:
            native_out = self._read_native(files, id_columns, entity_vocabs)
            if native_out is not None:
                return native_out
        records = [r for p in files for r in _read_records_with_retry(p)]

        index_maps = self.index_maps or self.build_index_maps(records)
        vocabs: dict[str, dict[str, int]] = {
            c: dict(v) for c, v in (entity_vocabs or {}).items()}
        frozen_vocab = entity_vocabs is not None

        n = len(records)
        labels = np.zeros(n, np.float32)
        offsets = np.zeros(n, np.float32)
        weights = np.ones(n, np.float32)
        ids = {c: np.full(n, -1, np.int64) for c in id_columns}

        shard_rows: dict[str, list] = {c.shard_id: [] for c in self.shard_configs}
        shard_cols: dict[str, list] = {c.shard_id: [] for c in self.shard_configs}
        shard_vals: dict[str, list] = {c.shard_id: [] for c in self.shard_configs}

        cols = self.input_columns
        for i, rec in enumerate(records):
            labels[i] = rec[cols.response]
            if rec.get(cols.offset) is not None:
                offsets[i] = rec[cols.offset]
            if rec.get(cols.weight) is not None:
                weights[i] = rec[cols.weight]
            meta = rec.get(cols.metadata_map) or {}
            for c in id_columns:
                raw = meta.get(c)
                if raw is None:
                    continue
                vocab = vocabs.setdefault(c, {})
                if raw not in vocab:
                    if frozen_vocab:
                        continue  # unseen entity at validation time: no id
                    vocab[raw] = len(vocab)
                ids[c][i] = vocab[raw]
            for cfg in self.shard_configs:
                imap = index_maps[cfg.shard_id]
                rs, cs, vs = (shard_rows[cfg.shard_id],
                              shard_cols[cfg.shard_id], shard_vals[cfg.shard_id])
                for key, value in _record_features(rec, cfg.feature_bags,
                                                   cols.features):
                    j = imap.key_to_index.get(key)
                    if j is not None:
                        rs.append(i)
                        cs.append(j)
                        vs.append(value)
                if cfg.has_intercept:
                    rs.append(i)
                    cs.append(imap.key_to_index[INTERCEPT_KEY])
                    vs.append(1.0)

        shards = {
            cfg.shard_id: FeatureShard.from_coo(
                np.asarray(shard_rows[cfg.shard_id], np.int64),
                np.asarray(shard_cols[cfg.shard_id], np.int32),
                np.asarray(shard_vals[cfg.shard_id], np.float32),
                n, len(index_maps[cfg.shard_id]))
            for cfg in self.shard_configs}

        data = GameData(labels=labels, offsets=offsets, weights=weights,
                        shards=shards, id_columns=ids)
        return data, index_maps, vocabs

    def _read_native(self, files, id_columns, entity_vocabs):
        """All-numpy assembly from the C++ decoder; None → fall back.

        Up to 8 files decode at once on worker threads (the ctypes call
        releases the GIL) while this thread merges each decoded file's key
        table and vocabularies in file order and, when the index maps are
        known up front, splits it into the shards' CSR arrays.
        """
        from photon_ml_tpu_torch import native
        from photon_ml_tpu_torch.io.pipeline import (
            DecodePrefetcher,
            _ingest_decode_seconds,
            _ingest_files,
        )
        from photon_ml_tpu_torch.resilience import (
            fault_point,
            heartbeat,
            retry,
        )
        from photon_ml_tpu_torch.telemetry import tracing

        if not native.available():
            return None

        def decode(p):
            def attempt():
                heartbeat("io.read")
                fault_point("io.read", path=p)
                return native.decode_training_file(p,
                                                   id_keys=tuple(id_columns))

            with tracing.span("io.read.file", path=p) as sp:
                d = retry(attempt, name=f"io.read:{os.path.basename(p)}")
            _ingest_decode_seconds().inc(sp.seconds)
            _ingest_files().inc()
            return d

        # each decode in flight holds its whole file
        workers = min(len(files), os.cpu_count() or 4, 8)
        preset_maps = self.index_maps

        labels_p, offsets_p, weights_p = [], [], []
        all_keys: dict[str, int] = {}
        pending_splits: list = []
        split_parts: dict[str, list] = {c.shard_id: []
                                        for c in self.shard_configs}
        vocabs: dict[str, dict[str, int]] = {
            c: dict(v) for c, v in (entity_vocabs or {}).items()}
        frozen = entity_vocabs is not None
        ids_p: dict[str, list] = {c: [] for c in id_columns}

        def split_file(d):
            """CSR-split one decoded file into every shard; ``k2c`` maps the
            file's local key ids straight to shard columns."""
            for cfg in self.shard_configs:
                imap = index_maps[cfg.shard_id]
                k2c = np.empty(len(d.feature_keys), np.int32)
                for i, k in enumerate(d.feature_keys):
                    k2c[i] = imap.key_to_index.get(k, -1)
                icol = (imap.key_to_index[INTERCEPT_KEY]
                        if cfg.has_intercept else -1)
                split = native.shard_split(
                    d.feat_indptr, d.feat_key_id, d.feat_val,
                    np.ascontiguousarray(k2c), icol)
                if split is None:
                    return False
                split_parts[cfg.shard_id].append(split)
            return True

        index_maps = preset_maps
        for d in DecodePrefetcher(decode, files, workers=workers):
            if d is None:  # incompatible schema: fall back
                return None
            with tracing.span("io.read.assemble",
                              n_records=int(d.n_records)):
                labels_p.append(d.response)
                offsets_p.append(d.offset)
                weights_p.append(d.weight)
                if preset_maps is None:
                    for k in d.feature_keys:
                        all_keys.setdefault(k, len(all_keys))
                for c in id_columns:
                    local = d.id_cols[c]
                    local_vocab = d.id_vocabs[c]
                    vocab = vocabs.setdefault(c, {})
                    id_remap = np.full(len(local_vocab) + 1, -1, np.int64)
                    for i, raw in enumerate(local_vocab):
                        if raw not in vocab:
                            if frozen:
                                continue
                            vocab[raw] = len(vocab)
                        id_remap[i] = vocab[raw]
                    # a missing id is -1 locally, which indexes the trailing -1
                    ids_p[c].append(id_remap[local])
                if preset_maps is not None:
                    if not split_file(d):
                        return None
                else:
                    # column ids depend on the whole key universe: split after
                    # the last file
                    pending_splits.append(d)

        n = int(sum(len(p) for p in labels_p))
        labels = (np.concatenate(labels_p) if labels_p
                  else np.zeros(0)).astype(np.float32)
        offsets = np.nan_to_num(
            np.concatenate(offsets_p) if offsets_p else np.zeros(0),
            nan=0.0).astype(np.float32)
        weights = (np.concatenate(weights_p) if weights_p
                   else np.zeros(0))
        weights = np.where(np.isnan(weights), 1.0, weights).astype(np.float32)

        if index_maps is None:
            global_keys = [None] * len(all_keys)
            for k, j in all_keys.items():
                global_keys[j] = k
            index_maps = {}
            # the bag of a key is its name before the first '.'
            names_only = [k.split(NAME_TERM_DELIMITER, 1)[0]
                          for k in global_keys]
            bags = [nm.split(".", 1)[0] if "." in nm else nm
                    for nm in names_only]
            for cfg in self.shard_configs:
                keep = (global_keys if cfg.feature_bags is None else
                        [k for k, b in zip(global_keys, bags)
                         if b in cfg.feature_bags])
                index_maps[cfg.shard_id] = build_index_map(
                    keep, add_intercept=cfg.has_intercept)
            for d in pending_splits:
                if not split_file(d):
                    return None

        shards = {}
        for cfg in self.shard_configs:
            parts = split_parts[cfg.shard_id]
            imap = index_maps[cfg.shard_id]
            if not parts:
                indptr = np.zeros(n + 1, np.int64)
                cols = np.zeros(0, np.int32)
                vals = np.zeros(0, np.float32)
            elif len(parts) == 1:
                indptr, cols, vals = parts[0]
            else:
                indptr_parts = [p[0] for p in parts]
                nnz0 = np.cumsum([0] + [int(p[-1]) for p in indptr_parts])
                indptr = np.concatenate(
                    [indptr_parts[0]]
                    + [p[1:] + off for p, off
                       in zip(indptr_parts[1:], nnz0[1:-1])])
                cols = np.concatenate([p[1] for p in parts])
                vals = np.concatenate([p[2] for p in parts])
            shards[cfg.shard_id] = FeatureShard(
                indptr=indptr, cols=cols, vals=vals, dim=len(imap))

        ids = {c: (np.concatenate(ids_p[c]) if ids_p[c]
                   else np.full(0, -1, np.int64))
               for c in id_columns}

        data = GameData(labels=labels, offsets=offsets, weights=weights,
                        shards=shards, id_columns=ids)
        return data, index_maps, vocabs


def write_training_examples(path: str, data_records: Iterable[dict], *,
                            codec: str = "deflate",
                            sync: "bytes | None" = None) -> int:
    """Write TrainingExampleAvro records; ``sync`` pins the container's sync
    marker for byte-identical output."""
    from photon_ml_tpu_torch.io.avro import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    return write_avro_file(path, data_records, TRAINING_EXAMPLE_AVRO,
                           codec=codec, sync=sync)
