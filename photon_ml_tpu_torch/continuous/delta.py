"""Per-entity data fingerprints: the refresh loop's change detector.

A copy of ``photon_ml_tpu/continuous/delta.py``: the same splitmix64 row
hashes over the same host numpy columns, so both packages write the same
``data-manifest.json`` for the same Avro and agree on every digest. The
fingerprints read host arrays only (they are taken before any upload).

A refresh must answer one question per random-effect entity: *did this
entity's training data change since the model I am warm-starting from?*
The answer has to be cheap at "hundreds of millions of entities" scale and
independent of row order (file splits, shard merges and multi-file reads
reorder rows freely), so the fingerprint is an order-invariant combine of
per-row hashes, computed fully vectorized:

- each nonzero of the coordinate's feature shard contributes a mixed
  ``(column, value-bits)`` word, summed per row (a row's feature VECTOR is
  a set — duplicates accumulate identically in the reader);
- each row's feature sum is mixed with its label/offset/weight bits;
- each entity's fingerprint is the XOR of its mixed row hashes plus its
  row count (XOR alone would miss duplicated rows).

The manifest (``data-manifest.json``, written next to every published
model by the training drivers) maps RAW entity ids → fingerprints per
coordinate; raw ids are the stable identity across runs (dense ids are a
per-run artifact of vocabulary order). :func:`entity_delta` diffs two
manifests into the touched/carried split the incremental refit consumes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.game.data import GameData

#: the manifest's file name at a run-directory root (next to ``best/``)
MANIFEST_NAME = "data-manifest.json"

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized (wrapping uint64 arithmetic)."""
    x = np.asarray(x, np.uint64).copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _f32_bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32).astype(
        np.uint64)


def entity_fingerprints(data: GameData, random_effect_type: str,
                        feature_shard_id: str) -> dict[int, str]:
    """``dense entity id → fingerprint`` over the entity's training rows.

    The fingerprint covers exactly what the entity's solve consumes: its
    rows' labels, offsets, weights and this shard's feature vectors.
    Row-order invariant (XOR combine) and partition invariant — the same
    rows under any file split fingerprint identically.
    """
    with np.errstate(over="ignore"):
        entities = data.id_columns[random_effect_type]
        shard = data.shards[feature_shard_id]
        n = data.n_samples
        # per-row feature content: sum of mixed (col, value) words
        contrib = _mix64((shard.cols.astype(np.uint64) + np.uint64(1))
                         * _GOLDEN ^ _mix64(_f32_bits(shard.vals)))
        feat = np.zeros(n, np.uint64)
        np.add.at(feat, shard.rows(), contrib)
        row_h = _mix64(
            feat
            ^ _mix64(_f32_bits(data.labels))
            ^ _mix64(_f32_bits(data.offsets) * _GOLDEN)
            ^ _mix64(_f32_bits(data.weights) + _GOLDEN))
        present = np.flatnonzero(entities >= 0)
        if not len(present):
            return {}
        order = np.argsort(entities[present], kind="stable")
        rows = present[order]
        ents = entities[rows]
        bound = np.empty(len(ents), bool)
        bound[0] = True
        np.not_equal(ents[1:], ents[:-1], out=bound[1:])
        seg_start = np.flatnonzero(bound)
        uniq = ents[seg_start]
        counts = np.diff(np.append(seg_start, len(ents)))
        agg = np.bitwise_xor.reduceat(_mix64(row_h[rows]), seg_start)
    return {int(e): f"{int(h):016x}:{int(c)}"
            for e, h, c in zip(uniq, agg, counts)}


def build_manifest(data: GameData,
                   re_coordinates: Mapping[str, tuple[str, str]],
                   vocabs: Mapping[str, Mapping[str, int]]) -> dict:
    """The run's data manifest: per random-effect coordinate, RAW entity id
    → fingerprint. ``re_coordinates`` maps coordinate id → (random effect
    type, feature shard id); coordinates sharing both reuse one
    fingerprint pass."""
    out: dict = {"version": 1, "nSamples": data.n_samples,
                 "coordinates": {}}
    cache: dict[tuple[str, str], dict[int, str]] = {}
    for cid, (re_type, shard_id) in re_coordinates.items():
        key = (re_type, shard_id)
        fps = cache.get(key)
        if fps is None:
            fps = cache[key] = entity_fingerprints(data, re_type, shard_id)
        reverse = {v: k for k, v in vocabs.get(re_type, {}).items()}
        out["coordinates"][cid] = {
            "randomEffectType": re_type,
            "featureShardId": shard_id,
            "entities": {reverse.get(e, str(e)): fp
                         for e, fp in fps.items()},
        }
    return out


def manifest_digest(manifest: dict) -> str:
    """Content digest of a manifest (the ``dataManifest`` lineage field in
    ``model-metadata.json``) — canonical-JSON blake2b."""
    return hashlib.blake2b(
        json.dumps(manifest, sort_keys=True).encode(), digest_size=16
    ).hexdigest()


def save_manifest(path: str, manifest: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)


def load_manifest(path: str) -> Optional[dict]:
    """The manifest at ``path``, or None when absent (a parent run that
    pre-dates manifests: the refresh then treats EVERY entity as touched —
    a correct, if cold, refresh)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def manifest_path_for(model_dir: str) -> str:
    """The manifest location for a resolved model dir: at the RUN root
    (the manifest describes the run's training data; ``best/`` and
    ``all/config-i`` are siblings under it)."""
    model_dir = os.path.normpath(model_dir)
    root = (os.path.dirname(model_dir)
            if os.path.basename(model_dir) == "best" else model_dir)
    return os.path.join(root, MANIFEST_NAME)


@dataclasses.dataclass(frozen=True)
class EntityDelta:
    """The touched/carried split of one coordinate's entities (raw ids).

    ``touched``: entities whose fingerprint changed, plus entities new to
    this run — these re-solve. ``carried``: entities whose data is
    unchanged, plus entities with no data this run — their coefficients
    carry forward untouched.
    """

    touched: tuple[str, ...]
    carried: tuple[str, ...]


def entity_delta(previous: Optional[Mapping[str, str]],
                 current: Mapping[str, str]) -> EntityDelta:
    """Diff two per-entity fingerprint maps (raw id → fingerprint).
    ``previous=None`` (no manifest recorded) touches everything."""
    if previous is None:
        return EntityDelta(touched=tuple(sorted(current)), carried=())
    touched = [raw for raw, fp in current.items()
               if previous.get(raw) != fp]
    carried = [raw for raw, fp in previous.items()
               if raw not in current or current[raw] == fp]
    return EntityDelta(touched=tuple(sorted(touched)),
                       carried=tuple(sorted(carried)))


def coordinate_deltas(previous_manifest: Optional[dict],
                      current_manifest: dict) -> dict[str, EntityDelta]:
    """Per-coordinate :func:`entity_delta` between two manifests. A
    coordinate absent from the previous manifest (renamed, added) touches
    all of its entities."""
    out = {}
    prev_coords = (previous_manifest or {}).get("coordinates", {})
    for cid, info in current_manifest["coordinates"].items():
        prev = prev_coords.get(cid)
        prev_entities = None
        if prev is not None and \
                prev.get("randomEffectType") == info["randomEffectType"] \
                and prev.get("featureShardId") == info["featureShardId"]:
            prev_entities = prev.get("entities", {})
        out[cid] = entity_delta(prev_entities, info["entities"])
    return out
