"""Model persistence: GLM and GAME models ↔ the reference's directory layout.

Counterpart of ``photon_ml_tpu/io/model_io.py``::

    output/
      model-metadata.json
      fixed-effect/<coordinateId>/coefficients/part-00000.avro
      random-effect/<coordinateId>/coefficients/part-00000.avro

Coefficient files are ``BayesianLinearModelAvro`` records: a fixed effect is
one record, a random effect one record per entity (modelId = the raw entity
id). Both packages write the same records and the same metadata, so a model
saved by either loads in the other.

The port's random-effect models carry no variances, so their records are
written with ``variances: null`` and variances found on load are dropped.
Serving reads a model's content identity (:func:`model_lineage_id`), its
kind (:func:`model_kind`) and its model-derived entity vocabularies
(:func:`game_model_entity_vocabs`); :func:`load_serving_model` gives all of
it with the model from one decode of each part file. Not ported yet: writing coefficient
patches (``save_game_model_patch``).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.io.avro import iter_avro_file, write_avro_file
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_AVRO
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.types import NAME_TERM_DELIMITER, TaskType, feature_key


def _split_key(key: str) -> tuple[str, str]:
    if NAME_TERM_DELIMITER in key:
        name, term = key.split(NAME_TERM_DELIMITER, 1)
        return name, term
    return key, ""


def _ntv_list(values: np.ndarray, index_map: IndexMap, sparsity_threshold: float):
    names = index_map.names()
    out = []
    for i, v in enumerate(values):
        if abs(float(v)) > sparsity_threshold:
            name, term = _split_key(names[i])
            out.append({"name": name, "term": term, "value": float(v)})
    return out


def _from_ntv_list(entries, index_map: IndexMap) -> np.ndarray:
    w = np.zeros(len(index_map), np.float32)
    for e in entries or ():
        idx = index_map.key_to_index.get(feature_key(e["name"], e.get("term") or ""))
        if idx is not None:
            w[idx] = e["value"]
    return w


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# single GLM
# ---------------------------------------------------------------------------


def save_glm_model(path: str, model: GeneralizedLinearModel,
                   index_map: IndexMap, *, model_id: str = "best",
                   sparsity_threshold: float = 0.0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    coeffs = model.coefficients
    record = {
        "modelId": model_id,
        "modelClass": model.task.value,
        "lossFunction": model.task.value,
        "means": _ntv_list(_host(coeffs.means), index_map, sparsity_threshold),
        "variances": None if coeffs.variances is None else _ntv_list(
            _host(coeffs.variances), index_map, -1.0),
    }
    write_avro_file(path, [record], BAYESIAN_LINEAR_MODEL_AVRO)


def save_glm_model_text(path: str, model: GeneralizedLinearModel,
                        index_map: IndexMap, *,
                        sparsity_threshold: float = 0.0) -> None:
    """The text model beside the Avro one (the reference's legacy pipeline
    writes both): one tab-separated ``name<TAB>term<TAB>value`` line per
    coefficient above ``sparsity_threshold`` in magnitude, by |value|
    descending, ties in index order."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    means = _host(model.coefficients.means)
    names = index_map.names()
    order = np.argsort(-np.abs(means), kind="stable")
    with open(path, "w") as f:
        for i in order:
            v = float(means[i])
            if abs(v) <= sparsity_threshold:
                continue
            name, term = _split_key(names[int(i)])
            f.write(f"{name}\t{term}\t{v!r}\n")


def load_glm_model(path: str, index_map: IndexMap,
                   device=None) -> GeneralizedLinearModel:
    """The GLM at ``path``, its coefficients on ``device`` (``cuda`` unless
    the caller passes ``device="cpu"``)."""
    return _glm_from_record(next(iter(iter_avro_file(path))), index_map,
                            resolve_device(device))


def _glm_from_record(record: dict, index_map: IndexMap,
                     device: torch.device) -> GeneralizedLinearModel:
    means = _from_ntv_list(record["means"], index_map)
    variances = (None if record.get("variances") is None
                 else _from_ntv_list(record["variances"], index_map))
    task = TaskType(record["modelClass"]) if record.get("modelClass") else \
        TaskType.LOGISTIC_REGRESSION
    return GeneralizedLinearModel(
        coefficients=Coefficients(
            means=torch.as_tensor(means, device=device),
            variances=None if variances is None
            else torch.as_tensor(variances, device=device)),
        task=task)


# ---------------------------------------------------------------------------
# GAME models
# ---------------------------------------------------------------------------


def _coordinate_kind(cm) -> tuple[str, dict]:
    """(directory kind, metadata extras) for one coordinate model."""
    if isinstance(cm, FixedEffectModel):
        return "fixed-effect", {"featureShardId": cm.feature_shard_id}
    return "random-effect", {"featureShardId": cm.feature_shard_id,
                             "randomEffectType": cm.random_effect_type}


def _write_coordinate_part(output_dir: str, cid: str, cm,
                           imap: IndexMap,
                           entity_vocabs: dict[str, dict[str, int]],
                           sparsity_threshold: float) -> str:
    """One coordinate's ``coefficients/part-00000.avro``."""
    kind, _ = _coordinate_kind(cm)
    part = os.path.join(output_dir, kind, cid, "coefficients",
                        "part-00000.avro")
    os.makedirs(os.path.dirname(part), exist_ok=True)
    if isinstance(cm, FixedEffectModel):
        save_glm_model(part, cm.model, imap, model_id=cid,
                       sparsity_threshold=sparsity_threshold)
    else:
        vocab = entity_vocabs[cm.random_effect_type]
        reverse = {v: k for k, v in vocab.items()}
        if not _save_re_model_native(part, cm, reverse, imap,
                                     sparsity_threshold):
            # the null codec, as the native writer uses
            write_avro_file(
                part, _re_records(cm, imap, reverse, sparsity_threshold),
                BAYESIAN_LINEAR_MODEL_AVRO, codec="null")
    return part


#: the lineage fields every ``model-metadata.json`` carries (null when the
#: writer supplies none, so repeated saves of one model are byte-identical):
#: ``parentModel`` (the model this one warm-started from), ``trainedAt``
#: (an ISO timestamp) and ``dataManifest`` (the digest of the run's data
#: manifest)
LINEAGE_FIELDS = ("parentModel", "trainedAt", "dataManifest")


def _apply_lineage(metadata: dict, lineage) -> None:
    for field in LINEAGE_FIELDS:
        metadata[field] = (lineage or {}).get(field)


def save_game_model(
    output_dir: str,
    model: GameModel,
    index_maps: dict[str, IndexMap],
    entity_vocabs: dict[str, dict[str, int]],
    *,
    sparsity_threshold: float = 0.0,
    lineage: Optional[dict] = None,
) -> None:
    """Write the reference's fixed-effect/random-effect directory tree, one
    coordinate after another. ``lineage`` fills :data:`LINEAGE_FIELDS`."""
    os.makedirs(output_dir, exist_ok=True)
    metadata = {"task": model.task.value, "coordinates": {}}
    _apply_lineage(metadata, lineage)
    for cid, cm in model.coordinates.items():
        kind, extra = _coordinate_kind(cm)
        metadata["coordinates"][cid] = {"type": kind, **extra}
        _write_coordinate_part(output_dir, cid, cm,
                               index_maps[cm.feature_shard_id], entity_vocabs,
                               sparsity_threshold)
    with open(os.path.join(output_dir, "model-metadata.json"), "w") as f:
        json.dump(metadata, f, indent=2)


def _save_re_model_native(path: str, model: RandomEffectModel,
                          reverse_vocab: dict[int, str], index_map: IndexMap,
                          sparsity_threshold: float) -> bool:
    """Columnar fast path for the per-entity part file
    (``native/avro_writer.cc::photon_write_re_models``): the same records
    as :func:`_re_records`. False (fall back) when the native library is
    missing."""
    from photon_ml_tpu_torch import native

    if not native.available():
        return False
    keys = np.asarray(model.keys)
    coeffs = np.asarray(model.coeffs, np.float64)
    entity_of = keys // model.dim
    feat_of = (keys % model.dim).astype(np.int32)
    # one record per distinct entity, in key order (keys are sorted)
    starts = np.flatnonzero(np.r_[True, entity_of[1:] != entity_of[:-1]]) \
        if len(keys) else np.zeros(0, np.int64)
    entities = entity_of[starts]
    n_models = len(entities)
    counts = np.diff(np.append(starts, len(keys)))
    seg_of = np.repeat(np.arange(n_models), counts)
    keep = np.abs(coeffs) > sparsity_threshold
    rec_indptr = np.zeros(n_models + 1, np.int64)
    np.cumsum(np.bincount(seg_of[keep], minlength=n_models),
              out=rec_indptr[1:])
    split = [_split_key(k) for k in index_map.names()]
    return native.write_re_models(
        path,
        model_ids=[reverse_vocab.get(int(e), str(int(e))) for e in entities],
        model_class=model.task.value,
        rec_indptr=rec_indptr,
        name_ids=feat_of[keep],
        values=coeffs[keep],
        variances=None,
        names=[s[0] for s in split],
        terms=[s[1] for s in split])


def _re_records(model: RandomEffectModel, index_map: IndexMap,
                reverse_vocab: dict[int, str],
                sparsity_threshold: float) -> Iterator[dict]:
    """Per-entity ``BayesianLinearModelAvro`` records, in key order."""
    names = index_map.names()
    if not len(model.keys):
        return
    entity_of = model.keys // model.dim
    feat_of = model.keys % model.dim
    starts = np.flatnonzero(np.r_[True, entity_of[1:] != entity_of[:-1]])
    bounds = np.r_[starts, len(model.keys)]
    for s, e in zip(bounds[:-1], bounds[1:]):
        entity = int(entity_of[s])
        means = []
        for j, v in zip(feat_of[s:e], model.coeffs[s:e]):
            v = float(v)
            if abs(v) <= sparsity_threshold:
                continue
            name, term = _split_key(names[int(j)])
            means.append({"name": name, "term": term, "value": v})
        yield {
            "modelId": reverse_vocab.get(entity, str(entity)),
            "modelClass": model.task.value,
            "lossFunction": model.task.value,
            "means": means,
            "variances": None,
        }


#: metadata ``kind`` of a coefficient patch (a model dir without one is a
#: full model)
PATCH_KIND = "coefficient-patch"


def model_kind(model_dir: str) -> str:
    """``"model"`` or ``"coefficient-patch"`` for a resolved model dir."""
    return _read_metadata(model_dir).get("kind") or "model"


def _read_metadata(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "model-metadata.json")) as f:
        return json.load(f)


def _part_records(model_dir: str, metadata: dict):
    """``cid → iterable`` of a coordinate's decoded coefficient records,
    streamed from its part file."""
    def records_of(cid: str):
        info = metadata["coordinates"][cid]
        return iter_avro_file(os.path.join(
            model_dir, info["type"], cid, "coefficients", "part-00000.avro"))
    return records_of


def _lineage_id(metadata: dict, records_of) -> str:
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    structural = {
        "task": metadata["task"],
        "kind": metadata.get("kind"),
        "coordinates": {
            cid: {k: info.get(k) for k in ("type", "featureShardId",
                                           "randomEffectType")}
            for cid, info in metadata["coordinates"].items()},
    }
    h.update(json.dumps(structural, sort_keys=True).encode())
    for cid in sorted(metadata["coordinates"]):
        h.update(cid.encode())
        for rec in records_of(cid):
            h.update(json.dumps(rec, sort_keys=True).encode())
    return h.hexdigest()


def model_lineage_id(model_dir: str) -> str:
    """Content identity of a saved model: blake2b over the metadata's
    structural fields and every coordinate's decoded records.

    Writer-agnostic: Avro container bytes differ between any two writes
    (random sync markers) and alias dirs rewrite metadata with ``aliasOf``,
    but the records, and so this id, are the same for the same model
    content, whichever package wrote it.
    """
    model_dir = resolve_game_model_dir(model_dir)
    metadata = _read_metadata(model_dir)
    return _lineage_id(metadata, _part_records(model_dir, metadata))


def _entity_vocabs(metadata: dict, records_of) -> dict[str, dict[str, int]]:
    vocabs: dict[str, dict[str, int]] = {}
    for cid, info in metadata["coordinates"].items():
        if info["type"] != "random-effect":
            continue
        vocab = vocabs.setdefault(info["randomEffectType"], {})
        for rec in records_of(cid):
            raw = rec["modelId"]
            if raw not in vocab:
                vocab[raw] = len(vocab)
    return vocabs


def game_model_entity_vocabs(model_dir: str,
                             metadata: Optional[dict] = None,
                             ) -> dict[str, dict[str, int]]:
    """Entity vocabularies derived from the model's own coefficient files
    (raw ``modelId`` strings → dense ids, in record order per part file).

    The batch scorer keys entity lookups off the dataset's vocabulary;
    online serving has no dataset, so the model's saved per-entity records
    are its id universe. Coordinates sharing a random-effect type merge
    into one vocabulary (ids from the first coordinate's record order,
    extended by later ones).
    """
    if metadata is None:
        metadata = _read_metadata(model_dir)
    return _entity_vocabs(metadata, _part_records(model_dir, metadata))


def resolve_game_model_dir(path: str) -> str:
    """Accept a ``train_game`` run dir (containing ``best/``) or a model dir
    holding ``model-metadata.json`` directly."""
    path = os.path.normpath(path)
    if os.path.exists(os.path.join(path, "model-metadata.json")):
        return path
    nested = os.path.join(path, "best")
    if os.path.exists(os.path.join(nested, "model-metadata.json")):
        return nested
    raise FileNotFoundError(f"no model-metadata.json under {path!r}")


def find_feature_index_dir(model_dir: str, *, max_up: int = 3) -> str:
    """Locate the run's ``feature-indexes`` directory: it lives at the
    train_game run root, while the model may sit at ``<run>/best`` or
    ``<run>/all/config-N``, so walk up to find it."""
    probe = os.path.normpath(model_dir)
    for _ in range(max_up):
        candidate = os.path.join(probe, "feature-indexes")
        if os.path.isdir(candidate):
            return candidate
        probe = os.path.dirname(probe)
    raise FileNotFoundError(
        f"no feature-indexes directory at or above {model_dir!r}")


def _game_model(metadata: dict, records_of,
                index_maps: dict[str, IndexMap],
                entity_vocabs: dict[str, dict[str, int]],
                device: torch.device) -> GameModel:
    task = TaskType(metadata["task"])
    coordinates = {}
    for cid, info in metadata["coordinates"].items():
        shard_id = info["featureShardId"]
        imap = index_maps[shard_id]
        if info["type"] == "fixed-effect":
            glm = _glm_from_record(next(iter(records_of(cid))), imap, device)
            coordinates[cid] = FixedEffectModel(
                model=GeneralizedLinearModel(
                    coefficients=glm.coefficients, task=task),
                feature_shard_id=shard_id)
            continue
        re_type = info["randomEffectType"]
        vocab = entity_vocabs[re_type]
        dim = len(imap)
        keys, coeffs = [], []
        for rec in records_of(cid):
            entity = vocab.get(rec["modelId"])
            if entity is None:
                continue  # entity absent from this dataset's vocab
            for e in rec["means"] or ():
                j = imap.key_to_index.get(
                    feature_key(e["name"], e.get("term") or ""))
                if j is not None:
                    keys.append(entity * dim + j)
                    coeffs.append(e["value"])
        keys = np.asarray(keys, np.int64)
        order = np.argsort(keys, kind="stable")
        coordinates[cid] = RandomEffectModel(
            random_effect_type=re_type, feature_shard_id=shard_id,
            task=task, dim=dim, keys=keys[order],
            coeffs=np.asarray(coeffs, np.float32)[order])
    return GameModel(coordinates=coordinates, task=task)


def load_game_model(
    output_dir: str,
    index_maps: dict[str, IndexMap],
    entity_vocabs: dict[str, dict[str, int]],
    device=None,
) -> GameModel:
    """The GAME model saved at ``output_dir``, keyed by this dataset's index
    maps and entity vocabularies (entities absent from a vocabulary and
    features absent from an index map are dropped). Fixed-effect
    coefficients land on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``); random-effect tables stay host numpy."""
    device = resolve_device(device)
    metadata = _read_metadata(output_dir)
    return _game_model(metadata, _part_records(output_dir, metadata),
                       index_maps, entity_vocabs, device)


def load_serving_model(model_dir: str, index_maps: dict[str, IndexMap],
                       device=None):
    """What online serving loads from a resolved model dir, decoding each
    part file once: ``(metadata, model, entity vocabularies, lineage
    id)``, the same as :func:`load_game_model` under
    :func:`game_model_entity_vocabs` and :func:`model_lineage_id`."""
    device = resolve_device(device)
    metadata = _read_metadata(model_dir)
    stream = _part_records(model_dir, metadata)
    decoded = {cid: list(stream(cid)) for cid in metadata["coordinates"]}
    vocabs = _entity_vocabs(metadata, decoded.__getitem__)
    model = _game_model(metadata, decoded.__getitem__, index_maps, vocabs,
                        device)
    return (metadata, model, vocabs,
            _lineage_id(metadata, decoded.__getitem__))
