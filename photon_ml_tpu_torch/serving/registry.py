"""Versioned model registry: load, validate, pin and hot-swap GAME models.

Counterpart of ``photon_ml_tpu/serving/registry.py``:

- :meth:`ModelRegistry.load` reads a ``train_game`` output dir (either
  package's) through ``resolve_game_model_dir`` /
  ``find_feature_index_dir``, builds the dense per-entity stores on the
  registry's device and a fresh
  :class:`~photon_ml_tpu_torch.serving.engine.ScoringEngine`, and registers
  the result under a monotonically increasing version id.
- **Validation before activation**: the whole load (metadata checks,
  index maps, every coefficient part file, store packing) completes before
  the version becomes visible. A corrupt candidate raises and the active
  version keeps serving. With ``warmup`` the new engine captures its
  bucket graphs outside the swap lock, while the incumbent serves.
- **Atomic hot swap**: :meth:`activate` replaces one reference under a
  lock. In-flight requests hold their version's ``ServingModel`` and finish
  on it; old versions stay registered (instant rollback) until
  :meth:`retire` drops them.

Not ported: coefficient patches (``load_patch``; a patch dir given to
:meth:`reload` raises :class:`NotImplementedError`), two-phase
``prepare`` and reshard, the canary and quality monitor, fleet shards and
the ranking engine.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Mapping, Optional, Sequence

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.events import GLOBAL_BUS, EventBus
from photon_ml_tpu_torch.game.model import FixedEffectModel, GameModel
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfig
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.io.model_io import (
    PATCH_KIND,
    find_feature_index_dir,
    load_serving_model,
    model_kind,
    resolve_game_model_dir,
)
from photon_ml_tpu_torch.serving.engine import ScoringEngine
from photon_ml_tpu_torch.serving.store import (
    TABLE_DTYPES,
    EntityCoefficientStore,
)
from photon_ml_tpu_torch.telemetry import metrics as _metrics

#: resident bytes of the active version's dense coefficient tables (rows +
#: int8 scale vectors), per coordinate and storage dtype
_TABLE_BYTES = _metrics.gauge(
    "photon_serving_table_bytes",
    "Device bytes of the active serving coefficient table",
    labels=("coordinate", "dtype"))


@dataclasses.dataclass(frozen=True)
class ServingModel:
    """One immutable, fully materialized model version: everything a
    request needs, so a swap can never tear its state."""

    version: int
    model_dir: str
    model: GameModel
    index_maps: Mapping[str, IndexMap]
    stores: Mapping[str, EntityCoefficientStore]
    engine: ScoringEngine
    #: content identity (io.model_io.model_lineage_id) of the model
    lineage: Optional[str] = None
    #: raw → dense entity-id universe the version's models were loaded under
    entity_vocabs: Mapping[str, Mapping[str, int]] = dataclasses.field(
        default_factory=dict)
    #: lineage of the model this one was trained from (metadata
    #: ``parentModel``)
    parent_lineage: Optional[str] = None

    def score(self, records: Sequence[dict]):
        return self.engine.score(records)


class ModelRegistry:
    """Thread-safe version store with one pinned *active* version.

    Tables and engines live on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``; no card raises).
    """

    def __init__(self, shard_configs: Sequence[FeatureShardConfig], *,
                 max_batch: int = 1024, warmup: bool = False,
                 table_dtype: str = "float32", device=None,
                 bus: Optional[EventBus] = None):
        if table_dtype not in TABLE_DTYPES:
            raise ValueError(f"unknown table_dtype {table_dtype!r}; "
                             f"expected one of {TABLE_DTYPES}")
        self.device = resolve_device(device)
        self.shard_configs = tuple(shard_configs)
        self.max_batch = max_batch
        self.warmup = warmup
        #: storage format of every loaded version's coefficient tables
        self.table_dtype = table_dtype
        self.bus = bus if bus is not None else GLOBAL_BUS
        self._lock = threading.Lock()
        self._versions: dict[int, ServingModel] = {}  # guarded-by: _lock
        self._active: Optional[ServingModel] = None  # guarded-by: _lock
        self._next_version = 1  # guarded-by: _lock

    # --- queries ----------------------------------------------------------
    def active(self) -> ServingModel:
        sm = self._active
        if sm is None:
            raise RuntimeError("no active model version (load one first)")
        return sm

    def active_or_none(self) -> Optional[ServingModel]:
        return self._active

    @property
    def active_version(self) -> Optional[int]:
        sm = self._active
        return None if sm is None else sm.version

    def versions(self) -> list[int]:
        with self._lock:
            return sorted(self._versions)

    def get(self, version: int) -> ServingModel:
        with self._lock:
            return self._versions[version]

    # --- lifecycle --------------------------------------------------------
    def load(self, model_dir: str, *, activate: bool = True) -> ServingModel:
        """Load and validate a candidate dir; register (and by default
        activate) it. Raises without touching the active version when the
        candidate is unreadable or structurally invalid."""
        try:
            loaded = self._load_validated(model_dir)
        except Exception as e:
            self.bus.post("model_reload_rejected", path=model_dir,
                          error=repr(e))
            raise
        with self._lock:
            version = self._next_version
            self._next_version += 1
            sm = ServingModel(version=version, **loaded)
            self._versions[version] = sm
        if self.warmup:
            # capture every bucket OUTSIDE the swap lock: traffic keeps
            # flowing on the old version while the new one warms
            sm.engine.warmup()
        self.bus.post("model_loaded", version=version, path=sm.model_dir,
                      n_entities={cid: s.n_entities
                                  for cid, s in sm.stores.items()})
        if activate:
            self.activate(version)
        return sm

    def activate(self, version: int) -> ServingModel:
        """Atomically pin ``version`` as active. In-flight requests keep
        the reference they already grabbed and finish on the old version."""
        with self._lock:
            sm = self._versions[version]
            previous = self._active
            self._active = sm
        for cid, store in sm.stores.items():
            _TABLE_BYTES.labels(coordinate=cid,
                                dtype=store.table_dtype).set(
                                    store.table_bytes)
        self.bus.post("model_activated", version=sm.version,
                      previous=None if previous is None
                      else previous.version)
        return sm

    def reload(self, model_dir: str) -> ServingModel:
        """The ``/reload`` verb: load, validate, activate. Full model dirs
        only: a coefficient patch raises :class:`NotImplementedError`, and
        the incumbent keeps serving."""
        try:
            if model_kind(resolve_game_model_dir(model_dir)) == PATCH_KIND:
                raise NotImplementedError(
                    f"{model_dir}: coefficient patches are not ported "
                    f"(publish a full model dir)")
        except Exception as e:
            self.bus.post("model_reload_rejected", path=model_dir,
                          error=repr(e))
            raise
        return self.load(model_dir, activate=True)

    def retire(self, version: int) -> None:
        """Drop a non-active version (its device tables and graphs go once
        in-flight holders release their references)."""
        with self._lock:
            if self._active is not None and self._active.version == version:
                raise ValueError(f"version {version} is active; activate "
                                 "another version before retiring it")
            self._versions.pop(version, None)

    # --- internals --------------------------------------------------------
    def _load_validated(self, model_dir: str) -> dict:
        model_dir = resolve_game_model_dir(model_dir)
        index_dir = find_feature_index_dir(model_dir)
        with open(os.path.join(model_dir, "model-metadata.json")) as f:
            metadata = json.load(f)
        self._check_metadata(model_dir, metadata)
        index_maps = {
            cfg.shard_id: IndexMap.load(
                os.path.join(index_dir, f"{cfg.shard_id}.json"))
            for cfg in self.shard_configs}
        # the model's saved per-entity records are serving's id universe
        # (there is no dataset to build one from)
        _, model, vocabs, lineage = load_serving_model(
            model_dir, index_maps, device=self.device)
        stores = {
            cid: EntityCoefficientStore.build(
                cm, vocabs[cm.random_effect_type],
                table_dtype=self.table_dtype, device=self.device)
            for cid, cm in model.coordinates.items()
            if not isinstance(cm, FixedEffectModel)}
        engine = ScoringEngine(model, self.shard_configs, index_maps, stores,
                               max_batch=self.max_batch, device=self.device)
        return {"model_dir": model_dir, "model": model,
                "index_maps": index_maps, "stores": stores,
                "engine": engine, "lineage": lineage,
                "parent_lineage": metadata.get("parentModel"),
                "entity_vocabs": vocabs}

    def _check_metadata(self, model_dir: str, metadata: dict) -> None:
        """Structural validation before any heavy load: coordinate types
        known, shard ids covered by the serving config, every part file
        present."""
        known = {cfg.shard_id for cfg in self.shard_configs}
        coords = metadata.get("coordinates")
        if not coords:
            raise ValueError(f"{model_dir}: metadata names no coordinates")
        for cid, info in coords.items():
            if info.get("type") not in ("fixed-effect", "random-effect"):
                raise ValueError(
                    f"{model_dir}: coordinate {cid!r} has unknown type "
                    f"{info.get('type')!r}")
            if info.get("featureShardId") not in known:
                raise ValueError(
                    f"{model_dir}: coordinate {cid!r} uses feature shard "
                    f"{info.get('featureShardId')!r}, not in the serving "
                    f"--feature-shards config {sorted(known)}")
            part = os.path.join(model_dir, info["type"], cid,
                                "coefficients", "part-00000.avro")
            if not os.path.exists(part):
                raise FileNotFoundError(
                    f"{model_dir}: missing coefficient file {part}")
