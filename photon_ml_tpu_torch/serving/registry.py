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
- **Coefficient patches** (:meth:`load_patch`): version N+1 derived from
  the active version by overlaying a ``refresh_game`` patch. Only the
  touched rows are written, into fresh tables
  (``EntityCoefficientStore.apply_patch``); untouched coordinates share
  the parent's store objects; the patched version gets an engine of its
  own (the design note in ``serving/engine.py``). The patch is validated
  before anything registers: its metadata, its ``parentModel`` against
  the active version's lineage, every part file.
- **Routing and two phases**: :meth:`reload` and :meth:`prepare` route a
  candidate by its metadata ``kind`` (full model or patch); ``prepare``
  registers a warmed version without activating it, for
  ``activate`` or ``retire`` to follow.

Loads and patches run under the resilience retry policy, with the
``serving.reload`` fault site at the verb and ``io.delta_publish`` between
a patch's validation and its registration; a failure at any point leaves
the active version serving and :meth:`versions` unchanged. Each version
records its load's split (``load_seconds``).

Quality and ranking:

- each version carries the train-time baseline found at its run root
  (:func:`~photon_ml_tpu_torch.quality.baseline.find_baseline`; a patch
  without one inherits its parent's) and attaches a
  :class:`~photon_ml_tpu_torch.quality.monitor.QualityMonitor` on it to
  its engine;
- with a :class:`~photon_ml_tpu_torch.quality.canary.CanaryConfig`, a
  candidate (full load, reload or patch) shadow-scores the request
  reservoir against the incumbent after its warmup and before it
  registers; under the gate a divergence past the bound raises
  :class:`~photon_ml_tpu_torch.quality.canary.CanaryRejected` through the
  reject path, and the incumbent keeps serving;
- with a ``rank_coordinate``, each version gets a
  :class:`~photon_ml_tpu_torch.retrieval.engine.RankingEngine`: a patch
  re-gathers only its touched items into the next
  :class:`~photon_ml_tpu_torch.retrieval.index.ItemIndex` and shares the
  parent's ranking programs, and a full load pins the rank-drift probes
  into its baseline.

Fleet shards: a registry built with ``fleet_shard=(index, count)`` packs
every version's tables as that shard's view (``serving/store.py``) under
its active bucket → shard table (:attr:`ModelRegistry.shard_map`, which
travels with each version and swaps with it at activation). A per-host
patch (``refresh_game --fleet-shards``, metadata ``fleetShard`` /
``fleetShardCount``) applies only on its own shard: a host refuses a
foreign shard's patch, an unsharded host refuses any, and a host serving
a map other than the default placement the refresh cut the set by
refuses it too (a global patch applies on any host). A patch that
writes none of this host's rows shares the parent's tables and engine
programs, so its activation captures nothing.
:meth:`ModelRegistry.prepare_reshard` repacks the active version under a
candidate map as phase one of a live reshard; it refuses a version made
from a per-host patch, whose model holds only its own shard's refreshed
rows (the JAX registry repacks such a version's stale rows).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Mapping, Optional, Sequence

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.events import GLOBAL_BUS, EventBus
from photon_ml_tpu_torch.fleet.sharding import ShardMap, check_shard
from photon_ml_tpu_torch.game.model import FixedEffectModel, GameModel
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfig
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.io.model_io import (
    PATCH_KIND,
    decode_game_model,
    find_feature_index_dir,
    load_serving_model,
    model_kind,
    resolve_game_model_dir,
)
from photon_ml_tpu_torch.quality import (
    CanaryConfig,
    QualityMonitor,
    RequestReservoir,
    find_baseline,
    load_baseline,
    rank_probe_records,
    rank_probe_sample,
    run_canary,
)
from photon_ml_tpu_torch.resilience import fault_point, retry
from photon_ml_tpu_torch.serving import stages as _stages
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

#: item-axis size of the active version's retrieval index (0 when ranking
#: is off)
_RANK_ITEMS = _metrics.gauge(
    "photon_rank_items",
    "Items in the active version's retrieval index (the /rank candidate "
    "vocabulary; 0 = ranking disabled)")
_metrics.mark_host_owned("photon_rank_items")

#: how many probe users the rank-drift reference pins
_RANK_PROBE_USERS = 16


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
    #: wall seconds of this version's load, by step: ``read`` (metadata
    #: and part files), then ``build`` (a full load's stores and engine)
    #: or ``apply`` (a patch's derived stores, merged model and engine),
    #: then ``capture`` (the warmup's graphs, with ``warmup``)
    load_seconds: Mapping[str, float] = dataclasses.field(
        default_factory=dict)
    #: train-time quality profile found at the run root; seeds the
    #: engine's monitor
    baseline: object = None
    #: canary annotation of this version's activation (divergence vs the
    #: incumbent over the request reservoir), None when not evaluated
    canary: Optional[Mapping] = None
    #: this version's :class:`~photon_ml_tpu_torch.retrieval.engine.
    #: RankingEngine` (None = ranking disabled)
    rank_engine: object = None
    #: the bucket → shard table the version's stores were packed under
    #: (None on an unsharded host); activating the version swaps the
    #: registry's active map with it
    shard_map: object = None
    #: derived through a per-host patch: the version's model holds only
    #: this host's shard's refreshed rows, so it cannot repack another
    #: shard's (a reshard needs the merged model loaded first)
    shard_patched: bool = False

    def score(self, records: Sequence[dict]):
        # the request path learns which version answered, also across the
        # microbatcher's worker thread (stages.py)
        _stages.note_served_by(self.version, self.lineage)
        return self.engine.score(records)

    def score_margins(self, records: Sequence[dict]):
        _stages.note_served_by(self.version, self.lineage)
        return self.engine.score_margins(records)

    def rank(self, records: Sequence[dict], ks: Sequence[int]):
        if self.rank_engine is None:
            raise RuntimeError("ranking is not enabled on this registry "
                               "(pass rank_coordinate=)")
        _stages.note_served_by(self.version, self.lineage)
        return self.rank_engine.rank(records, ks)


class ModelRegistry:
    """Thread-safe version store with one pinned *active* version.

    Tables and engines live on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``; no card raises). ``fleet_shard=(index,
    count)`` makes this host one shard of an entity-sharded fleet.
    """

    def __init__(self, shard_configs: Sequence[FeatureShardConfig], *,
                 max_batch: int = 1024, warmup: bool = False,
                 table_dtype: str = "float32", device=None,
                 canary: Optional[CanaryConfig] = None,
                 rank_coordinate: Optional[str] = None,
                 rank_max_k: int = 128,
                 fleet_shard: Optional[tuple] = None,
                 bus: Optional[EventBus] = None):
        if table_dtype not in TABLE_DTYPES:
            raise ValueError(f"unknown table_dtype {table_dtype!r}; "
                             f"expected one of {TABLE_DTYPES}")
        self.device = resolve_device(device)
        #: this host's fleet shard ``(index, count)``, None when unsharded
        self.fleet_shard = check_shard(fleet_shard)
        #: the active bucket → shard table (None when unsharded): the
        #: default map until a reshard epoch activates another
        self.shard_map = (None if self.fleet_shard is None
                          else ShardMap.default(self.fleet_shard[1]))
        self.shard_configs = tuple(shard_configs)
        self.max_batch = max_batch
        self.warmup = warmup
        #: storage format of every loaded version's coefficient tables
        self.table_dtype = table_dtype
        #: canary policy: None disables shadow scoring;
        #: CanaryConfig(gate=False) annotates, gate=True refuses
        self.canary = canary
        #: bounded uniform sample of recent request records, the canary's
        #: shadow-scoring workload (fed by observe_requests)
        self.reservoir = RequestReservoir()
        #: random-effect coordinate whose entity axis /rank retrieves over
        #: (None = ranking disabled)
        self.rank_coordinate = rank_coordinate
        self.rank_max_k = int(rank_max_k)
        self.bus = bus if bus is not None else GLOBAL_BUS
        # lifecycle events (model_loaded / activated / rejected) become
        # metrics through the telemetry bridge; binding is idempotent per
        # (bus, registry), so every registry's bus feeds /metrics
        from photon_ml_tpu_torch.telemetry import bridge

        bridge.bind(bus=self.bus)
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

    def observe_requests(self, records: Sequence[dict]) -> None:
        """Feed scored request records into the canary reservoir."""
        self.reservoir.add(records)

    @property
    def shard_map_hash(self) -> Optional[str]:
        """Content hash of the active shard map (None when unsharded): it
        rides every response beside the lineage, and the router and the
        host compare it to refuse a mixed-map fan-out."""
        sm = self.shard_map
        return None if sm is None else sm.map_hash

    # --- lifecycle --------------------------------------------------------
    def load(self, model_dir: str, *, activate: bool = True) -> ServingModel:
        """Load and validate a candidate dir; register (and by default
        activate) it. Raises without touching the active version when the
        candidate is unreadable or structurally invalid."""
        name = f"serving.load:{os.path.basename(os.path.normpath(model_dir))}"
        return self._register(
            lambda: retry(lambda: self._load_validated(model_dir),
                          name=name),
            model_dir, activate)

    def load_patch(self, patch_dir: str, *,
                   activate: bool = True) -> ServingModel:
        """Derive version N+1 from the active version by overlaying an
        entity-level coefficient patch: only the touched rows are written,
        into fresh tables; untouched coordinates share the parent's stores.
        Validated like any candidate (metadata, lineage against the active
        version, every part file) before anything registers; a failure,
        an ``io.delta_publish`` fault among them, leaves the active version
        serving and the registry unchanged."""
        name = f"serving.patch:{os.path.basename(os.path.normpath(patch_dir))}"
        return self._register(
            lambda: retry(lambda: self._load_patch_validated(patch_dir),
                          name=name),
            patch_dir, activate)

    def _register(self, load, path: str, activate: bool,  # photon-lint: disable=tel-perf-counter -- load_seconds is the version's own record of its load steps (ServingModel.load_seconds); no metric family carries model-load walls
                  canary: bool = True) -> ServingModel:
        """Run ``load`` (the validated candidate's fields), warm its engine
        when configured, then register it under the next version id and
        by default activate it. Nothing registers when either step
        raises."""
        try:
            loaded = load()
            if self.warmup:
                # capture every bucket before the version is visible,
                # outside the swap lock: traffic keeps flowing on the
                # incumbent while the new engine warms
                t0 = time.perf_counter()
                loaded["engine"].warmup()
                if loaded["rank_engine"] is not None:
                    loaded["rank_engine"].warmup()
                loaded["load_seconds"]["capture"] = \
                    time.perf_counter() - t0
            # the structure is sound; now the predictions are judged,
            # on the warm candidate (its shadow scores capture nothing)
            loaded["canary"] = (self._canary_evaluate(loaded) if canary
                                else None)
        except Exception as e:
            self.bus.post("model_reload_rejected", path=path,
                          error=repr(e))
            raise
        with self._lock:
            version = self._next_version
            self._next_version += 1
            sm = ServingModel(version=version, **loaded)
            self._versions[version] = sm
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
            if sm.shard_map is not None:
                # the map travels with the version: a reshard's activation
                # (or its rollback) swaps tables and map in one pin
                self.shard_map = sm.shard_map
        for cid, store in sm.stores.items():
            _TABLE_BYTES.labels(coordinate=cid,
                                dtype=store.table_dtype).set(
                                    store.table_bytes)
        _RANK_ITEMS.set(0 if sm.rank_engine is None
                        else sm.rank_engine.index.n_items)
        self.bus.post("model_activated", version=sm.version,
                      previous=None if previous is None
                      else previous.version)
        return sm

    def reload(self, model_dir: str) -> ServingModel:
        """The ``/reload`` verb: load, validate, activate. Routes by the
        candidate's metadata ``kind``: a full model dir rebuilds the
        tables, a coefficient patch overlays the active version's
        (:meth:`load_patch`), so one publish directory can mix both."""
        return self._route(model_dir, activate=True)

    def prepare(self, model_dir: str) -> ServingModel:
        """Phase one of a two-phase activation: validate the candidate,
        warm it and register it without activating; :meth:`activate`
        (phase two) or :meth:`retire` (the abort) follows. The incumbent
        serves throughout. Routes full dirs and patches as :meth:`reload`
        does."""
        return self._route(model_dir, activate=False, phase="prepare")

    def _route(self, model_dir: str, *, activate: bool,
               phase: Optional[str] = None) -> ServingModel:
        try:
            # a faulted reload takes the path of a corrupt candidate: the
            # incumbent keeps serving
            if phase is None:
                fault_point("serving.reload", path=model_dir)
            else:
                fault_point("serving.reload", path=model_dir, phase=phase)
            kind = model_kind(resolve_game_model_dir(model_dir))
        except Exception as e:
            self.bus.post("model_reload_rejected", path=model_dir,
                          error=repr(e))
            raise
        if kind == PATCH_KIND:
            return self.load_patch(model_dir, activate=activate)
        return self.load(model_dir, activate=activate)

    def retire(self, version: int) -> None:
        """Drop a non-active version (its device tables and graphs go once
        in-flight holders release their references)."""
        with self._lock:
            if self._active is not None and self._active.version == version:
                raise ValueError(f"version {version} is active; activate "
                                 "another version before retiring it")
            self._versions.pop(version, None)

    def prepare_reshard(self, shard_map) -> "tuple[ServingModel, dict]":  # photon-lint: disable=tel-perf-counter -- load_seconds is the version's own record of its load steps (ServingModel.load_seconds); no metric family carries model-load walls
        """Phase one of a live reshard: repack the active version's tables
        under a candidate bucket → shard map and register the result,
        warmed, without activating it. Returns ``(prepared, moved)``, where
        ``moved`` counts this host's rows by direction (``moved_in``,
        ``moved_out``, ``retained``): only ids of reassigned buckets move.
        The model content is untouched (same lineage, same coefficients);
        a coordinate whose membership did not change keeps the incumbent's
        table, and when none changed the version shares the incumbent's
        engine programs. Runs the ``serving.reload`` fault site, so an
        injected refusal aborts the fleet epoch."""
        if not isinstance(shard_map, ShardMap):
            shard_map = ShardMap.from_dict(shard_map)
        parent = self.active()
        if self.fleet_shard is None:
            raise ValueError(
                "reshard needs a fleet-sharded host (serve with "
                "--fleet-shard/--fleet-shard-count); an unsharded host "
                "has no bucket table to move")
        if shard_map.n_shards != self.fleet_shard[1]:
            raise ValueError(
                f"shard map names {shard_map.n_shards} shards, this "
                f"fleet has {self.fleet_shard[1]} hosts per replica "
                f"group — resizing the host set is a topology change, "
                f"not a map move")
        if parent.shard_patched:
            raise ValueError(
                f"version {parent.version} came through a per-host patch: "
                f"its model holds only shard {self.fleet_shard[0]}'s "
                f"refreshed rows, and a reshard would pack stale rows of "
                f"the moved buckets — /reload the merged full model first")
        index = self.fleet_shard[0]
        moved = {"moved_in": 0, "moved_out": 0, "retained": 0}
        path = f"shard-map:{shard_map.map_hash}"
        try:
            fault_point("serving.reload", path=path, phase="prepare")
            t0 = time.perf_counter()
            stores: dict[str, EntityCoefficientStore] = {}
            for cid, store in parent.stores.items():
                vocab = parent.entity_vocabs.get(store.random_effect_type,
                                                 {})
                old_ids = set(store.row_of_id)
                new_ids = {raw for raw in vocab
                           if shard_map.owns(raw, index)}
                moved["moved_in"] += len(new_ids - old_ids)
                moved["moved_out"] += len(old_ids - new_ids)
                moved["retained"] += len(old_ids & new_ids)
                if new_ids == old_ids:
                    # membership unchanged: the incumbent's table, with
                    # only the governing map advanced
                    stores[cid] = dataclasses.replace(store,
                                                      shard_map=shard_map)
                else:
                    stores[cid] = EntityCoefficientStore.build(
                        parent.model.coordinates[cid], vocab,
                        table_dtype=self.table_dtype,
                        shard=self.fleet_shard, shard_map=shard_map,
                        device=self.device)
            engine = ScoringEngine(parent.model, self.shard_configs,
                                   parent.index_maps, stores,
                                   max_batch=self.max_batch,
                                   device=self.device,
                                   share_from=parent.engine)
            rank_engine = None
            if self.rank_coordinate is not None:
                cid = self.rank_coordinate
                unchanged = (parent.rank_engine is not None
                             and stores[cid].table
                             is parent.stores[cid].table)
                rank_engine = self._build_rank_engine(
                    engine, stores,
                    index=parent.rank_engine.index if unchanged else None,
                    share_from=parent.rank_engine)
            engine.monitor = QualityMonitor(parent.baseline)
            loaded = {
                "model_dir": parent.model_dir, "model": parent.model,
                "index_maps": parent.index_maps, "stores": stores,
                "engine": engine, "rank_engine": rank_engine,
                "lineage": parent.lineage,
                "entity_vocabs": parent.entity_vocabs,
                "parent_lineage": parent.parent_lineage,
                "baseline": parent.baseline, "shard_map": shard_map,
                "load_seconds": {"build": time.perf_counter() - t0}}
        except Exception as e:
            self.bus.post("model_reload_rejected", path=path,
                          error=repr(e))
            raise
        # no canary: the content is the incumbent's, only its placement
        # moved
        sm = self._register(lambda: loaded, path, activate=False,
                            canary=False)
        return sm, moved

    # --- internals --------------------------------------------------------
    def _load_validated(self, model_dir: str) -> dict:  # photon-lint: disable=tel-perf-counter -- load_seconds is the version's own record of its load steps (ServingModel.load_seconds); no metric family carries model-load walls
        t0 = time.perf_counter()
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
        model, vocabs, lineage = load_serving_model(
            model_dir, index_maps, metadata=metadata, device=self.device)
        t1 = time.perf_counter()
        stores = {
            cid: EntityCoefficientStore.build(
                cm, vocabs[cm.random_effect_type],
                table_dtype=self.table_dtype, shard=self.fleet_shard,
                shard_map=self.shard_map, device=self.device)
            for cid, cm in model.coordinates.items()
            if not isinstance(cm, FixedEffectModel)}
        engine = ScoringEngine(model, self.shard_configs, index_maps, stores,
                               max_batch=self.max_batch, device=self.device)
        incumbent = self._active
        rank_engine = self._build_rank_engine(
            engine, stores,
            share_from=None if incumbent is None else incumbent.rank_engine)
        # the train-time profile published at the run root; without one
        # the monitor accumulates without score bins
        baseline = load_baseline(find_baseline(model_dir))
        # a full load pins the rank-drift reference (patches inherit it)
        baseline = self._pin_rank_reference(baseline, rank_engine, stores)
        engine.monitor = QualityMonitor(baseline)
        return {"model_dir": model_dir, "model": model,
                "index_maps": index_maps, "stores": stores,
                "engine": engine, "rank_engine": rank_engine,
                "lineage": lineage,
                "parent_lineage": metadata.get("parentModel"),
                "entity_vocabs": vocabs, "baseline": baseline,
                "shard_map": self.shard_map,
                "load_seconds": {"read": t1 - t0,
                                 "build": time.perf_counter() - t1}}

    # --- ranking ----------------------------------------------------------
    def _build_rank_engine(self, engine: ScoringEngine, stores, *,
                           index=None, share_from=None):
        """The version's RankingEngine (None when ranking is off).
        ``index`` replaces the from-scratch ItemIndex build (the patch
        path's incremental one); ``share_from`` reuses a compatible
        engine's programs."""
        if self.rank_coordinate is None:
            return None
        from photon_ml_tpu_torch.retrieval import ItemIndex, RankingEngine

        store = stores.get(self.rank_coordinate)
        if store is None:
            raise ValueError(
                f"rank coordinate {self.rank_coordinate!r} is not a "
                f"random-effect coordinate of this model "
                f"(have {sorted(stores)})")
        if index is None:
            index = ItemIndex.build(store, self.rank_coordinate)
        return RankingEngine(engine, index, max_k=self.rank_max_k,
                             share_from=share_from)

    def _pin_rank_reference(self, baseline, rank_engine, stores):
        """Attach the rank-drift reference (deterministic probe users →
        their top-k ids now) to a full load's baseline; at load time,
        before activation, never on the request path."""
        if baseline is None or rank_engine is None \
                or baseline.rank_probes is not None \
                or rank_engine.index.n_items == 0:
            return baseline
        user_ids: list = []
        for cid in rank_engine.user_re_coordinates:
            user_ids.extend(stores[cid].row_of_id)
        if not user_ids:
            # a model without user coordinates ranks every user cold
            user_ids = [f"__rank_probe_{i}"
                        for i in range(_RANK_PROBE_USERS)]
        probes = rank_probe_sample(user_ids, _RANK_PROBE_USERS)
        k = min(10, rank_engine.max_k, rank_engine.index.n_items)
        results = rank_engine.rank(
            rank_probe_records(probes, rank_engine.user_entity_types),
            [k] * len(probes))
        return dataclasses.replace(
            baseline, rank_k=k,
            rank_probes={u: tuple(ids)
                         for u, (ids, _) in zip(probes, results)})

    def _canary_evaluate(self, loaded: dict) -> Optional[dict]:
        """Shadow-score the request reservoir through the candidate vs the
        incumbent. None (skipped) without a canary config, an incumbent,
        or enough reservoir traffic; raises CanaryRejected past the bound
        when the config gates."""
        cfg = self.canary
        if cfg is None:
            return None
        incumbent = self._active
        if incumbent is None:
            return None
        records = self.reservoir.sample()
        if len(records) < cfg.min_records:
            return None
        return run_canary(
            incumbent.engine.score, loaded["engine"].score, records,
            bound=cfg.bound_for(self.table_dtype), gate=cfg.gate,
            candidate_dir=loaded["model_dir"], bus=self.bus)

    def _load_patch_validated(self, patch_dir: str) -> dict:  # photon-lint: disable=tel-perf-counter -- load_seconds is the version's own record of its load steps (ServingModel.load_seconds); no metric family carries model-load walls
        t0 = time.perf_counter()
        parent = self.active_or_none()
        if parent is None:
            raise RuntimeError(
                "patch activation needs an active parent version (load a "
                "full model first)")
        model_dir = resolve_game_model_dir(patch_dir)
        with open(os.path.join(model_dir, "model-metadata.json")) as f:
            metadata = json.load(f)
        if metadata.get("kind") != PATCH_KIND:
            raise ValueError(
                f"{model_dir}: not a coefficient patch "
                f"(kind={metadata.get('kind')!r})")
        want = metadata.get("parentModel")
        if not want or want != parent.lineage:
            raise ValueError(
                f"{model_dir}: patch parentModel {want!r} does not match "
                f"the active version's lineage {parent.lineage!r} — a "
                f"patch only overlays the exact model it was computed "
                f"against (refresh from the currently served model, or "
                f"publish a full model instead)")
        if metadata.get("fleetShardCount") is not None:
            # a per-host patch (refresh_game --fleet-shards) carries one
            # shard's rows; applied anywhere else it would leave that
            # host's slice stale under the merged model's lineage
            want_shard = (int(metadata.get("fleetShard")),
                          int(metadata["fleetShardCount"]))
            if self.fleet_shard is None:
                raise ValueError(
                    f"{model_dir}: patch is for fleet shard "
                    f"{want_shard[0]}/{want_shard[1]} but this host is "
                    f"unsharded — serve with --fleet-shard/"
                    f"--fleet-shard-count or publish a global patch")
            if want_shard != self.fleet_shard:
                raise ValueError(
                    f"{model_dir}: patch is for fleet shard "
                    f"{want_shard[0]}/{want_shard[1]}, this host holds "
                    f"shard {self.fleet_shard[0]}/{self.fleet_shard[1]} "
                    f"— a foreign shard's patch never applies")
            default = ShardMap.default(want_shard[1])
            if parent.shard_map is not None \
                    and parent.shard_map.buckets != default.buckets:
                # the refresh cut the patch set by the default placement:
                # under another map this host would skip rows it now owns
                raise ValueError(
                    f"{model_dir}: per-host patches are cut by the default "
                    f"bucket map {default.map_hash}, this host serves "
                    f"shard map {parent.shard_map.map_hash} — publish the "
                    f"global patch (each host applies its own rows) or "
                    f"reshard back to the default placement")
        self._check_metadata(model_dir, metadata)
        # the patch rides its parent's feature space by contract (the
        # refresh presets the parent's index maps): the parent's maps are
        # the patch's, not read again
        _, patch_model, patch_vocabs, decoded = decode_game_model(
            model_dir, parent.index_maps, metadata=metadata,
            device=self.device)
        # everything validated, nothing registered: a fault here must
        # leave the active version serving and the registry unchanged
        fault_point("io.delta_publish", path=model_dir)
        t1 = time.perf_counter()
        # the union id universe: the parent's vocabularies extended by the
        # patch's new entities
        vocabs = {t: dict(v) for t, v in parent.entity_vocabs.items()}
        for t, pv in patch_vocabs.items():
            tgt = vocabs.setdefault(t, {})
            for raw in pv:
                tgt.setdefault(raw, len(tgt))
        # an entity re-solved to an all-zero row carries no coefficient in
        # its record (nor a key in the decoded model): its row is zeroed,
        # as a removal's is, so the patched version scores as the merged
        # model does
        removed_by_cid = {
            cid: list(info.get("removedEntities") or []) + [
                r["modelId"] for r in decoded.get(cid, ()) if not r["means"]]
            for cid, info in metadata["coordinates"].items()}
        coordinates = dict(parent.model.coordinates)
        stores: dict[str, EntityCoefficientStore] = {}
        for cid, cm in parent.model.coordinates.items():
            if isinstance(cm, FixedEffectModel):
                if cid in patch_model.coordinates:
                    coordinates[cid] = patch_model.coordinates[cid]
                continue
            upd = patch_model.coordinates.get(cid)
            removed = removed_by_cid.get(cid, [])
            if upd is None and not removed:
                # an untouched coordinate shares the parent's store
                stores[cid] = parent.stores[cid]
                continue
            t = cm.random_effect_type
            drop_dense = [vocabs[t][raw] for raw in removed
                          if raw in vocabs[t]]
            if upd is not None:
                # the host model merge keeps ServingModel.model truthful
                # (the engine scores from the stores)
                lut = {int(patch_vocabs[t][raw]): int(vocabs[t][raw])
                       for raw in patch_vocabs[t]}
                upd_union = upd.remap_entities(lut)
            else:
                upd_union = dataclasses.replace(
                    cm, keys=cm.keys[:0], coeffs=cm.coeffs[:0])
            coordinates[cid] = cm.merge(upd_union, drop_entities=drop_dense)
            stores[cid] = parent.stores[cid].apply_patch(
                upd, patch_vocabs.get(t, {}), removed=removed)
        model = GameModel(coordinates=coordinates, task=parent.model.task)
        # the parent's programs when every table is the parent's (a patch
        # that wrote no row of this host's), else an engine whose graphs
        # will hold the derived tables
        engine = ScoringEngine(model, self.shard_configs, parent.index_maps,
                               stores, max_batch=self.max_batch,
                               device=self.device, share_from=parent.engine)
        rank_engine = None
        if self.rank_coordinate is not None:
            parent_rank = parent.rank_engine
            cid = self.rank_coordinate
            index = None if parent_rank is None else parent_rank.index
            if index is not None and stores.get(cid) is not \
                    parent.stores.get(cid):
                # the patch touched the item coordinate: re-gather only
                # the touched rows (new items append inside the padding)
                t = model.coordinates[cid].random_effect_type
                touched = (list(patch_vocabs.get(t, {}))
                           + list(removed_by_cid.get(cid, [])))
                index = index.apply_patch(stores[cid], touched)
            rank_engine = self._build_rank_engine(
                engine, stores, index=index, share_from=parent_rank)
        # the refresh publishes its baseline at its run root (the patch's
        # parent dir); a patch shipped alone inherits the incumbent's
        baseline = load_baseline(find_baseline(model_dir)) or parent.baseline
        if baseline is not None and baseline.rank_probes is None \
                and parent.baseline is not None \
                and parent.baseline.rank_probes is not None:
            # the rank-drift reference chains through patches
            baseline = dataclasses.replace(
                baseline, rank_k=parent.baseline.rank_k,
                rank_probes=parent.baseline.rank_probes)
        engine.monitor = QualityMonitor(baseline)
        return {"model_dir": model_dir, "model": model,
                "index_maps": parent.index_maps, "stores": stores,
                "engine": engine, "rank_engine": rank_engine,
                "baseline": baseline,
                # the patched version is the merged full model: the next
                # patch chains onto it
                "lineage": metadata.get("modelId"),
                "parent_lineage": want,
                "entity_vocabs": vocabs,
                "shard_patched": (parent.shard_patched or metadata.get(
                    "fleetShardCount") is not None),
                "shard_map": (parent.shard_map
                              if parent.shard_map is not None
                              else self.shard_map),
                "load_seconds": {"read": t1 - t0,
                                 "apply": time.perf_counter() - t1}}

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
