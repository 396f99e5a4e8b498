"""GAME data layer: global columnar data, fixed-effect and random-effect datasets.

Counterpart of ``photon_ml_tpu/game/data.py``. The global dataset is
host-resident columnar numpy (labels, offsets, weights, per-shard CSR
features, per-entity-type id columns). A fixed-effect dataset is the shard's
dense design, densified on the device from the CSR arrays. A random-effect
dataset groups entities into fixed-shape size buckets — dense
``(entities, samples, features)`` blocks in each entity's compact local
feature space (the INDEX_MAP projector) — that the batched L-BFGS solves
one lane per entity. Bucket shapes come from the geometric or the histogram
strategy; the host packing is the JAX package's numpy path.

Not ported yet (they raise :class:`NotImplementedError`): sparse designs
for wide shards, the RANDOM projector, and upload-and-drop streaming
buckets (``cache_device_buckets=False``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.projector import ProjectorType
from photon_ml_tpu_torch.util import group_starts as _group_starts
from photon_ml_tpu_torch.util import hash_uniform as _hash_uniform

#: fixed-effect designs at or below this width densify when they fit the
#: byte caps; wider ones would need the sparse designs (not ported)
DENSE_DESIGN_MAX_DIM = 4096
#: largest dim/(nnz per row) ratio at which a wider shard still densifies
DENSE_CROSSOVER_NNZ_MULT = 512
#: per-device byte cap for a densified design
DENSE_DESIGN_MAX_BYTES = 4 << 30
#: host byte cap for the f32 image the dense decision assumes
DENSE_DESIGN_MAX_HOST_BYTES = 8 << 30


@dataclasses.dataclass(frozen=True)
class FeatureShard:
    """Host CSR feature block over all samples for one feature shard."""

    indptr: np.ndarray  # (n_samples + 1,) int64
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float32
    dim: int

    @property
    def n_samples(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    def row_counts(self) -> np.ndarray:
        return np.diff(self.indptr)

    def rows(self) -> np.ndarray:
        """One row id per nnz."""
        return np.repeat(np.arange(self.n_samples, dtype=np.int64),
                         self.row_counts())

    def take(self, sample_idx: np.ndarray) -> "FeatureShard":
        """Row subset (and reorder) by sample indices."""
        sample_idx = np.asarray(sample_idx, np.int64)
        counts = self.row_counts()[sample_idx]
        new_indptr = np.zeros(len(sample_idx) + 1, np.int64)
        np.cumsum(counts, out=new_indptr[1:])
        total = int(new_indptr[-1])
        row_of_nnz = np.repeat(np.arange(len(sample_idx)), counts)
        offset_in_row = np.arange(total) - np.repeat(new_indptr[:-1], counts)
        gather = self.indptr[sample_idx][row_of_nnz] + offset_in_row
        return FeatureShard(indptr=new_indptr, cols=self.cols[gather],
                            vals=self.vals[gather], dim=self.dim)

    @staticmethod
    def from_coo(rows, cols, vals, n_samples: int, dim: int) -> "FeatureShard":
        """CSR from COO triplets (copied; sorted by row, stable)."""
        rows = np.asarray(rows, np.int64)
        order = np.argsort(rows, kind="stable")
        cols = np.asarray(cols, np.int32)[order]
        vals = np.asarray(vals, np.float32)[order]
        indptr = np.zeros(n_samples + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n_samples), out=indptr[1:])
        return FeatureShard(indptr=indptr, cols=cols, vals=vals, dim=dim)


@dataclasses.dataclass(frozen=True)
class GameData:
    """The global host-resident dataset: one row per sample; entity ids are
    pre-indexed into ``[0, n_entities)``, ``-1`` marks a missing id.
    Device images derived from it (dense shards, labels, weights) are cached
    per device and dtype and shared by every coordinate built over it."""

    labels: np.ndarray  # (n,) float32
    offsets: np.ndarray  # (n,) float32
    weights: np.ndarray  # (n,) float32
    shards: dict[str, FeatureShard]
    id_columns: dict[str, np.ndarray]  # entity-type -> (n,) int64
    _device_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False, init=False)

    def __post_init__(self):
        n = self.labels.shape[0]
        if self.offsets.shape[0] != n or self.weights.shape[0] != n:
            raise ValueError(
                f"offsets/weights length ({self.offsets.shape[0]}/"
                f"{self.weights.shape[0]}) != labels length ({n})")
        for name, shard in self.shards.items():
            if shard.n_samples != n:
                raise ValueError(
                    f"shard {name!r}: {shard.n_samples} rows != {n}")
        for name, ids in self.id_columns.items():
            if ids.shape[0] != n:
                raise ValueError(f"id column {name!r}: {ids.shape[0]} != {n}")

    @property
    def n_samples(self) -> int:
        return int(self.labels.shape[0])

    def _cached(self, key, make):
        out = self._device_cache.get(key)
        if out is None:
            out = make()
            self._device_cache[key] = out
        return out

    def device_labels(self, device) -> torch.Tensor:
        return self._cached(("labels", str(device)),
                            lambda: torch.as_tensor(self.labels, device=device))

    def device_weights(self, device) -> torch.Tensor:
        return self._cached(("weights", str(device)),
                            lambda: torch.as_tensor(self.weights,
                                                    device=device))

    def device_dense_shard(self, shard_id: str, dtype,
                           device) -> torch.Tensor:
        """Dense ``(n, dim)`` device image of a feature shard, built ON THE
        DEVICE from the CSR arrays (duplicate entries accumulate in f32),
        stored in ``dtype``."""
        def make():
            shard = self.shards[shard_id]
            rows = torch.as_tensor(shard.rows(), device=device)
            cols = torch.as_tensor(shard.cols.astype(np.int64), device=device)
            vals = torch.as_tensor(shard.vals, device=device)
            x = torch.zeros((shard.n_samples, shard.dim), dtype=torch.float32,
                            device=device)
            x.index_put_((rows, cols), vals, accumulate=True)
            return x.to(dtype)

        return self._cached(("dense_shard", shard_id, str(dtype), str(device)),
                            make)

    @staticmethod
    def build(labels, shards, offsets=None, weights=None,
              id_columns=None) -> "GameData":
        labels = np.asarray(labels, np.float32)
        n = labels.shape[0]
        return GameData(
            labels=labels,
            offsets=np.zeros(n, np.float32) if offsets is None
            else np.asarray(offsets, np.float32),
            weights=np.ones(n, np.float32) if weights is None
            else np.asarray(weights, np.float32),
            shards=dict(shards),
            id_columns={k: np.asarray(v, np.int64)
                        for k, v in (id_columns or {}).items()})


# ---------------------------------------------------------------------------
# Fixed effect
# ---------------------------------------------------------------------------


def choose_dense_design(shard: FeatureShard, *, itemsize: int = 4) -> bool:
    """Dense vs sparse layout for a fixed-effect design — the JAX package's
    measured crossover rule (``choose_dense_design_stats`` there)."""
    n, dim = shard.n_samples, shard.dim
    if n * dim * 4 > DENSE_DESIGN_MAX_HOST_BYTES:
        return False
    if n * dim * itemsize > DENSE_DESIGN_MAX_BYTES:
        return False
    if dim <= DENSE_DESIGN_MAX_DIM:
        return True
    return dim <= DENSE_CROSSOVER_NNZ_MULT * (shard.nnz / max(n, 1))


def design_dtype_of(dtype) -> torch.dtype:
    """The design dtype of a spec: ``"float32"``, ``"bfloat16"`` or a
    ``torch.dtype``."""
    if isinstance(dtype, str):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown design dtype {dtype!r}")
        return torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return dtype


@dataclasses.dataclass(frozen=True)
class FixedEffectDataset:
    """Device-ready data for one fixed-effect coordinate; coordinate descent
    binds fresh residual offsets every sweep via :meth:`glm_data`."""

    coordinate_id: str
    feature_shard_id: str
    design: object  # DenseDesign on the device
    labels: torch.Tensor
    weights: torch.Tensor
    dim: int
    n_samples: int = 0

    @staticmethod
    def build(coordinate_id: str, data: GameData, feature_shard_id: str, *,
              dtype=torch.float32, device=None) -> "FixedEffectDataset":
        """The design is densified on ``device`` (``cuda`` unless the caller
        passes ``device="cpu"``)."""
        from photon_ml_tpu_torch.device import resolve_device
        from photon_ml_tpu_torch.ops.design import DenseDesign

        device = resolve_device(device)

        shard = data.shards[feature_shard_id]
        dtype = design_dtype_of(dtype)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not choose_dense_design(shard, itemsize=itemsize):
            raise NotImplementedError(
                f"fixed effect {coordinate_id!r}: shard {feature_shard_id!r} "
                f"({shard.n_samples} x {shard.dim}) needs a sparse design, "
                "which is not ported")
        x = data.device_dense_shard(feature_shard_id, dtype, device)
        return FixedEffectDataset(
            coordinate_id=coordinate_id, feature_shard_id=feature_shard_id,
            design=DenseDesign(x=x), labels=data.device_labels(device),
            weights=data.device_weights(device), dim=shard.dim,
            n_samples=shard.n_samples)

    def glm_data(self, offsets: torch.Tensor):
        from photon_ml_tpu_torch.ops.objective import GLMData

        return GLMData(design=self.design, labels=self.labels,
                       offsets=offsets.to(torch.float32), weights=self.weights)


# ---------------------------------------------------------------------------
# Random effect
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RandomEffectDatasetConfig:
    """Bounds and bucketing settings for one random-effect coordinate
    (reference ``RandomEffectDataConfiguration``)."""

    random_effect_type: str  # id-column name, e.g. "userId"
    feature_shard_id: str
    #: max training rows kept per entity (hash-keyed subsample beyond it)
    active_data_upper_bound: Optional[int] = None
    #: entities with fewer rows get no model (their rows stay passive)
    active_data_lower_bound: int = 1
    #: cap on per-entity features kept (by within-entity support, ties by id)
    max_active_features: Optional[int] = None
    projector_type: ProjectorType = ProjectorType.INDEX_MAP
    projected_dim: Optional[int] = None
    #: "geometric": per-entity sample/feature counts padded to powers of
    #: these growth factors
    sample_bucket_growth: float = 4.0
    feature_bucket_growth: float = 2.0
    #: "geometric" or "histogram" (≤max_*_buckets padded sizes chosen from
    #: the size distribution by a min-total-padding partition)
    bucket_strategy: str = "geometric"
    max_sample_buckets: int = 8
    max_feature_buckets: int = 4
    #: keep the bucket tensors resident on the device across sweeps (the
    #: only mode ported)
    cache_device_buckets: bool = True
    seed: int = 20260729

    def __post_init__(self):
        if (self.projector_type is ProjectorType.RANDOM
                and self.max_active_features is not None):
            raise ValueError(
                "max_active_features applies to the INDEX_MAP projector's "
                "per-entity feature selection")
        if self.bucket_strategy not in ("geometric", "histogram"):
            raise ValueError(
                f"unknown bucket_strategy {self.bucket_strategy!r} "
                "(expected 'geometric' or 'histogram')")
        if self.max_sample_buckets < 1 or self.max_feature_buckets < 1:
            raise ValueError(
                "max_sample_buckets and max_feature_buckets must be ≥ 1 "
                f"(got {self.max_sample_buckets}/{self.max_feature_buckets})")

    def check_ported(self) -> None:
        """Raise for the options this port does not run yet."""
        if self.projector_type is not ProjectorType.INDEX_MAP:
            raise NotImplementedError(
                f"projector_type {self.projector_type.value}: only the "
                "INDEX_MAP projector is ported")
        if not self.cache_device_buckets:
            raise NotImplementedError(
                "cache_device_buckets=False (upload-and-drop streaming "
                "buckets) is not ported")


def _geom_at_least(x: np.ndarray, growth: float, floor: int = 1) -> np.ndarray:
    """Elementwise next integer power of ``growth`` ≥ max(x, floor)."""
    x = np.maximum(np.asarray(x, np.int64), floor)
    exp = np.ceil(np.log(x) / np.log(growth) - 1e-9).astype(np.int64)
    out = np.ceil(np.power(growth, exp)).astype(np.int64)
    return np.maximum(out, x)  # guard against fp rounding down


#: unique-size cap for the histogram DP: above it, sizes are pre-quantized
#: to a geometric grid of at most this many points
_HIST_MAX_UNIQUE = 512


def _histogram_pad(x: np.ndarray, max_buckets: int,
                   floor: int = 1) -> np.ndarray:
    """Elementwise padded size via a min-total-padding ≤max_buckets
    partition of the observed sizes (DP over sorted unique sizes: a bucket
    covering sizes (v_i..v_j] costs v_j · (count in the range))."""
    x = np.maximum(np.asarray(x, np.int64), floor)
    v, c = np.unique(x, return_counts=True)
    if len(v) > _HIST_MAX_UNIQUE:
        lo = max(floor, int(v[0]))
        growth = max(1.02,
                     (float(v[-1]) / lo) ** (1.0 / (_HIST_MAX_UNIQUE - 1)))
        xq = _geom_at_least(x, growth, floor)
        v, c = np.unique(xq, return_counts=True)
        x = xq
    m = len(v)
    k_max = min(max_buckets, m)
    w = np.zeros(m + 1, np.int64)
    np.cumsum(c, out=w[1:])
    inf = np.int64(1) << 60
    dp = np.full((k_max + 1, m + 1), inf)
    dp[0, 0] = 0
    parent = np.zeros((k_max + 1, m + 1), np.int64)
    lower = np.arange(m)[:, None] <= np.arange(m)[None, :]
    for k in range(1, k_max + 1):
        cand = dp[k - 1, :m, None] + v[None, :] * (w[1:][None, :] - w[:m, None])
        cand = np.where(lower & (dp[k - 1, :m, None] < inf), cand, inf)
        dp[k, 1:] = cand.min(axis=0)
        parent[k, 1:] = cand.argmin(axis=0)
    k_best = int(np.argmin(dp[1:, m])) + 1
    bounds = []
    j = m
    for k in range(k_best, 0, -1):
        bounds.append(int(v[j - 1]))
        j = int(parent[k, j])
    bounds = np.array(sorted(set(bounds)), np.int64)
    pos = np.searchsorted(bounds, x, side="left")
    return bounds[pos]


@dataclasses.dataclass(frozen=True)
class REBucket:
    """One fixed-shape bucket of entities: the unit of a batched solve.

    ``x`` is dense ``(E, S, D)`` in each entity's local feature space;
    ``feature_index`` maps local column j of entity e to the shard feature id
    (``-1`` on padding columns, whose x-values are zero); ``weights`` is zero
    on padded sample rows; ``sample_idx`` is each slot's global sample row
    (``-1`` on padding)."""

    entity_ids: np.ndarray  # (E,) int64
    x: np.ndarray  # (E, S, D) float32
    labels: np.ndarray  # (E, S) float32
    weights: np.ndarray  # (E, S) float32
    sample_idx: np.ndarray  # (E, S) int64
    feature_index: np.ndarray  # (E, D) int64

    @property
    def n_entities(self) -> int:
        return int(self.entity_ids.shape[0])

    @property
    def tensor_shape(self) -> tuple[int, int, int]:
        return tuple(self.x.shape)


@dataclasses.dataclass(frozen=True)
class RandomEffectDataset:
    """Active data bucketed for batched solves + the passive remainder
    (rows scored with the trained model but not trained on)."""

    coordinate_id: str
    config: RandomEffectDatasetConfig
    buckets: list[REBucket]
    passive_sample_idx: np.ndarray  # (p,) int64
    passive_entity_ids: np.ndarray  # (p,) int64
    n_entities_total: int
    #: device images of the bucket arrays, filled by the solver and kept
    #: for the dataset's lifetime (one upload per bucket per run)
    _device_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def n_active_entities(self) -> int:
        return sum(b.n_entities for b in self.buckets)

    @staticmethod
    def build(coordinate_id: str, data: GameData,
              config: RandomEffectDatasetConfig) -> "RandomEffectDataset":
        config.check_ported()
        shard = data.shards[config.feature_shard_id]
        entities = data.id_columns[config.random_effect_type]
        n = data.n_samples
        sample_uids = np.arange(n, dtype=np.int64)

        present = entities >= 0
        order = np.argsort(entities[present], kind="stable")
        sample_rows = np.flatnonzero(present)[order]  # grouped by entity
        ent_sorted = entities[sample_rows]
        if len(ent_sorted):
            bound = np.empty(len(ent_sorted), bool)
            bound[0] = True
            np.not_equal(ent_sorted[1:], ent_sorted[:-1], out=bound[1:])
            seg_start = np.flatnonzero(bound)
            uniq = ent_sorted[seg_start]
            seg_count = np.diff(np.append(seg_start, len(ent_sorted)))
        else:
            seg_start = np.zeros(0, np.int64)
            uniq = np.zeros(0, np.int64)
            seg_count = np.zeros(0, np.int64)

        # active/passive split per entity
        lower = config.active_data_lower_bound
        upper = config.active_data_upper_bound
        n_rows = len(sample_rows)
        seg_of_row = np.repeat(np.arange(len(uniq)), seg_count)
        entity_active = seg_count >= lower
        keep = np.ones(n_rows, bool)
        if (upper is not None and seg_count.size
                and int(seg_count.max()) > upper):
            # uniform subsample without replacement per entity, keyed by a
            # hash of (seed, global sample id)
            keys = _hash_uniform(sample_uids[sample_rows], config.seed)
            order2 = np.lexsort((keys, seg_of_row))
            ranks = np.empty(n_rows, np.int64)
            ranks[order2] = np.arange(n_rows) - np.repeat(seg_start, seg_count)
            keep = ranks < upper
        active_mask = entity_active[seg_of_row] & keep
        passive = sample_rows[~active_mask]
        all_active = sample_rows[active_mask]
        active_seg = np.flatnonzero(entity_active)
        act_entity = uniq[active_seg].astype(np.int64)
        n_active = len(act_entity)
        dense_of_seg = np.full(len(uniq), -1, np.int64)
        dense_of_seg[active_seg] = np.arange(n_active)
        ent_of_active = dense_of_seg[seg_of_row[active_mask]]
        n_entities_total = int(entities.max()) + 1 if n and present.any() \
            else 0

        buckets = (_index_map_buckets(data, shard, all_active, ent_of_active,
                                      act_entity, config)
                   if n_active else [])
        return RandomEffectDataset(
            coordinate_id=coordinate_id, config=config, buckets=buckets,
            passive_sample_idx=passive, passive_entity_ids=entities[passive],
            n_entities_total=n_entities_total)


def _padded_shapes(n_samp_per_entity: np.ndarray,
                   n_feat_per_entity: np.ndarray,
                   config: RandomEffectDatasetConfig):
    """Per-entity padded (samples, features) per the configured strategy."""
    if config.bucket_strategy == "histogram":
        return (_histogram_pad(n_samp_per_entity, config.max_sample_buckets),
                _histogram_pad(n_feat_per_entity, config.max_feature_buckets))
    return (_geom_at_least(n_samp_per_entity, config.sample_bucket_growth),
            _geom_at_least(n_feat_per_entity, config.feature_bucket_growth))


def _index_map_buckets(data, shard, all_active, ent_of_active, act_entity,
                       config) -> list[REBucket]:
    """INDEX_MAP buckets: each entity's observed shard features (pruned to
    ``max_active_features`` by support), compact-indexed, grouped by padded
    (samples, features) shape."""
    n_active = len(act_entity)
    sub = shard.take(all_active)  # CSR over active rows, entity-grouped
    nnz_ent = np.repeat(ent_of_active, sub.row_counts())

    # support per (entity, feature)
    pair_keys = nnz_ent * np.int64(shard.dim) + sub.cols.astype(np.int64)
    uniq_pairs, pair_inv, pair_support = np.unique(
        pair_keys, return_inverse=True, return_counts=True)
    pair_ent = uniq_pairs // shard.dim
    pair_feat = uniq_pairs % shard.dim

    if config.max_active_features is not None:
        rank_order = np.lexsort((pair_feat, -pair_support, pair_ent))
        ranked_ent = pair_ent[rank_order]
        starts = _group_starts(ranked_ent)
        rank_within = np.arange(len(ranked_ent)) - np.repeat(
            starts, np.diff(np.append(starts, len(ranked_ent))))
        kept = np.zeros(len(uniq_pairs), bool)
        kept[rank_order] = rank_within < config.max_active_features
    else:
        kept = np.ones(len(uniq_pairs), bool)

    # local index of each kept pair within its entity (order: feature id)
    local_idx = np.full(len(uniq_pairs), -1, np.int64)
    kept_ent = pair_ent[kept]
    starts_k = _group_starts(kept_ent)
    counts_k = np.diff(np.append(starts_k, len(kept_ent)))
    local_idx[kept] = np.arange(len(kept_ent)) - np.repeat(starts_k, counts_k)
    n_feat_per_entity = np.zeros(n_active, np.int64)
    if len(kept_ent):
        ent_u, ent_c = np.unique(kept_ent, return_counts=True)
        n_feat_per_entity[ent_u] = ent_c

    n_samp_per_entity = np.bincount(ent_of_active, minlength=n_active
                                    ).astype(np.int64)
    nnz_rows_local = np.repeat(np.arange(len(all_active)), sub.row_counts())

    buckets: list[REBucket] = []
    s_pad, d_pad = _padded_shapes(n_samp_per_entity, n_feat_per_entity, config)
    bucket_key = s_pad * np.int64(1 << 40) + d_pad
    uniq_keys, bucket_of_entity = np.unique(bucket_key, return_inverse=True)
    pair_bucket = bucket_of_entity[pair_ent]
    nnz_bucket = bucket_of_entity[nnz_ent]
    row_bucket = bucket_of_entity[ent_of_active]
    nnz_kept = local_idx[pair_inv] >= 0
    for bi, key in enumerate(uniq_keys):
        sel = np.flatnonzero(bucket_key == key)
        S, D, E = int(s_pad[sel[0]]), int(d_pad[sel[0]]), len(sel)
        x = np.zeros((E, S, D), np.float32)
        feature_index = np.full((E, D), -1, np.int64)
        slot_of_entity = np.full(n_active, -1, np.int64)
        slot_of_entity[sel] = np.arange(E)

        sel_pairs = kept & (pair_bucket == bi)
        pe = slot_of_entity[pair_ent[sel_pairs]]
        feature_index[pe, local_idx[sel_pairs]] = pair_feat[sel_pairs]

        labels, weights, sample_idx, rows_sel, pos = _bucket_sample_fill(
            data, all_active, ent_of_active, slot_of_entity, E, S,
            np.flatnonzero(row_bucket == bi))

        take = (nnz_bucket == bi) & nnz_kept
        pos_of_active_row = np.full(len(all_active), -1, np.int64)
        pos_of_active_row[rows_sel] = pos
        np.add.at(x, (slot_of_entity[nnz_ent[take]],
                      pos_of_active_row[nnz_rows_local[take]],
                      local_idx[pair_inv[take]]), sub.vals[take])

        buckets.append(REBucket(
            entity_ids=act_entity[sel], x=x, labels=labels, weights=weights,
            sample_idx=sample_idx, feature_index=feature_index))
    return buckets


def _bucket_sample_fill(data, all_active, ent_of_active, slot_of_entity,
                        n_entities, n_slots, rows_sel):
    """Scatter the selected entities' rows (``rows_sel`` indexes
    ``all_active``) into bucket sample slots, in row order within entity.
    Returns ``(labels, weights, sample_idx, rows_sel, pos)``."""
    labels = np.zeros((n_entities, n_slots), np.float32)
    weights = np.zeros((n_entities, n_slots), np.float32)
    sample_idx = np.full((n_entities, n_slots), -1, np.int64)
    ent_rows = ent_of_active[rows_sel]
    row_starts = _group_starts(ent_rows)
    row_counts = np.diff(np.append(row_starts, len(ent_rows)))
    pos = np.arange(len(ent_rows)) - np.repeat(row_starts, row_counts)
    es = slot_of_entity[ent_rows]
    g = all_active[rows_sel]
    labels[es, pos] = data.labels[g]
    weights[es, pos] = data.weights[g]
    sample_idx[es, pos] = g
    return labels, weights, sample_idx, rows_sel, pos
