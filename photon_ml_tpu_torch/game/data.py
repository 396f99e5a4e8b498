"""GAME data layer: global columnar data, fixed-effect and random-effect datasets.

Counterpart of ``photon_ml_tpu/game/data.py``. The global dataset is
host-resident columnar numpy (labels, offsets, weights, per-shard CSR
features, per-entity-type id columns). A fixed-effect dataset is the shard's
dense design, densified on the device from the CSR arrays, or for a shard
too wide to densify (:func:`choose_dense_design`) a
:class:`~photon_ml_tpu_torch.ops.design.ChunkedSparseDesign` built from its
COO triplets, in f32. A random-effect
dataset groups entities into fixed-shape size buckets — dense
``(entities, samples, features)`` blocks in each entity's compact local
feature space (the INDEX_MAP projector), or in the shared space of the
RANDOM projector, ``(entities, samples, projected_dim)`` — that the
batched solves run one lane per entity. Bucket shapes come from the
geometric or the histogram strategy. The buckets are packed by the native
packer (``native/bucket_pack.cc`` through :mod:`photon_ml_tpu_torch.native`,
two linear passes over the rows) when the library loads, else by the numpy
packer; both give the same buckets. A resident INDEX_MAP bucket is built
as index maps only: its ``(E, S, D)`` host fill is a deferred thunk, since
the solver rebuilds the tensors on the device from the index maps and the
dataset's ``source_data``. With ``cache_device_buckets=False`` the solver
uploads each bucket for its solve and drops it (upload-and-drop streaming)
instead of keeping every bucket on the device; the build turns a
coordinate to streaming when its resident buckets would pass
:data:`RE_FAT_CACHE_MAX_BYTES`.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.projector import ProjectorType, RandomProjector
from photon_ml_tpu_torch.util import group_starts as _group_starts
from photon_ml_tpu_torch.util import hash_uniform as _hash_uniform
from photon_ml_tpu_torch.util import materialize_thunk

logger = logging.getLogger(__name__)

#: fixed-effect designs at or below this width densify when they fit the
#: byte caps; wider ones take the chunked sparse design
DENSE_DESIGN_MAX_DIM = 4096
#: largest dim/(nnz per row) ratio at which a wider shard still densifies
DENSE_CROSSOVER_NNZ_MULT = 512
#: per-device byte cap for a densified design
DENSE_DESIGN_MAX_BYTES = 4 << 30
#: host byte cap for the f32 image the dense decision assumes
DENSE_DESIGN_MAX_HOST_BYTES = 8 << 30
#: per-device cap on a random-effect coordinate's device-resident bucket
#: tensors, as :func:`resident_fat_bytes` counts them; past it the build
#: turns the coordinate to upload-and-drop streaming (peak device memory:
#: one bucket) instead of running out of memory. Chosen for one NVIDIA H100
#: 80GB HBM3 at a 700.00 W power limit: 30 GiB of its 80 GB, the share of
#: the device the JAX package gives the resident buckets, since the device
#: also holds the shared dense shard image (at most
#: DENSE_DESIGN_MAX_BYTES), the score vectors and the solvers'
#: temporaries, and the port's statics hold int64 row indices beside the
#: f32 count's four (E, S) arrays.
RE_FAT_CACHE_MAX_BYTES = 30 << 30

#: held while :meth:`GameData._cached` makes a device image, so one image
#: is made once whichever thread asks first
_IMAGE_LOCK = threading.Lock()


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

    def to_dense(self) -> np.ndarray:
        """The ``(n, dim)`` f32 host matrix (duplicate entries add)."""
        flat = np.bincount(
            self.rows() * np.int64(self.dim) + self.cols.astype(np.int64),
            weights=self.vals.astype(np.float64),
            minlength=self.n_samples * self.dim)
        return flat.astype(np.float32).reshape(self.n_samples, self.dim)

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

    def clear_device_cache(self) -> None:
        """Release the cached device images."""
        self._device_cache.clear()

    @staticmethod
    def _device_key(device) -> str:
        """``device`` as a cache key: ``cuda`` names the current card, as
        a tensor's ``cuda:<index>`` does, so both find one image."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return str(dev)

    def _cached(self, key, make):
        """The image under ``key``, made by ``make`` once: the estimator's
        build threads (one per random-effect coordinate) share this cache,
        so a second thread asking for an image in the making waits for it
        and gets the same tensor."""
        out = self._device_cache.get(key)
        if out is None:
            with _IMAGE_LOCK:
                out = self._device_cache.get(key)
                if out is None:
                    out = make()
                    self._device_cache[key] = out
        return out

    def device_labels(self, device) -> torch.Tensor:
        return self._cached(("labels", self._device_key(device)),
                            lambda: torch.as_tensor(self.labels, device=device))

    def device_weights(self, device) -> torch.Tensor:
        return self._cached(("weights", self._device_key(device)),
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

        return self._cached(("dense_shard", shard_id, str(dtype),
                             self._device_key(device)), make)

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
    return choose_dense_design_stats(shard.n_samples, shard.dim, shard.nnz,
                                     itemsize=itemsize)


def choose_dense_design_stats(n_samples: int, dim: int, nnz: int, *,
                              n_shards: int = 1,
                              n_local_samples: Optional[int] = None,
                              itemsize: int = 4) -> bool:
    """:func:`choose_dense_design`'s rule on explicit statistics: a
    multi-process job passes the GLOBAL ``(n, nnz)`` (summed over ranks) so
    every rank picks the same layout; ``n_local_samples`` (the largest
    rank's rows) bounds the host image each rank builds, and the device cap
    applies to one of ``n_shards`` blocks."""
    n_local = n_samples if n_local_samples is None else n_local_samples
    if n_local * dim * 4 > DENSE_DESIGN_MAX_HOST_BYTES:
        return False
    if n_samples * dim * itemsize // max(n_shards, 1) \
            > DENSE_DESIGN_MAX_BYTES:
        return False
    if dim <= DENSE_DESIGN_MAX_DIM:
        return True
    return dim <= DENSE_CROSSOVER_NNZ_MULT * (nnz / max(n_samples, 1))


def host_design_for_shard(shard: FeatureShard, *, dense: bool,
                          dtype=torch.float32):
    """The shard as a host design for the per-rank feed
    (:func:`~photon_ml_tpu_torch.parallel.multihost.
    global_glm_data_multihost`): a dense CPU tensor in ``dtype``, or a
    :class:`~photon_ml_tpu_torch.ops.design.CsrDesign` with f32 values
    (the sparse layout keeps f32 whatever ``dtype`` says)."""
    from photon_ml_tpu_torch.ops.design import CsrDesign, DenseDesign

    if dense:
        return DenseDesign(x=torch.from_numpy(shard.to_dense()).to(
            design_dtype_of(dtype)))
    return CsrDesign.from_coo(shard.rows(), shard.cols, shard.vals,
                              n_rows=shard.n_samples, n_cols=shard.dim,
                              device="cpu")


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
    binds fresh residual offsets every sweep via :meth:`glm_data`.

    With a ``mesh`` whose ``"data"`` axis has more than one slot, the
    design, labels and weights are built once as a
    :class:`~photon_ml_tpu_torch.parallel.distributed.MeshGLMData` (block
    ``i`` of the rows on data slot ``i``, the reference's RDD
    partitioning) held in ``design``; ``labels`` and ``weights`` are then
    the padded vectors gathered on the first slot, and only the per-sweep
    offsets are placed again."""

    coordinate_id: str
    feature_shard_id: str
    design: object  # DenseDesign, ChunkedSparseDesign or MeshGLMData
    labels: torch.Tensor
    weights: torch.Tensor
    dim: int
    n_samples: int = 0
    mesh: Optional[object] = None
    n_shards: int = 1

    @staticmethod
    def build(coordinate_id: str, data: GameData, feature_shard_id: str, *,
              dtype=torch.float32, device=None,
              mesh=None) -> "FixedEffectDataset":
        """The design is densified on ``device`` (``cuda`` unless the caller
        passes ``device="cpu"``) in ``dtype``; a shard that
        :func:`choose_dense_design` rejects becomes a chunked sparse design
        there, its values in f32 whatever ``dtype`` says (the JAX
        package's single-chip wide-sparse branch). On a data mesh the host
        design (dense in ``dtype``, or COO, by the same rule at one block's
        size) is split into blocks on the host and each block goes to its
        slot: the whole design is never on one device."""
        from photon_ml_tpu_torch.device import resolve_device
        from photon_ml_tpu_torch.ops.design import (
            ChunkedSparseDesign,
            DenseDesign,
        )
        from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS

        device = resolve_device(device)

        shard = data.shards[feature_shard_id]
        dtype = design_dtype_of(dtype)
        itemsize = torch.empty((), dtype=dtype).element_size()
        n_shards = 1 if mesh is None else int(mesh.shape.get(DATA_AXIS, 1))
        if n_shards > 1:
            from photon_ml_tpu_torch.ops.objective import GLMData
            from photon_ml_tpu_torch.parallel.distributed import (
                shard_glm_data,
            )

            host = host_design_for_shard(
                shard, dtype=dtype, dense=choose_dense_design_stats(
                    shard.n_samples, shard.dim, shard.nnz,
                    n_shards=n_shards, itemsize=itemsize))
            sharded = shard_glm_data(
                GLMData(design=host, labels=torch.from_numpy(data.labels),
                        offsets=torch.zeros(shard.n_samples),
                        weights=torch.from_numpy(data.weights)),
                n_shards, device_put_mesh=mesh)
            return FixedEffectDataset(
                coordinate_id=coordinate_id,
                feature_shard_id=feature_shard_id, design=sharded,
                labels=sharded.gather("labels"),
                weights=sharded.gather("weights"), dim=shard.dim,
                n_samples=shard.n_samples, mesh=mesh, n_shards=n_shards)
        if choose_dense_design(shard, itemsize=itemsize):
            design = DenseDesign(
                x=data.device_dense_shard(feature_shard_id, dtype, device))
        else:
            design = ChunkedSparseDesign.from_coo(
                shard.rows(), shard.cols, shard.vals,
                n_rows=shard.n_samples, n_cols=shard.dim, device=device)
        return FixedEffectDataset(
            coordinate_id=coordinate_id, feature_shard_id=feature_shard_id,
            design=design, labels=data.device_labels(device),
            weights=data.device_weights(device), dim=shard.dim,
            n_samples=shard.n_samples)

    def glm_data(self, offsets: torch.Tensor):
        """The data with this sweep's residual ``offsets``: on a data mesh
        the sharded layout with the offsets padded and placed per slot."""
        from photon_ml_tpu_torch.ops.objective import GLMData

        if self.n_shards > 1:
            return self.design.replace_rows(offsets=offsets.to(torch.float32))
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
    #: keep the bucket tensors resident on the device across sweeps; False
    #: uploads each bucket for its solve and drops it after, so the device
    #: holds no more than the bucket in flight and the one before it
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


_THUNK_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class REBucket:
    """One fixed-shape bucket of entities: the unit of a batched solve.

    ``x`` is dense ``(E, S, D)`` in each entity's local feature space;
    ``feature_index`` maps local column j of entity e to the shard feature id
    (``-1`` on padding columns, whose x-values are zero); ``weights`` is zero
    on padded sample rows; ``sample_idx`` is each slot's global sample row
    (``-1`` on padding; an entity's rows fill its first slots).

    An index-only build passes one zero-argument thunk returning ``(x,
    labels, weights)`` as all three; the first read of any of them runs it
    once, under a lock, and keeps its arrays. :attr:`tensor_shape` reads
    the index maps and runs nothing."""

    entity_ids: np.ndarray  # (E,) int64
    x: np.ndarray  # (E, S, D) float32, or the deferred fill
    labels: np.ndarray  # (E, S) float32, or the deferred fill
    weights: np.ndarray  # (E, S) float32, or the deferred fill
    sample_idx: np.ndarray  # (E, S) int64
    feature_index: np.ndarray  # (E, D) int64

    def __getattribute__(self, name):
        if name in ("x", "labels", "weights"):
            val = object.__getattribute__(self, name)
            if callable(val):
                materialize_thunk(self, ("x", "labels", "weights"),
                                  _THUNK_LOCK)
                return object.__getattribute__(self, name)
            return val
        return object.__getattribute__(self, name)

    @property
    def materialized(self) -> bool:
        """Whether the host tensors exist (an eager build, or a deferred
        fill that has run)."""
        return not callable(object.__getattribute__(self, "x"))

    @property
    def n_entities(self) -> int:
        return int(self.entity_ids.shape[0])

    @property
    def tensor_shape(self) -> tuple[int, int, int]:
        """``(E, S, D)``, without running a deferred fill."""
        e, s = self.sample_idx.shape
        return (e, s, int(self.feature_index.shape[1]))


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
    #: set under the RANDOM projector: the buckets hold projected features
    #: and models train in the projected space
    projector: Optional[RandomProjector] = None
    #: the GameData an INDEX_MAP dataset was bucketed from: the solver
    #: rebuilds resident bucket tensors on the device by gathers through
    #: its dense shard image, instead of uploading padded host fills
    source_data: Optional[GameData] = dataclasses.field(
        default=None, compare=False, repr=False)
    #: device images of the bucket arrays (and the index maps they are
    #: rebuilt from), filled by the solver and kept for the dataset's
    #: lifetime (one upload per bucket per run) unless the config streams
    #: them
    _device_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def clear_device_cache(self) -> None:
        """Release the cached bucket images."""
        self._device_cache.clear()

    @property
    def n_active_entities(self) -> int:
        return sum(b.n_entities for b in self.buckets)

    @staticmethod
    def build(coordinate_id: str, data: GameData,
              config: RandomEffectDatasetConfig,
              projector: Optional[RandomProjector] = None,
              use_native: Optional[bool] = None,
              sample_uids: Optional[np.ndarray] = None,
              n_entity_shards: int = 1,
              ) -> "RandomEffectDataset":
        """``projector`` overrides the seeded Gaussian matrix of the RANDOM
        projector (the factored coordinate passes its learned
        projection). ``use_native`` picks the INDEX_MAP bucket packer: the
        native one (True: raise when the library is missing), the numpy
        one (False), or the native one when the library loads (None).
        ``sample_uids`` (default: the row indices) key the active-data
        subsample: a multi-process build passes global row ids, so each
        rank keeps the rows a single-process build keeps.
        ``n_entity_shards`` (the slots of an entity mesh axis) divides the
        resident bytes the memory guard holds to the per-device cap."""
        shard = data.shards[config.feature_shard_id]
        entities = data.id_columns[config.random_effect_type]
        n = data.n_samples
        if sample_uids is None:
            sample_uids = np.arange(n, dtype=np.int64)

        present = entities >= 0
        order = _stable_group_order(entities[present])
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

        if config.projector_type is ProjectorType.RANDOM:
            if projector is None:
                if config.projected_dim is None:
                    raise ValueError("RANDOM projector requires projected_dim")
                projector = RandomProjector.build(
                    shard.dim, config.projected_dim, config.seed)
            buckets = _random_projection_buckets(
                data, shard, all_active, ent_of_active, act_entity,
                projector, config)
            config = _guard_fat_cache(coordinate_id, config, buckets,
                                      n_entity_shards)
            return RandomEffectDataset(
                coordinate_id=coordinate_id, config=config, buckets=buckets,
                passive_sample_idx=passive,
                passive_entity_ids=entities[passive],
                n_entities_total=n_entities_total, projector=projector)
        buckets = _index_map_buckets(data, shard, all_active, ent_of_active,
                                     act_entity, config, use_native)
        config = _guard_fat_cache(coordinate_id, config, buckets,
                                  n_entity_shards)
        return RandomEffectDataset(
            coordinate_id=coordinate_id, config=config, buckets=buckets,
            passive_sample_idx=passive, passive_entity_ids=entities[passive],
            n_entities_total=n_entities_total, source_data=data)


def resident_fat_bytes(buckets) -> int:
    """Device bytes of a coordinate's resident bucket tensors, counted as
    f32: x ``(E, S, D)`` and four ``(E, S)`` arrays (labels, weights and
    two row indices). The one home of the formula: the build's guard and
    the estimator's budget both read it."""
    return sum(e * s * d * 4 + 4 * e * s * 4
               for (e, s, d) in (b.tensor_shape for b in buckets))


def _guard_fat_cache(coordinate_id: str, config: RandomEffectDatasetConfig,
                     buckets, n_entity_shards: int
                     ) -> RandomEffectDatasetConfig:
    """Resident buckets keep every bucket's tensors on the device for the
    dataset's lifetime. Past :data:`RE_FAT_CACHE_MAX_BYTES` per device (the
    total over the entity axis's slots, which each hold 1/K of the lanes)
    the coordinate streams instead (upload-and-drop: peak device memory
    one bucket). The sum over coordinates is held by
    ``GameEstimator.prepare``, which sees them all."""
    if not config.cache_device_buckets:
        return config
    fat = resident_fat_bytes(buckets) // max(int(n_entity_shards), 1)
    if fat <= RE_FAT_CACHE_MAX_BYTES:
        return config
    logger.warning(
        "random-effect coordinate %s: device-resident buckets would hold "
        "%.1f GiB of fat tensors per device (> %.1f GiB cap) — reverting "
        "to upload-and-drop streaming (peak device memory = one bucket; "
        "slower sweeps). Shard entities across more processes "
        "(--multihost) or slots (--mesh entity=K) to regain the resident "
        "path.", coordinate_id, fat / 2**30, RE_FAT_CACHE_MAX_BYTES / 2**30)
    return dataclasses.replace(config, cache_device_buckets=False)


def _stable_group_order(ids: np.ndarray) -> np.ndarray:
    """Stable argsort of a dense non-negative id column: the native O(n)
    counting sort when the library loads, else numpy's stable sort."""
    from photon_ml_tpu_torch import native

    if native.available():
        out = native.counting_sort(ids)
        if out is not None:
            return out
    return np.argsort(ids, kind="stable")


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
                       config, use_native: Optional[bool]) -> list[REBucket]:
    """INDEX_MAP buckets: each entity's observed shard features (pruned to
    ``max_active_features`` by support), compact-indexed, grouped by padded
    (samples, features) shape. The native packer when ``use_native`` is
    not False and the library loads, else the numpy packer: the same
    buckets in the same order."""
    if not len(act_entity):
        return []
    if use_native is None or use_native:
        from photon_ml_tpu_torch import native

        if native.available():
            bks = _index_map_buckets_native(
                data, shard, all_active, ent_of_active, act_entity, config)
            if bks is not None:
                return bks
        if use_native:
            raise RuntimeError("native bucket packer requested but the "
                               "native library is unavailable")
    return _index_map_buckets_numpy(
        data, shard, all_active, ent_of_active, act_entity, config)


def _index_map_buckets_native(data, shard, all_active, ent_of_active,
                              act_entity, config) -> Optional[list[REBucket]]:
    """The native packer: pass A counts each entity's kept features, the
    bucket shapes follow, and pass B packs each bucket. A resident bucket
    whose shard the solver can densify on the device is packed as index
    maps only, with the fill deferred to a thunk. None when the library
    goes away mid-build."""
    from photon_ml_tpu_torch import native

    n_active = len(act_entity)
    n_samp_per_entity = np.bincount(ent_of_active, minlength=n_active
                                    ).astype(np.int64)
    ent_starts = np.zeros(n_active + 1, np.int64)
    np.cumsum(n_samp_per_entity, out=ent_starts[1:])
    # the library's argument types (no copy when they already match)
    indptr = np.ascontiguousarray(shard.indptr, np.int64)
    cols = np.ascontiguousarray(shard.cols, np.int32)
    vals = np.ascontiguousarray(shard.vals, np.float32)
    aa = np.ascontiguousarray(all_active, np.int64)
    scratch = native.BucketPackScratch(shard.dim)
    n_feat_per_entity = native.re_feature_counts(
        indptr, cols, aa, ent_starts, shard.dim, config.max_active_features,
        scratch)
    if n_feat_per_entity is None:
        return None
    s_pad, d_pad = _padded_shapes(n_samp_per_entity, n_feat_per_entity, config)
    bucket_key = s_pad * np.int64(1 << 40) + d_pad
    labels32 = np.ascontiguousarray(data.labels, np.float32)
    weights32 = np.ascontiguousarray(data.weights, np.float32)
    # the solver's compact path (random_effect.py::_compact_shared) needs a
    # resident coordinate and a shard whose dense image fits the device cap
    indices_only = (config.cache_device_buckets
                    and shard.n_samples * shard.dim * 4
                    <= DENSE_DESIGN_MAX_BYTES)
    # one scratch for every deferred fill of this build, made at the first:
    # each bucket fills at most once and the buckets' entities are disjoint,
    # so its stamps never collide
    lazy_scratch: list = []
    buckets: list[REBucket] = []
    for key in np.unique(bucket_key):
        sel = np.flatnonzero(bucket_key == key)
        S, D = int(s_pad[sel[0]]), int(d_pad[sel[0]])
        if indices_only:
            packed = native.re_bucket_indices(
                indptr, cols, aa, ent_starts, sel, S, D,
                config.max_active_features, scratch)
            if packed is None:
                return None
            sample_idx, feature_index = packed

            def fill(sel=sel, S=S, D=D):
                if not lazy_scratch:
                    lazy_scratch.append(native.BucketPackScratch(shard.dim))
                out = native.re_bucket_fill(
                    indptr, cols, vals, aa, ent_starts, labels32, weights32,
                    sel, S, D, shard.dim, config.max_active_features,
                    lazy_scratch[0])
                if out is None:
                    raise RuntimeError("the native library became "
                                       "unavailable for a deferred bucket "
                                       "fill")
                return out[:3]

            buckets.append(REBucket(
                entity_ids=act_entity[sel], x=fill, labels=fill,
                weights=fill, sample_idx=sample_idx,
                feature_index=feature_index))
            continue
        packed = native.re_bucket_fill(
            indptr, cols, vals, aa, ent_starts, labels32, weights32, sel,
            S, D, shard.dim, config.max_active_features, scratch)
        if packed is None:
            return None
        x, labels, weights, sample_idx, feature_index = packed
        buckets.append(REBucket(
            entity_ids=act_entity[sel], x=x, labels=labels, weights=weights,
            sample_idx=sample_idx, feature_index=feature_index))
    return buckets


def _index_map_buckets_numpy(data, shard, all_active, ent_of_active,
                             act_entity, config) -> list[REBucket]:
    """The numpy packer: sorts of the nnz stream, every bucket filled."""
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


def _random_projection_buckets(data, shard, all_active, ent_of_active,
                               act_entity, projector: RandomProjector,
                               config) -> list[REBucket]:
    """Fixed-shape buckets in the shared projected space: every entity has
    the projected dim as its feature dim, so entities bucket by padded
    sample count only, and ``feature_index`` is the identity into the
    projected space (model keys live there until ``to_shard_space``)."""
    buckets: list[REBucket] = []
    n_active = len(act_entity)
    if not n_active:
        return buckets
    sub = shard.take(all_active)
    z = projector.project_rows(sub.cols, sub.vals, sub.rows(),
                               len(all_active))
    d = projector.projected_dim
    n_samp = np.bincount(ent_of_active, minlength=n_active).astype(np.int64)
    if config.bucket_strategy == "histogram":
        s_pad = _histogram_pad(n_samp, config.max_sample_buckets)
    else:
        s_pad = _geom_at_least(n_samp, config.sample_bucket_growth)
    for s_key in np.unique(s_pad):
        sel = np.flatnonzero(s_pad == s_key)
        S, E = int(s_key), len(sel)
        x = np.zeros((E, S, d), np.float32)
        feature_index = np.tile(np.arange(d, dtype=np.int64), (E, 1))
        slot_of_entity = np.full(n_active, -1, np.int64)
        slot_of_entity[sel] = np.arange(E)
        labels, weights, sample_idx, rows_sel, pos = _bucket_sample_fill(
            data, all_active, ent_of_active, slot_of_entity, E, S,
            np.flatnonzero(np.isin(ent_of_active, sel)))
        x[slot_of_entity[ent_of_active[rows_sel]], pos, :] = z[rows_sel]
        buckets.append(REBucket(
            entity_ids=act_entity[sel], x=x, labels=labels, weights=weights,
            sample_idx=sample_idx, feature_index=feature_index))
    return buckets
