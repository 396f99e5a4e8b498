"""Random-effect training: batched per-entity solves over fixed-shape buckets.

Counterpart of ``photon_ml_tpu/game/random_effect.py``. Every size bucket is
one batched L-BFGS, OWL-QN (an L1 part) or TRON solve whose lanes are the
bucket's entities, each lane with its own convergence (TRON's
Hessian-vector products take the closed form over the bucket); each
objective evaluation is one launch of the entity kernel
(:mod:`~photon_ml_tpu_torch.ops.fused_re`) over the whole ``(E, S, D)``
bucket, a RANDOM-projected ``(E, S, P)`` bucket included. Variances, when
configured, are computed per bucket at the solution and kept on the real
``(entity, feature)`` slots.

A resident, unprojected dataset (the JAX package's ``_sweep_fused``) is
swept as one program, profiled as ``game.re.sweep_fused``
(:mod:`~photon_ml_tpu_torch.telemetry.profiling`): every bucket's solve is
a member of one :func:`~photon_ml_tpu_torch.optimize.common.drive`, which
dispatches every member's step before it reads the host's one answer per
round, so the coordinate makes as many host reads as its slowest bucket
alone, not their sum. Each member runs the operations it runs alone, so
the sweep equals the per-bucket loop bit for bit. Offsets and warm starts
are gathered on the device (the warm start through a cached join into the
previous model's key table), and the model's tables stay on the device
until first read. Streaming (``cache_device_buckets=False``) and projected
datasets keep the per-bucket loop, each solve profiled as
``game.re.solve_bucket``; a streaming dataset uploads each bucket for its
solve and drops it (and keeps no join). Both paths gather the warm start
through the same join, and give an unprojected model its table on the
device (``coeffs_device``), which warm starts and passive scoring read.

A resident bucket of an INDEX_MAP dataset is rebuilt on the device, once,
by gathers through its index maps into the dense image of its shard
(:func:`_materialize_fat`), so its host fill is never made; a projected,
streaming or mesh dataset uploads its host fill instead. What every sweep
of a resident dataset reuses is built by :meth:`RandomEffectSolver.
_warm_compile`, which the estimator runs on a thread of its own while the
fixed effect trains.

Entity parallelism (the reference's ``RandomEffectDatasetPartitioner``):
with a mesh that has an ``"entity"`` axis, each bucket's lanes are padded
to the product of every mesh axis (entity last, the JAX package's
``_lane_axes``) with zero-data lanes and cut into contiguous slices, one a
slot; each slice is a batched solve of its own on its slot (kernel 2 over
the slice), a member of the sweep's drive, and the scores and coefficients
go back in lane order. The batched optimizers freeze each lane on its
own, so a lane's iterates do not depend on the other lanes of its solve,
and kernel 2 cuts a slice's rows into the whole bucket's chunks
(:func:`~photon_ml_tpu_torch.ops.fused_re.entity_plan`'s ``plan_lanes``)
and the scores are per-row sums: on the card a sharded solve equals the
unsharded one bit for bit. On the CPU the plain version's PyTorch kernels
compute some elements of a small tensor by another path
(``torch.sigmoid``; a batched product of one lane), so thin slices part
from the whole bucket at roundoff there.

Padding is inert: padded sample rows carry weight 0, padded feature columns
are all-zero, so with a zero start their coefficients stay exactly 0 (under
L1 too: their pseudo-gradient is 0).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.data import (
    DENSE_DESIGN_MAX_BYTES,
    RandomEffectDataset,
    REBucket,
    design_dtype_of,
)
from photon_ml_tpu_torch.game.model import RandomEffectModel, key_join
from photon_ml_tpu_torch.glm.problem import (
    GLMOptimizationConfiguration,
    OptimizationProblem,
)
from photon_ml_tpu_torch.ops.design import DenseDesign, accumulation_dtype
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.objective import (
    GLMData,
    GLMObjective,
    seed_live_rows,
)
from photon_ml_tpu_torch.optimize.common import drive
from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS, on_slot
from photon_ml_tpu_torch.telemetry import profiling
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType


def _bucket_solve(problem: OptimizationProblem, data: GLMData, w0, lam,
                  want_var: bool):
    """One bucket's batched solve, and its variances when configured."""
    w = problem.run(data, w0, lam).w
    var = (problem.compute_variances(w, data, lam).to(torch.float32)
           .reshape(-1) if want_var else None)
    return w, var


_bucket_solve_profiled = profiling.profile_fn(_bucket_solve,
                                              "game.re.solve_bucket")


def _bucket_keys(bucket: REBucket, shard_dim: int) -> np.ndarray:
    """Model-table keys of a bucket's kept (entity, feature) slots, in
    bucket slot order."""
    fmask = bucket.feature_index >= 0
    ent = np.broadcast_to(bucket.entity_ids[:, None],
                          bucket.feature_index.shape)
    return ent[fmask] * np.int64(shard_dim) + bucket.feature_index[fmask]


@dataclasses.dataclass(frozen=True)
class _BucketStatics:
    """Device images of one bucket, reused by every sweep."""

    x: torch.Tensor  # (E, S, D) design dtype
    labels: torch.Tensor  # (E, S) f32
    weights: torch.Tensor  # (E, S) f32
    gather_idx: torch.Tensor  # (E, S) int64 sample row, 0 on padding
    slots: torch.Tensor  # flat (E*S) positions of real rows
    rows: torch.Tensor  # their global sample rows


@dataclasses.dataclass(frozen=True)
class RandomEffectSolver:
    """Per-coordinate solver bound to a task type, a design dtype
    (``"float32"`` or ``"bfloat16"``) and a device (``cuda`` unless the
    caller passes ``device="cpu"``), where the scores are returned.
    ``mesh``/``entity_axis`` opt into entity-parallel solves (see the
    module docstring); a mesh without ``entity_axis`` solves unsharded."""

    task: TaskType
    config: GLMOptimizationConfiguration
    design_dtype: str = "float32"
    device: Optional[torch.device] = None
    mesh: Optional[object] = None
    entity_axis: str = ENTITY_AXIS

    def __post_init__(self):
        dev = resolve_device(self.device)
        if dev.type == "cuda" and dev.index is None:
            # the index a tensor made on ``cuda`` carries, so the caches
            # keyed by device find what the estimator's thread built
            dev = torch.device("cuda", torch.cuda.current_device())
        object.__setattr__(self, "device", dev)
        if (self.mesh is not None
                and self.entity_axis not in self.mesh.shape):
            # a data-only (or feature-only) mesh has no lanes to shard
            object.__setattr__(self, "mesh", None)
        # per-iteration traces would be carried for every entity lane
        if self.config.optimizer_config.track_states:
            object.__setattr__(self, "config", dataclasses.replace(
                self.config, optimizer_config=dataclasses.replace(
                    self.config.optimizer_config, track_states=False)))

    def _problem(self, plan_lanes: Optional[int] = None
                 ) -> OptimizationProblem:
        """The bucket problem; ``plan_lanes`` (a lane slice's whole bucket)
        keeps kernel 2's row chunks those of the whole bucket."""
        return OptimizationProblem(
            GLMObjective(loss=loss_for_task(self.task),
                         entity_plan_lanes=plan_lanes), self.config)

    def _lane_axes(self) -> tuple:
        """Every mesh axis name, entity last: bucket lanes split over all
        of them, so a ``(data, entity)`` mesh solves on every slot."""
        names = [a for a in self.mesh.axis_names if a != self.entity_axis]
        return tuple(names) + (self.entity_axis,)

    def _slices(self, n_lanes: int) -> list:
        """``(slot, first lane, lanes)`` of each lane slice: the whole
        bucket on the solver's device, or on a mesh the lanes padded to a
        multiple of the slots and cut into contiguous slices in slot
        order."""
        if self.mesh is None:
            return [(self.device, 0, n_lanes)]
        slots = self.mesh.lane_devices(self._lane_axes())
        per = -(-n_lanes // len(slots))
        return [(dev, k * per, per) for k, dev in enumerate(slots)]

    def _statics(self, dataset: RandomEffectDataset, i: int,
                 bucket: REBucket, dev: torch.device, lo: int,
                 n_lanes: int) -> _BucketStatics:
        """Device images of lanes ``[lo, lo + n_lanes)`` of bucket ``i`` on
        ``dev`` (lanes past the bucket's padded with zero data): cached on
        the dataset, or under ``cache_device_buckets=False`` built for this
        solve only. Rebuilt on the device from the bucket's index maps
        when :meth:`_compact_shared` allows, else uploaded from the host
        fill; both give the same tensors."""
        key = ("bucket", i, self.design_dtype, str(dev), lo, n_lanes)
        st = dataset._device_cache.get(key)
        if st is None:
            shared = self._compact_shared(dataset, dev)
            if shared is not None:
                st = self._statics_compact(dataset, i, bucket, dev, shared)
            else:
                st = self._statics_host(bucket, dev, lo, n_lanes)
            if dataset.config.cache_device_buckets:
                dataset._device_cache[key] = st
        return st

    def _statics_host(self, bucket: REBucket, dev: torch.device, lo: int,
                      n_lanes: int) -> _BucketStatics:
        """The statics uploaded from the bucket's host fill."""
        def lanes(a, fill=0):
            return _lane_slice(a, lo, n_lanes, fill)

        si = lanes(bucket.sample_idx, -1)
        live = si >= 0
        weights = lanes(bucket.weights)
        st = _BucketStatics(
            x=torch.as_tensor(lanes(bucket.x), device=dev).to(
                design_dtype_of(self.design_dtype)),
            labels=torch.as_tensor(lanes(bucket.labels), device=dev),
            weights=torch.as_tensor(weights, device=dev),
            gather_idx=torch.as_tensor(np.maximum(si, 0), device=dev),
            slots=torch.as_tensor(np.flatnonzero(live), device=dev),
            rows=torch.as_tensor(si[live], device=dev))
        # the live rows the kernel dispatch counts, from the host copy
        seed_live_rows(st.weights, weights)
        return st

    def _statics_compact(self, dataset: RandomEffectDataset, i: int,
                         bucket: REBucket, dev: torch.device,
                         shared) -> _BucketStatics:
        """The statics rebuilt on ``dev`` from the bucket's index maps and
        the shared dense image: the bucket's host fill is never read."""
        perm, counts, fi = self._compact_arrays(dataset, i, bucket, dev)
        n_fi = bucket.feature_index.shape[1]
        identity = (n_fi == shared[0].shape[1] and bool(
            (bucket.feature_index == np.arange(n_fi)).all()))
        st = _BucketStatics(*_materialize_fat(
            *shared, perm, counts, fi, S=int(bucket.sample_idx.shape[1]),
            identity_cols=identity))
        # the live rows the kernel dispatch counts, from the host weights
        # of the bucket's rows (the fill's weights are exactly these)
        si = bucket.sample_idx
        seed_live_rows(st.weights, (si >= 0) & (
            dataset.source_data.weights[np.maximum(si, 0)] > 0))
        return st

    def _compact_shared(self, dataset: RandomEffectDataset,
                        dev: torch.device):
        """``(dense shard image, labels, weights)`` of the dataset's
        source data on ``dev``, shared by every coordinate on the shard;
        None when the bucket tensors come from the host fill: no source
        data, a projected dataset, a streaming one (upload-and-drop bounds
        device memory at one bucket; the image would stay for the run), a
        mesh (each slot would hold a copy of the image) or an image over
        the device cap."""
        data = dataset.source_data
        if data is None or dataset.projector is not None:
            return None
        if not dataset.config.cache_device_buckets or self.mesh is not None:
            return None
        sid = dataset.config.feature_shard_id
        shard = data.shards[sid]
        dtype = design_dtype_of(self.design_dtype)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if shard.n_samples * shard.dim * itemsize > DENSE_DESIGN_MAX_BYTES:
            return None
        return (data.device_dense_shard(sid, dtype, dev),
                data.device_labels(dev), data.device_weights(dev))

    def _compact_arrays(self, dataset: RandomEffectDataset, i: int,
                        bucket: REBucket, dev: torch.device):
        """A bucket's index maps on ``dev``, uploaded once and cached,
        without their padding: ``perm`` (the bucket's rows in entity order;
        an entity's rows fill its first slots), per-entity ``counts`` and
        ``feature_index``. :func:`_materialize_fat` rebuilds the padded
        ``(E, S)`` row index from the first two."""
        key = ("compact", i, str(dev))
        cached = dataset._device_cache.get(key)
        if cached is None:
            si = bucket.sample_idx
            mask = si >= 0
            cached = (torch.as_tensor(si[mask], device=dev),
                      torch.as_tensor(mask.sum(axis=1), device=dev),
                      torch.as_tensor(bucket.feature_index, device=dev))
            dataset._device_cache[key] = cached
        return cached

    # --- the sweep ----------------------------------------------------------

    def _want_var(self) -> bool:
        return self.config.variance_type != VarianceComputationType.NONE

    def _fused_eligible(self, dataset: RandomEffectDataset) -> bool:
        """The datasets the fused sweep serves, as in the JAX package:
        resident buckets, no projector, at least one bucket. Streaming
        datasets keep the loop, which bounds device memory at one bucket;
        projected ones keep it too."""
        return (dataset.config.cache_device_buckets
                and dataset.projector is None and len(dataset.buckets) > 0)

    def train(self, dataset: RandomEffectDataset, offsets: torch.Tensor,
              lam: float, warm_start: Optional[RandomEffectModel] = None,
              dim: Optional[int] = None
              ) -> tuple[RandomEffectModel, torch.Tensor]:
        """Train every bucket against the residual ``offsets`` (a device
        vector over all samples). Returns the model and a device vector of
        this coordinate's margin on every active sample (0 elsewhere). A
        RANDOM-projected dataset trains a model keyed in the projected
        space. A resident, unprojected dataset takes the fused sweep
        (:meth:`_sweep_fused`), any other the per-bucket loop
        (:meth:`_sweep_looped`)."""
        if dataset.projector is not None:
            shard_dim = dataset.projector.projected_dim
        else:
            shard_dim = dim if dim is not None else _shard_dim(dataset)
        self._join_warm(dataset)
        if self._fused_eligible(dataset):
            return _sweep_fused_profiled(self, dataset, offsets, lam,
                                         warm_start, shard_dim)
        return self._sweep_looped(dataset, offsets, lam, warm_start,
                                  shard_dim)

    def _bucket_data(self, st: _BucketStatics, offsets: torch.Tensor,
                     dev: torch.device) -> GLMData:
        """A bucket's (or lane slice's) solve data: its statics and the
        residual offsets gathered on the device (0 on padding rows)."""
        live = st.weights > 0
        boff = torch.where(live, offsets.to(dev)[st.gather_idx],
                           torch.zeros_like(st.weights))
        return GLMData(design=DenseDesign(x=st.x), labels=st.labels,
                       offsets=boff, weights=st.weights)

    def _sweep_fused(self, dataset: RandomEffectDataset,
                     offsets: torch.Tensor, lam: float,
                     warm_start: Optional[RandomEffectModel],
                     shard_dim: int
                     ) -> tuple[RandomEffectModel, torch.Tensor]:
        """The whole coordinate in one drive (profiled as
        ``game.re.sweep_fused``): each bucket, or on a mesh each lane
        slice of a bucket, is a member; its residual offsets and its warm
        start are gathered on the device (the warm start through the
        cached join of its slots into the previous model's key table,
        :meth:`_warm_ctx`); every member's solve then runs in one
        :func:`~photon_ml_tpu_torch.optimize.common.drive`, whose rounds
        read the tests of all members at once. After the drive, each
        member's variances (when configured) and margins are computed, the
        margins scattered into the scores, and its coefficients and
        variances laid into one flat device payload. The model's tables
        stay on the device until first read (:mod:`~photon_ml_tpu_torch.
        game.model`); ``coeffs_device`` is the sorted table there."""
        want_var = self._want_var()
        warm, table = self._warm_table(dataset, warm_start, shard_dim)
        members, steps, slots = [], [], []
        for i, bucket in enumerate(dataset.buckets):
            e = bucket.tensor_shape[0]
            problem = self._problem(None if self.mesh is None else e)
            for dev, lo, n_lanes in self._slices(e):
                st = self._statics(dataset, i, bucket, dev, lo, n_lanes)
                w0 = self._warm_start(dataset, i, bucket, warm, table,
                                      shard_dim, dev, lo, n_lanes)
                with on_slot(dev):
                    data = self._bucket_data(st, offsets, dev)
                    steps.append(problem.steps(data, w0, lam))
                members.append((i, dev, n_lanes, st, data, problem))
                slots.append(functools.partial(on_slot, dev))
        with torch.profiler.record_function(
                f"re.sweep[{len(members)} members]"):
            results = drive(steps, slots)
        scores = torch.zeros_like(offsets, dtype=torch.float32)
        ws = [[] for _ in dataset.buckets]
        vs = [[] for _ in dataset.buckets]
        for (i, dev, n_lanes, st, data, problem), res in zip(members,
                                                             results):
            with on_slot(dev):
                w = res.w
                if want_var:
                    vs[i].append(problem.compute_variances(w, data, lam).to(
                        torch.float32).reshape(n_lanes, -1).to(self.device))
                margins = _lane_margins(st.x, w)  # (E, S) f32
            scores[st.rows.to(scores.device)] = \
                margins.reshape(-1)[st.slots].to(scores.device)
            ws[i].append(w.to(self.device))
        return self._model(dataset, shard_dim, ws, vs, deferred=True), scores

    def _sweep_looped(self, dataset: RandomEffectDataset,
                      offsets: torch.Tensor, lam: float,
                      warm_start: Optional[RandomEffectModel],
                      shard_dim: int
                      ) -> tuple[RandomEffectModel, torch.Tensor]:
        """One solve after another, each bucket's (each lane slice's)
        profiled as ``game.re.solve_bucket``: the path of streaming and
        projected datasets. A streaming dataset uploads each bucket for its
        solve and drops it. The model's tables come to the host at once;
        an unprojected model also gets its ``coeffs_device``."""
        want_var = self._want_var()
        warm, table = self._warm_table(dataset, warm_start, shard_dim)
        scores = torch.zeros_like(offsets, dtype=torch.float32)
        ws = [[] for _ in dataset.buckets]
        vs = [[] for _ in dataset.buckets]
        for i, bucket in enumerate(dataset.buckets):
            e, s, d = bucket.tensor_shape
            problem = self._problem(None if self.mesh is None else e)
            for dev, lo, n_lanes in self._slices(e):
                st = self._statics(dataset, i, bucket, dev, lo, n_lanes)
                w0 = self._warm_start(dataset, i, bucket, warm, table,
                                      shard_dim, dev, lo, n_lanes)
                with on_slot(dev):
                    data = self._bucket_data(st, offsets, dev)
                    # a profiler range per bucket solve: device time by
                    # bucket shape
                    with torch.profiler.record_function(
                            f"re.bucket[{n_lanes}x{s}x{d}]"):
                        w, var = _bucket_solve_profiled(
                            problem, data, w0, lam, want_var)
                    margins = _lane_margins(st.x, w)  # (E, S) f32
                scores[st.rows.to(scores.device)] = \
                    margins.reshape(-1)[st.slots].to(scores.device)
                ws[i].append(w.to(self.device))
                if want_var:
                    vs[i].append(var.reshape(n_lanes, d).to(self.device))
        return self._model(dataset, shard_dim, ws, vs, deferred=False), scores

    def _model(self, dataset: RandomEffectDataset, shard_dim: int, ws: list,
               vs: list, deferred: bool) -> RandomEffectModel:
        """The coordinate's model from each bucket's solved lane slices
        (``ws[i]``, ``vs[i]``, in lane order): every bucket's coefficients,
        then every bucket's variances, in one flat device payload, copied
        to the host at once or, ``deferred``, at the table's first read.
        An unprojected model gets the sorted table on the device
        (``coeffs_device``), gathered through :meth:`_coef_idx` and the
        cached key order."""
        buckets = dataset.buckets
        solved = [torch.cat(w)[:b.tensor_shape[0]].reshape(-1)
                  for w, b in zip(ws, buckets)]
        solved_var = [torch.cat(v)[:b.tensor_shape[0]].reshape(-1)
                      for v, b in zip(vs, buckets) if v]
        keys, order = self._host_keys(dataset, shard_dim)
        payload = (torch.cat(solved + solved_var) if solved
                   else torch.zeros(0, dtype=torch.float32,
                                    device=self.device))
        tables = _host_tables(payload, buckets, bool(solved_var), order)
        coeffs_device = None
        if dataset.projector is None:
            parts = [w[self._coef_idx(dataset, i, b)]
                     for i, (w, b) in enumerate(zip(solved, buckets))]
            coeffs_device = (torch.cat(parts) if parts else payload)[
                self._order_device(dataset, shard_dim)]
        if deferred:
            coeffs = tables
            variances = tables if solved_var else None
        else:
            coeffs, variances = tables()
        cfg = dataset.config
        return RandomEffectModel(
            random_effect_type=cfg.random_effect_type,
            feature_shard_id=cfg.feature_shard_id, task=self.task,
            dim=shard_dim, keys=keys, coeffs=coeffs, variances=variances,
            projector=dataset.projector, coeffs_device=coeffs_device)

    # --- what every sweep of a dataset reuses ------------------------------

    def _warm_table(self, dataset: RandomEffectDataset,
                    warm: Optional[RandomEffectModel], shard_dim: int):
        """``(warm, table)`` of a sweep: the warm model when it can seed
        this dataset (None otherwise), and the device table the joins
        gather from: its ``coeffs_device``, its host table uploaded once
        (a projected or loaded model), or without a warm model the
        dataset's zero table."""
        if not _usable_warm(warm, shard_dim, dataset.projector):
            return None, self._zero_coeffs(dataset)
        if warm.coeffs_device is not None:
            return warm, warm.coeffs_device
        return warm, torch.as_tensor(np.asarray(warm.coeffs, np.float32),
                                     device=self.device)

    def _warm_start(self, dataset: RandomEffectDataset, i: int,
                    bucket: REBucket, warm: Optional[RandomEffectModel],
                    table: torch.Tensor, shard_dim: int, dev: torch.device,
                    lo: int, n_lanes: int) -> torch.Tensor:
        """The ``(n_lanes, D)`` warm start of lanes ``[lo, lo + n_lanes)``
        of bucket ``i`` on ``dev``: one gather from ``table`` through the
        cached join (:meth:`_warm_ctx`), 0 on slots the table lacks and on
        padding lanes."""
        pos, found = self._warm_ctx(dataset, i, bucket, warm, shard_dim,
                                    dev, lo, n_lanes)
        with on_slot(dev):
            return _warm_gather(table.to(dev), pos, found)

    def _warm_ctx(self, dataset: RandomEffectDataset, i: int,
                  bucket: REBucket, warm: Optional[RandomEffectModel],
                  shard_dim: int, dev: torch.device, lo: int,
                  n_lanes: int):
        """``(pos, found)`` on ``dev``: where each (entity, feature) slot
        of lanes ``[lo, lo + n_lanes)`` of bucket ``i`` sits in ``warm``'s
        key table (``found`` False on absent slots and on padding lanes).
        Built once and cached with the key table it joins; a model of
        another key table (one trained on another dataset) rebuilds it.
        Without a usable warm model, a zero join (``found`` all False)."""
        if warm is not None:
            key = ("warmidx", i, str(dev), lo, n_lanes)
            ctx = dataset._device_cache.get(key)
            if ctx is not None and not (ctx[0] is warm.keys or np.array_equal(
                    ctx[0], warm.keys)):
                ctx = None
            if ctx is None:
                fi = bucket.feature_index
                ent = np.broadcast_to(bucket.entity_ids[:, None], fi.shape)
                pos, found = key_join(warm.keys, shard_dim, ent, fi)
                ctx = (warm.keys,
                       torch.as_tensor(_lane_slice(pos, lo, n_lanes, 0),
                                       device=dev),
                       torch.as_tensor(_lane_slice(found, lo, n_lanes, False),
                                       device=dev))
                _keep(dataset, key, ctx)
            return ctx[1], ctx[2]
        key = ("zeroctx", i, str(dev), lo, n_lanes)
        ctx = dataset._device_cache.get(key)
        if ctx is None:
            shape = (n_lanes, bucket.feature_index.shape[1])
            ctx = (torch.zeros(shape, dtype=torch.int64, device=dev),
                   torch.zeros(shape, dtype=torch.bool, device=dev))
            _keep(dataset, key, ctx)
        return ctx

    def _coef_idx(self, dataset: RandomEffectDataset, i: int,
                  bucket: REBucket) -> torch.Tensor:
        """Flat positions of bucket ``i``'s kept (entity, feature) slots in
        its ``(E * D)`` coefficients, on the solver's device (cached)."""
        key = ("coeffidx", i, str(self.device))
        cidx = dataset._device_cache.get(key)
        if cidx is None:
            cidx = torch.as_tensor(np.flatnonzero(bucket.feature_index >= 0),
                                   device=self.device)
            _keep(dataset, key, cidx)
        return cidx

    @staticmethod
    def _key_table_len(dataset: RandomEffectDataset) -> int:
        """Keys of the table the dataset trains: one a kept slot."""
        return sum(int((b.feature_index >= 0).sum()) for b in dataset.buckets)

    def _zero_coeffs(self, dataset: RandomEffectDataset) -> torch.Tensor:
        """An all-zero table as long as the dataset's, which the zero join
        gathers from for a sweep without a usable warm model (cached)."""
        key = ("zerocoeffs", str(self.device))
        z = dataset._device_cache.get(key)
        if z is None:
            z = torch.zeros(max(self._key_table_len(dataset), 1),
                            dtype=torch.float32, device=self.device)
            _keep(dataset, key, z)
        return z

    @staticmethod
    def _host_keys(dataset: RandomEffectDataset, shard_dim: int):
        """``(sorted keys, order)`` of the dataset's key table: the keys of
        every bucket's kept slots in bucket order, and the stable order
        that sorts them. They depend on the dataset alone (cached)."""
        key = ("hostkeys", shard_dim)
        hk = dataset._device_cache.get(key)
        if hk is None:
            parts = [_bucket_keys(b, shard_dim) for b in dataset.buckets]
            keys = np.concatenate(parts) if parts else np.zeros(0, np.int64)
            order = np.argsort(keys, kind="stable")
            hk = (keys[order], order)
            _keep(dataset, key, hk)
        return hk

    def _order_device(self, dataset: RandomEffectDataset,
                      shard_dim: int) -> torch.Tensor:
        """The key order on the solver's device (cached as the JAX
        package's ``("order",)``): the keys are distinct (entity, feature)
        pairs in entity-major order, so every key modulus above the
        features sorts them alike."""
        key = ("order", str(self.device))
        order = dataset._device_cache.get(key)
        if order is None:
            order = torch.as_tensor(self._host_keys(dataset, shard_dim)[1],
                                    device=self.device)
            _keep(dataset, key, order)
        return order

    # --- the background build (the JAX package's warm compile) ------------

    def _warm_compile(self, dataset: RandomEffectDataset,
                      dim: Optional[int] = None) -> None:
        """Build what every :meth:`train` of a fused-eligible dataset
        reuses: the bucket statics (rebuilt on the device from the index
        maps, each with its ``nonzero`` sync, or uploaded from host fills
        on a mesh), the compact index uploads, the zero warm joins, the
        coefficient indices and the key order on the host and on the
        device. The JAX package compiles its sweep program at this point;
        the port has no program to compile, so this is all that runs. The
        estimator runs it on a thread of its own from :meth:`GameEstimator.
        prepare`, so it overlaps the fixed-effect stage; :meth:`train`
        joins that thread first (:meth:`_join_warm`)."""
        if not self._fused_eligible(dataset):
            return
        shard_dim = dim if dim is not None else _shard_dim(dataset)
        for i, bucket in enumerate(dataset.buckets):
            for dev, lo, n_lanes in self._slices(bucket.tensor_shape[0]):
                self._statics(dataset, i, bucket, dev, lo, n_lanes)
                self._warm_ctx(dataset, i, bucket, None, shard_dim, dev, lo,
                               n_lanes)
            self._coef_idx(dataset, i, bucket)
        self._zero_coeffs(dataset)
        self._order_device(dataset, shard_dim)

    @staticmethod
    def _join_warm(dataset: RandomEffectDataset) -> None:
        """Wait for the background build of :meth:`_warm_compile` started
        by :meth:`GameEstimator.prepare`, before any cache read."""
        th = getattr(dataset, "_warm_thread", None)
        if th is not None and th is not threading.current_thread():
            th.join()


_sweep_fused_profiled = profiling.profile_fn(RandomEffectSolver._sweep_fused,
                                             "game.re.sweep_fused")


def _keep(dataset: RandomEffectDataset, key, value) -> None:
    """Cache ``value`` on ``dataset`` under ``key``, unless the dataset
    streams: a streaming dataset keeps nothing from one sweep to the next."""
    if dataset.config.cache_device_buckets:
        dataset._device_cache[key] = value


def _usable_warm(warm: Optional[RandomEffectModel], shard_dim: int,
                 projector) -> bool:
    """Whether ``warm`` can seed a sweep in this key space: keys of the
    same width, projected exactly when the dataset is."""
    return (warm is not None and len(warm.keys) > 0 and warm.dim == shard_dim
            and (warm.projector is None) == (projector is None))


def _warm_gather(table: torch.Tensor, pos: torch.Tensor,
                 found: torch.Tensor) -> torch.Tensor:
    """Warm-start lanes gathered from a coefficient table: the coefficient
    at ``pos`` where ``found``, else 0."""
    return torch.where(found, table[pos], 0.0).to(torch.float32)


def _lane_slice(a: np.ndarray, lo: int, n_lanes: int, fill) -> np.ndarray:
    """Rows ``[lo, lo + n_lanes)`` of ``a``, padded with ``fill`` past its
    end."""
    part = a[lo:lo + n_lanes]
    if part.shape[0] < n_lanes:
        part = np.concatenate([part, np.full(
            (n_lanes - part.shape[0],) + a.shape[1:], fill, a.dtype)])
    return part


def _host_tables(payload: torch.Tensor, buckets, want_var: bool,
                 order: np.ndarray):
    """The thunk that turns a sweep's flat payload (every bucket's ``(E,
    D)`` coefficients, then their variances) into the model's sorted host
    tables ``(coeffs, variances)``. It copies the payload, or takes the
    host copy it is given (:meth:`GameModel.materialize`'s share of one
    transfer); ``device_payload`` is the payload."""
    def host_tables(injected=None):
        flat = (payload.cpu().numpy() if injected is None
                else np.asarray(injected))
        coeffs, variances = [], []
        at = 0
        at_var = sum(b.tensor_shape[0] * b.tensor_shape[2] for b in buckets)
        for b in buckets:
            e, _, d = b.tensor_shape
            fmask = b.feature_index >= 0
            coeffs.append(flat[at:at + e * d].reshape(e, d)[fmask])
            at += e * d
            if want_var:
                variances.append(
                    flat[at_var:at_var + e * d].reshape(e, d)[fmask])
                at_var += e * d
        c = (np.concatenate(coeffs).astype(np.float32) if coeffs
             else np.zeros(0, np.float32))
        var = (np.concatenate(variances).astype(np.float32)[order]
               if want_var and variances else None)
        return c[order], var

    host_tables.device_payload = payload
    return host_tables


def _materialize_fat(shard_x: torch.Tensor, labels_g: torch.Tensor,
                     weights_g: torch.Tensor, perm: torch.Tensor,
                     counts: torch.Tensor, fi: torch.Tensor, *, S: int,
                     identity_cols: bool = False):
    """A bucket's statics built on the device from its compact index maps:
    ``(x, labels, weights, gather_idx, slots, rows)``, the tensors
    :meth:`RandomEffectSolver._statics_host` uploads, gathered from the
    shared dense image ``shard_x`` (already in the design dtype) and the
    data's labels and weights. The padded ``(E, S)`` row index comes from
    ``perm`` and ``counts``; padding reads 0 (a where, not a product, so
    no -0.0). ``identity_cols`` (every entity's feature map is
    ``arange(dim)``) turns the element gather into a row gather."""
    e = int(counts.shape[0])
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(S, device=counts.device)
    valid = slot[None, :] < counts[:, None]
    if perm.numel():
        pos = (starts[:, None] + slot[None, :]).clamp(max=perm.numel() - 1)
        idx = torch.where(valid, perm[pos], -1)
    else:  # a bucket of only zero-row entities
        idx = torch.full((e, S), -1, dtype=torch.int64, device=counts.device)
    clip = idx.clamp(min=0)
    rmask = idx >= 0
    zero = torch.zeros((), dtype=shard_x.dtype, device=shard_x.device)
    if identity_cols:
        x = torch.where(rmask[:, :, None], shard_x[clip], zero)
    else:
        keep = rmask[:, :, None] & (fi >= 0)[:, None, :]
        x = torch.where(keep, shard_x[clip[:, :, None],
                                      fi.clamp(min=0)[:, None, :]], zero)
    labels = torch.where(rmask, labels_g[clip], 0.0)
    weights = torch.where(rmask, weights_g[clip], 0.0)
    slots = torch.nonzero(rmask.reshape(-1)).reshape(-1)
    return x, labels, weights, clip, slots, idx.reshape(-1)[slots]


def _lane_margins(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(E, S)`` margins of an ``(E, S, D)`` bucket at ``(E, D)`` lanes,
    accumulated in at least f32: a product and a sum over each row's D
    terms, whose bits do not depend on how many lanes the call holds (a
    batched matrix product picks its algorithm by the batch), so a lane's
    scores are the same in a slice and in the whole bucket."""
    acc = accumulation_dtype(x.dtype)
    return (x.to(acc) * w.to(acc)[:, None, :]).sum(-1)


def _shard_dim(dataset: RandomEffectDataset) -> int:
    top = 0
    for b in dataset.buckets:
        if b.feature_index.size:
            top = max(top, int(b.feature_index.max()) + 1)
    return top
