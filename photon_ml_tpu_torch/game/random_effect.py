"""Random-effect training: batched per-entity solves over fixed-shape buckets.

Counterpart of ``photon_ml_tpu/game/random_effect.py``. Every size bucket is
one batched L-BFGS, OWL-QN (an L1 part) or TRON solve whose lanes are the
bucket's entities, each lane with its own convergence (TRON's
Hessian-vector products take the closed form over the bucket); each
objective evaluation is one launch of the entity kernel
(:mod:`~photon_ml_tpu_torch.ops.fused_re`) over the whole ``(E, S, D)``
bucket, a RANDOM-projected ``(E, S, P)`` bucket included. Variances, when
configured, are computed per bucket at the solution and kept on the real
``(entity, feature)`` slots. The sweep is a plain loop over buckets — the
JAX package's fused whole-sweep program (``_sweep_fused``) has no
counterpart yet. A resident bucket of an INDEX_MAP dataset is rebuilt on
the device, once, by gathers through its index maps into the dense image
of its shard (:func:`_materialize_fat`), so its host fill is never made;
a projected, streaming or mesh dataset uploads its host fill instead. A
streaming dataset (``cache_device_buckets=False``) uploads each bucket
for its solve and drops it. Each bucket solve is
profiled as ``game.re.solve_bucket``
(:mod:`~photon_ml_tpu_torch.telemetry.profiling`); the JAX package's
``game.re.sweep_fused`` label has no counterpart.

Entity parallelism (the reference's ``RandomEffectDatasetPartitioner``):
with a mesh that has an ``"entity"`` axis, each bucket's lanes are padded
to the product of every mesh axis (entity last, the JAX package's
``_lane_axes``) with zero-data lanes and cut into contiguous slices, one a
slot; each slice is a batched solve of its own on its slot (kernel 2 over
the slice), and the scores and coefficients go back in lane order. The
slices are solved in turn. The batched optimizers freeze each lane on its
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
from photon_ml_tpu_torch.game.model import RandomEffectModel
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
        object.__setattr__(self, "device", resolve_device(self.device))
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
            part = a[lo:lo + n_lanes]
            if part.shape[0] < n_lanes:
                part = np.concatenate([part, np.full(
                    (n_lanes - part.shape[0],) + a.shape[1:], fill,
                    a.dtype)])
            return part

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

    def train(self, dataset: RandomEffectDataset, offsets: torch.Tensor,
              lam: float, warm_start: Optional[RandomEffectModel] = None,
              dim: Optional[int] = None
              ) -> tuple[RandomEffectModel, torch.Tensor]:
        """Train every bucket against the residual ``offsets`` (a device
        vector over all samples). Returns the model and a device vector of
        this coordinate's margin on every active sample (0 elsewhere). A
        RANDOM-projected dataset trains a model keyed in the projected
        space."""
        cfg = dataset.config
        if dataset.projector is not None:
            shard_dim = dataset.projector.projected_dim
        else:
            shard_dim = dim if dim is not None else _shard_dim(dataset)
        want_var = (self.config.variance_type
                    != VarianceComputationType.NONE)
        scores = torch.zeros_like(offsets, dtype=torch.float32)
        solved, solved_var = [], []
        for i, bucket in enumerate(dataset.buckets):
            e, s, d = bucket.tensor_shape
            warm = _gather_warm_start(bucket, warm_start, shard_dim)
            problem = self._problem(None if self.mesh is None else e)
            ws, vs = [], []
            for dev, lo, n_lanes in self._slices(e):
                st = self._statics(dataset, i, bucket, dev, lo, n_lanes)
                w0 = np.zeros((n_lanes, d), np.float32)
                w0[:max(0, min(n_lanes, e - lo))] = warm[lo:lo + n_lanes]
                with on_slot(dev):
                    live = st.weights > 0
                    boff = torch.where(live, offsets.to(dev)[st.gather_idx],
                                       torch.zeros_like(st.weights))
                    data = GLMData(design=DenseDesign(x=st.x),
                                   labels=st.labels, offsets=boff,
                                   weights=st.weights)
                    # a profiler range per bucket solve: device time by
                    # bucket shape
                    with torch.profiler.record_function(
                            f"re.bucket[{n_lanes}x{s}x{d}]"):
                        w, var = _bucket_solve_profiled(
                            problem, data, torch.as_tensor(w0, device=dev),
                            lam, want_var)
                    margins = _lane_margins(st.x, w)  # (E, S) f32
                scores[st.rows.to(scores.device)] = \
                    margins.reshape(-1)[st.slots].to(scores.device)
                ws.append(w.to(self.device))
                if want_var:
                    vs.append(var.reshape(n_lanes, d).to(self.device))
            # back in lane order, the padding lanes dropped
            solved.append(torch.cat(ws)[:e].reshape(-1))
            if want_var:
                solved_var.append(torch.cat(vs)[:e].reshape(-1))
        keys, coeffs, variances = [], [], []
        if solved:
            # one device-to-host copy of every coefficient and variance
            flat = torch.cat(solved + solved_var).cpu().numpy()
            at, at_var = 0, sum(int(w.numel()) for w in solved)
            for bucket in dataset.buckets:
                e, _, d = bucket.tensor_shape
                fmask = bucket.feature_index >= 0
                keys.append(_bucket_keys(bucket, shard_dim))
                coeffs.append(flat[at:at + e * d].reshape(e, d)[fmask])
                at += e * d
                if want_var:
                    variances.append(
                        flat[at_var:at_var + e * d].reshape(e, d)[fmask])
                    at_var += e * d
        keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
        coeffs = (np.concatenate(coeffs).astype(np.float32) if coeffs
                  else np.zeros(0, np.float32))
        order = np.argsort(keys, kind="stable")
        var = None
        if want_var and variances:
            var = np.concatenate(variances).astype(np.float32)[order]
        model = RandomEffectModel(
            random_effect_type=cfg.random_effect_type,
            feature_shard_id=cfg.feature_shard_id, task=self.task,
            dim=shard_dim, keys=keys[order], coeffs=coeffs[order],
            variances=var, projector=dataset.projector)
        return model, scores


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


def _gather_warm_start(bucket: REBucket, warm: Optional[RandomEffectModel],
                       shard_dim: int) -> np.ndarray:
    """Previous sweep's coefficients for each (entity, local feature) slot."""
    w0 = np.zeros(bucket.feature_index.shape, np.float32)
    if warm is None or not len(warm.keys) or warm.dim != shard_dim:
        return w0
    fmask = bucket.feature_index >= 0
    ent = np.broadcast_to(bucket.entity_ids[:, None],
                          bucket.feature_index.shape)
    w0[fmask] = warm.lookup(ent[fmask], bucket.feature_index[fmask])
    return w0
