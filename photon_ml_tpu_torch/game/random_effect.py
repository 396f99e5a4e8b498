"""Random-effect training: batched per-entity solves over fixed-shape buckets.

Counterpart of ``photon_ml_tpu/game/random_effect.py``. Every size bucket is
one batched L-BFGS or TRON solve whose lanes are the bucket's entities
(TRON's Hessian-vector products take the closed form over the bucket);
each objective evaluation is one launch of the entity kernel
(:mod:`~photon_ml_tpu_torch.ops.fused_re`) over the whole ``(E, S, D)``
bucket. The sweep is a plain loop over buckets — the JAX package's fused
whole-sweep program (``_sweep_fused``) has no counterpart yet.

Padding is inert: padded sample rows carry weight 0, padded feature columns
are all-zero, so with a zero start their coefficients stay exactly 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.data import (
    RandomEffectDataset,
    REBucket,
    design_dtype_of,
)
from photon_ml_tpu_torch.game.model import RandomEffectModel
from photon_ml_tpu_torch.glm.problem import (
    GLMOptimizationConfiguration,
    OptimizationProblem,
)
from photon_ml_tpu_torch.ops.design import DenseDesign
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective
from photon_ml_tpu_torch.types import TaskType


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
    caller passes ``device="cpu"``)."""

    task: TaskType
    config: GLMOptimizationConfiguration
    design_dtype: str = "float32"
    device: Optional[torch.device] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        # per-iteration traces would be carried for every entity lane
        if self.config.optimizer_config.track_states:
            object.__setattr__(self, "config", dataclasses.replace(
                self.config, optimizer_config=dataclasses.replace(
                    self.config.optimizer_config, track_states=False)))

    def _problem(self) -> OptimizationProblem:
        return OptimizationProblem(GLMObjective(loss=loss_for_task(self.task)),
                                   self.config)

    def _statics(self, dataset: RandomEffectDataset, i: int,
                 bucket: REBucket) -> _BucketStatics:
        key = ("bucket", i, self.design_dtype, str(self.device))
        st = dataset._device_cache.get(key)
        if st is None:
            dev = self.device
            si = bucket.sample_idx
            live = si >= 0
            st = _BucketStatics(
                x=torch.as_tensor(bucket.x, device=dev).to(
                    design_dtype_of(self.design_dtype)),
                labels=torch.as_tensor(bucket.labels, device=dev),
                weights=torch.as_tensor(bucket.weights, device=dev),
                gather_idx=torch.as_tensor(np.maximum(si, 0), device=dev),
                slots=torch.as_tensor(np.flatnonzero(live), device=dev),
                rows=torch.as_tensor(si[live], device=dev))
            dataset._device_cache[key] = st
        return st

    def train(self, dataset: RandomEffectDataset, offsets: torch.Tensor,
              lam: float, warm_start: Optional[RandomEffectModel] = None,
              dim: Optional[int] = None
              ) -> tuple[RandomEffectModel, torch.Tensor]:
        """Train every bucket against the residual ``offsets`` (a device
        vector over all samples). Returns the model and a device vector of
        this coordinate's margin on every active sample (0 elsewhere)."""
        cfg = dataset.config
        shard_dim = dim if dim is not None else _shard_dim(dataset)
        problem = self._problem()
        scores = torch.zeros_like(offsets, dtype=torch.float32)
        solved = []
        for i, bucket in enumerate(dataset.buckets):
            st = self._statics(dataset, i, bucket)
            live = st.weights > 0
            boff = torch.where(live, offsets[st.gather_idx],
                               torch.zeros_like(st.weights))
            w0 = torch.as_tensor(_gather_warm_start(bucket, warm_start,
                                                    shard_dim),
                                 device=self.device)
            data = GLMData(design=DenseDesign(x=st.x), labels=st.labels,
                           offsets=boff, weights=st.weights)
            e, s, d = bucket.tensor_shape
            # a profiler range per bucket solve: device time by bucket shape
            with torch.profiler.record_function(f"re.bucket[{e}x{s}x{d}]"):
                w = problem.run(data, w0, lam).w
            margins = DenseDesign(x=st.x).matvec(w)  # (E, S) f32
            scores[st.rows] = margins.reshape(-1)[st.slots]
            solved.append(w.reshape(-1))
        keys, coeffs = [], []
        if solved:
            flat = torch.cat(solved).cpu().numpy()  # one device-to-host copy
            at = 0
            for bucket in dataset.buckets:
                e, _, d = bucket.tensor_shape
                w_np = flat[at:at + e * d].reshape(e, d)
                at += e * d
                keys.append(_bucket_keys(bucket, shard_dim))
                coeffs.append(w_np[bucket.feature_index >= 0])
        keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
        coeffs = (np.concatenate(coeffs).astype(np.float32) if coeffs
                  else np.zeros(0, np.float32))
        order = np.argsort(keys, kind="stable")
        model = RandomEffectModel(
            random_effect_type=cfg.random_effect_type,
            feature_shard_id=cfg.feature_shard_id, task=self.task,
            dim=shard_dim, keys=keys[order], coeffs=coeffs[order])
        return model, scores


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
