"""Down-sampling for fixed-effect training data.

Re-design of the reference's samplers
(``photon-api/.../sampling/{DownSampler, BinaryClassificationDownSampler,
DefaultDownSampler}.scala``): the reference materializes a down-sampled RDD
per CD iteration; here sampling is a fresh per-sweep weight vector — rows
dropped get weight 0 (exactly absent from the objective), kept rows are
re-weighted by ``1/rate`` so the objective stays an unbiased estimate.

A copy of ``photon_ml_tpu/sampling.py`` over the port's
``util.hash_uniform``: both packages keep the same rows for the same seed
and sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from photon_ml_tpu_torch.util import hash_uniform


def _sweep_uniform(uids: np.ndarray, seed: int, sweep: int) -> np.ndarray:
    """Per-row uniform draw keyed by (seed, sweep, global row id) — a pure
    per-row function, so the kept set is identical under any row partition
    (the property multi-process training's sp==mp equality rests on)."""
    return hash_uniform(
        np.maximum(np.asarray(uids, np.int64), 0),
        seed ^ ((sweep + 1) * 0x5851F42D4C957F2D) & 0x7FFFFFFFFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class DownSampler:
    """Uniform down-sampler (reference ``DefaultDownSampler``)."""

    rate: float
    seed: int = 20260729

    def __post_init__(self):
        if not 0.0 < self.rate < 1.0:
            raise ValueError(f"down-sampling rate must be in (0, 1): {self.rate}")

    def _keep(self, labels: np.ndarray, sweep: int,
              uids: Optional[np.ndarray]) -> np.ndarray:
        """``sweep`` must vary per CD iteration so each sweep draws a fresh
        sample (the reference creates a new sampled RDD per iteration).
        With ``uids`` (global row ids, same shape as ``labels``; negatives
        = padding) the draw is the counter-based per-row hash — identical
        under any row partition; without, a sequential rng stream over the
        batch shape (direct API use)."""
        if uids is not None:
            return _sweep_uniform(uids, self.seed, sweep) < self.rate
        rng = np.random.default_rng((self.seed, sweep))
        # size=shape (not shape[0]): the sharded fixed-effect path hands in
        # the stacked (n_shards, per) layout
        return rng.uniform(size=labels.shape) < self.rate

    def downsample(self, labels: np.ndarray, weights: np.ndarray,
                   sweep: int = 0,
                   uids: Optional[np.ndarray] = None) -> np.ndarray:
        keep = self._keep(labels, sweep, uids)
        return np.where(keep, weights / self.rate, 0.0).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class BinaryClassificationDownSampler(DownSampler):
    """Negative-class down-sampler for dominant-negative binary data
    (reference ``BinaryClassificationDownSampler``): positives always kept;
    negatives kept with probability ``rate`` and re-weighted ``1/rate``."""

    def downsample(self, labels: np.ndarray, weights: np.ndarray,
                   sweep: int = 0,
                   uids: Optional[np.ndarray] = None) -> np.ndarray:
        pos = labels > 0.5
        keep_neg = self._keep(labels, sweep, uids)
        out = np.where(pos, weights,
                       np.where(keep_neg, weights / self.rate, 0.0))
        return out.astype(np.float32)
