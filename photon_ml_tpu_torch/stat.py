"""Per-feature summary statistics (counterpart of ``photon_ml_tpu/stat.py``,
the reference's ``FeatureDataStatistics``): mean, variance, min, max, max
magnitude and nonzero count of every feature column, computed in one
vectorized numpy pass over a CSR shard with the implicit zeros counted.
They feed the normalization contexts and the summarization output file;
:meth:`FeatureDataStatistics.allreduce` combines a multi-process job's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from photon_ml_tpu_torch.game.data import FeatureShard


@dataclasses.dataclass(frozen=True)
class FeatureDataStatistics:
    mean: np.ndarray
    variance: np.ndarray
    min: np.ndarray
    max: np.ndarray
    max_magnitude: np.ndarray
    num_nonzeros: np.ndarray
    count: int

    @staticmethod
    def from_shard(shard: FeatureShard) -> "FeatureDataStatistics":
        d = shard.dim
        n = shard.n_samples
        cols = shard.cols.astype(np.int64)
        vals = shard.vals.astype(np.float64)
        nnz = np.bincount(cols, minlength=d).astype(np.int64)
        s1 = np.bincount(cols, weights=vals, minlength=d)
        s2 = np.bincount(cols, weights=vals * vals, minlength=d)
        mean = s1 / max(n, 1)
        # the unbiased variance over all n rows, implicit zeros included
        denom = max(n - 1, 1)
        variance = np.maximum((s2 - n * mean * mean) / denom, 0.0)

        vmin = np.zeros(d)
        vmax = np.zeros(d)
        np.minimum.at(vmin, cols, vals)
        np.maximum.at(vmax, cols, vals)
        # a column stored in every row has no implicit zero: its min and max
        # come from the stored values alone
        full = nnz >= n
        if full.any():
            explicit_min = np.full(d, np.inf)
            explicit_max = np.full(d, -np.inf)
            np.minimum.at(explicit_min, cols, vals)
            np.maximum.at(explicit_max, cols, vals)
            vmin[full] = explicit_min[full]
            vmax[full] = explicit_max[full]
        max_magnitude = np.maximum(np.abs(vmin), np.abs(vmax))
        return FeatureDataStatistics(
            mean=mean, variance=variance, min=vmin, max=vmax,
            max_magnitude=max_magnitude, num_nonzeros=nnz, count=n)

    def allreduce(self) -> "FeatureDataStatistics":
        """The global statistics of a multi-process job from each process's
        own (the identity in one process), so every process builds the
        same normalization. Means and variances recombine through the
        moment sums (s1, s2); min, max and nonzero counts reduce directly,
        over the host collectives of
        :mod:`photon_ml_tpu_torch.parallel.multihost`."""
        from photon_ml_tpu_torch.parallel.multihost import (
            allreduce_max,
            allreduce_sum,
            process_count,
        )

        if process_count() == 1:
            return self
        n = self.count
        s1 = self.mean * n
        s2 = self.variance * max(n - 1, 1) + n * np.square(self.mean)
        n_g = int(allreduce_sum(np.array([n], np.int64))[0])
        s1_g = allreduce_sum(s1)
        s2_g = allreduce_sum(s2)
        mean = s1_g / max(n_g, 1)
        variance = np.maximum(
            (s2_g - n_g * np.square(mean)) / max(n_g - 1, 1), 0.0)
        vmin = -allreduce_max(-self.min)
        vmax = allreduce_max(self.max)
        return FeatureDataStatistics(
            mean=mean, variance=variance, min=vmin, max=vmax,
            max_magnitude=np.maximum(np.abs(vmin), np.abs(vmax)),
            num_nonzeros=allreduce_sum(self.num_nonzeros), count=n_g)

    def to_records(self, names: list[str]):
        """FeatureSummarizationResultAvro-shaped records."""
        from photon_ml_tpu_torch.io.model_io import _split_key

        for i, key in enumerate(names):
            name, term = _split_key(key)
            yield {
                "featureName": name,
                "featureTerm": term,
                "metrics": {
                    "mean": float(self.mean[i]),
                    "variance": float(self.variance[i]),
                    "min": float(self.min[i]),
                    "max": float(self.max[i]),
                    "maxMagnitude": float(self.max_magnitude[i]),
                    "numNonzeros": float(self.num_nonzeros[i]),
                    "count": float(self.count),
                },
            }
