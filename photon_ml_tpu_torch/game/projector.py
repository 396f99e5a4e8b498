"""Random-effect feature-space projectors (counterpart of
``photon_ml_tpu/game/projector.py``).

- **INDEX_MAP**: each entity's observed shard features, compact-indexed;
  built inside the bucket build in :mod:`photon_ml_tpu_torch.game.data`
  (a bucket's ``feature_index`` is the map).
- **RANDOM**: one shared Gaussian Johnson–Lindenstrauss matrix ``P``
  (``projected_dim × shard_dim``) projects every entity's features into a
  common low-dimensional space. Training runs on ``z = P x``; since margins
  are linear, the learned ``v`` equals the shard-space coefficients
  ``w = Pᵀ v``, which is how a model is exported
  (:meth:`~photon_ml_tpu_torch.game.model.RandomEffectModel.to_shard_space`).

:class:`RandomProjector` is host numpy, a copy of the JAX package's: the
same seed gives the same matrix, bit for bit.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class ProjectorType(str, enum.Enum):
    """Reference ``projector/ProjectorType.scala``."""

    INDEX_MAP = "INDEX_MAP"
    RANDOM = "RANDOM"


@dataclasses.dataclass(frozen=True)
class RandomProjector:
    """Shared Gaussian projection ``P`` with JL scaling
    1/sqrt(projected_dim); one matrix serves every entity of the
    coordinate."""

    matrix: np.ndarray  # (projected_dim, shard_dim) float32

    @property
    def projected_dim(self) -> int:
        return int(self.matrix.shape[0])

    @property
    def shard_dim(self) -> int:
        return int(self.matrix.shape[1])

    @staticmethod
    def build(shard_dim: int, projected_dim: int,
              seed: int) -> "RandomProjector":
        if projected_dim <= 0 or projected_dim > shard_dim:
            raise ValueError(
                f"projected_dim must be in [1, shard_dim={shard_dim}], "
                f"got {projected_dim}")
        rng = np.random.default_rng(seed)
        m = rng.normal(size=(projected_dim, shard_dim)).astype(np.float32)
        m /= np.float32(np.sqrt(projected_dim))
        return RandomProjector(matrix=m)

    def project_rows(self, cols: np.ndarray, vals: np.ndarray,
                     rows: np.ndarray, n_rows: int) -> np.ndarray:
        """Dense projected features ``Z = X Pᵀ`` from the CSR triplets of
        the rows being projected (rows numbered 0..n_rows-1): one
        scatter-accumulated pass, no shard-wide dense intermediate."""
        z = np.zeros((n_rows, self.projected_dim), np.float32)
        if len(cols):
            contrib = vals[:, None].astype(np.float32) * self.matrix.T[cols]
            np.add.at(z, rows, contrib)
        return z

    def project_back(self, v: np.ndarray) -> np.ndarray:
        """Shard-space coefficients ``w = Pᵀ v`` (exact for scoring:
        ``w·x = v·Px``), over ``(..., projected_dim)`` batches."""
        return np.asarray(v, np.float32) @ self.matrix

    def project_back_variances(self, var: np.ndarray) -> np.ndarray:
        """Approximate shard-space variances ``var_w = (P²)ᵀ var_v`` (exact
        under an independent-coordinate posterior)."""
        return np.asarray(var, np.float32) @ (self.matrix ** 2)
