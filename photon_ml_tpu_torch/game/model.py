"""GAME model layer: fixed-effect, random-effect, and composite GAME models.

Counterpart of ``photon_ml_tpu/game/model.py``. A ``GameModel`` is an
ordered map coordinateId → per-coordinate model; a sample's total score is
its offset plus the sum of the coordinate scores. The fixed effect is one
coefficient vector; a random-effect model is a flat, key-sorted
``(entity, feature) → coefficient`` table in host numpy, so scoring any
dataset is one searchsorted join.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Global coefficients for one fixed-effect coordinate."""

    model: GeneralizedLinearModel
    feature_shard_id: str

    def score(self, data: GameData) -> np.ndarray:
        """Raw margins w·x per sample (no offset), accumulated in f64."""
        shard = data.shards[self.feature_shard_id]
        w = self.model.coefficients.means.detach().cpu().double().numpy()
        out = np.zeros(data.n_samples, np.float64)
        np.add.at(out, shard.rows(),
                  shard.vals.astype(np.float64) * w[shard.cols])
        return out.astype(np.float32)


def sum_coordinate_margins(offsets, margins) -> np.ndarray:
    """The GAME score-summation contract: ``f32(f64(offset) + Σ f64(mᵢ))``
    accumulated in coordinate order."""
    total = np.asarray(offsets).astype(np.float64)
    for m in margins:
        total = total + np.asarray(m).astype(np.float64)
    return total.astype(np.float32)


def key_join(keys: np.ndarray, dim: int, entity_ids: np.ndarray,
             feature_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-table join for (entity, feature) pairs: ``(pos, found)``;
    ``found`` is False for negative ids and absent pairs, ``pos`` is always
    in range."""
    valid = (np.asarray(entity_ids) >= 0) & (np.asarray(feature_ids) >= 0)
    q = (np.maximum(entity_ids, 0).astype(np.int64) * np.int64(dim)
         + np.maximum(feature_ids, 0).astype(np.int64))
    pos = np.searchsorted(keys, q)
    pos = np.minimum(pos, max(len(keys) - 1, 0))
    found = (valid & (keys[pos] == q) if len(keys)
             else np.zeros(q.shape, bool))
    return pos, found


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity coefficient table for one random-effect coordinate:
    ``keys`` are ``entity_id * dim + feature_id`` (int64, sorted),
    ``coeffs`` the matching f32 coefficients; entities absent from the
    table score 0."""

    random_effect_type: str
    feature_shard_id: str
    task: TaskType
    dim: int  # key modulus: the shard's vocabulary size
    keys: np.ndarray
    coeffs: np.ndarray

    def lookup(self, entity_ids: np.ndarray,
               feature_ids: np.ndarray) -> np.ndarray:
        """Coefficient for each (entity, feature) pair; 0 where absent."""
        pos, found = key_join(self.keys, self.dim, entity_ids, feature_ids)
        out = np.zeros(found.shape, np.float32)
        out[found] = self.coeffs[pos[found]]
        return out

    def score(self, data: GameData,
              sample_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """Margins ``Σ_j x_j·w[entity, j]`` per sample (only the rows of
        ``sample_idx``, in that order, when given)."""
        shard = data.shards[self.feature_shard_id]
        entities = data.id_columns[self.random_effect_type]
        if sample_idx is not None:
            shard = shard.take(sample_idx)
            entities = entities[sample_idx]
        rows = shard.rows()
        ent_per_nnz = entities[rows]
        valid = ent_per_nnz >= 0
        w = np.zeros(shard.nnz, np.float32)
        if valid.any():
            w[valid] = self.lookup(ent_per_nnz[valid], shard.cols[valid])
        out = np.zeros(shard.n_samples, np.float64)
        np.add.at(out, rows, shard.vals.astype(np.float64) * w)
        return out.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Ordered coordinateId → model map (reference ``GameModel.scala``)."""

    coordinates: Mapping[str, FixedEffectModel | RandomEffectModel]
    task: TaskType

    def score(self, data: GameData) -> np.ndarray:
        """Total margin per sample: offsets + sum of coordinate scores."""
        return sum_coordinate_margins(
            data.offsets, (m.score(data) for m in self.coordinates.values()))

    def score_by_coordinate(self, data: GameData) -> dict[str, np.ndarray]:
        return {cid: m.score(data) for cid, m in self.coordinates.items()}
