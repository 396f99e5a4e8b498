"""GAME model layer: fixed-effect, random-effect, and composite GAME models.

Counterpart of ``photon_ml_tpu/game/model.py``. A ``GameModel`` is an
ordered map coordinateId → per-coordinate model; a sample's total score is
its offset plus the sum of the coordinate scores. The fixed effect is one
coefficient vector; a random-effect model is a flat, key-sorted
``(entity, feature) → coefficient`` table in host numpy, so scoring any
dataset is one searchsorted join. A model trained under the RANDOM
projector keeps its table in the projected space and scores by projecting
features first; :meth:`RandomEffectModel.to_shard_space` exports it.

A trained random-effect table may stay on the device until it is first
read: the solver installs a thunk that carries the flat device payload
(``device_payload``) in place of ``coeffs``/``variances``, and the first
access copies it to the host, once, under one lock.
:meth:`GameModel.materialize` copies every pending table and every
fixed-effect tensor of a model in one transfer; :meth:`GameModel.
device_wait` waits for the device work behind them without copying them.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import FeatureShard, GameData
from photon_ml_tpu_torch.game.projector import RandomProjector
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.util import materialize_thunk

#: guards the deferred tables' materialization (a model's first access,
#: :meth:`GameModel.materialize`), which may run on the background saver's
#: threads; it is rare, so one lock serves every model
_THUNK_LOCK = threading.Lock()


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


def sum_coordinate_margins(offsets, margins):
    """The GAME score-summation contract: ``f32(f64(offset) + Σ f64(mᵢ))``
    accumulated in coordinate order, in numpy, or in torch where
    ``offsets`` is a tensor (the serving and ranking programs; the margins
    then broadcast against the offsets, e.g. ``(b, 1)`` user terms and
    ``(b, items)`` item terms)."""
    if isinstance(offsets, torch.Tensor):
        total = offsets.to(torch.float64)
        for m in margins:
            total = total + m.to(torch.float64)
        return total.to(torch.float32)
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
    ``coeffs`` the matching f32 coefficients and ``variances`` (optional)
    theirs; entities absent from the table score 0.

    With a ``projector`` the table lives in the projected space: ``dim`` is
    the projected dim and scoring projects shard features through the
    shared matrix first.

    ``coeffs`` (and ``variances`` when configured) may be a zero-argument
    thunk returning ``(coeffs, variances)``, with the flat device tensor
    it copies from as its ``device_payload``; the first access runs it
    (see the module docstring), so every reader sees numpy.
    ``coeffs_device`` holds the same values as ``coeffs`` on the device,
    where the solver left them (None for a loaded, merged or projected
    model): warm starts and passive scoring read it there."""

    random_effect_type: str
    feature_shard_id: str
    task: TaskType
    dim: int  # key modulus: the shard's vocabulary size, or projected dim
    keys: np.ndarray
    coeffs: np.ndarray
    variances: Optional[np.ndarray] = None
    projector: Optional[RandomProjector] = None
    coeffs_device: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __getattribute__(self, name):
        if name in ("coeffs", "variances"):
            val = object.__getattribute__(self, name)
            if callable(val):
                materialize_thunk(self, ("coeffs", "variances"), _THUNK_LOCK)
                return object.__getattribute__(self, name)
            return val
        return object.__getattribute__(self, name)

    def __getstate__(self):
        # a pickled model carries its host tables, not the thunk (a closure
        # over device tensors) nor the device table
        state = dict(object.__getattribute__(self, "__dict__"))
        state["coeffs"], state["variances"] = self.coeffs, self.variances
        state["coeffs_device"] = None
        return state

    @property
    def pending(self):
        """The deferred table's thunk, or None once it is on the host."""
        val = object.__getattribute__(self, "coeffs")
        return val if callable(val) else None

    @property
    def n_entities(self) -> int:
        return (int(np.unique(self.keys // self.dim).shape[0])
                if len(self.keys) else 0)

    def lookup(self, entity_ids: np.ndarray,
               feature_ids: np.ndarray) -> np.ndarray:
        """Coefficient for each (entity, feature) pair; 0 where absent."""
        pos, found = key_join(self.keys, self.dim, entity_ids, feature_ids)
        out = np.zeros(found.shape, np.float32)
        out[found] = self.coeffs[pos[found]]
        return out

    def merge(self, update: "RandomEffectModel",
              drop_entities: Sequence[int] = ()) -> "RandomEffectModel":
        """Entity-level patch merge: entities present in ``update`` (or
        listed in ``drop_entities``) have their rows replaced by (resp.
        dropped in favour of) the update's; every other entity's rows carry
        forward bit-identically. Both models live in one key space (same
        ``dim``, same dense entity ids, no projector). Variances survive
        only when both sides carry them."""
        if update.random_effect_type != self.random_effect_type:
            raise ValueError(
                f"merge across random-effect types "
                f"{self.random_effect_type!r} != {update.random_effect_type!r}")
        if update.dim != self.dim:
            raise ValueError(f"merge across dims {self.dim} != {update.dim}")
        if self.projector is not None or update.projector is not None:
            raise ValueError("merge expects shard-space models "
                             "(call to_shard_space() first)")
        upd_entities = (np.unique(update.keys // self.dim)
                        if len(update.keys) else np.zeros(0, np.int64))
        drop = np.union1d(np.asarray(list(drop_entities), np.int64),
                          upd_entities)
        keep = (~np.isin(self.keys // self.dim, drop) if len(self.keys)
                else np.zeros(0, bool))
        keys = np.concatenate([self.keys[keep], update.keys])
        coeffs = np.concatenate([
            np.asarray(self.coeffs, np.float32)[keep],
            np.asarray(update.coeffs, np.float32)])
        variances = None
        if self.variances is not None and update.variances is not None:
            variances = np.concatenate([
                np.asarray(self.variances, np.float32)[keep],
                np.asarray(update.variances, np.float32)])
        order = np.argsort(keys, kind="stable")
        return RandomEffectModel(
            random_effect_type=self.random_effect_type,
            feature_shard_id=self.feature_shard_id, task=self.task,
            dim=self.dim, keys=keys[order], coeffs=coeffs[order],
            variances=None if variances is None else variances[order])

    def remap_entities(self, new_of_old: Mapping[int, int]
                       ) -> "RandomEffectModel":
        """The same coefficients under another dense entity-id universe
        (``old dense id → new dense id``): a patch loaded under its own
        vocabulary is remapped into the serving version's before
        :meth:`merge`. Every entity must be mapped."""
        if not len(self.keys):
            return self
        ent = self.keys // self.dim
        feat = self.keys % self.dim
        lut = np.full(int(ent.max()) + 1, -1, np.int64)
        for old, new in new_of_old.items():
            if 0 <= int(old) < len(lut):
                lut[int(old)] = int(new)
        new_ent = lut[ent]
        if (new_ent < 0).any():
            missing = np.unique(ent[new_ent < 0])[:5]
            raise KeyError(
                f"remap_entities: no mapping for dense entities "
                f"{missing.tolist()}")
        keys = new_ent * np.int64(self.dim) + feat
        order = np.argsort(keys, kind="stable")
        return dataclasses.replace(
            self, keys=keys[order],
            coeffs=np.asarray(self.coeffs, np.float32)[order],
            variances=(None if self.variances is None
                       else np.asarray(self.variances, np.float32)[order]),
            coeffs_device=None)

    def entity_rows(self, dense_ids: Sequence[int]) -> np.ndarray:
        """Dense ``(len(dense_ids), dim)`` coefficient rows of the given
        entities (0 where absent): the rows a serving table patch writes."""
        ids = np.asarray(list(dense_ids), np.int64)
        out = np.zeros((len(ids), self.dim), np.float32)
        if not len(self.keys) or not len(ids):
            return out
        ent = self.keys // self.dim
        feat = self.keys % self.dim
        pos_of = {int(e): i for i, e in enumerate(ids)}
        mask = np.isin(ent, ids)
        rows = np.fromiter((pos_of[int(e)] for e in ent[mask]), np.int64,
                           count=int(mask.sum()))
        out[rows, feat[mask]] = np.asarray(self.coeffs, np.float32)[mask]
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
        if self.projector is not None:
            return self._score_projected(shard, entities)
        rows = shard.rows()
        ent_per_nnz = entities[rows]
        valid = ent_per_nnz >= 0
        w = np.zeros(shard.nnz, np.float32)
        if valid.any():
            w[valid] = self.lookup(ent_per_nnz[valid], shard.cols[valid])
        out = np.zeros(shard.n_samples, np.float64)
        np.add.at(out, rows, shard.vals.astype(np.float64) * w)
        return out.astype(np.float32)

    def _score_projected(self, shard: FeatureShard,
                         entities: np.ndarray) -> np.ndarray:
        """Margin ``v·(Px)`` per sample: project the features into the
        shared space, then join each entity's coefficient row."""
        z = self.projector.project_rows(
            shard.cols, shard.vals, shard.rows(), shard.n_samples)
        valid = np.flatnonzero(entities >= 0)
        out = np.zeros(shard.n_samples, np.float32)
        if len(valid):
            d = self.dim
            # one coefficient row per distinct entity, gathered per sample
            uniq, inv = np.unique(entities[valid], return_inverse=True)
            ent = np.repeat(uniq, d)
            feat = np.tile(np.arange(d, dtype=np.int64), len(uniq))
            table = self.lookup(ent, feat).reshape(len(uniq), d)
            out[valid] = np.einsum("nd,nd->n", z[valid], table[inv])
        return out

    def to_shard_space(self) -> "RandomEffectModel":
        """A RANDOM-projected model back in the original feature space
        (``w = Pᵀ v``, exact for scoring since margins are linear; the
        variances as :meth:`RandomProjector.project_back_variances` maps
        them), dense per entity. A shard-space model is returned as is."""
        if self.projector is None:
            return self
        p = self.projector
        d, full = p.projected_dim, p.shard_dim
        if not len(self.keys):
            return dataclasses.replace(self, dim=full, projector=None)
        ent = np.unique(self.keys // d)
        v = np.zeros((len(ent), d), np.float32)
        pos = np.searchsorted(ent, self.keys // d)
        v[pos, self.keys % d] = self.coeffs
        w = p.project_back(v)
        keys = (ent[:, None] * np.int64(full)
                + np.arange(full, dtype=np.int64)).ravel()
        variances = None
        if self.variances is not None:
            var_v = np.zeros((len(ent), d), np.float32)
            var_v[pos, self.keys % d] = self.variances
            variances = p.project_back_variances(var_v).ravel()
        return RandomEffectModel(
            random_effect_type=self.random_effect_type,
            feature_shard_id=self.feature_shard_id, task=self.task,
            dim=full, keys=keys, coeffs=w.ravel().astype(np.float32),
            variances=variances, projector=None)


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Ordered coordinateId → model map (reference ``GameModel.scala``)."""

    coordinates: Mapping[str, FixedEffectModel | RandomEffectModel]
    task: TaskType

    def _device_tensors(self) -> list:
        """``(install, flat device tensor)`` of every table still on the
        device: each random effect's pending payload, each fixed-effect
        tensor on a CUDA device."""
        jobs = []
        for m in self.coordinates.values():
            if isinstance(m, RandomEffectModel):
                thunk = m.pending
                if thunk is None:
                    continue

                def install_re(flat, m=m, thunk=thunk):
                    c, v = thunk(flat)
                    object.__setattr__(m, "coeffs", c)
                    object.__setattr__(m, "variances", v)

                jobs.append((install_re, thunk.device_payload))
            elif isinstance(m, FixedEffectModel):
                coeffs = m.model.coefficients
                for field in ("means", "variances"):
                    t = getattr(coeffs, field)
                    if isinstance(t, torch.Tensor) and t.is_cuda:

                        def install_fe(flat, coeffs=coeffs, field=field,
                                       t=t):
                            # a copy out of the shared transfer buffer
                            object.__setattr__(coeffs, field, torch.as_tensor(
                                flat.reshape(t.shape).copy()).to(t.dtype))

                        jobs.append((install_fe, t.detach().reshape(-1)))
        return jobs

    def device_wait(self) -> None:
        """Wait until the device work behind this model's tables has
        finished, without copying them: one element of the last table
        still on the device is read (the coordinates' solves are chained
        by their scores, so that read drains them all). A stage's wall then
        holds its device work."""
        jobs = self._device_tensors()
        if jobs:
            jobs[-1][1][:1].cpu()

    def materialize(self) -> None:
        """Copy every table still on the device to the host in one
        concatenated transfer: the random effects' pending payloads become
        their numpy tables, the fixed effects' CUDA tensors host tensors.
        Nothing happens when all of them are on the host already."""
        with _THUNK_LOCK:
            jobs = self._device_tensors()
            if not jobs:
                return
            sizes = [int(t.numel()) for _, t in jobs]
            device = jobs[0][1].device
            flat = torch.cat([t.to(device=device, dtype=torch.float32)
                              for _, t in jobs]).cpu().numpy()
            bounds = np.cumsum([0] + sizes)
            for (install, _), lo, hi in zip(jobs, bounds[:-1], bounds[1:]):
                install(flat[lo:hi])

    def score(self, data: GameData) -> np.ndarray:
        """Total margin per sample: offsets + sum of coordinate scores."""
        return sum_coordinate_margins(
            data.offsets, (m.score(data) for m in self.coordinates.values()))

    def score_by_coordinate(self, data: GameData) -> dict[str, np.ndarray]:
        return {cid: m.score(data) for cid, m in self.coordinates.items()}
