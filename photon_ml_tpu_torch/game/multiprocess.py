"""Multi-process GAME training: entity-partitioned random effects
(counterpart of ``photon_ml_tpu/game/multiprocess.py``).

The reference trains random effects sharded across machines: rows are
shuffled so each executor owns complete entities
(``RandomEffectDatasetPartitioner.scala``), the per-entity solves run there
with no communication, and the model stays sharded the same way. Here, one
process a card:

- **Entity partition** (:func:`balanced_entity_partition`): a
  deterministic, frequency-balanced assignment entity → process, computed
  identically on every process from all-reduced entity row counts.
- **Row shuffle** (:func:`exchange_rows`): each process starts from its own
  row share (its Avro files, :func:`process_file_share`) and keeps the rows
  whose owner it is, over the host gather
  (:func:`~photon_ml_tpu_torch.parallel.multihost.allgather_concat`).
- **Per-process datasets**: the fixed effect is this rank's block of the
  global row layout (:class:`MultiProcessFixedEffectDataset`), solved by
  :class:`~photon_ml_tpu_torch.parallel.distributed.DistributedGLMObjective`
  — kernel 1 on the block and one ``all_reduce`` a evaluation; each random
  effect is built over the process's own entities and solved on its own
  card through the per-bucket loop and kernel 2, with no collective.
- **Row-local score accounting**: residuals live on the process that owns
  the row; a random-effect coordinate whose entity type differs from the
  primary partition exchanges residuals and scores through the host gather
  each sweep.
- **Model assembly**: the per-process random-effect tables are gathered
  into one model, identical on every process; the chief writes outputs.

Every collective is the identity in one process, so the pipeline runs (and
is tested) single-process too.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import logging
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.game.data import (
    FeatureShard,
    GameData,
    RandomEffectDataset,
    choose_dense_design_stats,
    design_dtype_of,
    host_design_for_shard,
)
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
from photon_ml_tpu_torch.glm.training import build_problem
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops.objective import GLMData
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.distributed import _pad_rows
from photon_ml_tpu_torch.resilience import fault_point, fault_value, heartbeat
from photon_ml_tpu_torch.telemetry import profiling
from photon_ml_tpu_torch.telemetry.aggregate import sweep_boundary
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Entity partition, row shuffle, file shares
# ---------------------------------------------------------------------------


def balanced_entity_partition(row_counts: np.ndarray,
                              n_processes: int) -> np.ndarray:
    """Frequency-balanced entity → process assignment: entities by row
    count descending (ties by entity id), each to the least-loaded process
    (ties by process index) — deterministic, so every process computes
    the same map. Entities with no rows are assigned too (the map is
    total). Returns ``(n_entities,)`` int32 process ids."""
    counts = np.asarray(row_counts, np.int64)
    n_processes = int(n_processes)
    if n_processes <= 1:
        return np.zeros(len(counts), np.int32)
    order = np.lexsort((np.arange(len(counts)), -counts))
    owner = np.zeros(len(counts), np.int32)
    heap = [(0, p) for p in range(n_processes)]
    heapq.heapify(heap)
    for e in order:
        load, p = heapq.heappop(heap)
        owner[e] = p
        heapq.heappush(heap, (load + int(counts[e]), p))
    return owner


def _take_rows(game: GameData, rows: np.ndarray) -> GameData:
    return GameData(
        labels=game.labels[rows], offsets=game.offsets[rows],
        weights=game.weights[rows],
        shards={k: s.take(rows) for k, s in game.shards.items()},
        id_columns={k: v[rows] for k, v in game.id_columns.items()})


def exchange_rows(game_local: GameData, dest_local: np.ndarray
                  ) -> tuple[GameData, np.ndarray]:
    """All-to-all row shuffle: keep the rows this process owns.

    ``dest_local`` is each local row's destination process. Global row ids
    are (process-order offset + local index), the host gather's
    concatenation order, and the kept rows come back sorted by global id —
    each process's rows are a deterministic slice of one global order, row
    for row comparable with a single-process run. Returns ``(owned
    GameData, owned global row ids)``."""
    me = multihost.process_index()
    dest_local = np.asarray(dest_local, np.int32)
    if multihost.process_count() == 1:
        keep = np.flatnonzero(dest_local == me)
        return _take_rows(game_local, keep), keep.astype(np.int64)
    gather = multihost.allgather_concat
    keep = np.flatnonzero(gather(dest_local) == me).astype(np.int64)
    shards = {}
    for name, shard in game_local.shards.items():
        counts = gather(shard.row_counts().astype(np.int64))
        indptr = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        shards[name] = FeatureShard(
            indptr=indptr, cols=gather(shard.cols), vals=gather(shard.vals),
            dim=shard.dim).take(keep)
    return GameData(
        labels=gather(game_local.labels)[keep],
        offsets=gather(game_local.offsets)[keep],
        weights=gather(game_local.weights)[keep], shards=shards,
        id_columns={k: gather(v)[keep]
                    for k, v in game_local.id_columns.items()}), keep


def owner_of_rows(entities: np.ndarray, owner_of_entity: np.ndarray,
                  global_rows: np.ndarray, n_processes: int) -> np.ndarray:
    """Destination process per row: its entity's owner; rows without an
    entity (id < 0) round-robin by global row id."""
    entities = np.asarray(entities, np.int64)
    dest = np.where(entities >= 0,
                    owner_of_entity[np.maximum(entities, 0)],
                    (np.asarray(global_rows, np.int64) % n_processes
                     ).astype(np.int32))
    return dest.astype(np.int32)


def process_file_share(reader, input_path) -> list[str]:
    """This process's share of the input files: a CONTIGUOUS run of the
    sorted listing, balanced by cumulative bytes, so the global row ids of
    the process-order concatenation are the single-process read order (and
    every draw keyed by a global row id — down-sampling, the active-data
    subsample — equals the single-process run's).

    The processes agree on the listing first (its length and a digest of
    its names): a listing that differs fails every process alike. Fewer
    files than processes raises (a process with no rows would desync the
    budgets); sizes that differ across processes fall back to equal-count
    shares."""
    all_files = reader.paths(input_path)
    n_proc = multihost.process_count()
    if n_proc > 1:
        digest = hashlib.sha256("\0".join(all_files).encode()).digest()[:8]
        h = np.frombuffer(digest, np.uint32).astype(np.float64)
        sig = multihost.allgather_concat(
            np.array([float(len(all_files)), h[0], h[1]])).reshape(n_proc, 3)
        if not (sig == sig[:1]).all():
            raise SystemExit(
                "--multihost: the input file listing diverges across "
                "processes (different lengths or names) — every process "
                "must see the same files; re-run once the input directory "
                "is stable")
    if len(all_files) < n_proc:
        raise SystemExit(
            f"--multihost with {n_proc} processes needs at least that many "
            f"input files (got {len(all_files)}; split the data)")
    try:
        sizes = np.array([max(os.path.getsize(f), 1) for f in all_files],
                         np.float64)
    except OSError:
        sizes = None
    if n_proc > 1:
        ok = sizes is not None
        local = np.concatenate(
            [[float(ok)], sizes if ok else np.zeros(len(all_files))])
        rows = multihost.allgather_concat(local).reshape(
            n_proc, len(all_files) + 1)
        if (rows[:, 0] == 1.0).all() and (rows == rows[:1]).all():
            sizes = rows[0, 1:]
        else:
            sizes = np.ones(len(all_files), np.float64)
    elif sizes is None:
        sizes = np.ones(len(all_files), np.float64)
    cum = np.cumsum(sizes)
    targets = cum[-1] * (np.arange(1, n_proc) / n_proc)
    cuts = np.searchsorted(cum, targets, side="left") + 1
    bounds = [0]
    for i, c in enumerate(cuts):
        lo = bounds[-1] + 1
        hi = len(all_files) - (n_proc - 1 - i)
        bounds.append(int(min(max(c, lo), hi)))
    bounds.append(len(all_files))
    pid = multihost.process_index()
    return all_files[bounds[pid]:bounds[pid + 1]]


# ---------------------------------------------------------------------------
# Global id agreement
# ---------------------------------------------------------------------------


def reconcile_global_ids(data: GameData, index_maps, vocabs,
                         id_columns=()):
    """Make per-process feature index maps and entity vocabularies global:
    the key sets are unioned over the host gather and rebuilt in the
    canonical order (:func:`~photon_ml_tpu_torch.io.index.build_index_map`'s
    sorted order, what a single-process read of every file builds; sorted
    raw ids for vocabularies), and this process's columns are remapped.
    Collective: every process passes the same shards and ``id_columns``.
    Returns ``(data, index_maps, vocabs)``."""
    from photon_ml_tpu_torch.io.index import build_index_map
    from photon_ml_tpu_torch.types import INTERCEPT_KEY

    new_maps = {}
    new_shards = dict(data.shards)
    for sid in sorted(index_maps):
        local_names = index_maps[sid].names()
        union = set(multihost.allgather_concat_strings(local_names))
        gmap = build_index_map(union, add_intercept=INTERCEPT_KEY in union)
        perm = np.array([gmap.key_to_index[k] for k in local_names],
                        np.int32)
        shard = data.shards[sid]
        new_shards[sid] = dataclasses.replace(
            shard, cols=(perm[shard.cols] if len(shard.cols)
                         else shard.cols), dim=len(gmap))
        new_maps[sid] = gmap
    data = dataclasses.replace(data, shards=new_shards)
    data, new_vocabs = reconcile_vocabs(data, vocabs, id_columns)
    return data, new_maps, new_vocabs


def reconcile_vocabs(data: GameData, vocabs, id_columns=()):
    """The entity-vocabulary half of :func:`reconcile_global_ids` alone,
    for a driver whose feature index maps are preset (scoring). Collective.
    Returns ``(data, vocabs)``."""
    new_vocabs = {}
    new_ids = dict(data.id_columns)
    for col in sorted(set(id_columns) | set(vocabs)):
        vocab = vocabs.get(col, {})
        local_names = [""] * len(vocab)
        for k, i in vocab.items():
            local_names[i] = k
        union = sorted(set(multihost.allgather_concat_strings(local_names)))
        gvocab = {k: i for i, k in enumerate(union)}
        perm = np.array([gvocab[k] for k in local_names], np.int64)
        ids = data.id_columns.get(col)
        if ids is not None and len(perm):
            new_ids[col] = np.where(ids >= 0, perm[np.maximum(ids, 0)],
                                    np.int64(-1))
        new_vocabs[col] = gvocab
    return dataclasses.replace(data, id_columns=new_ids), new_vocabs


# ---------------------------------------------------------------------------
# The fixed effect: this rank's block of the global row layout
# ---------------------------------------------------------------------------


def _feed_rows(values, per: int, device) -> torch.Tensor:
    """One per-local-row array (trailing dims kept) on ``device``, padded
    with zero rows to the agreed ``per`` — the layout of
    :func:`~photon_ml_tpu_torch.parallel.distributed.shard_glm_data` with
    one block (local rows first, padding at the tail), so a re-fed leaf
    lines up row for row with the block built once."""
    return _pad_rows(np.asarray(values, np.float32), per).to(device)


@dataclasses.dataclass
class MultiProcessFixedEffectDataset:
    """This rank's block of a fixed-effect coordinate's rows on its device,
    built once; each sweep binds fresh residual offsets (and down-sampled
    weights) through :meth:`glm_data`."""

    coordinate_id: str
    feature_shard_id: str
    design: object
    labels: torch.Tensor
    weights: torch.Tensor
    dim: int
    n_local_rows: int
    rows_per_shard: int
    device: torch.device

    @staticmethod
    def build(coordinate_id: str, game_owned: GameData,
              feature_shard_id: str, device, *,
              design_dtype: str = "float32",
              ) -> "MultiProcessFixedEffectDataset":
        """The dense/sparse layout is decided on GLOBAL statistics (every
        rank must take the same one): the summed row and nonzero counts,
        the largest rank's rows for the host image, one of
        ``process_count()`` blocks for the device cap."""
        shard = game_owned.shards[feature_shard_id]
        g = multihost.allreduce_sum(
            np.array([shard.n_samples, shard.nnz], np.int64))
        n_loc = int(multihost.allreduce_max(
            np.array([shard.n_samples], np.int64))[0])
        dtype = design_dtype_of(design_dtype)
        dense = choose_dense_design_stats(
            int(g[0]), shard.dim, int(g[1]),
            n_shards=multihost.process_count(), n_local_samples=n_loc,
            itemsize=torch.empty((), dtype=dtype).element_size())
        local = GLMData(
            design=host_design_for_shard(shard, dense=dense, dtype=dtype),
            labels=torch.as_tensor(game_owned.labels),
            offsets=torch.zeros(shard.n_samples),
            weights=torch.as_tensor(game_owned.weights))
        fed = multihost.global_glm_data_multihost(local, device)
        return MultiProcessFixedEffectDataset(
            coordinate_id=coordinate_id, feature_shard_id=feature_shard_id,
            design=fed.design, labels=fed.labels, weights=fed.weights,
            dim=shard.dim, n_local_rows=shard.n_samples,
            rows_per_shard=int(fed.labels.shape[0]), device=fed.labels.device)

    def glm_data(self, local_offsets, local_weights=None) -> GLMData:
        """The block with this rank's residual offsets; ``local_weights``
        (a sweep's down-sampled weights) replaces the weights for this
        solve only."""
        per = self.rows_per_shard
        return GLMData(
            design=self.design, labels=self.labels,
            offsets=_feed_rows(local_offsets, per, self.device),
            weights=(self.weights if local_weights is None
                     else _feed_rows(local_weights, per, self.device)))

    def local_scores(self, scores: torch.Tensor) -> np.ndarray:
        """This rank's rows of a block-shaped score vector (the tail
        padding dropped), on the host."""
        return scores[:self.n_local_rows].cpu().numpy().astype(np.float32)


def _fixed_train_dist(task: TaskType, config: GLMOptimizationConfiguration):
    """The distributed fixed-effect solve: ``train(data, w0, lam) ->
    (w, variances, offset-free margins of this rank's block)``, profiled as
    ``game.fixed_effect.dist``."""
    problem = build_problem(task, config, distributed=True)

    def train(data: GLMData, w0: torch.Tensor, lam: float):
        w = problem.run(data, w0, lam).w[0]
        variances = problem.compute_variances(w, data, lam)
        return w, variances, data.design.matvec(w)

    return profiling.profile_fn(train, "game.fixed_effect.dist")


# ---------------------------------------------------------------------------
# Coordinate descent across processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiProcessGameResult:
    model: GameModel  # identical on every process
    #: this process's rows: global ids and per-coordinate scores
    global_rows: np.ndarray
    scores: dict[str, np.ndarray]
    #: per-sweep validation metric dicts, identical on every process
    validation_history: list = dataclasses.field(default_factory=list)


# Sweep-boundary checkpoints: each process persists its own share of the
# row-partitioned state (its residual scores, its random-effect tables)
# as proc-<pid>/sweep-<k>.npz (tmp + rename), fingerprint-guarded; resume
# agrees on the smallest latest sweep over processes, so a process that
# died mid-save replays its last complete sweep.


def _mp_ckpt_dir(root: str) -> str:
    return os.path.join(root, f"proc-{multihost.process_index()}")


def _mp_ckpt_save(root: str, sweep: int, fingerprint: str,
                  scores: Mapping[str, np.ndarray],
                  re_local_models: Mapping[str, RandomEffectModel],
                  fe_models: Mapping[str, FixedEffectModel],
                  validation_history: Sequence[Mapping] = (),
                  trained_projection_cids: frozenset = frozenset()) -> None:
    from photon_ml_tpu_torch.resilience import retry

    d = _mp_ckpt_dir(root)
    os.makedirs(d, exist_ok=True)
    payload: dict[str, np.ndarray] = {}
    if validation_history:
        payload["history"] = np.frombuffer(
            json.dumps(list(validation_history)).encode("utf-8"), np.uint8)
    for cid, s in scores.items():
        payload[f"score::{cid}"] = np.asarray(s, np.float32)
    for cid, m in re_local_models.items():
        payload[f"rekeys::{cid}"] = m.keys
        payload[f"recoef::{cid}"] = m.coeffs
        if m.variances is not None:
            payload[f"revar::{cid}"] = m.variances
        payload[f"remeta::{cid}"] = np.array([m.dim], np.int64)
        if m.projector is not None and cid in trained_projection_cids:
            # a factored coordinate's projection is trained state
            payload[f"reproj::{cid}"] = np.asarray(m.projector.matrix,
                                                   np.float32)
    for cid, m in fe_models.items():
        c = m.model.coefficients
        payload[f"few::{cid}"] = c.means.detach().cpu().numpy()
        if c.variances is not None:
            payload[f"fev::{cid}"] = c.variances.detach().cpu().numpy()
    payload["fingerprint"] = np.frombuffer(fingerprint.encode("utf-8"),
                                           np.uint8)

    def attempt() -> None:
        tmp = os.path.join(d, f".sweep-{sweep}.npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        # written, rename pending: a kill here leaves the previous sweep
        # as the loadable latest
        fault_point("ckpt.save", step=sweep, path=d, scope="mp")
        os.replace(tmp, os.path.join(d, f"sweep-{sweep}.npz"))

    retry(attempt, name=f"ckpt.save:mp-sweep-{sweep}")
    kept = sorted(
        (int(n[len("sweep-"):-len(".npz")]) for n in os.listdir(d)
         if n.startswith("sweep-") and n.endswith(".npz")), reverse=True)
    for old in kept[3:]:
        try:
            os.unlink(os.path.join(d, f"sweep-{old}.npz"))
        except OSError:
            pass


def _mp_ckpt_latest(root: str) -> int:
    """Latest complete sweep this process saved (-1: none)."""
    d = _mp_ckpt_dir(root)
    if not os.path.isdir(d):
        return -1
    best = -1
    for name in os.listdir(d):
        if name.startswith("sweep-") and name.endswith(".npz"):
            try:
                best = max(best, int(name[len("sweep-"):-len(".npz")]))
            except ValueError:
                pass
    return best


def _mp_ckpt_load(root: str, sweep: int, fingerprint: str, task,
                  re_templates: Mapping[str, RandomEffectModel],
                  fe_templates: Mapping[str, object], device):
    """This process's (scores, random-effect tables, fixed-effect models,
    history); the templates carry the non-array fields."""
    from photon_ml_tpu_torch.game.projector import RandomProjector

    with np.load(os.path.join(_mp_ckpt_dir(root),
                              f"sweep-{sweep}.npz")) as z:
        saved_fp = bytes(z["fingerprint"]).decode("utf-8")
        if saved_fp != fingerprint:
            raise ValueError(
                f"checkpoint fingerprint mismatch under {root!r}: saved "
                f"{saved_fp!r} != current {fingerprint!r} — the run "
                "configuration or row partition changed; delete the "
                "checkpoint directory to start fresh")
        scores = {k[len("score::"):]: z[k] for k in z.files
                  if k.startswith("score::")}
        re_models = {}
        for k in z.files:
            if not k.startswith("rekeys::"):
                continue
            cid = k[len("rekeys::"):]
            t = re_templates[cid]
            projector = (RandomProjector(matrix=z[f"reproj::{cid}"])
                         if f"reproj::{cid}" in z.files else t.projector)
            re_models[cid] = RandomEffectModel(
                random_effect_type=t.random_effect_type,
                feature_shard_id=t.feature_shard_id, task=task,
                dim=int(z[f"remeta::{cid}"][0]), keys=z[k],
                coeffs=z[f"recoef::{cid}"],
                variances=(z[f"revar::{cid}"]
                           if f"revar::{cid}" in z.files else None),
                projector=projector)
        fe_models = {}
        for k in z.files:
            if not k.startswith("few::"):
                continue
            cid = k[len("few::"):]
            var = (torch.as_tensor(z[f"fev::{cid}"], device=device)
                   if f"fev::{cid}" in z.files else None)
            fe_models[cid] = FixedEffectModel(
                model=GeneralizedLinearModel(
                    coefficients=Coefficients(
                        means=torch.as_tensor(z[k], device=device),
                        variances=var), task=task),
                feature_shard_id=fe_templates[cid].feature_shard_id)
        history = (json.loads(bytes(z["history"]).decode("utf-8"))
                   if "history" in z.files else [])
    return scores, re_models, fe_models, history


@dataclasses.dataclass(frozen=True)
class _REPlan:
    """A random-effect coordinate's share of one process: its owned rows
    (all of each owned entity's) and, unless factored, its dataset."""

    cfg: object  # the coordinate's configuration
    game: GameData
    global_rows: np.ndarray
    dataset: Optional[RandomEffectDataset]  # None: factored (per call)
    primary: bool  # rows coincide with the primary partition


def _solve(problem, data, w0, lam):
    return problem.run(data, w0, lam)


#: the factored coordinate's distributed projection solve
_projection_solve = profiling.profile_fn(_solve, "game.factored_projection")


def _train_factored_mp(coord, global_rows: np.ndarray, offsets: np.ndarray,
                       warm, device):
    """A factored coordinate across processes: the per-entity latent solves
    run process-local like any random effect, and the shared projection —
    a GLM in ``vec(P)`` over the implicit Khatri-Rao design — is one
    distributed solve over every rank's rows, so every process holds the
    same ``P``. Mirrors :meth:`FactoredRandomEffectCoordinate.train` step
    for step; global row ids key the active-data subsample."""
    from photon_ml_tpu_torch.game.factored import FactoredDesign
    from photon_ml_tpu_torch.game.projector import RandomProjector
    from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver

    cfg = coord.dataset_config
    shard = coord.data.shards[cfg.feature_shard_id]
    p = (warm.projector.matrix if warm is not None
         and warm.projector is not None
         else RandomProjector.build(shard.dim, coord.latent_dim,
                                    cfg.seed).matrix)
    solver = RandomEffectSolver(task=coord.task, config=coord.config,
                                device=device)
    problem = build_problem(coord.task, coord.projection_config,
                            distributed=True)
    entities = coord.data.id_columns[cfg.random_effect_type]
    off_dev = torch.as_tensor(np.asarray(offsets, np.float32), device=device)
    latent = warm
    fed = None
    for _ in range(max(1, coord.n_factored_iterations)):
        dataset = RandomEffectDataset.build(
            coord.coordinate_id, coord.data, coord._ds_config,
            projector=RandomProjector(matrix=p), sample_uids=global_rows)
        latent, _ = solver.train(dataset, off_dev, coord.lam,
                                 warm_start=latent)
        v = coord._latent_table(latent, entities).astype(np.float32)
        if fed is None:
            # the first alternation feeds the whole block; x, labels,
            # weights and offsets stay, later ones re-feed only v
            fed = multihost.global_glm_data_multihost(GLMData(
                design=FactoredDesign(x=torch.from_numpy(shard.to_dense()),
                                      v=torch.from_numpy(v),
                                      latent_dim=coord.latent_dim),
                labels=torch.as_tensor(coord.data.labels),
                offsets=torch.as_tensor(np.asarray(offsets, np.float32)),
                weights=torch.as_tensor(coord.data.weights)), device)
        else:
            fed = dataclasses.replace(fed, design=FactoredDesign(
                x=fed.design.x,
                v=_feed_rows(v, int(fed.labels.shape[0]), device),
                latent_dim=coord.latent_dim))
        w = _projection_solve(
            problem, fed, torch.as_tensor(p.reshape(-1), device=device),
            coord.lam_projection).w[0]
        p = w.cpu().numpy().astype(np.float32).reshape(coord.latent_dim,
                                                       shard.dim)
    dataset = RandomEffectDataset.build(
        coord.coordinate_id, coord.data, coord._ds_config,
        projector=RandomProjector(matrix=p), sample_uids=global_rows)
    latent, _ = solver.train(dataset, off_dev, coord.lam, warm_start=latent)
    return latent, np.asarray(latent.score(coord.data), np.float32)


def _allgather_rowvec(global_rows: np.ndarray, values: np.ndarray,
                      n_global: int) -> np.ndarray:
    """A global row vector, identical on every process, from per-process
    slices."""
    rows = multihost.allgather_concat(np.asarray(global_rows, np.int64))
    vals = multihost.allgather_concat(np.asarray(values, np.float32))
    out = np.zeros(n_global, np.float32)
    out[rows] = vals
    return out


def _fingerprint(n_proc, task, update_sequence, lam, coordinate_configs,
                 locked, initial_models, n_global, primary_rows) -> str:
    def coeffs(m):
        a = (m.coeffs if isinstance(m, RandomEffectModel)
             else m.model.coefficients.means.detach().cpu().numpy())
        return hashlib.sha1(np.asarray(a, np.float32).tobytes()).hexdigest()

    return hashlib.sha1(json.dumps({
        "n_proc": n_proc,
        "task": str(task),
        "sequence": list(update_sequence),
        "lam": sorted((c, float(lam.get(c, 0.0))) for c in update_sequence),
        "configs": {c: repr(coordinate_configs.get(c))
                    for c in update_sequence},
        "locked": sorted(locked),
        "initial": {c: coeffs(m) for c, m in sorted(initial_models.items())},
        "n_global": n_global,
        "rows": hashlib.sha1(
            np.ascontiguousarray(primary_rows).tobytes()).hexdigest(),
    }, sort_keys=True).encode()).hexdigest()


def train_game_multiprocess(
    game_local: GameData,
    task: TaskType,
    coordinate_configs: Mapping[str, object],
    update_sequence: Sequence[str],
    lam: Mapping[str, float],
    n_cd_iterations: int = 1,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    initial_models: Optional[Mapping[str, object]] = None,
    locked: Sequence[str] = (),
    validation: Optional[tuple] = None,
    guard=None,
    device=None,
) -> MultiProcessGameResult:
    """GAME coordinate descent across every process of the job.

    ``game_local`` is THIS process's row share (any partition, e.g. its
    Avro files); ``coordinate_configs`` maps coordinate ids to fixed,
    random or factored random-effect configurations. The primary row
    partition follows the first trained random-effect coordinate (others
    exchange residuals each sweep); with none, rows stay where they were
    read. ``device`` defaults to this rank's card.

    ``initial_models``/``locked``: the partial-retrain path with
    single-process semantics (every process holds the same loaded models).
    ``validation`` (``(GameData, evaluators)``, the whole validation set on
    every process) evaluates the assembled model after each sweep.
    ``checkpoint_dir``/``resume``: per-process sweep-boundary state.
    ``guard``: divergence rollback, its verdict max-reduced over processes
    so they all roll back (or freeze) together; fault plans must be seeded
    alike on every process so injected faults fire symmetrically."""
    from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.estimator import (
        FactoredRandomEffectCoordinateConfig,
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_tpu_torch.game.factored import (
        FactoredRandomEffectCoordinate,
    )

    device = multihost.local_device(device)
    n_proc = multihost.process_count()
    gather = multihost.allgather_concat
    locked = set(locked)
    initial_models = dict(initial_models or {})
    for cid in locked:
        if cid not in initial_models:
            raise KeyError(f"locked coordinate {cid!r} needs an initial model")
    missing_seq = locked - set(update_sequence)
    if missing_seq:
        raise ValueError(
            f"locked coordinates {sorted(missing_seq)} must appear in the "
            f"update sequence")
    for cid in update_sequence:
        if cid not in coordinate_configs and cid not in locked:
            raise KeyError(f"update sequence names unknown coordinate {cid!r}")
    re_kinds = (RandomEffectCoordinateConfig,
                FactoredRandomEffectCoordinateConfig)

    n_local = game_local.n_samples
    counts = gather(np.array([n_local], np.int64))
    n_global = int(counts.sum())
    base = int(np.concatenate([[0], np.cumsum(counts)])[
        multihost.process_index()])
    local_global_rows = base + np.arange(n_local, dtype=np.int64)

    # --- one owner map per entity type ------------------------------------
    re_types = [coordinate_configs[cid].dataset.random_effect_type
                for cid in update_sequence if cid not in locked
                and isinstance(coordinate_configs[cid], re_kinds)]
    owner_by_type: dict[str, np.ndarray] = {}
    for t in dict.fromkeys(re_types):
        ents = game_local.id_columns[t]
        n_ent = int(multihost.allreduce_max(
            np.array([ents.max() + 1 if len(ents) else 0], np.int64))[0])
        ent_counts = multihost.allreduce_sum(np.bincount(
            ents[ents >= 0], minlength=max(n_ent, 1)).astype(np.int64))
        owner_by_type[t] = balanced_entity_partition(ent_counts, n_proc)

    # --- the primary row partition ----------------------------------------
    primary_type = re_types[0] if re_types else None
    if primary_type is None:
        game_primary, primary_rows = game_local, local_global_rows
    else:
        # ship only what the primary-partition coordinates read
        need = set()
        for cid in update_sequence:
            if cid in locked:
                continue
            cfg = coordinate_configs[cid]
            if isinstance(cfg, FixedEffectCoordinateConfig):
                need.add(cfg.feature_shard_id)
            elif cfg.dataset.random_effect_type == primary_type:
                need.add(cfg.dataset.feature_shard_id)
        slim = GameData(
            labels=game_local.labels, offsets=game_local.offsets,
            weights=game_local.weights,
            shards={k: v for k, v in game_local.shards.items() if k in need},
            id_columns={primary_type: game_local.id_columns[primary_type]})
        game_primary, primary_rows = exchange_rows(slim, owner_of_rows(
            game_local.id_columns[primary_type], owner_by_type[primary_type],
            local_global_rows, n_proc))

    # --- per-coordinate builds --------------------------------------------
    fe_datasets: dict[str, MultiProcessFixedEffectDataset] = {}
    re_plans: dict[str, _REPlan] = {}
    for cid in update_sequence:
        if cid in locked:
            continue
        cfg = coordinate_configs[cid]
        if isinstance(cfg, FixedEffectCoordinateConfig):
            fe_datasets[cid] = MultiProcessFixedEffectDataset.build(
                cid, game_primary, cfg.feature_shard_id, device,
                design_dtype=cfg.design_dtype)
        elif isinstance(cfg, re_kinds):
            t = cfg.dataset.random_effect_type
            if t == primary_type:
                game_c, rows_c, is_primary = game_primary, primary_rows, True
            else:
                slim = GameData(
                    labels=game_local.labels, offsets=game_local.offsets,
                    weights=game_local.weights,
                    shards={cfg.dataset.feature_shard_id:
                            game_local.shards[cfg.dataset.feature_shard_id]},
                    id_columns={t: game_local.id_columns[t]})
                game_c, rows_c = exchange_rows(slim, owner_of_rows(
                    game_local.id_columns[t], owner_by_type[t],
                    local_global_rows, n_proc))
                is_primary = False
            factored = isinstance(cfg, FactoredRandomEffectCoordinateConfig)
            # the owned entities' rows are complete here; global row ids
            # key the active-data subsample as a single-process build does
            ds = None if factored else RandomEffectDataset.build(
                cid, game_c, cfg.dataset, sample_uids=rows_c)
            re_plans[cid] = _REPlan(cfg=cfg, game=game_c,
                                    global_rows=rows_c, dataset=ds,
                                    primary=is_primary)
        else:
            raise TypeError(
                f"coordinate {cid!r}: multi-process training supports fixed, "
                f"random and factored random effects (got "
                f"{type(cfg).__name__})")

    # --- coordinate descent with row-local score accounting ---------------
    scores: dict[str, np.ndarray] = {
        cid: np.zeros(len(primary_rows), np.float32)
        for cid in update_sequence}
    models: dict[str, object] = {}
    re_local_models: dict[str, RandomEffectModel] = {}
    # seed from the initial models: scored on the read partition (which
    # holds every shard), mapped onto the primary one by global row
    for cid, m0 in initial_models.items():
        if cid not in update_sequence:
            continue
        models[cid] = m0
        if isinstance(m0, RandomEffectModel) and cid not in locked:
            re_local_models[cid] = m0
        g = _allgather_rowvec(local_global_rows,
                              np.asarray(m0.score(game_local), np.float32),
                              n_global)
        scores[cid] = g[primary_rows].astype(np.float32)

    start_sweep = 0
    fingerprint = None
    resumed_history: list = []
    if checkpoint_dir is not None:
        fingerprint = _fingerprint(n_proc, task, update_sequence, lam,
                                   coordinate_configs, locked,
                                   initial_models, n_global, primary_rows)
        if resume:
            agreed = int(-multihost.allreduce_max(np.array(
                [-_mp_ckpt_latest(checkpoint_dir)], np.int64))[0])
            if agreed >= 0:
                from photon_ml_tpu_torch.resilience import retry

                templates = {
                    cid: RandomEffectModel(
                        random_effect_type=p.cfg.dataset.random_effect_type,
                        feature_shard_id=p.cfg.dataset.feature_shard_id,
                        task=task, dim=0, keys=np.zeros(0, np.int64),
                        coeffs=np.zeros(0, np.float32),
                        projector=(p.dataset.projector
                                   if p.dataset is not None else None))
                    for cid, p in re_plans.items()}
                saved_scores, saved_re, fe_models, resumed_history = retry(
                    lambda: _mp_ckpt_load(checkpoint_dir, agreed,
                                          fingerprint, task, templates,
                                          fe_datasets, device),
                    name=f"ckpt.restore:mp-sweep-{agreed}")
                re_local_models.update(saved_re)
                scores.update(saved_scores)
                models.update(fe_models)
                start_sweep = agreed + 1
                logger.info("mp resumed from checkpoint sweep %d", agreed)

    total = game_primary.offsets.astype(np.float32) + sum(
        scores[cid] for cid in update_sequence)
    assembled_memo: list = []

    def assemble() -> GameModel:
        """Gather the per-process random-effect tables into the global
        model (identical on every process)."""
        if assembled_memo:
            return assembled_memo[0]
        out = dict(models)
        for cid, local_model in re_local_models.items():
            if local_model is initial_models.get(cid):
                continue  # still the seeded global table
            keys = gather(local_model.keys)
            coeffs = gather(local_model.coeffs)
            variances = (gather(local_model.variances)
                         if local_model.variances is not None else None)
            order = np.argsort(keys, kind="stable")
            out[cid] = RandomEffectModel(
                random_effect_type=local_model.random_effect_type,
                feature_shard_id=local_model.feature_shard_id, task=task,
                dim=local_model.dim, keys=keys[order], coeffs=coeffs[order],
                variances=None if variances is None else variances[order],
                projector=local_model.projector)
        gm = GameModel(coordinates={cid: out[cid]
                                    for cid in update_sequence}, task=task)
        assembled_memo.append(gm)
        return gm

    validation_history: list[dict] = list(resumed_history)
    lam = dict(lam)  # guard retries raise a coordinate's weight
    for sweep in range(start_sweep, n_cd_iterations):
        heartbeat("mp.sweep")
        fault_point("worker.stall", sweep=sweep)
        for cid in update_sequence:
            heartbeat("mp.step")
            if cid in locked:
                continue
            if (guard is not None and cid in guard.frozen
                    and (cid in models or cid in re_local_models)):
                continue
            cfg = coordinate_configs[cid]
            while True:
                residual = total - scores[cid]
                prev_fe = models.get(cid)
                prev_re = re_local_models.get(cid)
                step_error = new_model = new_scores = None
                try:
                    if cid in fe_datasets:
                        new_model, new_scores = _train_fixed_step(
                            fe_datasets[cid], cfg, task, game_primary,
                            primary_rows, residual, models.get(cid),
                            lam.get(cid, 0.0), sweep)
                        models[cid] = new_model
                    else:
                        plan = re_plans[cid]
                        # residuals live on the primary owners; a
                        # coordinate of another entity type reads them
                        # through the global vector (the score join)
                        res_c = (residual if plan.primary else
                                 _allgather_rowvec(primary_rows, residual,
                                                   n_global)[plan.global_rows])
                        if plan.dataset is not None:
                            model_c, sc = RandomEffectCoordinate(
                                coordinate_id=cid, dataset=plan.dataset,
                                data=plan.game, task=task,
                                config=cfg.optimization,
                                lam=lam.get(cid, 0.0),
                                design_dtype=cfg.design_dtype).train(
                                torch.as_tensor(res_c, device=device),
                                re_local_models.get(cid), sweep=sweep)
                            sc = sc.cpu().numpy().astype(np.float32)
                        else:
                            model_c, sc = _train_factored_mp(
                                FactoredRandomEffectCoordinate(
                                    coordinate_id=cid, data=plan.game,
                                    dataset_config=cfg.dataset, task=task,
                                    config=cfg.optimization,
                                    projection_config=(
                                        cfg.projection_optimization),
                                    lam=lam.get(cid, 0.0),
                                    lam_projection=cfg.lam_projection,
                                    n_factored_iterations=(
                                        cfg.n_factored_iterations)),
                                plan.global_rows, res_c,
                                re_local_models.get(cid), device)
                        re_local_models[cid] = new_model = model_c
                        new_scores = (sc if plan.primary else
                                      _allgather_rowvec(
                                          plan.global_rows, sc,
                                          n_global)[primary_rows])
                    new_scores = fault_value("optimizer.step", new_scores,
                                             coordinate=cid, sweep=sweep)
                except Exception as e:
                    if guard is None:
                        raise
                    # faults from a seeded plan raise on every process
                    # alike, so the verdict collective below stays aligned
                    step_error = e
                if guard is None:
                    break
                # the verdict is collective: a split one would desync every
                # later collective
                local_ok = (step_error is None
                            and guard.healthy(new_model, new_scores))
                bad = int(multihost.allreduce_max(
                    np.array([0 if local_ok else 1], np.int64))[0]) > 0
                if not bad:
                    break
                if prev_fe is None:
                    models.pop(cid, None)
                else:
                    models[cid] = prev_fe
                if prev_re is None:
                    re_local_models.pop(cid, None)
                else:
                    re_local_models[cid] = prev_re
                action = guard.on_divergence(
                    cid, sweep=sweep,
                    has_good_model=(prev_fe is not None
                                    or prev_re is not None
                                    or cid in initial_models),
                    error=step_error)
                if action == "freeze":
                    new_scores = None
                    break
                lam[cid] = guard.next_lam(lam.get(cid, 0.0))
            if new_scores is None:
                continue
            assembled_memo.clear()
            total = residual + new_scores
            scores[cid] = new_scores
            logger.info("mp sweep %d coordinate %s done", sweep, cid)
        if validation is not None:
            # model and validation data are the same on every process: each
            # evaluates alone, with no collective
            from photon_ml_tpu_torch.evaluation import evaluate_all

            vdata, evaluators = validation
            results = evaluate_all(
                evaluators, assemble().score(vdata), vdata.labels,
                weights=vdata.weights, id_tags=vdata.id_columns)
            validation_history.append(results.as_dict())
            logger.info("mp sweep %d validation: %s", sweep, results)
        if checkpoint_dir is not None:
            _mp_ckpt_save(checkpoint_dir, sweep, fingerprint, scores,
                          {cid: m for cid, m in re_local_models.items()
                           if m is not initial_models.get(cid)},
                          {cid: m for cid, m in models.items()
                           if cid in fe_datasets},
                          validation_history=validation_history,
                          trained_projection_cids=frozenset(
                              cid for cid, p in re_plans.items()
                              if p.dataset is None))
        # the fleet-metrics fold point: a collective when --metrics-port
        # installed the hook; every process reaches it once a sweep
        sweep_boundary(sweep=sweep)
    return MultiProcessGameResult(
        model=assemble(), global_rows=primary_rows, scores=scores,
        validation_history=validation_history)


def _train_fixed_step(ds: MultiProcessFixedEffectDataset, cfg, task,
                      game_primary: GameData, primary_rows: np.ndarray,
                      residual: np.ndarray, prev: Optional[FixedEffectModel],
                      lam: float, sweep: int):
    """One distributed fixed-effect solve against this rank's residuals;
    returns the model and this rank's offset-free scores."""
    w_sweep = None
    if cfg.downsampler is not None:
        # the draw is keyed by global row id: every partition of the rows,
        # the single-process run included, keeps the same rows
        w_sweep = cfg.downsampler.downsample(
            game_primary.labels, game_primary.weights, sweep=sweep,
            uids=primary_rows)
    data = ds.glm_data(residual, local_weights=w_sweep)
    w0 = (torch.zeros(ds.dim, dtype=torch.float32, device=ds.device)
          if prev is None
          else prev.model.coefficients.means.to(ds.device))
    w, variances, margins = _fixed_train_dist(task, cfg.optimization)(
        data, w0, lam)
    model = FixedEffectModel(
        model=GeneralizedLinearModel(
            coefficients=Coefficients(means=w, variances=variances),
            task=task),
        feature_shard_id=ds.feature_shard_id)
    return model, ds.local_scores(margins)
