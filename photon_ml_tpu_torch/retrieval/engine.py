"""Top-k ranking engine: a user's margins against every item, on the card.

Counterpart of ``photon_ml_tpu/retrieval/engine.py``. One ranking call
scores a user record against every row of the
:class:`~photon_ml_tpu_torch.retrieval.index.ItemIndex` and returns the k
best:

1. the user-side margins (fixed effects, the other random effects) and the
   offset come from the version's own
   :class:`~photon_ml_tpu_torch.serving.engine.ScoringEngine` bucket
   program, so they are the ``/score`` path's margins by construction;
2. the ranking program computes the item coordinate's margins against the
   whole padded item axis, dequantizing the item matrix through
   :func:`~photon_ml_tpu_torch.serving.store.gather_rows` and reducing
   ``(x[:, None, :] * tab[None]).sum(dim=2)`` in f64, the same row
   reduction as the engine's ``(x * tab).sum(dim=1)`` (an index spread
   over a mesh: each part on its slot, the parts' margins concatenated in
   item order on the first slot);
3. it sums every coordinate and then the index's static margins through
   :func:`~photon_ml_tpu_torch.game.model.sum_coordinate_margins` in the
   model's coordinate order, masks
   the padding to ``-inf`` and sorts each row descending with a stable
   sort, so tied scores keep item order (``lax.top_k``'s tie-break toward
   the lower item position; ``torch.topk`` promises no order among ties).

**Parity contract.** At f32 tables the ids and scores equal scoring every
(user, item) pair through the engine and sorting stably; quantized tables
hold the store's bounds.

**Captures.** On the card each (user-batch bucket, k bucket, item bucket)
is one CUDA graph over static buffers: the user inputs (offsets, the
user-side f32 margins, the item shard's features) and the item tables
(matrix and scales, a pair a part, and the static margins) with the live
item count as a device scalar, so a patch that grows the vocabulary inside
the padding changes no shape. An index whose parts lie on other devices
than the engine's runs its program eagerly (a graph is captured on one
device). :meth:`RankingEngine.warmup` captures the grid; steady state
captures nothing. A patch-derived version whose coordinate structure
matches its parent's (the reference's ``_trace_compatible``) shares the
parent's programs (``share_from``) and captures nothing: before a replay,
a program copies in the item tables of the version it serves when they
are not the ones it holds (a device copy of ``bucket × dim`` elements,
under the program's lock). ``compile_count`` counts captures (programs
built on the CPU) of the shared cache.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    sum_coordinate_margins,
)
from photon_ml_tpu_torch.parallel.mesh import on_slot
from photon_ml_tpu_torch.resilience import fault_point
from photon_ml_tpu_torch.retrieval.index import ItemIndex
from photon_ml_tpu_torch.serving import stages as _stages
from photon_ml_tpu_torch.serving import store as _store
from photon_ml_tpu_torch.serving.engine import (
    CAPTURE_LOCK,
    RequestBatch,
    ScoringEngine,
    next_bucket,
)
from photon_ml_tpu_torch.telemetry import metrics as _metrics
from photon_ml_tpu_torch.telemetry import profiling as _profiling

#: the ``fn`` label of this engine's program builds in
#: ``photon_compiles_total`` (the JAX package's label): one per bucket
#: program built, a CUDA graph capture on the card
RANKING_FN_LABEL = "serving.rank"

#: engine-side ranking latency per (user-bucket, k-bucket) dispatch
_RANK_LATENCY = _metrics.histogram(
    "photon_rank_engine_latency_seconds",
    "Engine ranking time per padded (user-bucket, k-bucket) dispatch",
    labels=("bucket", "k_bucket"))

#: the ranked path feeds the same request-path stage family as /score
_STAGE_SECONDS = _metrics.histogram(
    "photon_serving_stage_seconds",
    "Serving request time per request-path stage "
    "(parse | queue_wait | batch_assemble | execute | respond)",
    labels=("stage",))

class _RankProgram:
    """One (user bucket, k bucket, item bucket) program: its static
    buffers and, on the card, the CUDA graph captured over them."""

    __slots__ = ("lock", "offsets", "margins", "x", "parts", "static",
                 "n_items", "loaded", "vals", "idx", "graph")

    def __init__(self, b: int, n_coords: int, dim: int, index: ItemIndex):
        dev = index.device
        self.lock = threading.Lock()
        self.offsets = torch.zeros(b, dtype=torch.float32, device=dev)
        self.margins = torch.zeros((n_coords, b), dtype=torch.float32,
                                   device=dev)
        self.x = torch.zeros((b, dim), dtype=torch.float32, device=dev)
        self.parts = tuple(
            (torch.empty_like(m), None if sc is None
             else torch.empty_like(sc)) for m, sc in index.parts)
        self.static = torch.empty_like(index.static)
        self.n_items = torch.zeros((), dtype=torch.int64, device=dev)
        #: the index whose item tables the buffers hold
        self.loaded = None
        self.vals = self.idx = self.graph = None

    def load(self, index: ItemIndex) -> None:
        """Stage ``index``'s item tables (a no-op when already staged)."""
        if self.loaded is index:
            return
        for (m, sc), (im, isc) in zip(self.parts, index.parts):
            m.copy_(im)
            if sc is not None:
                sc.copy_(isc)
        self.static.copy_(index.static)
        self.n_items.fill_(index.n_items)
        self.loaded = index


class RankingEngine:
    """Ranks user records against one model version's item axis.

    Built from the version's :class:`~photon_ml_tpu_torch.serving.engine.
    ScoringEngine`: packing and the user-side margins are the scoring
    engine's own, so the ranked path cannot skew from the scored one.
    Thread-safe."""

    def __init__(self, engine: ScoringEngine, index: ItemIndex, *,
                 max_k: int = 128, max_batch: int = 8,
                 share_from: Optional["RankingEngine"] = None):
        self.engine = engine
        self.model = engine.model
        self.index = index
        self.max_k = next_bucket(max_k)
        self.max_batch = next_bucket(max_batch)
        cm = self.model.coordinates.get(index.coordinate_id)
        if cm is None or isinstance(cm, FixedEffectModel):
            raise ValueError(
                f"rank coordinate {index.coordinate_id!r} is not a "
                f"random-effect coordinate of this model "
                f"(have {sorted(self.model.coordinates)})")
        if cm.random_effect_type != index.random_effect_type:
            raise ValueError(
                f"index entity type {index.random_effect_type!r} != "
                f"coordinate's {cm.random_effect_type!r}")
        if index.device != engine.device:
            raise ValueError(f"index is on {index.device}, the engine on "
                             f"{engine.device}")
        self._coords = list(self.model.coordinates.items())
        self._shard_order = [c.shard_id for c in engine.shard_configs]
        self._re_order = [cid for cid, m in self._coords
                          if not isinstance(m, FixedEffectModel)]
        #: random-effect coordinates consumed from the request (all but
        #: the item coordinate)
        self._rank_re_order = [cid for cid in self._re_order
                               if cid != index.coordinate_id]
        self._item_pos = [cid for cid, _ in self._coords].index(
            index.coordinate_id)
        self._item_shard = self._shard_order.index(cm.feature_shard_id)
        #: entity types a bare ``/rank?user=`` id is applied to
        self.user_entity_types = tuple(dict.fromkeys(
            self.model.coordinates[cid].random_effect_type
            for cid in self._rank_re_order))
        root = (share_from._root if share_from is not None
                and self._trace_compatible(share_from) else None)
        if root is not None:
            # a patch-derived version: the parent's programs fit it (the
            # item tables are staged per replay), so it captures nothing
            self._root = root
            return
        self._root = self
        #: (user bucket, k bucket, item bucket) → program; the root's
        self._programs: dict = {}
        self._build_lock = threading.Lock()
        self._compiles = 0  # guarded-by: _build_lock

    def _trace_compatible(self, other: "RankingEngine") -> bool:
        """May this version use ``other``'s programs? True when the
        coordinate structure (ids and kinds in order), shard order, item
        coordinate, item width and storage dtype all match; the item
        bucket is part of a program's key, so a grown one just adds
        programs."""
        return (
            [(cid, isinstance(m, FixedEffectModel))
             for cid, m in self._coords]
            == [(cid, isinstance(m, FixedEffectModel))
                for cid, m in other._coords]
            and self._shard_order == other._shard_order
            and self.index.coordinate_id == other.index.coordinate_id
            and self._rank_re_order == other._rank_re_order
            and self.index.dim == other.index.dim
            and self.index.table_dtype == other.index.table_dtype
            and self.index.slots == other.index.slots
            and self.engine.device == other.engine.device)

    # --- the ranking program ------------------------------------------------
    def _rank_padded(self, prog: _RankProgram, k_b: int):
        """``(scores (b, k_b) f32, item positions (b, k_b))`` of one padded
        user batch against the staged item tables."""
        f64 = torch.float64
        first = prog.x.device
        item_parts = []
        for matrix, scales in prog.parts:
            dev = matrix.device
            with on_slot(dev):
                rows = torch.arange(matrix.shape[0], device=dev)
                tab = _store.gather_rows((matrix, scales), rows, f64)
                x = prog.x.to(dev).to(f64)
                item_parts.append((x[:, None, :] * tab[None, :, :]).sum(
                    dim=2).to(torch.float32).to(first))
        item_margin = (item_parts[0] if len(item_parts) == 1
                       else torch.cat(item_parts, dim=1))
        item_rows = torch.arange(item_margin.shape[1], device=first)
        margins = [item_margin if j == self._item_pos
                   else prog.margins[j][:, None]
                   for j in range(len(self._coords))]
        # the static vector rides as a trailing term: all zeros without an
        # item-feature source, which leaves the pair scores bit-identical
        total = sum_coordinate_margins(prog.offsets[:, None],
                                       margins + [prog.static[None, :]])
        masked = torch.where(item_rows[None, :] < prog.n_items, total,
                             torch.full_like(total, -np.inf))
        vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
        return vals[:, :k_b].contiguous(), idx[:, :k_b].contiguous()

    def _build(self, b: int, k_b: int) -> _RankProgram:
        prog = _RankProgram(b, len(self._coords), self.index.dim, self.index)
        prog.load(self.index)
        dev = prog.x.device
        if dev.type != "cuda" or any(d != dev for d in self.index.slots):
            return prog
        with CAPTURE_LOCK:  # one graph build at a time (serving/engine.py)
            # one eager run on a side stream first (the sort's and the
            # allocator's first blocks), then the capture
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._rank_padded(prog, k_b)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                prog.vals, prog.idx = self._rank_padded(prog, k_b)
        prog.graph = graph
        return prog

    def _program(self, b: int, k_b: int) -> _RankProgram:
        root = self._root
        key = (b, k_b, self.index.bucket)
        prog = root._programs.get(key)
        if prog is None:
            with root._build_lock:
                prog = root._programs.get(key)
                if prog is None:
                    with _profiling.timed_compile(RANKING_FN_LABEL):
                        prog = self._build(b, k_b)
                    root._programs[key] = prog
                    root._compiles += 1
        return prog

    # --- stats ------------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Programs built in this engine's (possibly shared) cache: CUDA
        graph captures on the card. Constant after :meth:`warmup`; a
        patch-derived engine reports its root's count."""
        return self._root._compiles

    @property
    def user_re_coordinates(self) -> tuple:
        """Random-effect coordinates consumed from the request side."""
        return tuple(self._rank_re_order)

    # --- ranking ----------------------------------------------------------
    def rank(self, records: Sequence[dict], ks: Sequence[int]):
        """Top-k per record: ``[(ids, scores), ...]`` with ``ids`` raw item
        ids (best first) and ``scores`` their f32 totals. ``ks`` aligns with
        ``records``; a batch runs at its largest k's bucket and each record
        takes its own k."""
        fault_point("serving.execute", n=len(records), kind="rank")
        with _STAGE_SECONDS.labels(stage="batch_assemble").time() as t:
            batch = self.engine.pack(records)
        _stages.record("batch_assemble", t.seconds)
        return self.rank_batch(batch, ks)

    def rank_batch(self, batch: RequestBatch, ks: Sequence[int]):
        ks = [int(k) for k in ks]
        if len(ks) != batch.n:
            raise ValueError(f"{len(ks)} k values for {batch.n} records")
        for k in ks:
            if not 1 <= k <= self.max_k:
                raise ValueError(f"k must be in [1, {self.max_k}], got {k}")
        out = []
        with _STAGE_SECONDS.labels(stage="execute").time() as t:
            for lo in range(0, batch.n, self.max_batch):
                hi = min(lo + self.max_batch, batch.n)
                out.extend(self._rank_chunk(batch, ks[lo:hi], lo, hi))
        _stages.record("execute", t.seconds)
        return out

    def _rank_chunk(self, batch: RequestBatch, ks, lo: int, hi: int):
        n = hi - lo
        b = next_bucket(n)
        index = self.index
        k_b = min(next_bucket(max(ks)), self.max_k, index.bucket)
        # the user side through the scoring engine's own bucket program
        _, user_margins = self.engine._score_chunk(batch, lo, hi,
                                                   with_margins=True)
        prog = self._program(b, k_b)
        with prog.lock, _RANK_LATENCY.labels(bucket=str(b),
                                             k_bucket=str(k_b)).time():
            prog.load(index)
            prog.offsets[:n].copy_(torch.from_numpy(batch.offsets[lo:hi]))
            prog.margins[:, :n].copy_(torch.from_numpy(
                np.stack(user_margins)))
            prog.x[:n].copy_(torch.from_numpy(
                batch.xs[self._item_shard][lo:hi]))
            if prog.graph is not None:
                prog.graph.replay()
                vals, idx = prog.vals, prog.idx
            else:
                vals, idx = self._rank_padded(prog, k_b)
            vals = vals[:n].cpu().numpy()
            idx = idx[:n].cpu().numpy()
        out = []
        for i in range(n):
            # k may exceed the vocabulary: the padding is -inf, so the
            # first n_items positions are the real items in rank order
            k_i = min(ks[i], index.n_items)
            out.append(([index.item_ids[j] for j in idx[i, :k_i]],
                        vals[i, :k_i].astype(np.float32)))
        return out

    def warmup(self) -> int:
        """Build (on the card: capture) every (user bucket, k bucket)
        program over the current item axis. Returns the number built (0
        for a patch-derived engine sharing a warm cache)."""
        before = self.compile_count
        b = 1
        while b <= self.max_batch:
            empty = RequestBatch(
                n=b, offsets=np.zeros(b, np.float32),
                xs=tuple(np.zeros(
                    (b, len(self.engine.index_maps[c.shard_id])),
                    np.float32) for c in self.engine.shard_configs),
                rows=tuple(np.full(b, self.engine.stores[cid].fallback_row,
                                   np.int32) for cid in self._re_order))
            k = 1
            while k <= min(self.max_k, self.index.bucket):
                self._rank_chunk(empty, [k] * b, 0, b)
                k <<= 1
            b <<= 1
        return self.compile_count - before
