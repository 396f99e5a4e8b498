"""Online scoring engine: power-of-two buckets, one CUDA graph each.

Counterpart of ``photon_ml_tpu/serving/engine.py``. Requests arrive at any
batch size; the engine pads every batch up to a power-of-two bucket (1, 2,
4, … ``max_batch``), so the set of bucket programs is fixed and small
(log₂ max_batch + 1). On the card each bucket is one CUDA graph with static
input buffers (offsets, each feature shard's dense rows, each random-effect
coordinate's table rows) and static outputs (the total and the per-
coordinate f32 margins): :meth:`ScoringEngine.warmup` captures all of them
and steady-state serving captures nothing, whatever the request sizes.
Captures in one process run one at a time (:data:`CAPTURE_LOCK`).
``compile_count`` counts captures on the card and bucket programs built on
the CPU. A graph that fails to capture or to replay raises: there is no
eager fallback on the card.

Numeric contract: per-coordinate margins accumulate in float64 on the
device (the configuration of the JAX engine with ``jax_enable_x64``), and
the total runs the reduction of
:func:`photon_ml_tpu_torch.game.model.sum_coordinate_margins`: offsets plus
the f32 margins widened to f64, in the model's coordinate order. Each f32
product is exact in f64, so online f32 scores are bit-identical to
``score_game``'s but where another summation order of a row's f64 sum
lands on the other side of an f32 rounding boundary. Quantized tables
(``bfloat16``, ``int8``) dequantize in the program
(:func:`photon_ml_tpu_torch.serving.store.gather_rows`) and move a score
by at most what their format allows (bf16: 2^-8 of each |x·w| term;
int8: half a row's scale per unit of |x|).

A graph replays on shared static buffers, so each bucket's copy-in, replay
and copy-out runs under that bucket's lock (the JAX jitted call is
reentrant; a replay is not). Only the first ``n`` rows of a bucket's inputs
are written per call: the padding rows keep earlier calls' rows, and since
every output row depends only on its own input row, their outputs are
never read.

Versions and graphs (the port's design for coefficient patches): a graph
holds the device pointers of the random-effect tables it was captured over,
so it scores those tables and no others. The fixed effects' coefficients
are the program's own static buffers instead, loaded from the engine that
replays it when they are not that engine's already (a device copy of a few
hundred bytes, under the bucket's lock). An engine built with
``share_from`` therefore reuses its parent's programs (the JAX engine's
shared executables) when its random-effect tables are the parent's own
tensors and its structure matches: a patch that writes no row of this
host's tables, as on a fleet host whose shard the refresh did not touch,
captures nothing whatever its fixed effects, and ``compile_count`` counts
the shared cache. A patch that writes rows derives fresh tables
(:meth:`~photon_ml_tpu_torch.serving.store.EntityCoefficientStore.
apply_patch`), and its engine captures its own bucket graphs at warmup.
Versions stay immutable: a request still replaying on the parent reads the
parent's tables, and the only buffers versions share are the programs'
inputs, written under the bucket's lock. Each engine captures its buckets
once at warmup and none after, whichever way its version was made. Each
scored batch is handed to the version's quality monitor (``monitor``,
attached by the registry) after the copy to the host, outside the graphs;
brownout's ``quality`` level sheds it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    sum_coordinate_margins,
)
from photon_ml_tpu_torch.io.data_reader import (
    FeatureShardConfig,
    _record_features,
)
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.resilience.faults import fault_point
from photon_ml_tpu_torch.serving import overload as _overload
from photon_ml_tpu_torch.serving import stages as _stages
from photon_ml_tpu_torch.serving import store as _store
from photon_ml_tpu_torch.serving.store import EntityCoefficientStore
from photon_ml_tpu_torch.telemetry import metrics as _metrics
from photon_ml_tpu_torch.telemetry import profiling as _profiling
from photon_ml_tpu_torch.types import INTERCEPT_KEY

#: engine-side scoring time per padded bucket (copy-in, replay, copy-out)
_SCORE_LATENCY = _metrics.histogram(
    "photon_serving_score_latency_seconds",
    "Engine scoring time per padded batch bucket", labels=("bucket",))

#: per-stage request-path critical path (the same family the HTTP front end
#: and the microbatcher feed): the engine owns batch_assemble (records →
#: host arrays) and execute (every chunk of a batch on the device)
_STAGE_SECONDS = _metrics.histogram(
    "photon_serving_stage_seconds",
    "Serving request time per request-path stage "
    "(parse | queue_wait | batch_assemble | execute | respond)",
    labels=("stage",))


#: the ``fn`` label of this engine's program builds in
#: ``photon_compiles_total`` (the JAX package's label): one per bucket
#: program built, a CUDA graph capture on the card
SCORING_FN_LABEL = "serving.score"

#: one CUDA graph build at a time in the process: a capture that names no
#: stream records on torch's one default capture stream, and the side
#: streams of the eager run before it come from torch's round-robin stream
#: pool, so one of them can be that stream; two threads building at once
#: (a fleet's in-process hosts preparing an epoch, or their first requests
#: under --no-warmup) would record into, or wait inside, each other's
#: capture. Replays need no lock: they run on the caller's stream
CAPTURE_LOCK = threading.Lock()


def next_bucket(n: int) -> int:
    """Smallest power of two ≥ max(n, 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class RequestBatch:
    """Host arrays for one batch of scoring requests: per-shard dense
    designs, per-random-effect-coordinate store rows, offsets."""

    n: int
    offsets: np.ndarray  # (n,) float32
    xs: tuple  # per shard config: (n, dim) float32
    rows: tuple  # per RE coordinate: (n,) int32 store rows


class _BucketProgram:
    """One bucket's program: its static buffers and, on the card, the
    CUDA graph captured over them (None on the CPU, where the plain
    function runs on the buffers)."""

    __slots__ = ("lock", "offsets", "xs", "rows", "fe", "fe_of", "total",
                 "margins", "graph")

    def __init__(self, offsets, xs, rows, fe):
        self.lock = threading.Lock()
        self.offsets, self.xs, self.rows = offsets, xs, rows
        #: the fixed effects' f64 coefficients, and the engine they are
        #: loaded from
        self.fe, self.fe_of = fe, None
        self.total = self.margins = self.graph = None

    def load_fe(self, engine: "ScoringEngine") -> None:
        """Copy ``engine``'s fixed-effect coefficients into the program's
        buffers unless they are there already (under :attr:`lock`)."""
        if self.fe_of is engine:
            return
        for buf, cid in zip(self.fe, engine._fe_order):
            buf.copy_(engine._fe[cid])
        self.fe_of = engine


class ScoringEngine:
    """Scores request records against one loaded GAME model version.

    One engine per :class:`~photon_ml_tpu_torch.serving.registry.
    ServingModel` version: a hot swap installs a new engine, so an engine's
    bucket programs always hold its own coefficients. Thread-safe.
    """

    def __init__(self, model: GameModel,
                 shard_configs: Sequence[FeatureShardConfig],
                 index_maps: Mapping[str, IndexMap],
                 stores: Mapping[str, EntityCoefficientStore],
                 *, max_batch: int = 1024, device=None,
                 share_from: Optional["ScoringEngine"] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # tensors made on "cuda" land on the current device, and carry
            # its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model
        self.shard_configs = tuple(shard_configs)
        self.index_maps = dict(index_maps)
        self.stores = dict(stores)
        self.max_batch = next_bucket(max_batch)
        self._shard_order = [c.shard_id for c in self.shard_configs]
        # the model's coordinate order: the summation contract is
        # order-sensitive and the batch path walks the same dict
        self._coords = list(model.coordinates.items())
        self._re_order = [cid for cid, cm in self._coords
                          if not isinstance(cm, FixedEffectModel)]
        for cid in self._re_order:
            if cid not in self.stores:
                raise ValueError(f"no EntityCoefficientStore for "
                                 f"random-effect coordinate {cid!r}")
            if self.stores[cid].table.device != self.device:
                raise ValueError(
                    f"store {cid!r} is on {self.stores[cid].table.device}, "
                    f"the engine on {self.device}")
        self._fe_order = [cid for cid, cm in self._coords
                          if isinstance(cm, FixedEffectModel)]
        self._fe = {
            cid: cm.model.coefficients.means.detach().to(
                device=self.device, dtype=torch.float32).to(torch.float64)
            for cid, cm in self._coords if isinstance(cm, FixedEffectModel)}
        self._lock = threading.Lock()
        self._n_scored = 0  # guarded-by: _lock
        #: the engine owning the program cache: this one, or with
        #: share_from a compatible parent's root
        self._root = self
        if share_from is not None and self._shares_tables(share_from):
            self._root = share_from._root
        else:
            #: bucket size → program; built under _build_lock
            self._programs: dict[int, _BucketProgram] = {}
            self._build_lock = threading.Lock()
            self._compiles = 0  # guarded-by: _build_lock
        #: the version's online quality monitor
        #: (:class:`~photon_ml_tpu_torch.quality.monitor.QualityMonitor`),
        #: attached by the registry at load; None = no accumulation
        self.monitor = None

    def _shares_tables(self, other: "ScoringEngine") -> bool:
        """May this engine replay ``other``'s programs? True when the
        coordinate structure (ids and kinds in order), the feature shards
        and widths, the bucket range and the device match and every
        random-effect table is ``other``'s own tensor."""
        def structure(e):
            return ([(cid, isinstance(cm, FixedEffectModel))
                     for cid, cm in e._coords],
                    [(sid, len(e.index_maps[sid])) for sid in e._shard_order],
                    [c.feature_shard_id for _, c in e._coords],
                    e.max_batch, e.device)

        if structure(self) != structure(other):
            return False
        for cid in self._re_order:
            mine, theirs = self.stores[cid], other.stores[cid]
            if mine.table is not theirs.table \
                    or mine.scales is not theirs.scales:
                return False
        return True

    # --- the scoring program ----------------------------------------------
    def _score_padded(self, offsets: torch.Tensor, xs, rows, fe):
        """Total and per-coordinate f32 margins of one padded batch: f64
        row dots (``x @ w`` for a fixed effect, ``Σ x·row`` over gathered
        table rows for a random effect), then the summation contract."""
        f64 = torch.float64
        x64 = {sid: x.to(f64) for sid, x in zip(self._shard_order, xs)}
        re_rows = dict(zip(self._re_order, rows))
        fe_w = dict(zip(self._fe_order, fe))
        margins = []
        for cid, cm in self._coords:
            x = x64[cm.feature_shard_id]
            if isinstance(cm, FixedEffectModel):
                m = torch.mv(x, fe_w[cid])
            else:
                tab = _store.gather_rows(self.stores[cid].device_params,
                                         re_rows[cid], f64)
                m = (x * tab).sum(dim=1)
            margins.append(m.to(torch.float32))
        return sum_coordinate_margins(offsets, margins), tuple(margins)

    def _build(self, b: int) -> _BucketProgram:
        dev = self.device
        prog = _BucketProgram(
            offsets=torch.zeros(b, dtype=torch.float32, device=dev),
            xs=tuple(torch.zeros((b, len(self.index_maps[sid])),
                                 dtype=torch.float32, device=dev)
                     for sid in self._shard_order),
            rows=tuple(torch.full((b,), self.stores[cid].fallback_row,
                                  dtype=torch.int32, device=dev)
                       for cid in self._re_order),
            fe=tuple(torch.empty_like(self._fe[cid])
                     for cid in self._fe_order))
        prog.load_fe(self)
        if dev.type != "cuda":
            return prog
        # thread_local: HTTP threads replaying other graphs keep running
        # while this one captures (a reload's warmup, or a first request
        # of this size under --no-warmup)
        with CAPTURE_LOCK:
            # one eager run on a side stream first (the library handles
            # and the allocator's first blocks), then the capture
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._score_padded(prog.offsets, prog.xs, prog.rows, prog.fe)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                prog.total, prog.margins = self._score_padded(
                    prog.offsets, prog.xs, prog.rows, prog.fe)
        prog.graph = graph
        return prog

    def _program(self, b: int) -> _BucketProgram:
        root = self._root
        prog = root._programs.get(b)
        if prog is None:
            with root._build_lock:
                prog = root._programs.get(b)
                if prog is None:
                    with _profiling.timed_compile(SCORING_FN_LABEL):
                        prog = self._build(b)
                    root._programs[b] = prog
                    root._compiles += 1
        return prog

    # --- stats --------------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Bucket programs built so far in this engine's (possibly shared)
        cache: CUDA graph captures on the card, plain programs on the CPU.
        Constant after :meth:`warmup`: the zero-recompile contract; an
        engine sharing its parent's programs reports their count, so a
        swap that captured nothing leaves it unchanged."""
        return self._root._compiles

    @property
    def n_scored(self) -> int:
        return self._n_scored

    # --- request packing ----------------------------------------------------
    def pack(self, records: Sequence[dict]) -> RequestBatch:
        """Records (TrainingExampleAvro-shaped dicts: ``features`` list,
        ``metadataMap``, optional ``offset``) → host arrays.

        Feature handling mirrors the batch reader: bag filtering, index-map
        lookup (unknown keys dropped), the intercept column, duplicate
        (row, col) entries accumulating in f32.
        """
        n = len(records)
        offsets = np.zeros(n, np.float32)
        for i, rec in enumerate(records):
            off = rec.get("offset")
            if off is not None:
                offsets[i] = off
        xs = []
        for cfg in self.shard_configs:
            imap = self.index_maps[cfg.shard_id]
            x = np.zeros((n, len(imap)), np.float32)
            get = imap.key_to_index.get
            for i, rec in enumerate(records):
                for key, value in _record_features(rec, cfg.feature_bags):
                    j = get(key)
                    if j is not None:
                        x[i, j] += np.float32(value)
                if cfg.has_intercept:
                    x[i, imap.key_to_index[INTERCEPT_KEY]] += np.float32(1.0)
            xs.append(x)
        rows = []
        for cid in self._re_order:
            store = self.stores[cid]
            raw = [(rec.get("metadataMap") or {}).get(store.random_effect_type)
                   for rec in records]
            rows.append(store.rows_for(raw))
        return RequestBatch(n=n, offsets=offsets, xs=tuple(xs),
                            rows=tuple(rows))

    # --- scoring ------------------------------------------------------------
    def score(self, records: Sequence[dict]) -> np.ndarray:
        """Total GAME score per record (float32, batch-path parity)."""
        # the serving chaos site, once a scoring call and before any stage
        # work: an injected fault fails this batch (its futures get the
        # error; the batcher's worker lives on)
        fault_point("serving.execute", n=len(records))
        with _STAGE_SECONDS.labels(stage="batch_assemble").time() as t:
            batch = self.pack(records)
        _stages.record("batch_assemble", t.seconds)
        return self.score_batch(batch)

    def score_margins(self, records: Sequence[dict]):
        """Scores plus the per-coordinate f32 margins and offsets:
        ``(scores (n,) f32, offsets (n,) f32, [(cid, (n,) f32), ...])`` in
        the model's coordinate order."""
        fault_point("serving.execute", n=len(records))
        with _STAGE_SECONDS.labels(stage="batch_assemble").time() as t:
            batch = self.pack(records)
        _stages.record("batch_assemble", t.seconds)
        scores, margins = self.score_batch(batch, with_margins=True)
        return scores, batch.offsets, \
            [(cid, m) for (cid, _cm), m in zip(self._coords, margins)]

    def score_batch(self, batch: RequestBatch, with_margins: bool = False):
        out = np.empty(batch.n, np.float32)
        margins = ([np.empty(batch.n, np.float32) for _ in self._coords]
                   if with_margins else None)
        # batches past the largest bucket chunk: each row is scored on its
        # own, so the split leaves scores unchanged
        with _STAGE_SECONDS.labels(stage="execute").time() as exec_t:
            for lo in range(0, batch.n, self.max_batch):
                hi = min(lo + self.max_batch, batch.n)
                chunk, chunk_margins = self._score_chunk(
                    batch, lo, hi, with_margins=with_margins)
                out[lo:hi] = chunk
                if with_margins:
                    for j, m in enumerate(chunk_margins):
                        margins[j][lo:hi] = m
        _stages.record("execute", exec_t.seconds)
        with self._lock:
            self._n_scored += batch.n
        monitor = self.monitor
        if monitor is not None and not _overload.is_shed("quality"):
            # live quality accumulation (brownout level 2+ sheds it as
            # optional work): fallback-row hits per coordinate and nonzero
            # design cells per shard, host facts this batch already holds
            cold = {
                cid: int(np.count_nonzero(
                    np.asarray(r) == self.stores[cid].fallback_row))
                for cid, r in zip(self._re_order, batch.rows)}
            coverage = {
                cfg.shard_id: (int(np.count_nonzero(x)), int(x.size))
                for cfg, x in zip(self.shard_configs, batch.xs)}
            monitor.observe(out, cold=cold, coverage=coverage)
        return (out, margins) if with_margins else out

    def _score_chunk(self, batch: RequestBatch, lo: int, hi: int,
                     with_margins: bool = False):
        n = hi - lo
        b = next_bucket(n)
        prog = self._program(b)
        with prog.lock, _SCORE_LATENCY.labels(bucket=str(b)).time():
            prog.load_fe(self)
            prog.offsets[:n].copy_(torch.from_numpy(batch.offsets[lo:hi]))
            for buf, x in zip(prog.xs, batch.xs):
                buf[:n].copy_(torch.from_numpy(x[lo:hi]))
            for buf, r in zip(prog.rows, batch.rows):
                buf[:n].copy_(torch.from_numpy(np.asarray(r[lo:hi],
                                                          np.int32)))
            if prog.graph is not None:
                prog.graph.replay()
                total, margins = prog.total, prog.margins
            else:
                total, margins = self._score_padded(prog.offsets, prog.xs,
                                                    prog.rows, prog.fe)
            # the copy to the host waits for the device: inside the timer
            out = total[:n].cpu().numpy()
            out_margins = ([m[:n].cpu().numpy() for m in margins]
                           if with_margins else None)
        return out, out_margins

    def warmup(self, max_bucket: Optional[int] = None) -> int:
        """Build (on the card: capture) every bucket program (1, 2, 4, …
        ``max_batch``) and replay each once, so live traffic never waits
        on a capture. Returns the number of programs built."""
        top = self.max_batch if max_bucket is None else next_bucket(max_bucket)
        before = self.compile_count
        b = 1
        while b <= top:
            empty = RequestBatch(
                n=b, offsets=np.zeros(b, np.float32),
                xs=tuple(np.zeros((b, len(self.index_maps[sid])), np.float32)
                         for sid in self._shard_order),
                rows=tuple(np.full(b, self.stores[cid].fallback_row,
                                   np.int32) for cid in self._re_order))
            self._score_chunk(empty, 0, b)
            b <<= 1
        return self.compile_count - before
