"""Online scoring engine: power-of-two buckets, one CUDA graph each.

Counterpart of ``photon_ml_tpu/serving/engine.py``. Requests arrive at any
batch size; the engine pads every batch up to a power-of-two bucket (1, 2,
4, … ``max_batch``), so the set of bucket programs is fixed and small
(log₂ max_batch + 1). On the card each bucket is one CUDA graph with static
input buffers (offsets, each feature shard's dense rows, each random-effect
coordinate's table rows) and static outputs (the total and the per-
coordinate f32 margins): :meth:`ScoringEngine.warmup` captures all of them
and steady-state serving captures nothing, whatever the request sizes.
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
never read. Not ported: sharing one version's programs with another
(``share_from``; a graph holds its version's table pointers) and the
quality monitor (``monitor`` stays None).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.model import FixedEffectModel, GameModel
from photon_ml_tpu_torch.io.data_reader import (
    FeatureShardConfig,
    _record_features,
)
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.serving import stages as _stages
from photon_ml_tpu_torch.serving import store as _store
from photon_ml_tpu_torch.serving.store import EntityCoefficientStore
from photon_ml_tpu_torch.telemetry import metrics as _metrics
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

    __slots__ = ("lock", "offsets", "xs", "rows", "total", "margins",
                 "graph")

    def __init__(self, offsets, xs, rows):
        self.lock = threading.Lock()
        self.offsets, self.xs, self.rows = offsets, xs, rows
        self.total = self.margins = self.graph = None


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
                 *, max_batch: int = 1024, device=None):
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
        self._fe = {
            cid: cm.model.coefficients.means.detach().to(
                device=self.device, dtype=torch.float32).to(torch.float64)
            for cid, cm in self._coords if isinstance(cm, FixedEffectModel)}
        self._lock = threading.Lock()
        self._n_scored = 0  # guarded-by: _lock
        #: bucket size → program; built under _build_lock
        self._programs: dict[int, _BucketProgram] = {}
        self._build_lock = threading.Lock()
        self._compiles = 0  # guarded-by: _build_lock
        #: the JAX engine's quality monitor hook; not ported, stays None
        self.monitor = None

    # --- the scoring program ----------------------------------------------
    def _score_padded(self, offsets: torch.Tensor, xs, rows):
        """Total and per-coordinate f32 margins of one padded batch: f64
        row dots (``x @ w`` for a fixed effect, ``Σ x·row`` over gathered
        table rows for a random effect), then the summation contract."""
        f64 = torch.float64
        x64 = {sid: x.to(f64) for sid, x in zip(self._shard_order, xs)}
        re_rows = dict(zip(self._re_order, rows))
        margins = []
        for cid, cm in self._coords:
            x = x64[cm.feature_shard_id]
            if isinstance(cm, FixedEffectModel):
                m = torch.mv(x, self._fe[cid])
            else:
                tab = _store.gather_rows(self.stores[cid].device_params,
                                         re_rows[cid], f64)
                m = (x * tab).sum(dim=1)
            margins.append(m.to(torch.float32))
        # sum_coordinate_margins in torch: f32(f64(offset) + Σ f64(mᵢ))
        total = offsets.to(f64)
        for m in margins:
            total = total + m.to(f64)
        return total.to(torch.float32), tuple(margins)

    def _build(self, b: int) -> _BucketProgram:
        dev = self.device
        prog = _BucketProgram(
            offsets=torch.zeros(b, dtype=torch.float32, device=dev),
            xs=tuple(torch.zeros((b, len(self.index_maps[sid])),
                                 dtype=torch.float32, device=dev)
                     for sid in self._shard_order),
            rows=tuple(torch.full((b,), self.stores[cid].fallback_row,
                                  dtype=torch.int32, device=dev)
                       for cid in self._re_order))
        if dev.type != "cuda":
            return prog
        # one eager run on a side stream first (the library handles and
        # the allocator's first blocks), then the capture
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._score_padded(prog.offsets, prog.xs, prog.rows)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: HTTP threads replaying other graphs keep running
        # while this one captures (a reload's warmup, or a first request
        # of this size under --no-warmup)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            prog.total, prog.margins = self._score_padded(
                prog.offsets, prog.xs, prog.rows)
        prog.graph = graph
        return prog

    def _program(self, b: int) -> _BucketProgram:
        prog = self._programs.get(b)
        if prog is None:
            with self._build_lock:
                prog = self._programs.get(b)
                if prog is None:
                    prog = self._build(b)
                    self._programs[b] = prog
                    self._compiles += 1
        return prog

    # --- stats --------------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Bucket programs built so far: CUDA graph captures on the card,
        plain programs on the CPU. Constant after :meth:`warmup`: the
        zero-recompile contract."""
        return self._compiles

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
        with _STAGE_SECONDS.labels(stage="batch_assemble").time() as t:
            batch = self.pack(records)
        _stages.record("batch_assemble", t.seconds)
        return self.score_batch(batch)

    def score_margins(self, records: Sequence[dict]):
        """Scores plus the per-coordinate f32 margins and offsets:
        ``(scores (n,) f32, offsets (n,) f32, [(cid, (n,) f32), ...])`` in
        the model's coordinate order."""
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
        return (out, margins) if with_margins else out

    def _score_chunk(self, batch: RequestBatch, lo: int, hi: int,
                     with_margins: bool = False):
        n = hi - lo
        b = next_bucket(n)
        prog = self._program(b)
        with prog.lock, _SCORE_LATENCY.labels(bucket=str(b)).time():
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
                                                    prog.rows)
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
