"""Durable request/score log: bounded, sampled Avro segments per request.

Counterpart of ``photon_ml_tpu/serving/reqlog.py``; the segments are the
same ``RequestLogAvro`` records (:mod:`photon_ml_tpu_torch.io.schemas`), so
either package reads the other's log.

- one Avro record per served request: request id, wall timestamp, the
  version and content lineage that scored it, the front end's per-stage
  timings, and the scored records (features, entity ids, offset, the f32
  score widened to double, which is exact);
- **sampled** deterministically by request id (``crc32(id)`` against
  ``sample_rate``, through the one hashing home,
  :mod:`photon_ml_tpu_torch.fleet.sharding`): the same request logs on
  every host or on none;
- **segmented and rotated**: records buffer in memory and flush as whole
  Avro files (``reqlog-NNNNNNNN.avro``) every ``segment_records``
  requests; ``max_bytes`` bounds the directory by deleting the oldest
  segments (retention, counted apart from loss);
- **off the request path**: segment writes run on the log's own
  one-thread writer, under the ``io.save.reqlog`` fault site. A writer
  more than ``BUFFERED_SEGMENTS`` segments behind makes new records drop,
  counted: backpressure degrades the log, never the traffic;
- ``photon_reqlog_records_total`` / ``photon_reqlog_bytes_total`` /
  ``photon_reqlog_dropped_total`` count what was written and lost, and
  ``/healthz`` mirrors them.

Each record's ``stageMs`` holds the front end's ``parse`` and the
request's ``score`` wall, as the JAX service logs them.

This module is the one writer of ``RequestLogAvro`` files.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Optional, Sequence

from photon_ml_tpu_torch.io.avro import iter_avro_file, write_avro_file
from photon_ml_tpu_torch.io.schemas import REQUEST_LOG_AVRO
from photon_ml_tpu_torch.fleet.sharding import crc_bucket
from photon_ml_tpu_torch.resilience.faults import fault_point
from photon_ml_tpu_torch.serving import overload as _overload
from photon_ml_tpu_torch.telemetry import metrics as _metrics

_RECORDS_TOTAL = _metrics.counter(
    "photon_reqlog_records_total",
    "Request-log records durably written (post-sampling)")
_BYTES_TOTAL = _metrics.counter(
    "photon_reqlog_bytes_total",
    "Bytes of request-log Avro segments written")
_DROPPED_TOTAL = _metrics.counter(
    "photon_reqlog_dropped_total",
    "Request-log records LOST after sampling selected them: writer "
    "backpressure past the buffer budget, or failed segment writes")

#: sampling hash granularity: crc32(request id) % _SAMPLE_MOD < rate * MOD
_SAMPLE_MOD = 1 << 16

#: backpressure budget, in segments: the records not yet durable (the
#: buffer plus the segments submitted and not yet written) stay below
#: ``BUFFERED_SEGMENTS * segment_records`` (the JAX log's default budget)
BUFFERED_SEGMENTS = 8


class RequestLog:
    """Bounded, sampled, background-written Avro request/score log.

    Thread-safe. Segments are written in order on one writer thread,
    stopped by :meth:`close`.
    """

    def __init__(self, log_dir: str, *, sample_rate: float = 1.0,
                 segment_records: int = 256,
                 max_bytes: int = 64 << 20):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}")
        if segment_records < 1:
            raise ValueError(
                f"segment_records must be >= 1, got {segment_records}")
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.sample_rate = float(sample_rate)
        self.segment_records = int(segment_records)
        self.max_bytes = int(max_bytes)
        self.max_buffered = BUFFERED_SEGMENTS * self.segment_records
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="photon-reqlog")
        self._lock = threading.Lock()
        self._buffer: list[dict] = []  # guarded-by: _lock
        self._in_flight = 0  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        #: [path, records, bytes] of live segments, oldest first (what
        #: rotation walks)
        self._segments: list[list] = []  # guarded-by: _lock  # photon-lint: disable=res-bounded-queue -- bounded by max_bytes: _rotate()'s pop(0) IS the bound (retention, not a request queue)
        self._closed = False  # guarded-by: _lock
        #: this log's outstanding segment futures, pruned as they complete
        self._futures: list = []  # guarded-by: _lock
        self.n_records = 0  # guarded-by: _lock
        self.n_bytes = 0  # guarded-by: _lock
        self.n_dropped = 0  # guarded-by: _lock
        self.n_rotated = 0  # guarded-by: _lock

    # --- sampling ---------------------------------------------------------
    def should_log(self, request_id: str) -> bool:
        """Deterministic per-id sampling (same id, same verdict on every
        host and every retry). Brownout level 1 and up suspends it: the
        log is the first optional work shed under overload."""
        if _overload.is_shed("reqlog"):
            return False
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        h = crc_bucket(str(request_id), _SAMPLE_MOD)
        return h < int(self.sample_rate * _SAMPLE_MOD)

    # --- logging ----------------------------------------------------------
    def log(self, *, request_id: str, records: Sequence[dict],
            scores: Sequence[float], version: int,
            lineage: Optional[str] = None,
            stage_ms: Optional[Mapping[str, float]] = None,
            kind: str = "score",
            topk: Optional[Mapping] = None) -> bool:
        """Append one served request. Returns True when it was accepted
        into the log, False when sampled out or dropped on backpressure.
        ``kind`` marks the workload (``score`` | ``rank``); a ranked
        request logs its request record (score 0.0) and the returned result
        in ``topk`` (``{"k", "ids", "scores"}``)."""
        if not self.should_log(request_id):
            return False
        entry = {
            "requestId": str(request_id),
            "ts": time.time(),
            "kind": str(kind),
            "modelVersion": int(version if version is not None else -1),
            "modelLineage": lineage,
            "stageMs": {k: float(v) for k, v in (stage_ms or {}).items()},
            "records": [{
                "features": [{"name": f.get("name", ""),
                              "term": f.get("term") or "",
                              "value": float(f.get("value", 0.0))}
                             for f in (rec.get("features") or [])],
                "metadataMap": rec.get("metadataMap"),
                "offset": (None if rec.get("offset") is None
                           else float(rec["offset"])),
                "score": float(s),
                "label": (None if rec.get("label") is None
                          else float(rec["label"])),
            } for rec, s in zip(records, scores)],
            "topk": None if topk is None else {
                "k": int(topk["k"]),
                "ids": [str(i) for i in topk["ids"]],
                # f32 scores widened to double: exact
                "scores": [float(v) for v in topk["scores"]],
            },
        }
        flush_batch = None
        with self._lock:
            if self._closed:
                return False
            if len(self._buffer) + self._in_flight >= self.max_buffered:
                # the writer is behind its budget: drop the log record,
                # never the request, and count the loss
                self.n_dropped += 1
                _DROPPED_TOTAL.inc()
                return False
            self._buffer.append(entry)
            if len(self._buffer) >= self.segment_records:
                flush_batch = self._take_buffer_locked()
        if flush_batch is not None:
            self._submit_segment(flush_batch)
        return True

    def flush(self) -> None:
        """Submit whatever is buffered as a (possibly short) segment."""
        with self._lock:
            batch = self._take_buffer_locked()
        if batch is not None:
            self._submit_segment(batch)

    # --- segment machinery ------------------------------------------------
    def _take_buffer_locked(self):
        if not self._buffer:
            return None
        batch, self._buffer = self._buffer, []
        self._seq += 1
        self._in_flight += len(batch)
        return (self._seq, batch)

    def _submit_segment(self, seq_batch) -> None:
        seq, batch = seq_batch
        path = os.path.join(self.log_dir, f"reqlog-{seq:08d}.avro")

        def write() -> None:
            tmp = path + ".tmp"
            try:
                fault_point("io.save.reqlog", path=path)
                write_avro_file(tmp, batch, REQUEST_LOG_AVRO)
                os.replace(tmp, path)
            except Exception as e:
                # a failed segment is loss, counted; the log never fails
                # serving or shutdown
                if os.path.exists(tmp):
                    os.unlink(tmp)
                with self._lock:
                    self._in_flight -= len(batch)
                    self.n_dropped += len(batch)
                _DROPPED_TOTAL.inc(len(batch))
                logging.getLogger(__name__).error(
                    "reqlog segment write %s failed: %r", path, e)
                return
            size = os.path.getsize(path)
            with self._lock:
                self._in_flight -= len(batch)
                self._segments.append([path, len(batch), size])
                self.n_records += len(batch)
                self.n_bytes += size
            _RECORDS_TOTAL.inc(len(batch))
            _BYTES_TOTAL.inc(size)
            self._rotate()

        fut = self._writer.submit(write)
        with self._lock:
            self._futures = [f for f in self._futures if not f.done()]
            self._futures.append(fut)

    def _rotate(self) -> None:
        """Retention: delete the oldest segments while the directory holds
        more than ``max_bytes``. Rotated records were written and counted
        first: retention, not loss."""
        while True:
            with self._lock:
                total = sum(seg[2] for seg in self._segments)
                if total <= self.max_bytes or len(self._segments) <= 1:
                    return
                path, n, _size = self._segments.pop(0)
                self.n_rotated += n
            try:
                os.unlink(path)
            except OSError:
                pass

    # --- introspection ----------------------------------------------------
    @property
    def writer(self):
        """The segment writer's pool: what the capacity plane's
        ``saver_pool`` probe watches (the JAX log's background saver)."""
        return self._writer

    def stats(self) -> dict:
        """The ``/healthz`` block: the budget counters and the config."""
        with self._lock:
            return {
                "dir": self.log_dir,
                "sample_rate": self.sample_rate,
                "records": self.n_records,
                "bytes": self.n_bytes,
                "dropped": self.n_dropped,
                "rotated": self.n_rotated,
                "buffered": len(self._buffer) + self._in_flight,
                "segments": len(self._segments),
            }

    def close(self) -> None:
        """Flush the tail segment, wait for this log's writes (their
        errors are already counted as drops) and stop the writer."""
        with self._lock:
            if self._closed:
                return
        self.flush()
        with self._lock:
            self._closed = True
            futures, self._futures = self._futures, []
        for fut in futures:
            try:
                fut.result()
            except Exception:
                pass  # counted as dropped by the write job
        self._writer.shutdown(wait=True)


def iter_reqlog(log_dir: str):
    """Every logged request record of a directory's segments, oldest
    segment first (``.tmp`` staging files of a writer in progress are
    never read)."""
    for name in sorted(os.listdir(log_dir)):
        if not (name.startswith("reqlog-") and name.endswith(".avro")):
            continue
        yield from iter_avro_file(os.path.join(log_dir, name))
