"""Microbatching queue: coalesce single requests into engine-sized batches.

A copy of ``photon_ml_tpu/serving/batcher.py`` (host code).

Online GLMix traffic is dominated by batch-size-1 requests, but the engine's
per-call overhead (pack, pad, dispatch) amortizes across a batch — and the
power-of-two buckets mean a batch of 8 costs barely more than a batch of 1.
The batcher trades a bounded wait (``max_wait_ms``, default 2 ms) for that
amortization: submitters enqueue and get a Future; a single worker thread
drains up to ``max_batch`` requests per scoring call, waiting at most
``max_wait_ms`` after the first request of a batch arrives before firing.

Swap interaction: the score function is resolved PER BATCH (the registry's
active engine), so a hot-swap takes effect at the next batch boundary and a
batch never mixes versions.

Admission control: ``max_queue`` bounds the queue — a submit against a
full queue is refused with a typed
:class:`~photon_ml_tpu_torch.serving.overload.Shed` (``reason="queue_full"``,
mapped to 429 by the HTTP layer) instead of parking behind work the host
cannot catch up on. Requests may carry a monotonic ``deadline``; the
drain checks it as each batch assembles and sheds expired entries
(``reason="deadline"``) rather than scoring for a caller that already gave
up — a shed request NEVER reaches the engine's execute stage. A
``score(timeout=)`` caller that times out cancels its Future, and the
drain discards cancelled (abandoned) entries without letting them consume
a batch slot.

Worker-death contract: an ordinary scoring exception fails only its batch
(the Futures get the exception, the worker keeps draining). Anything that
escapes that per-batch handling — a BaseException out of the score fn, a
bug in the drain loop itself — fails the in-flight batch and every queued
Future with a ``RuntimeError`` naming the cause, and later :meth:`submit`
calls raise the same error instead of enqueueing into a dead batcher.

Observability: each request's time parked in the queue lands in
``photon_serving_stage_seconds{stage="queue_wait"}`` — one stage of the
request-path critical path. Enqueue stamps ``time.monotonic()`` (a
scheduling clock, the source for cross-thread deadlines and waits) and the
drain observes the delta into the registry histogram.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.serving import overload as _overload
from photon_ml_tpu_torch.serving import stages as _stages
from photon_ml_tpu_torch.telemetry import metrics as _metrics

#: how well the linger window coalesces traffic — the distribution should
#: shift right as load rises (that's the amortization working)
_BATCH_SIZE = _metrics.histogram(
    "photon_serving_batch_size",
    "Coalesced records per microbatcher scoring call",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
#: requests parked in the queue right now (sampled at enqueue/drain).
#: Host-owned: in a serving fleet each process has its own queue, so a
#: fleet aggregate fans this out under a ``process`` label.
_QUEUE_DEPTH = _metrics.gauge(
    "photon_serving_queue_depth", "Microbatcher queue depth")
_metrics.mark_host_owned("photon_serving_queue_depth")
#: per-stage request-path critical path (parse, queue_wait, batch_assemble,
#: execute, respond) — this module owns the queue_wait stage
_STAGE_SECONDS = _metrics.histogram(
    "photon_serving_stage_seconds",
    "Serving request time per request-path stage "
    "(parse | queue_wait | batch_assemble | execute | respond)",
    labels=("stage",))


class BatcherClosed(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` once :meth:`close` ran —
    the host is draining. The HTTP layer maps it to a typed 503
    ``reason=stopping`` (and closes the connection) so a fleet router
    retries the leg on a replica instead of surfacing a 500 from a
    stopping host."""


def _resolve(fut: Future, *, result=None, exception=None) -> None:
    """Set a Future's outcome, tolerating cancelled futures — a submitter
    that gave up must not take the worker (or the abort path) down."""
    try:
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


class MicroBatcher:
    """Single-worker request coalescer in front of a scoring callable.

    ``score_fn(records) -> np.ndarray`` scores one homogeneous batch (the
    registry's active version). Thread-safe; :meth:`submit` never blocks
    beyond the queue lock. ``max_queue=None`` leaves the queue unbounded
    (embedder's choice — ``serve_game`` always bounds it). ``coerce``
    maps each per-record result onto its Future (default ``float`` — the
    historical scalar-score contract); the ranked path passes records as
    opaque ``(record, k)`` tuples with a ``score_fn`` returning a
    1-D object array of ``(ids, scores)`` results and an identity
    ``coerce``.
    """

    def __init__(self, score_fn: Callable[[Sequence[dict]], np.ndarray], *,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 max_queue: Optional[int] = None,
                 coerce: Callable = float):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (or None for "
                             f"unbounded), got {max_queue}")
        self._score_fn = score_fn
        self._coerce = coerce
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_queue = max_queue
        self._cond = threading.Condition()
        # bounded by the max_queue admission check in submit() (a maxlen
        # deque would silently evict — shedding must be loud and typed)
        self._queue: collections.deque = collections.deque()  # guarded-by: _cond  # photon-lint: disable=res-bounded-queue -- bounded by the explicit max_queue Shed check in submit(); maxlen would drop silently
        self._closed = False  # guarded-by: _cond
        #: the BaseException that killed the worker, None while healthy
        self._dead: Optional[BaseException] = None  # guarded-by: _cond
        #: the batch the worker is scoring right now — failed alongside the
        #: queue if the worker dies mid-score
        self._inflight: list = []  # guarded-by: _cond
        self.n_batches = 0  # guarded-by: _cond
        #: requests that shared a batch with others
        self.n_coalesced = 0  # guarded-by: _cond
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="photon-serving-batcher")
        self._worker.start()

    @property
    def dead(self) -> Optional[BaseException]:
        """The exception that killed the worker, None while healthy (the
        ``/readyz`` liveness signal)."""
        with self._cond:
            return self._dead

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def submit(self, record: dict,
               deadline: Optional[float] = None,
               stage_out: Optional[dict] = None) -> "Future[float]":
        """Enqueue one record; the Future resolves to its float score.
        ``deadline`` is an absolute ``time.monotonic()`` instant — an
        entry still queued past it is shed at drain time. ``stage_out``,
        when given, receives this request's stage seconds (its own
        queue_wait plus the batch's assemble/execute — every rider of a
        micro-batch paid the whole batch's wall) for the fleet
        leg-summary side channel; ContextVars don't cross the worker
        thread, so the sink rides the entry. Raises
        :class:`~photon_ml_tpu_torch.serving.overload.Shed` when the bounded
        queue is full, RuntimeError once the batcher is closed or its
        worker has died."""
        import time

        fut: Future = Future()
        with self._cond:
            if self._dead is not None:
                raise RuntimeError(
                    f"batcher worker died: {self._dead!r}") from self._dead
            if self._closed:
                raise BatcherClosed("batcher is closed")
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                # admission control: refuse NOW (429 + Retry-After at the
                # HTTP layer) instead of queueing work the host is too far
                # behind to finish before the caller gives up
                raise _overload.shed(
                    "queue_full",
                    message=f"queue full ({len(self._queue)}/"
                            f"{self.max_queue} requests waiting)",
                    retry_after_s=max(self.max_wait_s * 2, 0.05))
            self._queue.append(
                (record, fut, time.monotonic(), deadline, stage_out))
            _QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify()
        return fut

    def score(self, record: dict, timeout: Optional[float] = None,
              deadline: Optional[float] = None,
              stage_out: Optional[dict] = None) -> float:
        """Blocking convenience wrapper around :meth:`submit`. On timeout
        the Future is cancelled so the abandoned entry is discarded at
        drain time instead of consuming a batch slot."""
        fut = self.submit(record, deadline=deadline, stage_out=stage_out)
        try:
            return fut.result(timeout=timeout)
        except FutureTimeoutError:
            fut.cancel()
            raise

    def close(self) -> None:
        """Drain outstanding work, then stop the worker."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._worker.join()

    # --- worker -----------------------------------------------------------
    def _run(self) -> None:
        try:
            while True:
                batch = self._next_batch()
                if batch is None:
                    return
                self._process(batch)
        except BaseException as e:
            # the drain loop itself died (BaseException out of the score
            # fn, a bug in the batching machinery): without this, queued
            # Futures hang forever and submitters keep feeding a queue
            # nothing reads
            self._abort(e)
            raise

    def _process(self, batch: list) -> None:
        import time

        records = [r for r, _, _, _, _ in batch]
        _BATCH_SIZE.observe(len(records))
        now = time.monotonic()
        wait_hist = _STAGE_SECONDS.labels(stage="queue_wait")
        for _, _, t_enq, _, stage_out in batch:
            waited = max(now - t_enq, 0.0)
            wait_hist.observe(waited)
            if stage_out is not None:
                stage_out["queue_wait"] = waited
        with self._cond:
            self._inflight = batch
        # NOTE: _inflight is cleared only on the resolved paths below — a
        # BaseException escaping this method must leave it set so _abort
        # can fail the very batch that killed the worker
        batch_stages: dict = {}
        try:
            with _stages.collect(batch_stages):
                scores = self._score_fn(records)
        except Exception as e:  # score failure fails THIS batch only
            self._finish(batch, exception=e)
            return
        # the engine timed assemble/execute once for the whole batch;
        # every rider waited on that same wall, so each sink gets the
        # batch-level seconds (leg-summary semantics, not attribution)
        for _, _, _, _, stage_out in batch:
            if stage_out is not None:
                stage_out.update(batch_stages)
        arr = np.asarray(scores)
        if arr.shape[:1] != (len(batch),):
            # contract violation from the score fn: fail the batch loudly
            # instead of silently zip-truncating some Futures into an
            # eternal hang
            self._finish(batch, exception=RuntimeError(
                f"score_fn returned {arr.shape[:1] or (0,)} scores "
                f"for a batch of {len(batch)}"))
            return
        with self._cond:
            # the worker is the only writer, but healthz/tests read these
            # stats from other threads — the lock-discipline pass flagged
            # the bare increments
            self.n_batches += 1
            if len(batch) > 1:
                self.n_coalesced += len(batch)
        self._finish(batch, scores=arr)

    def _finish(self, batch: list, *, scores=None, exception=None) -> None:
        if exception is not None:
            for _, fut, _, _, _ in batch:
                _resolve(fut, exception=exception)
        else:
            for (_, fut, _, _, _), s in zip(batch, scores):
                _resolve(fut, result=self._coerce(s))
        with self._cond:
            self._inflight = []

    def _abort(self, exc: BaseException) -> None:
        """Worker death: fail the in-flight batch and every queued Future,
        and poison future submissions."""
        with self._cond:
            self._dead = exc
            pending = list(self._inflight) + list(self._queue)
            self._inflight = []
            self._queue.clear()
            _QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        err = RuntimeError(f"batcher worker died: {exc!r}")
        err.__cause__ = exc
        for _, fut, _, _, _ in pending:
            _resolve(fut, exception=err)

    def _next_batch(self):
        """Block for the first request, then linger ``max_wait_s`` for
        followers (or until ``max_batch`` is reached). Expired-deadline
        entries are shed here — at queue drain, before any batch
        assembly — and cancelled (abandoned) entries are discarded;
        neither consumes a batch slot or reaches the score fn. None =
        closed and drained."""
        import time

        while True:
            expired = []
            with self._cond:
                while not self._queue:
                    if self._closed:
                        return None
                    self._cond.wait()
                if self.max_wait_s > 0:
                    linger = time.monotonic() + self.max_wait_s
                    while (len(self._queue) < self.max_batch
                           and not self._closed):
                        remaining = linger - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                out = []
                now = time.monotonic()
                while self._queue and len(out) < self.max_batch:
                    entry = self._queue.popleft()
                    _, fut, _, deadline, _ = entry
                    if fut.cancelled():
                        # abandoned by a timed-out score() caller: the
                        # request has no listener — don't spend a slot
                        continue
                    if deadline is not None and now >= deadline:
                        expired.append(entry)
                        continue
                    out.append(entry)
                _QUEUE_DEPTH.set(len(self._queue))
            for _, fut, _, _, _ in expired:
                # shed, not scored: the caller's budget is already gone
                _resolve(fut, exception=_overload.shed(
                    "deadline",
                    message="deadline expired while queued"))
            if out:
                return out
            # everything drained this round was expired or abandoned —
            # go back to waiting for live work
