"""Background model publication, overlapped ingest, atomic publication.

Counterpart of ``photon_ml_tpu/io/pipeline.py``:

- :class:`BackgroundSaver` — the training commands' two-pool writer
  service. Whole model saves run on orchestrator threads and fan their
  per-coordinate part files out on a shared part-writer pool; a command
  submits each save the moment its result exists, keeps going, and joins
  the writes before it returns (the first writer error propagates).
  Every GAME model directory is staged in a hidden sibling and published
  by :func:`publish_dir` (:func:`save_game_model_atomic`,
  :func:`publish_model_alias`), under the retry policy with the
  ``io.model_save`` fault site in the crash window: a kill or an
  injected fault mid-save never exposes a partial model to a serving
  watcher.
- :class:`DecodePrefetcher` — a bounded double-buffered pipeline of file
  decodes, and :func:`read_in_background` — one read on a background
  thread (the validation data, joined at first use).
- :func:`save_model_patch_atomic` — a refresh's patch, staged and
  published the same way under ``io.delta_publish``.

Background work runs under a copy of the submitter's context, so the
``io.save.model`` / ``io.save.part`` / ``io.save.index`` /
``io.save.alias`` / ``io.read.validation`` spans parent under the
command's stage and ``tools/perf_report.py`` shows how much of the I/O
wall was hidden. The four I/O metric families are the JAX package's:
``photon_save_{seconds,bytes}_total`` (fed by ``io/model_io.py``'s part
and metadata writes and the saver's file writes) and
``photon_ingest_{decode_seconds,files}_total`` (``io/data_reader.py``'s
file decodes).
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import shutil
import tempfile
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterator, Optional, Sequence

from photon_ml_tpu_torch.telemetry import metrics as tmetrics
from photon_ml_tpu_torch.telemetry import tracing


def _save_seconds():
    return tmetrics.counter(
        "photon_save_seconds_total",
        "Wall seconds spent writing model part-files, per coordinate "
        "(background writers included — compare with the driver's "
        "'Save models' join wall to see the hidden fraction)",
        labels=("coordinate",))


def _save_bytes():
    return tmetrics.counter(
        "photon_save_bytes_total",
        "Bytes of model/index artifacts written (part-files, metadata, "
        "feature indexes)")


def _ingest_decode_seconds():
    return tmetrics.counter(
        "photon_ingest_decode_seconds_total",
        "Wall seconds spent decoding input Avro files (prefetcher worker "
        "side; overlaps assembly on the consumer side)")


def _ingest_files():
    return tmetrics.counter(
        "photon_ingest_files_total",
        "Input Avro files decoded through the ingest prefetcher")


def publish_dir(staging: str, final: str) -> None:
    """Atomically publish a fully written ``staging`` directory at
    ``final`` (retire-then-rename): an existing ``final`` is renamed aside
    first (a ``.tmp`` suffix keeps it out of directory probes), the
    staging dir takes its place, then the retired copy is deleted — at no
    instant is ``final`` absent or partially written."""
    final = os.path.normpath(final)
    parent = os.path.dirname(os.path.abspath(final))
    if os.path.exists(final):
        retired = tempfile.mkdtemp(
            prefix=f".{os.path.basename(final)}-retired-", suffix=".tmp",
            dir=parent)
        os.rmdir(retired)
        os.rename(final, retired)
        os.rename(staging, final)
        shutil.rmtree(retired, ignore_errors=True)
    else:
        os.rename(staging, final)


def _gc_stale_staging(parent: str, base: str) -> None:
    """Drop the staging and retired leftovers of a crashed or
    fault-injected earlier attempt at publishing ``base``."""
    for name in os.listdir(parent):
        if name.endswith(".tmp") and (
                name.startswith(f".{base}-stage-")
                or name.startswith(f".{base}-retired-")):
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)


def save_game_model_atomic(output_dir: str, model, index_maps, entity_vocabs,
                           *, sparsity_threshold: float = 0.0,
                           executor: Optional[ThreadPoolExecutor] = None,
                           lineage: Optional[dict] = None) -> None:
    """:func:`~photon_ml_tpu_torch.io.model_io.save_game_model` written
    into a hidden staging sibling and published with :func:`publish_dir`,
    under the retry policy, with the ``io.model_save`` fault site in the
    crash window (staging fully written, rename not yet done): a fault or
    a kill there leaves the previous model, or nothing, visible — never a
    partial tree."""
    from photon_ml_tpu_torch.io.model_io import save_game_model
    from photon_ml_tpu_torch.resilience import fault_point, retry

    output_dir = os.path.normpath(output_dir)
    parent = os.path.dirname(os.path.abspath(output_dir))
    os.makedirs(parent, exist_ok=True)
    base = os.path.basename(output_dir)

    def attempt() -> None:
        _gc_stale_staging(parent, base)
        staging = tempfile.mkdtemp(prefix=f".{base}-stage-", suffix=".tmp",
                                   dir=parent)
        try:
            save_game_model(staging, model, index_maps, entity_vocabs,
                            sparsity_threshold=sparsity_threshold,
                            executor=executor, lineage=lineage)
            fault_point("io.model_save", path=output_dir)
            publish_dir(staging, output_dir)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise

    retry(attempt, name=f"io.model_save:{base}")


def save_model_patch_atomic(output_dir: str, patch_models, index_maps,
                            entity_vocabs, *, task, parent_model: str,
                            model_id: str, removed=None,
                            lineage: Optional[dict] = None,
                            sparsity_threshold: float = 0.0,
                            fleet_shard: Optional[tuple] = None) -> int:
    """:func:`~photon_ml_tpu_torch.io.model_io.save_game_model_patch`
    written into a hidden staging sibling and published with
    :func:`publish_dir`, under the retry policy, with the
    ``io.delta_publish`` fault site in the crash window (staging fully
    written, rename not yet done): a fault there leaves the previous patch,
    or nothing, visible. Returns the published patch's bytes."""
    from photon_ml_tpu_torch.io.model_io import save_game_model_patch
    from photon_ml_tpu_torch.resilience import fault_point, retry

    output_dir = os.path.normpath(output_dir)
    parent = os.path.dirname(os.path.abspath(output_dir))
    os.makedirs(parent, exist_ok=True)
    base = os.path.basename(output_dir)

    def attempt() -> None:
        _gc_stale_staging(parent, base)
        staging = tempfile.mkdtemp(prefix=f".{base}-stage-", suffix=".tmp",
                                   dir=parent)
        try:
            with tracing.span("refresh.publish", path=output_dir):
                save_game_model_patch(
                    staging, patch_models, index_maps, entity_vocabs,
                    task=task, parent_model=parent_model, model_id=model_id,
                    removed=removed, lineage=lineage,
                    sparsity_threshold=sparsity_threshold,
                    fleet_shard=fleet_shard)
                fault_point("io.delta_publish", path=output_dir)
                publish_dir(staging, output_dir)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise

    retry(attempt, name=f"io.delta_publish:{base}")
    total = 0
    for dirpath, _dirs, files in os.walk(output_dir):
        for name in files:
            total += os.path.getsize(os.path.join(dirpath, name))
    return total


def publish_model_alias(src_dir: str, dst_dir: str) -> None:
    """Publish ``dst_dir`` as an alias of the finished model at
    ``src_dir`` without serializing it again: the files are hardlinked
    (copied where the filesystem refuses a link) into a staging tree,
    ``model-metadata.json`` is rewritten with an ``aliasOf`` key naming the
    source, and the tree is published as :func:`save_game_model_atomic`
    publishes, under ``io.model_save``. ``--output-all-models``'s ``best/``
    is such an alias."""
    from photon_ml_tpu_torch.resilience import fault_point, retry

    src_dir = os.path.normpath(src_dir)
    dst_dir = os.path.normpath(dst_dir)
    parent = os.path.dirname(os.path.abspath(dst_dir))
    os.makedirs(parent, exist_ok=True)
    base = os.path.basename(dst_dir)

    def attempt() -> None:
        _gc_stale_staging(parent, base)
        staging = tempfile.mkdtemp(prefix=f".{base}-stage-", suffix=".tmp",
                                   dir=parent)
        try:
            with tracing.span("io.save.alias", src=src_dir, dst=dst_dir):
                for dirpath, _dirnames, filenames in os.walk(src_dir):
                    rel = os.path.relpath(dirpath, src_dir)
                    out = (staging if rel == "." else
                           os.path.join(staging, rel))
                    os.makedirs(out, exist_ok=True)
                    for name in filenames:
                        s = os.path.join(dirpath, name)
                        d = os.path.join(out, name)
                        if name == "model-metadata.json":
                            with open(s) as f:
                                metadata = json.load(f)
                            metadata["aliasOf"] = os.path.relpath(
                                src_dir, parent)
                            with open(d, "w") as f:
                                json.dump(metadata, f, indent=2)
                            continue
                        try:
                            os.link(s, d)
                        except OSError:
                            shutil.copy2(s, d)
            fault_point("io.model_save", path=dst_dir)
            publish_dir(staging, dst_dir)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise

    retry(attempt, name=f"io.model_save:{base}")


class BackgroundSaver:
    """A command's background writer: saves run off the critical path and
    are joined, with the first error propagating, before the command
    returns.

    Two pools, so a whole-model save waiting on its own part-file writes
    can never deadlock: orchestrators (one per model save in flight) on
    ``_saves``, part-file and index writers on the shared ``_parts`` pool.
    Each submission runs under a copy of the caller's context, so its
    spans parent under the stage the command was in when it submitted."""

    def __init__(self, part_workers: int = 4, save_workers: int = 2):
        self._parts = ThreadPoolExecutor(
            max_workers=part_workers, thread_name_prefix="photon-save-part")
        self._saves = ThreadPoolExecutor(
            max_workers=save_workers, thread_name_prefix="photon-save")
        self._lock = threading.Lock()
        self._pending: list[tuple[str, Future]] = []  # guarded-by: _lock

    def _track(self, label: str, fut: Future) -> Future:
        with self._lock:
            self._pending.append((label, fut))
        return fut

    def submit_game_save(self, output_dir: str, model, index_maps,
                         entity_vocabs, *, sparsity_threshold: float = 0.0,
                         lineage: Optional[dict] = None) -> Future:
        """Stage and publish a GAME model at ``output_dir`` in the
        background (:func:`save_game_model_atomic`), its coordinates' part
        files written on the part-writer pool. Returns the save's future;
        :meth:`join` collects it."""
        ctx = contextvars.copy_context()

        def job() -> None:
            with tracing.span("io.save.model", path=output_dir):
                save_game_model_atomic(
                    output_dir, model, index_maps, entity_vocabs,
                    sparsity_threshold=sparsity_threshold,
                    executor=self._parts, lineage=lineage)

        return self._track(f"model:{output_dir}",
                           self._saves.submit(ctx.run, job))

    def submit_file_write(self, fn: Callable[[str], Any], path: str, *,
                          label: str = "io.save.file", **attrs) -> Future:
        """Run ``fn(path)`` (an ``IndexMap.save``, a manifest, a baseline)
        on the writer pool under a ``label`` span; the written file's bytes
        feed ``photon_save_bytes_total``."""
        ctx = contextvars.copy_context()

        def job() -> None:
            with tracing.span(label, path=path, **attrs):
                fn(path)
            if os.path.exists(path):
                _save_bytes().inc(os.path.getsize(path))

        return self._track(f"{label}:{path}",
                           self._parts.submit(ctx.run, job))

    def submit(self, fn: Callable[[], Any], *, label: str = "io.save.task",
               **attrs) -> Future:
        """Run any write task on the writer pool under a ``label`` span."""
        ctx = contextvars.copy_context()

        def job():
            with tracing.span(label, **attrs):
                return fn()

        return self._track(label, self._parts.submit(ctx.run, job))

    def collect(self) -> list:
        """Prune the completed writes without blocking; returns the
        ``(label, exception)`` pairs of those that failed. A long-lived
        owner calls it now and then so the pending list stays bounded;
        writes in flight stay tracked for the final :meth:`join`."""
        with self._lock:
            done = [(label, fut) for label, fut in self._pending
                    if fut.done()]
            self._pending = [(label, fut) for label, fut in self._pending
                             if not fut.done()]
        return [(label, fut.exception()) for label, fut in done
                if fut.exception() is not None]

    def join(self) -> None:
        """Wait for every submitted write; the first error, in submission
        order, propagates: a failed background save fails the run."""
        with self._lock:
            pending, self._pending = self._pending, []
        first_error: Optional[BaseException] = None
        for label, fut in pending:
            try:
                fut.result()
            except BaseException as e:
                logging.getLogger(__name__).error(
                    "background write %s failed: %r", label, e)
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error

    def close(self) -> None:
        """Shut both pools down, waiting for the writes in flight (no
        writer outlives the command). Errors of writes never joined are
        dropped: ``close`` runs on the failure path, where a second raise
        would hide the first."""
        self._saves.shutdown(wait=True)
        self._parts.shutdown(wait=True)
        with self._lock:
            self._pending.clear()


class DecodePrefetcher:
    """Bounded double-buffered pipeline over ``fn(item)`` calls.

    Up to ``window`` calls run on a pool of threads while the consumer
    iterates the results strictly in submission order. An error in any call
    cancels everything still queued and re-raises on the consumer's side;
    leaving the iteration early cancels the remainder too. Each call runs
    in a copy of the consumer's context, so its spans parent under the
    consumer's current span."""

    def __init__(self, fn: Callable[[Any], Any], items: Sequence[Any], *,
                 workers: int = 2, window: Optional[int] = None):
        self._fn = fn
        self._items = list(items)
        self._workers = max(1, workers)
        # one in-flight slot beyond the workers keeps the pool fed while
        # the consumer holds the head result
        self._window = window if window is not None else self._workers + 1

    def __iter__(self) -> Iterator[Any]:
        pool = ThreadPoolExecutor(max_workers=self._workers,
                                  thread_name_prefix="photon-ingest")
        queue: deque[Future] = deque()
        it = iter(self._items)
        try:
            for item in it:
                queue.append(pool.submit(contextvars.copy_context().run,
                                         self._fn, item))
                if len(queue) >= self._window:
                    break
            while queue:
                head = queue.popleft()
                try:
                    result = head.result()
                except BaseException:
                    for f in queue:
                        f.cancel()
                    raise
                for item in it:
                    queue.append(pool.submit(contextvars.copy_context().run,
                                             self._fn, item))
                    break
                yield result
        finally:
            for f in queue:
                f.cancel()
            pool.shutdown(wait=True)


def read_in_background(fn: Callable[..., Any], *args,
                       label: str = "io.read.validation",
                       **kwargs) -> Future:
    """Run one read on a background thread under a ``label`` span, in the
    caller's context (the span parents under the current stage), and
    return its :class:`~concurrent.futures.Future`: the result, or the
    read's exception, is delivered at ``future.result()``, the join."""
    ctx = contextvars.copy_context()
    fut: Future = Future()

    def run() -> None:
        try:
            with tracing.span(label):
                result = fn(*args, **kwargs)
        except BaseException as e:  # delivered at the join
            fut.set_exception(e)
        else:
            fut.set_result(result)

    threading.Thread(target=lambda: ctx.run(run), daemon=True,
                     name="photon-read-bg").start()
    return fut
