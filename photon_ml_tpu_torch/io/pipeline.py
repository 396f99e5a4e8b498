"""Overlapped ingest and atomic publication.

Counterpart of ``photon_ml_tpu/io/pipeline.py``'s ``DecodePrefetcher``,
``publish_dir`` and ``save_model_patch_atomic`` (its patch write a
``refresh.publish`` span), and of its four I/O metric families:
``photon_save_{seconds,bytes}_total`` (fed by ``io/model_io.py``'s part
and metadata writes and the commands' other artifacts, :func:`count_saved`) and ``photon_ingest_{decode_seconds,files}_total``
(fed by ``io/data_reader.py``'s file decodes). The background saver and
the validation read in the background are not ported: the port's drivers
save and read in the calling thread (the bytes are the same).
"""

from __future__ import annotations

import contextvars
import os
import shutil
import tempfile
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


def count_saved(path: str) -> None:
    """Add a written artifact's bytes (a feature index, the data manifest,
    the quality baseline) to ``photon_save_bytes_total``, as the JAX
    package's background saver counts each file it writes."""
    _save_bytes().inc(os.path.getsize(path))


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
