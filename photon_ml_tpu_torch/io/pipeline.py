"""Overlapped ingest: decode files on worker threads, consume them in order.

Counterpart of ``photon_ml_tpu/io/pipeline.py::DecodePrefetcher`` (the
background saver and the validation read in the background are not ported:
the port's ``train_game`` saves and reads synchronously).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterator, Optional, Sequence


class DecodePrefetcher:
    """Bounded double-buffered pipeline over ``fn(item)`` calls.

    Up to ``window`` calls run on a pool of threads while the consumer
    iterates the results strictly in submission order. An error in any call
    cancels everything still queued and re-raises on the consumer's side;
    leaving the iteration early cancels the remainder too."""

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
                queue.append(pool.submit(self._fn, item))
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
                    queue.append(pool.submit(self._fn, item))
                    break
                yield result
        finally:
            for f in queue:
                f.cancel()
            pool.shutdown(wait=True)
