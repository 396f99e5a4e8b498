"""Training and serving lifecycle event bus.

A copy of ``photon_ml_tpu/events.py`` (stdlib only); the serving registry
posts its lifecycle events (``model_loaded``, ``model_activated``,
``model_reload_rejected``) and the front end its ``serving_request``
events here.

Re-design of the reference's event layer (``photon-client/.../event/...`` ⚠
SURVEY.md §2.5 — lifecycle events consumed by LinkedIn-internal listeners):
a tiny synchronous pub/sub bus the drivers post stage events to, so external
integrations (metrics exporters, progress UIs, experiment trackers) can
observe a run without the framework depending on them.

Listeners are plain callables ``(TrainingEvent) -> None``; a listener
exception is logged and swallowed (an observer must never kill a training
run — same contract as the reference's fire-and-forget event bus).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Mapping

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainingEvent:
    """One lifecycle notification.

    Standard event names posted by the drivers (mirroring the reference's
    lifecycle):

    - ``training_started`` / ``training_finished``
    - ``stage_started`` / ``stage_finished`` (payload: ``stage``)
    - ``configuration_evaluated`` (payload: config index, evaluation dict)
    - ``model_saved`` (payload: output path)
    """

    name: str
    payload: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    timestamp: float = dataclasses.field(default_factory=time.time)


Listener = Callable[[TrainingEvent], None]


class EventBus:
    """Synchronous in-process pub/sub (reference event bus equivalent).

    Thread-safe: the serving front end posts from ``ThreadingHTTPServer``
    worker threads while training code (or a test) may subscribe
    concurrently, so list mutation happens under a lock and ``post``
    iterates a snapshot. Listeners run on the POSTING thread, outside the
    lock — a slow listener delays its poster, never other
    subscribe/unsubscribe calls.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._listeners: list[Listener] = []

    def subscribe(self, listener: Listener) -> Callable[[], None]:
        """Register; returns an unsubscribe callable."""
        with self._lock:
            self._listeners.append(listener)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._listeners.remove(listener)
                except ValueError:
                    pass

        return unsubscribe

    def post(self, name: str, **payload: Any) -> TrainingEvent:
        event = TrainingEvent(name=name, payload=payload)
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(event)
            except Exception:  # observers must never kill training
                logger.exception("event listener failed on %s", name)
        return event

    def __len__(self) -> int:
        with self._lock:
            return len(self._listeners)


#: Default process-wide bus the CLI drivers post to; embedders may also pass
#: their own bus to the drivers.
GLOBAL_BUS = EventBus()
