"""Overload protection for the serving path: typed load-shedding and
brownout degradation.

A copy of ``photon_ml_tpu/serving/overload.py`` (host code). An overloaded
host degrades predictably instead of queueing forever:

- **Typed shedding.** :class:`Shed` is the one error admission control
  raises: at the batcher's bounded queue (``reason="queue_full"``), at a
  deadline check (``reason="deadline"``), or under max brownout
  (``reason="brownout"``). ``http.py`` maps it to **429** with a
  ``Retry-After`` hint; every shed lands in ``photon_shed_total{reason}``
  exactly once, at the raise site (:func:`shed` builds the error AND
  counts it). A shed request never reaches the engine's execute stage.
- **Brownout ladder.** Under sustained pressure the controller moves one
  level per tick, restoring in reverse on recovery. The ladder is the JAX
  package's: levels 1-3 shed the request log, quality accumulation and
  span tracing, none of which the port runs yet, so there they move only
  the ``photon_brownout_level`` gauge; level 4 sheds traffic (``/score`` →
  429 ``reason=brownout``, ``/readyz`` → 503).
- **The controller.** :class:`OverloadController` watches microbatcher
  queue pressure (depth against ``max_queue`` plus the windowed p99 of the
  ``queue_wait`` stage histogram) and moves the level one step per tick,
  with the high/low watermark gap as hysteresis.

State is process-global, like the metrics registry it feeds: one host has
one brownout level, whichever component asks.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from photon_ml_tpu_torch.telemetry import metrics as _metrics

logger = logging.getLogger(__name__)

#: every shed request, by why it was shed — the serving twin of the
#: training side's retry/divergence counters. Counted at the raise site
#: (:func:`shed`), exactly once per shed request.
_SHED_TOTAL = _metrics.counter(
    "photon_shed_total",
    "Requests shed by serving admission control, by reason "
    "(queue_full | deadline | brownout | connections | upstream — the "
    "last two map to 503: the connection budget or the fleet capacity "
    "is exhausted, the caller did nothing wrong)",
    labels=("reason",))

#: current brownout degradation level (0 = full service, MAX_LEVEL =
#: shedding traffic). Host-owned: each serving process degrades on its
#: own pressure, so a fleet aggregate fans this out per process.
_BROWNOUT_LEVEL = _metrics.gauge(
    "photon_brownout_level",
    "Serving brownout degradation level (0 = full service; 4 = "
    "shedding traffic)")
_metrics.mark_host_owned("photon_brownout_level")

#: the closed shed-reason vocabulary (materialized at import so /metrics
#: shows every reason at zero before the first shed). ``upstream`` is the
#: fleet router's reason — a per-host fan-out leg failed (dead host, slow
#: host past the fan-out timeout, injected ``fleet.fanout`` fault) — and
#: maps to **503** rather than 429: the caller did nothing wrong and the
#: capacity is gone, not busy. ``connections`` is the ``--max-connections``
#: budget refusing a socket past the ceiling: also a 503, sent with
#: ``Connection: close`` so the client retries against a host with socket
#: headroom.
SHED_REASONS = ("queue_full", "deadline", "brownout", "connections",
                "upstream")
for _r in SHED_REASONS:
    _SHED_TOTAL.labels(reason=_r)

#: optional-work features, in the order brownout sheds them (and the
#: reverse order recovery restores them)
FEATURES = ("reqlog", "quality", "tracing")

#: the level at which traffic itself is shed (every optional feature is
#: already gone by then)
MAX_LEVEL = len(FEATURES) + 1


class Shed(RuntimeError):
    """A request refused by admission control (never an engine failure).

    ``reason`` is one of :data:`SHED_REASONS`; ``retry_after_s`` is the
    hint ``http.py`` surfaces as the ``Retry-After`` header.
    """

    def __init__(self, reason: str, message: str = "",
                 retry_after_s: float = 1.0):
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        super().__init__(message or f"request shed ({reason})")


def shed(reason: str, message: str = "", retry_after_s: float = 1.0) -> Shed:
    """Count one shed request and build the typed error (the caller
    raises it — or sets it on the request's Future). Counting at the
    build site keeps the invariant: one Shed == one counter increment,
    however many layers the error then crosses."""
    if reason not in SHED_REASONS:
        raise ValueError(f"unknown shed reason {reason!r}; expected one "
                         f"of {SHED_REASONS}")
    _SHED_TOTAL.labels(reason=reason).inc()
    with _STATE_LOCK:
        _SHED_COUNTS[reason] += 1
    return Shed(reason, message, retry_after_s)


# ---------------------------------------------------------------------------
# process-global brownout state
# ---------------------------------------------------------------------------

_STATE_LOCK = threading.Lock()
_SHED_COUNTS: dict = {r: 0 for r in SHED_REASONS}
_LEVEL = 0


def level() -> int:
    """The current brownout level (0 = full service)."""
    with _STATE_LOCK:
        return _LEVEL


def shed_counts() -> dict:
    """Per-reason shed tallies (the ``/healthz`` / ``/readyz`` payload —
    the scrape equivalent is ``photon_shed_total``)."""
    with _STATE_LOCK:
        return dict(_SHED_COUNTS)


def is_shed(feature: str) -> bool:
    """Is this optional feature currently browned out? Call sites
    (reqlog sampling, quality accumulation, serving spans) check this on
    their hot path — one lock, no allocation."""
    with _STATE_LOCK:
        lvl = _LEVEL
    return feature in FEATURES and FEATURES.index(feature) < lvl


def traffic_shed() -> bool:
    """True at max brownout: new requests are shed, not queued."""
    return level() >= MAX_LEVEL


def set_level(new_level: int, bus=None) -> int:
    """Clamp and apply a brownout level; posts ``brownout_changed`` (and
    moves the gauge) only on an actual transition. Returns the applied
    level."""
    global _LEVEL
    new_level = max(0, min(int(new_level), MAX_LEVEL))
    with _STATE_LOCK:
        prev = _LEVEL
        if new_level == prev:
            return prev
        _LEVEL = new_level
    _BROWNOUT_LEVEL.set(new_level)
    if bus is None:
        from photon_ml_tpu_torch.events import GLOBAL_BUS as bus
    bus.post("brownout_changed", level=new_level, previous=prev,
             shed_features=list(FEATURES[:min(new_level, len(FEATURES))]),
             traffic_shed=new_level >= MAX_LEVEL)
    logger.warning("brownout level %d -> %d (shedding: %s%s)", prev,
                   new_level,
                   ", ".join(FEATURES[:min(new_level, len(FEATURES))])
                   or "nothing",
                   " + traffic" if new_level >= MAX_LEVEL else "")
    return new_level


class OverloadController:
    """Queue-pressure watcher driving the brownout ladder.

    Each tick reads the microbatcher's queue utilization (depth over
    ``max_queue``) and the ``queue_wait`` stage histogram's p99 over the
    tick window, then moves the level ONE step: up past the high
    watermark, down below the low watermark (hysteresis — the gap between
    the two absorbs noise). ``start()`` runs ticks on a background
    thread (``Event.wait``, never a bare sleep); tests drive
    :meth:`tick` synchronously.
    """

    def __init__(self, batcher, *, high_util: float = 0.75,
                 low_util: float = 0.25,
                 wait_p99_ms: Optional[float] = None,
                 poll_s: float = 1.0, bus=None,
                 connections=None):
        self.batcher = batcher
        #: optional ConnectionTracker (serving/http.py): a host whose
        #: ``--max-connections`` budget is nearly spent is under pressure
        #: even with a shallow batcher queue, so connection utilization
        #: feeds the same watermarks queue utilization does
        self.connections = connections
        self.high_util = float(high_util)
        self.low_util = float(low_util)
        #: optional queue-wait p99 threshold (ms) that escalates even
        #: when the queue is deep-but-under-capacity
        self.wait_p99_ms = wait_p99_ms
        self.poll_s = float(poll_s)
        self.bus = bus
        self._stop = threading.Event()
        #: start/stop are operator-lifecycle calls from one control thread
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller
        self._wait_hist = _metrics.histogram(
            "photon_serving_stage_seconds",
            "Serving request time per request-path stage "
            "(parse | queue_wait | batch_assemble | execute | respond)",
            labels=("stage",)).labels(stage="queue_wait")
        #: previous cumulative bucket snapshot — only the tick path (one
        #: thread, or tests ticking synchronously) touches it
        self._prev_wait = self._wait_hist.snapshot()[0]  # guarded-by: caller
        self.n_ticks = 0  # guarded-by: caller

    # --- one decision -----------------------------------------------------
    def _windowed_wait_p99_ms(self) -> Optional[float]:
        """p99 of queue_wait over THIS tick window (bucket-count deltas),
        None when the window saw no requests."""
        cum, _, _ = self._wait_hist.snapshot()
        prev, self._prev_wait = self._prev_wait, cum
        delta = [c - p for c, p in zip(cum, prev)]
        if delta[-1] <= 0:
            return None
        return _metrics.quantile_from_buckets(
            self._wait_hist.uppers, delta, 0.99) * 1e3

    def tick(self) -> int:
        """One control decision; returns the (possibly new) level."""
        self.n_ticks += 1
        depth = self.batcher.queue_depth()
        cap = self.batcher.max_queue
        util = (depth / cap) if cap else 0.0
        conn_util = (0.0 if self.connections is None
                     else self.connections.utilization())
        wait_p99 = self._windowed_wait_p99_ms()
        hot = util >= self.high_util or conn_util >= self.high_util or (
            self.wait_p99_ms is not None and wait_p99 is not None
            and wait_p99 >= self.wait_p99_ms)
        cool = util <= self.low_util and conn_util <= self.low_util and (
            self.wait_p99_ms is None or wait_p99 is None
            or wait_p99 < self.wait_p99_ms)
        cur = level()
        if hot and cur < MAX_LEVEL:
            return set_level(cur + 1, bus=self.bus)
        if cool and cur > 0:
            return set_level(cur - 1, bus=self.bus)
        return cur

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "OverloadController":
        def loop() -> None:
            while not self._stop.wait(self.poll_s):
                try:
                    self.tick()
                except Exception:
                    logger.exception("overload tick failed; will retry")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="photon-serving-overload")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # a stopping server restores full service: brownout is pressure
        # response, not configuration
        set_level(0, bus=self.bus)
