"""Black-box flight recorder: the last N telemetry records, dumped on death.

Counterpart of ``photon_ml_tpu/telemetry/flightrec.py``. A serving process
that dies takes its registry, its event stream and its trace buffer with
it. The :class:`FlightRecorder` keeps a preallocated ring of the most
recent span records (tapped off
:class:`~photon_ml_tpu_torch.telemetry.tracing.Tracer` through ``add_tap``,
so it fills with no ``trace.jsonl`` configured), event-bus events, log
lines and history snapshots, and writes it atomically to
``flight-<ts>.jsonl`` (a ``.tmp`` file, then ``os.replace``: a reader never
sees part of a dump) on four triggers:

- a fault-site trip: a ``fault_injected`` bus event
  (:mod:`photon_ml_tpu_torch.resilience.faults`);
- an unhandled exception: chained ``sys.excepthook`` and
  ``threading.excepthook``;
- SIGTERM: a chained handler installed by the serving commands' ``run``
  (what the supervisor sends first, so a supervised worker's black box
  survives its own eviction);
- a stall: :class:`Watchdog` (petted by the history sampler) and the
  supervisor's heartbeat stall (``supervisor_fault_detected`` with
  ``reason="stall"``).

``tools/postmortem.py`` renders a dump into an incident report; the dump's
header and record lines are the JAX package's. Record kinds and the names
of ``note()`` fields are closed sets: the black box holds request ids,
never request payloads.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from photon_ml_tpu_torch.telemetry.history import SERIES_NAME_RE

__all__ = [
    "DUMP_REASONS",
    "RECORD_KINDS",
    "FlightRecorder",
    "Watchdog",
]

#: why a dump happened — closed; the postmortem keys its headline off it
DUMP_REASONS = ("fault_site", "unhandled_exception", "sigterm",
                "watchdog_stall", "manual")

#: what a ring slot can hold — closed; ``tools/postmortem.py`` renders
#: each kind into its own report section
RECORD_KINDS = ("span", "event", "log", "history", "note")

#: default ring capacity — at one span + one event per request this is
#: roughly the last ~250 requests plus the interleaved history ticks
DEFAULT_CAPACITY = 512

#: don't let a fault storm turn into a dump storm: repeat triggers of
#: the SAME reason inside this window coalesce into the first dump
DEFAULT_COOLDOWN_S = 5.0

_SCHEMA = 1


class _FlightLogHandler(logging.Handler):
    def __init__(self, recorder: "FlightRecorder"):
        super().__init__()
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._recorder.record_log(
                self.format(record), level=record.levelname,
                logger=record.name)
        except Exception:
            pass  # the black box never takes down the thing it records


class FlightRecorder:
    """Crash-safe ring of recent telemetry + atomic dump-on-trigger.

    The ring is a fixed-size preallocated list written modulo capacity
    under one lock — recording is O(1) with zero allocation growth, so
    it can sit on the request path's span tap indefinitely. ``dump()``
    snapshots the ring under the lock, then renders and publishes the
    file OUTSIDE it (tmp + ``os.replace``), so a dump mid-traffic never
    stalls recorders for the I/O.
    """

    def __init__(self, dump_dir: str, *, capacity: int = DEFAULT_CAPACITY,
                 source: str = "host",
                 context_fn: Optional[Callable[[], dict]] = None,
                 tracer=None,
                 cooldown_s: float = DEFAULT_COOLDOWN_S):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self._dump_dir = dump_dir
        self._capacity = int(capacity)
        self._source = source
        self._context_fn = context_fn
        self._tracer = tracer
        self._cooldown_s = float(cooldown_s)
        self._ring: list = [None] * self._capacity
        self._seq = 0
        self._lock = threading.Lock()
        self._last_dump: dict[str, float] = {}
        self._uninstalls: list[Callable[[], None]] = []
        self._prev_excepthook = None
        self._prev_threading_hook = None
        self._prev_sigterm = None

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    # ------------------------------------------------------------------
    # recording lanes
    # ------------------------------------------------------------------

    def _append(self, kind: str, payload: dict) -> None:
        if kind not in RECORD_KINDS:
            raise ValueError(
                f"unknown flight record kind {kind!r}: the vocabulary is "
                f"closed ({', '.join(RECORD_KINDS)})")
        with self._lock:
            self._seq += 1
            self._ring[(self._seq - 1) % self._capacity] = {
                "seq": self._seq, "kind": kind, **payload}

    def record_span(self, record: dict) -> None:
        """One completed span/annotation record (the tracer tap lane)."""
        self._append("span", {"record": dict(record)})

    def record_event(self, name: str, payload: dict,
                     ts: Optional[float] = None) -> None:
        """One event-bus event (the bus subscription lane)."""
        self._append("event", {"event": name, "payload": dict(payload),
                               "ts": ts})

    def record_log(self, line: str, *, level: str = "INFO",
                   logger: str = "") -> None:
        self._append("log", {"line": str(line), "level": level,
                             "logger": logger})

    def record_history(self, snapshot: dict) -> None:
        """One history-ring snapshot (exposition text dropped — the ring
        keeps the derived series, the live sampler keeps the text)."""
        self._append("history", {"tick": snapshot.get("tick"),
                                 "ts": snapshot.get("ts"),
                                 "series": snapshot.get("series", {})})

    def note(self, name: str, **fields) -> None:
        """Manual breadcrumb. ``name`` and field names must be literal
        snake_case names; values may carry the request id (the join
        key), never raw payload fields."""
        for key in (name, *fields):
            if not SERIES_NAME_RE.match(key):
                raise ValueError(
                    f"flight note name/field {key!r} outside the closed "
                    f"vocabulary (want snake_case)")
        self._append("note", {"note": name, "fields": fields})

    def records(self) -> list[dict]:
        """The retained records, oldest first (a copy)."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> list[dict]:
        if self._seq <= self._capacity:
            return [r for r in self._ring[: self._seq] if r is not None]
        head = self._seq % self._capacity
        return [r for r in self._ring[head:] + self._ring[:head]
                if r is not None]

    # ------------------------------------------------------------------
    # dump
    # ------------------------------------------------------------------

    def dump(self, reason: str, *, ts: Optional[float] = None,
             force: bool = False) -> Optional[str]:
        """Publish the ring as ``flight-<ts>.jsonl`` in ``dump_dir``.

        Atomic by construction: the full document is written to a
        ``.tmp`` sibling, flushed + fsynced, then ``os.replace``d into
        place — a concurrent reader sees the complete dump or no file,
        never a partial one. Returns the path, or ``None`` when a
        repeat trigger of the same reason lands inside the cooldown.
        """
        if reason not in DUMP_REASONS:
            raise ValueError(
                f"unknown dump reason {reason!r}: the vocabulary is "
                f"closed ({', '.join(DUMP_REASONS)})")
        mono = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if (not force and last is not None
                    and mono - last < self._cooldown_s):
                return None
            self._last_dump[reason] = mono
            records = self._snapshot_locked()
            seq = self._seq
        wall = time.time() if ts is None else float(ts)
        header = {
            "kind": "flight_header",
            "schema": _SCHEMA,
            "reason": reason,
            "source": self._source,
            "ts": wall,
            "seq": seq,
            "capacity": self._capacity,
            "retained": len(records),
            "active_span_ids": (list(self._tracer.open_span_ids())
                                if self._tracer is not None else []),
        }
        if self._context_fn is not None:
            try:
                header["context"] = self._context_fn()
            except Exception as e:
                header["context_error"] = repr(e)
        os.makedirs(self._dump_dir, exist_ok=True)
        path = os.path.join(self._dump_dir, f"flight-{int(wall * 1000)}.jsonl")
        k = 0
        while os.path.exists(path):
            k += 1
            path = os.path.join(
                self._dump_dir, f"flight-{int(wall * 1000)}-{k}.jsonl")
        lines = [json.dumps(header, sort_keys=True, default=str)]
        lines.extend(json.dumps(r, sort_keys=True, default=str)
                     for r in records)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return path

    # ------------------------------------------------------------------
    # trigger wiring
    # ------------------------------------------------------------------

    def _on_event(self, event) -> None:
        payload = dict(event.payload)
        self.record_event(event.name, payload,
                          ts=getattr(event, "timestamp", None))
        if event.name == "fault_injected":
            self.dump("fault_site")
        elif (event.name == "supervisor_fault_detected"
                and payload.get("reason") == "stall"):
            self.dump("watchdog_stall")

    def install(self, *, bus=None, tracer=None, sampler=None,
                logger: Optional[logging.Logger] = None
                ) -> Callable[[], None]:
        """Wire the recording lanes: tracer tap, bus subscription (which
        also arms the fault-site and supervisor-stall dump triggers),
        history-sampler listener, log handler. Returns an uninstall
        callable; :meth:`close` calls it too."""
        uninstalls: list[Callable[[], None]] = []
        if tracer is not None:
            self._tracer = tracer
            uninstalls.append(tracer.add_tap(self.record_span))
        if bus is not None:
            uninstalls.append(bus.subscribe(self._on_event))
        if sampler is not None:
            uninstalls.append(sampler.add_listener(self.record_history))
        if logger is not None:
            handler = _FlightLogHandler(self)
            logger.addHandler(handler)
            uninstalls.append(lambda: logger.removeHandler(handler))
        self._uninstalls.extend(uninstalls)

        def _uninstall() -> None:
            for fn in uninstalls:
                try:
                    fn()
                except Exception:
                    pass
        return _uninstall

    def install_excepthook(self) -> None:
        """Dump on any unhandled exception (main thread or worker), then
        chain to the previous hooks — the crash still crashes."""
        if self._prev_excepthook is not None:
            return
        self._prev_excepthook = sys.excepthook
        self._prev_threading_hook = threading.excepthook

        def _hook(exc_type, exc, tb):
            self._record_crash(exc_type, exc, tb)
            self.dump("unhandled_exception")
            self._prev_excepthook(exc_type, exc, tb)

        def _thread_hook(args):
            self._record_crash(args.exc_type, args.exc_value,
                               args.exc_traceback, thread=args.thread)
            self.dump("unhandled_exception")
            self._prev_threading_hook(args)

        sys.excepthook = _hook
        threading.excepthook = _thread_hook

    def _record_crash(self, exc_type, exc, tb, thread=None) -> None:
        try:
            frames = traceback.format_exception(exc_type, exc, tb)
            self._append("note", {
                "note": "unhandled_exception",
                "fields": {
                    "error": repr(exc),
                    "thread": getattr(thread, "name", "main"),
                    "trace": "".join(frames)[-4000:],
                }})
        except Exception:
            pass

    def install_sigterm(self) -> bool:
        """Dump on SIGTERM, then chain to the previous handler (or exit
        with the conventional 143 when the previous disposition was the
        default). Signal handlers only install from the main thread —
        returns False (recorder still works, trigger unarmed) elsewhere.
        """
        def _handler(signum, frame):
            self.dump("sigterm")
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                raise SystemExit(128 + signum)

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)
        except ValueError:
            return False
        return True

    def uninstall_hooks(self) -> None:
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            threading.excepthook = self._prev_threading_hook
            self._prev_excepthook = None
            self._prev_threading_hook = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None

    def close(self) -> None:
        for fn in self._uninstalls:
            try:
                fn()
            except Exception:
                pass
        self._uninstalls.clear()
        self.uninstall_hooks()


class Watchdog:
    """In-process liveness: dump ``watchdog_stall`` when pets stop.

    ``pet(now=None)`` is called by whatever proves the process is making
    progress (the serving mains pet from the history sampler's
    listener); ``check(now=None)`` dumps — ONCE per stall episode,
    edge-triggered like the SLO burn latch — when the last pet is older
    than ``timeout_s``. Both take an injectable monotonic ``now`` so
    tests drive the clock; ``start(period_s)`` runs ``check`` on a
    daemon thread in production.
    """

    def __init__(self, recorder: FlightRecorder, *, timeout_s: float):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self._recorder = recorder
        self._timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._last_pet = time.monotonic()  # guarded-by: _lock
        self._stalled = False  # guarded-by: _lock
        self._stop = threading.Event()  # guarded-by: caller
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller

    def pet(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            self._last_pet = now
            self._stalled = False

    def check(self, now: Optional[float] = None) -> Optional[str]:
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            stale = now - self._last_pet >= self._timeout_s
            if not stale or self._stalled:
                return None
            self._stalled = True  # latch: one dump per episode
            age = now - self._last_pet
        self._recorder.note("watchdog_stall", pet_age_s=round(age, 3))
        return self._recorder.dump("watchdog_stall")

    def start(self, period_s: float) -> None:
        if period_s <= 0 or self._thread is not None:
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(period_s):
                self.check()
        self._thread = threading.Thread(
            target=_loop, name="photon-flight-watchdog", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
