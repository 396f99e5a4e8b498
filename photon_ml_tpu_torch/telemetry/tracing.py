"""Span tracing: nested ``span(name)`` contexts → ``trace.jsonl`` (a copy
of ``photon_ml_tpu/telemetry/tracing.py``: it is pure Python).

``util/Timed.scala`` gave the reference *flat* stage timings in a log file;
a run that interleaves coordinate descent, retries, checkpointing and
validation needs the *tree*: which stage contained which step, and where
the wall-clock actually went. A span is one timed region with an id, its
enclosing span's id (tracked per-thread via ``contextvars``, so concurrent
serving requests each get their own stack), and arbitrary JSON attributes.

- unconfigured (the default), spans cost two contextvar operations and a
  ``perf_counter`` pair — cheap enough to leave permanently in hot-ish
  paths like the coordinate-descent step loop;
- ``GLOBAL_TRACER.configure(path, bus=...)`` (done by the drivers'
  ``--telemetry-dir`` flag) appends one JSON line per completed span to
  ``<run_dir>/trace.jsonl`` and, when a bus is given, posts a
  ``span_finished`` event so the EventBus→metrics bridge folds span
  durations into the registry;
- ``timed()`` (:mod:`photon_ml_tpu_torch.logging_util`) is a thin wrapper
  over a span — stage sections appear in the trace tree for free.

Record layout (one JSON object per line)::

    {"name": ..., "span_id": 3, "parent_id": 2, "ts": <wall clock>,
     "t0": ..., "t1": ..., "seconds": ..., <attribute>: ...}

``t0``/``t1`` are ``perf_counter`` readings — monotonic and mutually
comparable within the process, so a child's interval provably nests inside
its parent's (the property the telemetry tests assert); ``ts`` is the wall
clock for humans correlating with ``photon.log``.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Iterator, Optional

#: the enclosing span's id on THIS thread/context (None = root)
_CURRENT: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "photon_current_span", default=None)

#: the full open-ancestor id stack on THIS thread/context — what lets a
#: span that outlives its lexical parent (async background work submitted
#: with a copied context) re-parent to the nearest ancestor still open
_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "photon_span_stack", default=())

#: reserved record keys — span attributes may not shadow them
_RESERVED = frozenset(
    {"name", "span_id", "parent_id", "ts", "t0", "t1", "seconds"})


class Span:
    """One live timed region; ``set(**attrs)`` attaches attributes any time
    before exit (e.g. a loss computed after the work the span times)."""

    __slots__ = ("name", "span_id", "parent_id", "attrs", "ts", "t0", "t1",
                 "seconds")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.seconds = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def record(self) -> dict:
        bad = _RESERVED & self.attrs.keys()
        if bad:
            raise ValueError(f"span attributes shadow reserved keys {bad}")
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "ts": self.ts,
                "t0": self.t0, "t1": self.t1,
                "seconds": self.seconds, **self.attrs}


class Tracer:
    """Span factory + (optional) JSONL sink + (optional) EventBus bridge."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._fh = None
        self._path: Optional[str] = None
        self._bus = None
        #: ids of spans currently open anywhere in the process — consulted
        #: at span exit so an async span re-parents instead of recording an
        #: interval that leaks outside its (already closed) parent
        self._open: set[int] = set()
        #: completed-record taps (the flight recorder's span lane) —
        #: replaced wholesale on mutation so readers iterate an immutable
        #: snapshot without taking the lock on the span hot path
        self._taps: tuple = ()

    @property
    def enabled(self) -> bool:
        """True when spans are being exported (a sink is configured)."""
        return self._fh is not None

    @property
    def path(self) -> Optional[str]:
        return self._path

    def configure(self, path: str, bus=None) -> "Tracer":
        """Start appending completed spans to ``path`` (parent dirs
        created). Reconfiguring closes the previous sink first."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")
            self._path = path
            self._bus = bus
        return self

    def close(self) -> None:
        """Stop exporting; spans keep working (and keep their parentage)
        as no-ops."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            self._fh = None
            self._path = None
            self._bus = None

    def add_tap(self, fn) -> "callable":
        """Call ``fn(record)`` for every completed span/annotation record
        — even when no file sink is configured (the flight recorder taps
        here so the black box fills on hosts that never write
        ``trace.jsonl``). Tap exceptions are swallowed; returns a
        removal callable."""
        with self._lock:
            self._taps = self._taps + (fn,)

        def _remove() -> None:
            with self._lock:
                self._taps = tuple(t for t in self._taps if t is not fn)
        return _remove

    @property
    def _sinking(self) -> bool:
        """True when a completed record goes anywhere (file or tap) —
        the guard that keeps unconfigured spans dict-build-free."""
        return self._fh is not None or bool(self._taps)

    def _write(self, record: dict) -> None:
        for tap in self._taps:
            try:
                tap(record)
            except Exception:
                pass
        line = json.dumps(record) + "\n"
        with self._lock:
            if self._fh is not None:
                self._fh.write(line)
                self._fh.flush()

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        sp = Span(name, next(self._ids), _CURRENT.get(), attrs)
        token = _CURRENT.set(sp.span_id)
        ancestors = _STACK.get()
        stack_token = _STACK.set(ancestors + (sp.span_id,))
        with self._lock:
            self._open.add(sp.span_id)
        sp.ts = time.time()
        sp.t0 = time.perf_counter()
        try:
            yield sp
        finally:
            # leave the open set BEFORE stamping t1: a concurrent child
            # that still observes this span open is then guaranteed to
            # stamp its own t1 first, so the enclosure check below can
            # never race a parent mid-close
            with self._lock:
                self._open.discard(sp.span_id)
            sp.t1 = time.perf_counter()
            sp.seconds = sp.t1 - sp.t0
            _CURRENT.reset(token)
            _STACK.reset(stack_token)
            with self._lock:
                if (sp.parent_id is not None
                        and sp.parent_id not in self._open):
                    # async span outlived its lexical parent (background
                    # writers inherit the submitting stage's context but
                    # may finish after the stage closes): re-parent to the
                    # nearest ancestor still open, so every recorded
                    # interval provably nests inside its parent's — the
                    # trace.jsonl enclosure contract
                    sp.parent_id = next(
                        (a for a in reversed(ancestors) if a in self._open),
                        None)
            if self._sinking:
                self._write(sp.record())
            bus = self._bus
            if bus is not None:
                bus.post("span_finished", span=name, span_id=sp.span_id,
                         parent_id=sp.parent_id, seconds=sp.seconds)

    def annotate(self, name: str, **payload) -> None:
        """Write a non-span record (e.g. an optimizer iteration table) into
        the trace file, tagged with the current span as its parent. No-op
        when unconfigured."""
        if not self._sinking:
            return
        self._write({"name": name, "span_id": None,
                     "parent_id": _CURRENT.get(), "ts": time.time(),
                     **payload})

    @contextlib.contextmanager
    def span_under(self, parent_id: Optional[int], name: str,
                   **attrs) -> Iterator[Span]:
        """A span with an EXPLICIT parent — for work handed to a pool
        thread where the submitting request's contextvars do not follow
        (the fleet router's fan-out legs). Inside the context, nested
        ``span()`` calls parent to this span as usual; at exit, a parent
        that already closed re-parents this span to root rather than
        recording an interval that leaks outside it."""
        sp = Span(name, next(self._ids), parent_id, attrs)
        token = _CURRENT.set(sp.span_id)
        # the explicit parent is the only known-open ancestor here: the
        # submitting thread's deeper ancestry is not visible to this pool
        # thread, and claiming it would let re-parenting resurrect spans
        # this leg never nested inside
        ancestry = () if parent_id is None else (parent_id,)
        stack_token = _STACK.set(ancestry + (sp.span_id,))
        with self._lock:
            self._open.add(sp.span_id)
        sp.ts = time.time()
        sp.t0 = time.perf_counter()
        try:
            yield sp
        finally:
            with self._lock:
                self._open.discard(sp.span_id)
            sp.t1 = time.perf_counter()
            sp.seconds = sp.t1 - sp.t0
            _CURRENT.reset(token)
            _STACK.reset(stack_token)
            with self._lock:
                if (sp.parent_id is not None
                        and sp.parent_id not in self._open):
                    sp.parent_id = None
            if self._sinking:
                self._write(sp.record())
            bus = self._bus
            if bus is not None:
                bus.post("span_finished", span=name, span_id=sp.span_id,
                         parent_id=sp.parent_id, seconds=sp.seconds)

    def record_span(self, name: str, *, seconds: float,
                    parent_id: Optional[int] = None,
                    ts: Optional[float] = None, **attrs) -> int:
        """Materialize an EXTERNALLY timed region as a completed span —
        how the router turns a shard host's leg-summary stage seconds
        into children of its ``fleet.leg`` span. ``t0``/``t1`` are null
        (the remote perf_counter domain is not comparable to ours; the
        report tools only need ``seconds``/``parent_id``). Returns the
        new span id. No-op (id still minted) when unconfigured."""
        span_id = next(self._ids)
        if self._sinking:
            record = {"name": name, "span_id": span_id,
                      "parent_id": parent_id,
                      "ts": time.time() if ts is None else ts,
                      "t0": None, "t1": None,
                      "seconds": float(seconds), **attrs}
            bad = _RESERVED & attrs.keys()
            if bad:
                raise ValueError(
                    f"span attributes shadow reserved keys {bad}")
            self._write(record)
        return span_id

    def open_span_ids(self) -> tuple:
        """Ids of spans currently open anywhere in the process, sorted —
        what the flight recorder stamps into a dump header so a
        postmortem can name the work in flight at the moment of death."""
        with self._lock:
            return tuple(sorted(self._open))


#: process-global tracer the drivers configure; instrumented modules call
#: the module-level :func:`span` so embedders can swap sinks in one place
GLOBAL_TRACER = Tracer()


def span(name: str, **attrs):
    return GLOBAL_TRACER.span(name, **attrs)


def annotate(name: str, **payload) -> None:
    GLOBAL_TRACER.annotate(name, **payload)


def current_span_id() -> Optional[int]:
    """The enclosing span's id on this thread/context (None = root) —
    capture it BEFORE handing work to a pool so :func:`span_under` can
    stitch the pool thread's spans back under the request."""
    return _CURRENT.get()


def span_under(parent_id: Optional[int], name: str, **attrs):
    return GLOBAL_TRACER.span_under(parent_id, name, **attrs)


def record_span(name: str, *, seconds: float,
                parent_id: Optional[int] = None,
                ts: Optional[float] = None, **attrs) -> int:
    return GLOBAL_TRACER.record_span(
        name, seconds=seconds, parent_id=parent_id, ts=ts, **attrs)


def enabled() -> bool:
    return GLOBAL_TRACER.enabled


def configure(path: str, bus=None) -> Tracer:
    return GLOBAL_TRACER.configure(path, bus=bus)


def close() -> None:
    GLOBAL_TRACER.close()
