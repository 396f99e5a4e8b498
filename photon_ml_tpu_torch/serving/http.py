"""Stdlib-HTTP front end for online GAME scoring.

Counterpart of ``photon_ml_tpu/serving/http.py``, JSON endpoints over
``http.server``:

- ``POST /score``: ``{"records": [...]}`` (or ``{"record": {...}}``) →
  ``{"scores": [...], "version": v, "lineage": ..., "latency_ms": ...,
  "request_id": ...}``. Records are TrainingExampleAvro-shaped dicts
  (``features`` list, ``metadataMap``, optional ``offset``). Single records
  go through the microbatcher when there is one; batches go straight to
  the engine. ``"margins": true`` adds the per-coordinate f32 margins and
  the offsets. A request refused by admission control (full bounded queue,
  expired ``X-Photon-Deadline-Ms`` budget, max brownout) gets **429** with
  ``Retry-After`` and a ``reason``; a deadline's remaining budget is echoed
  back (header and ``deadline_ms``) like the request id.
- ``GET /healthz``: liveness and the serving counters (active version,
  lineage, capture count, requests and records scored, queue depth, shed
  tallies, brownout level, connections).
- ``GET /readyz``: 503 with reasons while there is no active model, the
  batcher worker is dead, brownout is at max level or the connection
  budget is spent.
- ``GET /metrics``: Prometheus text of the process-global metrics registry.
- ``POST /reload``: ``{"model_dir": "..."}`` (defaults to the dir served
  at start) → validate and hot-swap; a rejected candidate gets 409 and the
  active version keeps serving.
- ``GET /rank`` and ``GET /history`` answer **501**: ranked retrieval and
  the retained-telemetry ring are not ported.

Every request gets an id here (an inbound ``X-Photon-Request-Id`` is
honoured, else one is minted), echoed as a header and in the ``/score``
body, and every stage of the critical path lands in
``photon_serving_stage_seconds{stage=parse|queue_wait|batch_assemble|
execute|respond}``. 200 ``/score`` replies carry the
``X-Photon-Leg-Summary`` stage header. Not ported: spans, the request log,
the canary reservoir, shard-map checks and two-phase ``/reload``.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional
from urllib.parse import urlsplit

from photon_ml_tpu_torch.serving import overload as _overload
from photon_ml_tpu_torch.serving import stages as _stages
from photon_ml_tpu_torch.serving.batcher import BatcherClosed, MicroBatcher
from photon_ml_tpu_torch.serving.registry import ModelRegistry
from photon_ml_tpu_torch.telemetry import metrics as _metrics

#: end-to-end /score handling time (pack + engine + marshaling)
_REQUEST_LATENCY = _metrics.histogram(
    "photon_serving_request_latency_seconds",
    "End-to-end /score request handling time")

#: per-stage request-path critical path: this module owns parse and
#: respond (batcher.py owns queue_wait; engine.py batch_assemble and
#: execute)
_STAGE_SECONDS = _metrics.histogram(
    "photon_serving_stage_seconds",
    "Serving request time per request-path stage "
    "(parse | queue_wait | batch_assemble | execute | respond)",
    labels=("stage",))

# --- connection plane: accepts/closes/refusals, open vs idle keep-alive
# sockets, connection lifetime and requests per connection -----------------

_CONN_ACCEPTED = _metrics.counter(
    "photon_connections_accepted_total",
    "Client connections accepted by the serving front end")
_CONN_CLOSED = _metrics.counter(
    "photon_connections_closed_total",
    "Accepted client connections since closed (accepted == closed + "
    "open, the accounting identity the chaos harness asserts)")
_CONN_REFUSED = _metrics.counter(
    "photon_connections_refused_total",
    "Connections refused by the --max-connections budget (each is "
    "answered with one typed 503 reason=connections + Connection: close)")
_CONN_OPEN = _metrics.gauge(
    "photon_connections_open",
    "Client connections currently open (accepted, not yet closed)")
_CONN_IDLE = _metrics.gauge(
    "photon_connections_idle",
    "Open keep-alive connections with no request in flight")
_CONN_PEAK = _metrics.gauge(
    "photon_connections_peak",
    "High-water mark of concurrently open client connections")
for _g in ("photon_connections_open", "photon_connections_idle",
           "photon_connections_peak"):
    _metrics.mark_host_owned(_g)
_CONN_LIFETIME = _metrics.histogram(
    "photon_connection_lifetime_seconds",
    "Lifetime of each closed client connection (accept to close)",
    buckets=(0.001, 0.01, 0.1, 0.5, 1.0, 5.0, 30.0, 60.0, 300.0,
             1800.0, 3600.0))
_CONN_REQUESTS = _metrics.histogram(
    "photon_connection_requests",
    "Requests served per closed client connection (keep-alive reuse)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))


class ConnectionTracker:
    """Lock-disciplined accounting of the front end's client sockets (a
    copy of the JAX package's). Invariant, held under one lock:
    ``accepted == closed + open``. ``max_connections`` (0 = unlimited) is
    the admission budget: a connection past it is refused, counted here,
    and answered by the handler with one typed 503
    ``reason=connections`` + ``Connection: close``."""

    def __init__(self, max_connections: int = 0):
        self.max_connections = max(0, int(max_connections))
        self._lock = threading.Lock()
        self.accepted = 0  # guarded-by: _lock
        self.closed = 0  # guarded-by: _lock
        self.refused = 0  # guarded-by: _lock
        self.open = 0  # guarded-by: _lock
        self.active = 0  # guarded-by: _lock
        self.peak = 0  # guarded-by: _lock

    def connect(self) -> bool:
        """Account one inbound connection; False = over budget."""
        with self._lock:
            if self.max_connections and self.open >= self.max_connections:
                self.refused += 1
                _CONN_REFUSED.inc()
                return False
            self.accepted += 1
            self.open += 1
            if self.open > self.peak:
                self.peak = self.open
                _CONN_PEAK.set(self.peak)
            _CONN_ACCEPTED.inc()
            _CONN_OPEN.set(self.open)
            _CONN_IDLE.set(self.open - self.active)
            return True

    def disconnect(self, lifetime_s: float, n_requests: int,
                   admitted: bool = True) -> None:
        if not admitted:
            return  # refused connections were never counted open
        with self._lock:
            self.closed += 1
            self.open = max(0, self.open - 1)
            _CONN_CLOSED.inc()
            _CONN_OPEN.set(self.open)
            _CONN_IDLE.set(max(0, self.open - self.active))
        _CONN_LIFETIME.observe(max(0.0, float(lifetime_s)))
        _CONN_REQUESTS.observe(max(0, int(n_requests)))

    def request_begin(self) -> None:
        with self._lock:
            self.active += 1
            _CONN_IDLE.set(max(0, self.open - self.active))

    def request_end(self) -> None:
        with self._lock:
            self.active = max(0, self.active - 1)
            _CONN_IDLE.set(max(0, self.open - self.active))

    def utilization(self) -> float:
        """Open connections over the budget (0.0 when unlimited)."""
        with self._lock:
            if not self.max_connections:
                return 0.0
            return min(1.0, self.open / self.max_connections)

    def exhausted(self) -> bool:
        """At (or past) the budget: what flips ``/readyz`` to 503."""
        with self._lock:
            return bool(self.max_connections
                        and self.open >= self.max_connections)

    def stats(self) -> dict:
        """The ``/healthz`` connection block."""
        with self._lock:
            return {"open": self.open,
                    "idle": max(0, self.open - self.active),
                    "active": self.active,
                    "peak": self.peak,
                    "budget": self.max_connections,
                    "accepted": self.accepted,
                    "closed": self.closed,
                    "refused": self.refused}


#: the inbound/outbound request-id header
REQUEST_ID_HEADER = "X-Photon-Request-Id"

#: inbound: the caller's remaining latency budget in milliseconds, stamped
#: against the monotonic clock at parse time; outbound: the budget still
#: remaining when the response was written
DEADLINE_HEADER = "X-Photon-Deadline-Ms"

#: outbound on 200 ``/score`` responses: this request's per-stage seconds,
#: compactly encoded (``parse=<s>;queue_wait=<s>;...``)
LEG_SUMMARY_HEADER = "X-Photon-Leg-Summary"

#: the closed stage vocabulary a leg summary may carry
LEG_SUMMARY_STAGES = (
    "parse", "queue_wait", "batch_assemble", "execute", "respond")

#: the endpoints of the JAX front end that the port does not serve, with
#: what is missing
_UNPORTED_PATHS = {
    "/rank": "ranked retrieval (/rank) is not ported",
    "/history": "the retained-telemetry ring (/history) is not ported",
}


def format_leg_summary(stages: Mapping[str, float]) -> str:
    """Encode a stage-seconds mapping (plus optional ``span`` id) as the
    ``X-Photon-Leg-Summary`` header value: only the closed stage
    vocabulary, seconds to the microsecond."""
    parts = []
    span_id = stages.get("span")
    if span_id is not None:
        parts.append(f"span={int(span_id)}")
    for key in LEG_SUMMARY_STAGES:
        value = stages.get(key)
        if value is not None:
            parts.append(f"{key}={float(value):.6f}")
    return ";".join(parts)


def new_request_id() -> str:
    """The one place a serving request id is minted."""
    return uuid.uuid4().hex


def shed_status(e: "_overload.Shed") -> int:
    """HTTP status of a typed shed: 429 (busy: retry the same place), 503
    for ``upstream`` and ``connections`` (the capacity is gone)."""
    return 503 if e.reason in ("upstream", "connections") else 429


class ServingService:
    """Endpoint logic, HTTP-free (testable directly; the handler is thin)."""

    def __init__(self, registry: ModelRegistry, *,
                 default_model_dir: Optional[str] = None,
                 batcher: Optional[MicroBatcher] = None,
                 default_timeout_ms: float = 0.0,
                 overload=None,
                 connections: Optional[ConnectionTracker] = None):
        self.registry = registry
        self.default_model_dir = default_model_dir
        self.batcher = batcher
        #: server-side deadline of requests that carry no
        #: X-Photon-Deadline-Ms of their own (0 = none)
        self.default_timeout_ms = float(default_timeout_ms)
        #: optional OverloadController, owned here: closed with the
        #: service, surfaced by /readyz
        self.overload = overload
        self.connections = connections if connections is not None \
            else ConnectionTracker()
        self._lock = threading.Lock()
        self.n_requests = 0  # guarded-by: _lock
        self.n_scored = 0  # guarded-by: _lock
        self._started_monotonic = time.monotonic()

    # --- deadlines --------------------------------------------------------
    def resolve_deadline(self,
                         budget_ms: "str | float | None") -> Optional[float]:
        """Stamp a request's latency budget against the monotonic clock, at
        parse time. ``budget_ms`` is the raw ``X-Photon-Deadline-Ms``
        header (or a number); absent, the server-side
        ``default_timeout_ms`` applies; neither → None. Raises ValueError on
        an unparsable header."""
        if budget_ms is None or budget_ms == "":
            budget_ms = (self.default_timeout_ms
                         if self.default_timeout_ms > 0 else None)
        if budget_ms is None:
            return None
        try:
            budget = float(budget_ms)
        except (TypeError, ValueError):
            raise ValueError(
                f"bad {DEADLINE_HEADER} header {budget_ms!r} (want a "
                f"millisecond budget)") from None
        return time.monotonic() + budget / 1e3

    @staticmethod
    def remaining_ms(deadline: Optional[float]) -> Optional[float]:
        if deadline is None:
            return None
        return max(0.0, (deadline - time.monotonic()) * 1e3)

    # --- endpoints --------------------------------------------------------
    def score(self, payload: dict,
              request_id: Optional[str] = None,
              deadline: Optional[float] = None,
              stage_sink: Optional[dict] = None) -> dict:
        """Score one request. Raises
        :class:`~photon_ml_tpu_torch.serving.overload.Shed` (→ 429) when
        admission control refuses it (an expired deadline, a full
        microbatcher queue, max brownout) without it reaching the engine's
        execute stage or the latency histogram. ``stage_sink``, when given,
        receives this request's stage seconds."""
        if request_id is None:
            request_id = new_request_id()
        if "record" in payload:
            records = [payload["record"]]
        else:
            records = payload.get("records")
        if not isinstance(records, list) or not records:
            raise ValueError("payload needs 'records': [non-empty list] "
                             "or 'record': {...}")
        with_margins = bool(payload.get("margins"))
        if deadline is not None and time.monotonic() >= deadline:
            raise _overload.shed(
                "deadline", message="deadline expired before scoring")
        if _overload.traffic_shed():
            raise _overload.shed(
                "brownout",
                message=f"brownout level {_overload.level()} is shedding "
                        f"traffic",
                retry_after_s=2.0)
        margins = offsets = None
        sink = stage_sink if stage_sink is not None else {}
        with _REQUEST_LATENCY.time() as timer, _stages.collect(sink):
            version = self.registry.active_version
            try:
                if with_margins:
                    # margin responses bypass the batcher: per-request
                    # shaped, not coalescible
                    raw, offsets, margins = \
                        self.registry.active().engine.score_margins(records)
                    scores = [float(s) for s in raw]
                elif self.batcher is not None and len(records) == 1:
                    scores = [self.batcher.score(records[0],
                                                 deadline=deadline,
                                                 stage_out=stage_sink)]
                else:
                    scores = [float(s)
                              for s in self.registry.active().score(records)]
            except _overload.Shed:
                # a refusal is not a serving latency
                timer.discard()
                raise
        latency_ms = timer.seconds * 1e3
        with self._lock:
            self.n_requests += 1
            self.n_scored += len(records)
        self.registry.bus.post("serving_request", batch=len(records),
                               latency_ms=latency_ms, version=version,
                               request_id=request_id)
        active = self.registry.active_or_none()
        out = {"scores": scores, "version": version,
               "lineage": None if active is None else active.lineage,
               "latency_ms": round(latency_ms, 3),
               "request_id": request_id}
        if with_margins:
            # f32 widened to double: exact
            out["margins"] = [[cid, [float(v) for v in m]]
                              for cid, m in margins]
            out["offsets"] = [float(v) for v in offsets]
        if deadline is not None:
            out["deadline_ms"] = round(self.remaining_ms(deadline), 1)
        return out

    def healthz(self) -> dict:
        active = self.registry.active_or_none()
        return {
            "status": "ok" if active is not None else "no_model",
            "version": self.registry.active_version,
            "versions": self.registry.versions(),
            "model_lineage_id": None if active is None else active.lineage,
            "parentModel": (None if active is None
                            else active.parent_lineage),
            # the model's coordinate walk (id, entity type or null for the
            # fixed effect), in the order scores sum
            "coordinates": (None if active is None else [
                [cid, getattr(cm, "random_effect_type", None)]
                for cid, cm in active.model.coordinates.items()]),
            "compiles": (0 if active is None
                         else active.engine.compile_count),
            "device": str(self.registry.device),
            "requests": self.n_requests,
            "scored": self.n_scored,
            "uptime_s": round(time.monotonic() - self._started_monotonic, 1),
            "queue_depth": (0 if self.batcher is None
                            else self.batcher.queue_depth()),
            "shed": _overload.shed_counts(),
            "brownout_level": _overload.level(),
            "connections": self.connections.stats(),
        }

    def readyz(self) -> tuple[int, dict]:
        """Readiness: ``(200 | 503, body)`` with the reasons and the same
        overload telemetry ``/healthz`` carries."""
        reasons = []
        if self.registry.active_or_none() is None:
            reasons.append("no_active_model")
        if self.batcher is not None and self.batcher.dead is not None:
            reasons.append("batcher_worker_dead")
        lvl = _overload.level()
        if lvl >= _overload.MAX_LEVEL:
            reasons.append("brownout_max")
        if self.connections.exhausted():
            reasons.append("connections_exhausted")
        body = {
            "ready": not reasons,
            "reasons": reasons,
            "version": self.registry.active_version,
            "queue_depth": (0 if self.batcher is None
                            else self.batcher.queue_depth()),
            "shed": _overload.shed_counts(),
            "brownout_level": lvl,
            "connections": self.connections.stats(),
        }
        return (200 if not reasons else 503), body

    def reload(self, payload: dict) -> dict:
        """One-shot ``/reload``: validate, register and activate the
        candidate dir (full model dirs only)."""
        if payload.get("phase") is not None:
            raise NotImplementedError(
                "two-phase /reload (prepare | activate | abort) is not "
                "ported")
        model_dir = payload.get("model_dir") or self.default_model_dir
        if not model_dir:
            raise ValueError("payload needs 'model_dir' (no default "
                             "configured)")
        previous = self.registry.active_version
        sm = self.registry.reload(model_dir)
        return {"version": sm.version, "previous": previous,
                "model_dir": sm.model_dir}

    def close(self) -> None:
        if self.overload is not None:
            # stops the controller and restores brownout level 0
            self.overload.stop()
        if self.batcher is not None:
            self.batcher.close()


def _make_handler(service: ServingService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1: persistent connections (every reply carries
        # Content-Length, which is all keep-alive needs)
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY: a reply goes out as two writes (headers, body), and
        # with Nagle the body waits for the client's delayed ACK of the
        # headers, ~40 ms a keep-alive request on loopback
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # noqa: D102
            pass

        # --- connection accounting ----------------------------------------
        def setup(self):
            super().setup()
            self._conn_t0 = time.monotonic()
            self._conn_requests = 0
            self._conn_admitted = service.connections.connect()

        def finish(self):
            try:
                super().finish()
            finally:
                service.connections.disconnect(
                    time.monotonic() - self._conn_t0,
                    self._conn_requests,
                    admitted=getattr(self, "_conn_admitted", True))

        def _request_id(self) -> str:
            inbound = self.headers.get(REQUEST_ID_HEADER)
            self.request_id = inbound.strip() if inbound else new_request_id()
            return self.request_id

        def _reply(self, status: int, body: dict,
                   headers: Optional[dict] = None) -> None:
            self._reply_raw(status, json.dumps(body).encode(),
                            "application/json", headers=headers)

        def _reply_raw(self, status: int, data: bytes, content_type: str,
                       headers: Optional[dict] = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            rid = getattr(self, "request_id", None)
            if rid is not None:
                self.send_header(REQUEST_ID_HEADER, rid)
            deadline = getattr(self, "deadline", None)
            if deadline is not None:
                self.send_header(DEADLINE_HEADER,
                                 f"{service.remaining_ms(deadline):.1f}")
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(data)

        def _reply_with_summary(self, status: int, out: dict,
                                headers: Optional[dict], leg_stages: dict,
                                parse_s: float) -> None:
            """Reply, with the leg-summary header on 200 replies
            (``respond`` in it is the JSON serialization share)."""
            with _STAGE_SECONDS.labels(stage="respond").time():
                if status == 200 and leg_stages:
                    leg_stages["parse"] = parse_s
                    t_ser = time.monotonic()
                    data = json.dumps(out).encode()
                    leg_stages["respond"] = time.monotonic() - t_ser
                    headers = dict(headers or {})
                    headers[LEG_SUMMARY_HEADER] = format_leg_summary(
                        leg_stages)
                    self._reply_raw(status, data, "application/json",
                                    headers=headers)
                else:
                    self._reply(status, out, headers=headers)

        def _payload(self) -> dict:
            length = int(self.headers.get("Content-Length") or 0)
            if not length:
                return {}
            return json.loads(self.rfile.read(length) or b"{}")

        def _refuse_if_stopping(self) -> bool:
            """A stopping host answers every request with a typed 503
            ``reason=stopping`` and closes the connection."""
            if not getattr(self.server, "photon_stopping", False):
                return False
            self.close_connection = True
            self._reply(503, {"error": "host is stopping",
                              "reason": "stopping"},
                        headers={"Connection": "close"})
            return True

        def _refuse_if_exhausted(self) -> bool:
            """A connection past the budget gets one typed 503
            ``reason=connections`` + ``Connection: close``."""
            if getattr(self, "_conn_admitted", True):
                return False
            self.close_connection = True
            e = _overload.shed(
                "connections",
                message=f"connection budget exhausted ("
                        f"{service.connections.max_connections})",
                retry_after_s=1.0)
            self._reply(shed_status(e),
                        {"error": str(e), "reason": e.reason},
                        headers={"Connection": "close",
                                 "Retry-After":
                                     str(max(1, round(e.retry_after_s)))})
            return True

        def do_GET(self):  # noqa: N802
            if self._refuse_if_stopping() or self._refuse_if_exhausted():
                return
            self._conn_requests += 1
            service.connections.request_begin()
            try:
                self._request_id()
                path = urlsplit(self.path).path
                if path == "/healthz":
                    self._reply(200, service.healthz())
                elif path == "/readyz":
                    status, body = service.readyz()
                    self._reply(status, body)
                elif path == "/metrics":
                    from photon_ml_tpu_torch.telemetry.prometheus import (
                        CONTENT_TYPE,
                        render,
                    )

                    self._reply_raw(200, render().encode(), CONTENT_TYPE)
                elif path in _UNPORTED_PATHS:
                    self._reply(501, {"error": _UNPORTED_PATHS[path]})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            finally:
                service.connections.request_end()

        def do_POST(self):  # noqa: N802
            if self._refuse_if_stopping() or self._refuse_if_exhausted():
                return
            self._conn_requests += 1
            service.connections.request_begin()
            try:
                self._post(self._request_id())
            finally:
                service.connections.request_end()

        def _post(self, rid: str) -> None:
            with _STAGE_SECONDS.labels(stage="parse").time() as parse_t:
                try:
                    payload = self._payload()
                    # the deadline budget is stamped at parse: queueing and
                    # scoring spend the budget the caller measures
                    self.deadline = service.resolve_deadline(
                        self.headers.get(DEADLINE_HEADER))
                    parse_error = None
                except (ValueError, json.JSONDecodeError) as e:
                    parse_error = f"bad request: {e}"
            if parse_error is not None:
                self._reply(400, {"error": parse_error})
                return
            path = urlsplit(self.path).path
            if path == "/score":
                headers = None
                leg_stages: dict = {}
                try:
                    out = service.score(payload, request_id=rid,
                                        deadline=self.deadline,
                                        stage_sink=leg_stages)
                    status = 200
                except BatcherClosed as e:
                    self.close_connection = True
                    out = {"error": str(e), "reason": "stopping",
                           "request_id": rid}
                    status = 503
                except _overload.Shed as e:
                    out = {"error": str(e), "reason": e.reason,
                           "request_id": rid}
                    status = shed_status(e)
                    headers = {
                        "Retry-After": str(max(1, round(e.retry_after_s)))}
                except ValueError as e:
                    out, status = {"error": str(e)}, 400
                except Exception as e:
                    out, status = {"error": repr(e)}, 500
                self._reply_with_summary(status, out, headers, leg_stages,
                                         parse_t.seconds)
            elif path == "/reload":
                try:
                    self._reply(200, service.reload(payload))
                except Exception as e:
                    # the swap was rejected and the active version is
                    # untouched: a conflict, not a server death
                    self._reply(409, {
                        "error": repr(e),
                        "version": service.registry.active_version})
            elif path in _UNPORTED_PATHS:
                self._reply(501, {"error": _UNPORTED_PATHS[path]})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

    return Handler


class GameServer:
    """Threaded HTTP server wrapper with a test-friendly lifecycle."""

    def __init__(self, service: ServingService, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_handler(service))
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "GameServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="photon-serving-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        # flip the refuse flag before teardown: keep-alive handler threads
        # outlive shutdown() and must answer 503 reason=stopping from here
        self._httpd.photon_stopping = True
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        self.service.close()
