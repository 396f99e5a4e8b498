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
  at start) → validate and hot-swap a full model dir or a coefficient
  patch; a rejected candidate gets 409 and the active version keeps
  serving. Two-phase: ``"phase": "prepare"`` registers a warmed version
  without activating it, ``"activate"`` or ``"abort"`` with its
  ``"version"`` pins or retires it. ``"phase": "prepare"`` with a
  ``"shard_map"`` instead of a model dir prepares a live reshard on a
  fleet host.
- ``GET /rank?user=...&k=...`` (also ``POST /rank`` with a full
  ``record``): top-k retrieval over the configured item coordinate
  (``serve_game --rank-item-coordinate``): ``{"ids": [...], "scores":
  [...], "k", "version", "lineage", "latency_ms", "request_id"}``, with
  the admission control, deadline and brownout of ``/score``; a bad k, a
  payload without ``user`` or ``record``, or ranking off is a 400. Ranked
  requests land in the request log as ``kind="rank"`` with their top-k.
- ``GET /history?series=&window=[&raw=1]``: the host's retained-telemetry
  ring (``telemetry/history.py``, armed by ``serve_game``); an unknown
  series or a bad window is a 400, an unarmed ring a 404, and ``raw=1``
  adds each snapshot's exposition text, which the fleet router folds.

Every request gets an id here (an inbound ``X-Photon-Request-Id`` is
honoured, else one is minted), echoed as a header and in the ``/score``
body, and every stage of the critical path lands in
``photon_serving_stage_seconds{stage=parse|queue_wait|batch_assemble|
execute|respond}``. 200 ``/score`` replies carry the
``X-Photon-Leg-Summary`` stage header. A reply's ``version`` and
``lineage`` name the version that scored it (``stages.SERVED_BY``), also
when a swap lands while the request waits in the microbatcher. With a
:class:`~photon_ml_tpu_torch.serving.reqlog.RequestLog` every served
``/score`` is logged with its stage timings, version and lineage, and
``/healthz`` carries the log's counters. Scored records feed the
registry's canary reservoir; ``/healthz`` carries whether the active
version has a quality baseline, the reservoir's size, the active version's
canary annotation and, with ranking on, the rank counters.

On a fleet host (``serve_game --fleet-shard``) ``/score`` and ``/rank``
replies carry the active shard map's hash beside the lineage, a request
stamped by the router with another map's hash (``X-Photon-Shard-Map``) is
refused with 503 ``reason=shard_map_mismatch``, and ``/healthz`` names the
host's shard and map.

Each request is a ``serving.request`` span over ``serving.parse``,
``serving.score`` or ``serving.rank``, and ``serving.respond`` (written to
the run's trace when ``--telemetry-dir`` configures one), unless brownout
sheds span tracing (``overload.is_shed("tracing")``).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional
from urllib.parse import parse_qs, urlsplit

from photon_ml_tpu_torch.resilience.faults import fault_point
from photon_ml_tpu_torch.serving import overload as _overload
from photon_ml_tpu_torch.serving import stages as _stages
from photon_ml_tpu_torch.serving.batcher import BatcherClosed, MicroBatcher
from photon_ml_tpu_torch.serving.registry import ModelRegistry
from photon_ml_tpu_torch.serving.reqlog import RequestLog
from photon_ml_tpu_torch.telemetry import metrics as _metrics
from photon_ml_tpu_torch.telemetry import tracing as _tracing

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

#: the bucket → shard map's content hash (``ShardMap.map_hash``): outbound
#: on a sharded host's replies beside the lineage; inbound from the fleet
#: router, held against the host's active map (a mismatch is a 503
#: ``reason=shard_map_mismatch``, as a mixed lineage is)
SHARD_MAP_HEADER = "X-Photon-Shard-Map"

#: outbound on 200 ``/score`` responses: this request's per-stage seconds,
#: compactly encoded (``parse=<s>;queue_wait=<s>;...``)
LEG_SUMMARY_HEADER = "X-Photon-Leg-Summary"

#: the closed stage vocabulary a leg summary may carry
LEG_SUMMARY_STAGES = (
    "parse", "queue_wait", "batch_assemble", "execute", "respond")

#: end-to-end /rank handling time (sheds excluded, as for /score)
_RANK_REQUEST_LATENCY = _metrics.histogram(
    "photon_rank_request_latency_seconds",
    "End-to-end /rank request handling time")

#: requested k of admitted /rank requests
_RANK_K = _metrics.histogram(
    "photon_rank_k",
    "Requested k per admitted /rank request",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))


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


def parse_leg_summary(value: "Optional[str]") -> dict:
    """Decode a leg-summary header → ``{stage: seconds}`` (plus ``span``
    as an int). Unknown keys and malformed values are dropped: an upstream
    must not mint unbounded attribute keys in the router's trace."""
    out: dict = {}
    for part in (value or "").split(";"):
        key, eq, raw = part.partition("=")
        if not eq:
            continue
        key = key.strip()
        if key == "span":
            try:
                out["span"] = int(raw)
            except ValueError:
                pass
        elif key in LEG_SUMMARY_STAGES:
            try:
                out[key] = float(raw)
            except ValueError:
                pass
    return out


class ShardMapMismatch(RuntimeError):
    """Router and host disagree on the bucket → shard map: refused like a
    mixed lineage, since mid-reshard a request routed under one map must
    never be answered under another."""


def new_request_id() -> str:
    """The one place a serving request id is minted."""
    return uuid.uuid4().hex


def shed_status(e: "_overload.Shed") -> int:
    """HTTP status of a typed shed: 429 (busy: retry the same place), 503
    for ``upstream`` and ``connections`` (the capacity is gone)."""
    return 503 if e.reason in ("upstream", "connections") else 429


class _NullSpan:
    """Span stand-in while brownout sheds tracing."""

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


@contextlib.contextmanager
def _maybe_span(name: str, **attrs):
    """A ``serving.*`` span, unless brownout has shed span tracing
    (optional work goes before traffic)."""
    if _overload.is_shed("tracing"):
        yield _NULL_SPAN
        return
    with _tracing.span(name, **attrs) as sp:
        yield sp


class ServingService:
    """Endpoint logic, HTTP-free (testable directly; the handler is thin)."""

    def __init__(self, registry: ModelRegistry, *,
                 default_model_dir: Optional[str] = None,
                 batcher: Optional[MicroBatcher] = None,
                 rank_batcher: Optional[MicroBatcher] = None,
                 default_timeout_ms: float = 0.0,
                 overload=None,
                 connections: Optional[ConnectionTracker] = None,
                 reqlog: Optional[RequestLog] = None):
        self.registry = registry
        self.default_model_dir = default_model_dir
        self.batcher = batcher
        #: the /rank coalescing queue (a MicroBatcher over (record, k)
        #: entries), None = rank calls go straight to the engine
        self.rank_batcher = rank_batcher
        #: server-side deadline of requests that carry no
        #: X-Photon-Deadline-Ms of their own (0 = none)
        self.default_timeout_ms = float(default_timeout_ms)
        #: optional OverloadController, owned here: closed with the
        #: service, surfaced by /readyz
        self.overload = overload
        self.connections = connections if connections is not None \
            else ConnectionTracker()
        #: the request log (closed with the service), None when off
        self.reqlog = reqlog
        #: the retained ring behind GET /history, armed by serve_game
        #: (None: /history answers 404)
        self.history = None
        self._lock = threading.Lock()
        self.n_requests = 0  # guarded-by: _lock
        self.n_scored = 0  # guarded-by: _lock
        self.n_ranked = 0  # guarded-by: _lock
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

    # --- shard map --------------------------------------------------------
    def check_shard_map(self, claimed: "Optional[str]") -> None:
        """Refuse a request routed under another bucket → shard map than
        this host's active one (the ``X-Photon-Shard-Map`` header): raises
        :class:`ShardMapMismatch`. No header, or an unsharded host: no
        check."""
        if not claimed:
            return
        have = self.registry.shard_map_hash
        if have is not None and claimed != have:
            raise ShardMapMismatch(
                f"request routed under shard map {claimed} but this host "
                f"serves {have} — refusing rather than answering for "
                f"rows it may not own")

    # --- endpoints --------------------------------------------------------
    def score(self, payload: dict,
              request_id: Optional[str] = None,
              stage_ms: Optional[Mapping[str, float]] = None,
              deadline: Optional[float] = None,
              stage_sink: Optional[dict] = None) -> dict:
        """Score one request. Raises
        :class:`~photon_ml_tpu_torch.serving.overload.Shed` (→ 429) when
        admission control refuses it (an expired deadline, a full
        microbatcher queue, max brownout) without it reaching the engine's
        execute stage or the latency histogram. ``stage_ms`` folds the HTTP
        layer's own stages (parse) into the logged timings;
        ``stage_sink``, when given, receives this request's stage
        seconds."""
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
        with _REQUEST_LATENCY.time() as timer, \
                _maybe_span("serving.score", request_id=request_id,
                            batch=len(records)) as sp, \
                _stages.collect(sink):
            try:
                if with_margins:
                    # margin responses bypass the batcher: per-request
                    # shaped, not coalescible
                    raw, offsets, margins = \
                        self.registry.active().score_margins(records)
                    scores = [float(s) for s in raw]
                elif self.batcher is not None and len(records) == 1:
                    scores = [self.batcher.score(records[0],
                                                 deadline=deadline,
                                                 stage_out=sink)]
                else:
                    scores = [float(s)
                              for s in self.registry.active().score(records)]
            except _overload.Shed:
                # a refusal is not a serving latency
                timer.discard()
                raise
            served = sink.get(_stages.SERVED_BY)
            sp.set(version=self.registry.active_version if served is None
                   else served[0])
        latency_ms = timer.seconds * 1e3
        # the version that scored this request: ServingModel.score notes
        # it, through the batcher's worker too; a batcher score function
        # that bypasses it leaves the active one
        served = sink.get(_stages.SERVED_BY)
        if served is None:
            active = self.registry.active_or_none()
            served = (self.registry.active_version,
                      None if active is None else active.lineage)
        version, lineage = served
        with self._lock:
            self.n_requests += 1
            self.n_scored += len(records)
        # scored records feed the canary reservoir: the workload the next
        # candidate is shadow-scored on
        self.registry.observe_requests(records)
        if self.reqlog is not None:
            timings = dict(stage_ms or {})
            timings["score"] = latency_ms
            self.reqlog.log(request_id=request_id, records=records,
                            scores=scores, version=version,
                            lineage=lineage, stage_ms=timings)
        self.registry.bus.post("serving_request", batch=len(records),
                               latency_ms=latency_ms, version=version,
                               request_id=request_id)
        out = {"scores": scores, "version": version, "lineage": lineage,
               "latency_ms": round(latency_ms, 3),
               "request_id": request_id}
        smh = self.registry.shard_map_hash
        if smh is not None:
            out["shard_map"] = smh
        if with_margins:
            # f32 widened to double: exact
            out["margins"] = [[cid, [float(v) for v in m]]
                              for cid, m in margins]
            out["offsets"] = [float(v) for v in offsets]
        if deadline is not None:
            out["deadline_ms"] = round(self.remaining_ms(deadline), 1)
        return out

    def rank(self, payload: dict,
             request_id: Optional[str] = None,
             stage_ms: Optional[Mapping[str, float]] = None,
             deadline: Optional[float] = None,
             stage_sink: Optional[dict] = None) -> dict:
        """Rank one user against the active version's item axis.
        ``payload`` carries ``k`` and either ``user`` (a raw entity id,
        ranked featureless and applied to every non-item coordinate's
        entity type) or a full ``record``. Admission as for :meth:`score`:
        an expired deadline, a full rank queue or max brownout raises
        :class:`~photon_ml_tpu_torch.serving.overload.Shed` (→ 429) before
        the engine runs, and sheds stay out of the latency histogram."""
        if request_id is None:
            request_id = new_request_id()
        active = self.registry.active()
        engine = active.rank_engine
        if engine is None:
            raise ValueError("ranking is not enabled (start serve_game "
                             "with --rank-item-coordinate)")
        try:
            # an absent k is 10, bounded by the engine's
            k = int(payload.get("k", min(10, engine.max_k)))
        except (TypeError, ValueError):
            raise ValueError(
                f"bad k {payload.get('k')!r} (want an integer)") from None
        if not 1 <= k <= engine.max_k:
            raise ValueError(f"k must be in [1, {engine.max_k}], got {k}")
        record = payload.get("record")
        if record is None:
            user = payload.get("user")
            if not user:
                raise ValueError("payload needs 'user' (raw entity id) "
                                 "or 'record' ({features, metadataMap})")
            record = {"features": [],
                      "metadataMap": {t: str(user)
                                      for t in engine.user_entity_types},
                      "offset": None}
        if deadline is not None and time.monotonic() >= deadline:
            raise _overload.shed(
                "deadline", message="deadline expired before ranking")
        if _overload.traffic_shed():
            raise _overload.shed(
                "brownout",
                message=f"brownout level {_overload.level()} is shedding "
                        f"traffic",
                retry_after_s=2.0)
        sink = stage_sink if stage_sink is not None else {}
        with _RANK_REQUEST_LATENCY.time() as timer, \
                _maybe_span("serving.rank", request_id=request_id,
                            k=k) as sp, \
                _stages.collect(sink):
            try:
                if self.rank_batcher is not None:
                    ids, scores = self.rank_batcher.score(
                        (record, k), deadline=deadline, stage_out=sink)
                else:
                    ((ids, scores),) = active.rank([record], [k])
            except _overload.Shed:
                timer.discard()
                raise
            sp.set(version=active.version, n=len(ids))
        _RANK_K.observe(k)
        latency_ms = timer.seconds * 1e3
        served = sink.get(_stages.SERVED_BY)
        if served is None:
            served = (active.version, active.lineage)
        version, lineage = served
        with self._lock:
            self.n_requests += 1
            self.n_ranked += 1
        if self.reqlog is not None:
            timings = dict(stage_ms or {})
            timings["rank"] = latency_ms
            self.reqlog.log(
                request_id=request_id, records=[record], scores=[0.0],
                version=version, lineage=lineage, stage_ms=timings,
                kind="rank",
                topk={"k": k, "ids": list(ids),
                      "scores": [float(v) for v in scores]})
        self.registry.bus.post("rank_request", k=k, n=len(ids),
                               latency_ms=latency_ms, version=version,
                               request_id=request_id)
        out = {"ids": list(ids), "scores": [float(v) for v in scores],
               "k": k, "version": version, "lineage": lineage,
               "latency_ms": round(latency_ms, 3),
               "request_id": request_id}
        smh = self.registry.shard_map_hash
        if smh is not None:
            out["shard_map"] = smh
        if deadline is not None:
            out["deadline_ms"] = round(self.remaining_ms(deadline), 1)
        return out

    def healthz(self) -> dict:
        active = self.registry.active_or_none()
        out = {
            "status": "ok" if active is not None else "no_model",
            "version": self.registry.active_version,
            "versions": self.registry.versions(),
            "model_lineage_id": None if active is None else active.lineage,
            "parentModel": (None if active is None
                            else active.parent_lineage),
            "quality_baseline": (active is not None
                                 and active.baseline is not None),
            # the fleet facts a router needs: this host's shard and the
            # governing bucket → shard map
            "fleet_shard": (None if self.registry.fleet_shard is None
                            else list(self.registry.fleet_shard)),
            "shard_map": (None if self.registry.shard_map is None
                          else {"hash": self.registry.shard_map.map_hash,
                                "version": self.registry.shard_map.version,
                                "nShards": self.registry.shard_map.n_shards}),
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
            # the canary's shadow-scoring workload size
            "reservoir": len(self.registry.reservoir),
            "uptime_s": round(time.monotonic() - self._started_monotonic, 1),
            "queue_depth": (0 if self.batcher is None
                            else self.batcher.queue_depth()),
            "shed": _overload.shed_counts(),
            "brownout_level": _overload.level(),
            "connections": self.connections.stats(),
        }
        if self.reqlog is not None:
            out["reqlog"] = self.reqlog.stats()
        if active is not None and active.canary is not None:
            out["canary"] = active.canary
        if active is not None and active.rank_engine is not None:
            out["rank"] = {
                "items": active.rank_engine.index.n_items,
                "max_k": active.rank_engine.max_k,
                "requests": self.n_ranked,
                "compiles": active.rank_engine.compile_count,
                "user_re_coordinates": list(
                    active.rank_engine.user_re_coordinates),
            }
        return out

    def readyz(self) -> tuple[int, dict]:
        """Readiness: ``(200 | 503, body)`` with the reasons and the same
        overload telemetry ``/healthz`` carries."""
        reasons = []
        if self.registry.active_or_none() is None:
            reasons.append("no_active_model")
        if self.batcher is not None and self.batcher.dead is not None:
            reasons.append("batcher_worker_dead")
        if self.rank_batcher is not None \
                and self.rank_batcher.dead is not None:
            reasons.append("rank_batcher_worker_dead")
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
        """One-shot (no ``phase``) or two-phase ``/reload``:

        - ``phase=prepare``: validate, warm and register the candidate
          (a full model dir or a patch) without activating it; returns its
          ``version`` and ``lineage``. The incumbent keeps serving.
        - ``phase=activate`` and ``version``: pin a prepared version.
        - ``phase=abort`` and ``version``: retire a prepared version.
        """
        phase = payload.get("phase")
        if phase in ("activate", "abort"):
            version = payload.get("version")
            if not isinstance(version, int):
                raise ValueError(
                    f"phase={phase} needs the prepared 'version' (int)")
            if phase == "activate":
                previous = self.registry.active_version
                sm = self.registry.activate(version)
                return {"version": sm.version, "previous": previous,
                        "lineage": sm.lineage, "phase": "activated"}
            self.registry.retire(version)
            return {"version": self.registry.active_version,
                    "retired": version, "phase": "aborted"}
        if phase not in (None, "prepare"):
            raise ValueError(f"unknown reload phase {phase!r} (want "
                             f"prepare | activate | abort)")
        if phase == "prepare" and payload.get("shard_map") is not None:
            # a live reshard's prepare: the candidate is a bucket → shard
            # map (the active model repacked), not a model dir;
            # activate / abort above work unchanged on its version
            previous = self.registry.active_version
            sm, moved = self.registry.prepare_reshard(payload["shard_map"])
            return {"version": sm.version, "previous": previous,
                    "lineage": sm.lineage,
                    "shard_map": sm.shard_map.map_hash,
                    "moved": moved, "phase": "prepared"}
        model_dir = payload.get("model_dir") or self.default_model_dir
        if not model_dir:
            raise ValueError("payload needs 'model_dir' (no default "
                             "configured)")
        previous = self.registry.active_version
        if phase == "prepare":
            sm = self.registry.prepare(model_dir)
            out = {"version": sm.version, "previous": previous,
                   "lineage": sm.lineage, "model_dir": sm.model_dir,
                   "phase": "prepared"}
        else:
            sm = self.registry.reload(model_dir)
            out = {"version": sm.version, "previous": previous,
                   "model_dir": sm.model_dir}
        if sm.canary is not None:
            # the activation's canary annotation (divergence vs the
            # incumbent over the request reservoir)
            out["canary"] = sm.canary
        return out

    def close(self) -> None:
        if self.overload is not None:
            # stops the controller and restores brownout level 0
            self.overload.stop()
        if self.batcher is not None:
            self.batcher.close()
        if self.rank_batcher is not None:
            self.rank_batcher.close()
        if self.reqlog is not None:
            self.reqlog.close()


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
            with _maybe_span("serving.respond",
                             request_id=getattr(self, "request_id", None)), \
                    _STAGE_SECONDS.labels(stage="respond").time():
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
                rid = self._request_id()
                parsed = urlsplit(self.path)
                path = parsed.path
                if path == "/rank":
                    # ?user=<raw id>&k=<int>; the deadline is stamped in
                    # the parse stage of the shared tail
                    qs = parse_qs(parsed.query)
                    with _maybe_span("serving.request", request_id=rid,
                                     path="/rank"):
                        self._handle_rank(rid, {key: values[0]
                                                for key, values in qs.items()
                                                if values})
                elif path == "/healthz":
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
                elif path == "/history":
                    self._handle_history(parsed.query)
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            finally:
                service.connections.request_end()

        def _handle_history(self, query: str) -> None:
            """``GET /history?series=&window=[&raw=1]``: the host's
            retained ring (an unknown series or a bad window is a 400, an
            unarmed sampler a 404); ``raw=1`` includes each snapshot's
            watched-subset exposition text, what the router's fold
            scrapes."""
            sampler = service.history
            if sampler is None:
                self._reply(404, {"error": "history sampler not armed"})
                return
            qs = parse_qs(query)
            try:
                window = int((qs.get("window") or ["0"])[0])
                series = tuple(
                    s for s in (qs.get("series") or [""])[0].split(",")
                    if s)
                raw = (qs.get("raw") or ["0"])[0] not in ("", "0")
                data = sampler.payload_json(window=window, series=series,
                                            include_prom=raw)
            except ValueError as e:
                self._reply(400, {"error": str(e)})
                return
            self._reply_raw(200, data, "application/json")

        def _handle_rank(self, rid: str, payload: dict,
                         parse_s: Optional[float] = None) -> None:
            """The /rank tail of the GET (query parameters) and POST (JSON
            body) routes: stamp the deadline unless the POST parse did,
            rank, and map a Shed to 429 as /score does."""
            headers = None
            leg_stages: dict = {}
            try:
                if parse_s is None:
                    with _maybe_span("serving.parse", request_id=rid), \
                            _STAGE_SECONDS.labels(stage="parse").time() as t:
                        fault_point("serving.parse", path="/rank")
                        self.deadline = service.resolve_deadline(
                            self.headers.get(DEADLINE_HEADER))
                    parse_s = t.seconds
                service.check_shard_map(self.headers.get(SHARD_MAP_HEADER))
                out = service.rank(payload, request_id=rid,
                                   stage_ms={"parse": parse_s * 1e3},
                                   deadline=self.deadline,
                                   stage_sink=leg_stages)
                status = 200
            except ShardMapMismatch as e:
                out = {"error": str(e), "reason": "shard_map_mismatch",
                       "request_id": rid}
                status = 503
            except BatcherClosed as e:
                self.close_connection = True
                out = {"error": str(e), "reason": "stopping",
                       "request_id": rid}
                status = 503
            except _overload.Shed as e:
                out = {"error": str(e), "reason": e.reason,
                       "request_id": rid}
                status = shed_status(e)
                headers = {"Retry-After": str(max(1, round(e.retry_after_s)))}
            except ValueError as e:
                out, status = {"error": str(e)}, 400
            except Exception as e:
                out, status = {"error": repr(e)}, 500
            self._reply_with_summary(status, out, headers, leg_stages,
                                     parse_s or 0.0)

        def do_POST(self):  # noqa: N802
            if self._refuse_if_stopping() or self._refuse_if_exhausted():
                return
            self._conn_requests += 1
            service.connections.request_begin()
            try:
                rid = self._request_id()
                with _maybe_span("serving.request", request_id=rid,
                                 path=self.path):
                    self._post(rid)
            finally:
                service.connections.request_end()

        def _post(self, rid: str) -> None:
            with _maybe_span("serving.parse", request_id=rid), \
                    _STAGE_SECONDS.labels(stage="parse").time() as parse_t:
                try:
                    fault_point("serving.parse", path=self.path)
                    payload = self._payload()
                    # the deadline budget is stamped at parse: queueing and
                    # scoring spend the budget the caller measures
                    self.deadline = service.resolve_deadline(
                        self.headers.get(DEADLINE_HEADER))
                    parse_error = None
                except (ValueError, json.JSONDecodeError) as e:
                    parse_error = (400, f"bad request: {e}")
                except Exception as e:
                    # an injected serving.parse fault (or a bug of the
                    # parse path) is the server's error, not the client's
                    parse_error = (500, repr(e))
            if parse_error is not None:
                status, message = parse_error
                self._reply(status, {"error": message})
                return
            path = urlsplit(self.path).path
            if path == "/score":
                headers = None
                leg_stages: dict = {}
                try:
                    service.check_shard_map(
                        self.headers.get(SHARD_MAP_HEADER))
                    out = service.score(
                        payload, request_id=rid,
                        stage_ms={"parse": parse_t.seconds * 1e3},
                        deadline=self.deadline, stage_sink=leg_stages)
                    status = 200
                except ShardMapMismatch as e:
                    # the fan-out was routed under another map generation
                    out = {"error": str(e), "reason": "shard_map_mismatch",
                           "request_id": rid}
                    status = 503
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
            elif path == "/rank":
                # a full record: {"record": ..., "k": N}
                self._handle_rank(rid, payload, parse_s=parse_t.seconds)
            elif path == "/reload":
                try:
                    self._reply(200, service.reload(payload))
                except Exception as e:
                    # the swap was rejected and the active version is
                    # untouched: a conflict, not a server death
                    self._reply(409, {
                        "error": repr(e),
                        "version": service.registry.active_version})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

    return Handler


class GameServer:
    """Threaded HTTP server wrapper with a test-friendly lifecycle. A
    ``watcher`` (:class:`~photon_ml_tpu_torch.serving.watcher.
    ModelDirectoryWatcher`), a ``drift_evaluator``
    (:class:`~photon_ml_tpu_torch.quality.monitor.DriftEvaluator`) and an
    ``autopilot`` (:class:`~photon_ml_tpu_torch.feedback.autopilot.
    FeedbackAutopilot`, stopped first) start and stop with the server.
    ``serve_game`` arms the retained plane on
    the attributes ``history``, ``saturation``, ``flight`` and
    ``watchdog``; :meth:`stop` closes the ring, the recorder and the
    watchdog."""

    def __init__(self, service: ServingService, *, host: str = "127.0.0.1",
                 port: int = 0, watcher=None, drift_evaluator=None,
                 autopilot=None):
        self.service = service
        self.watcher = watcher
        self.drift_evaluator = drift_evaluator
        self.autopilot = autopilot
        self.history = None  # HistorySampler
        self.saturation = None  # SaturationSampler
        self.flight = None  # FlightRecorder (--flight-dir)
        self.watchdog = None  # Watchdog (--watchdog-timeout-s)
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

    def _start_background(self) -> None:
        if self.watcher is not None:
            self.watcher.start()
        if self.drift_evaluator is not None:
            self.drift_evaluator.start()
        if self.autopilot is not None:
            self.autopilot.start()

    def start(self) -> "GameServer":
        self._start_background()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="photon-serving-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._start_background()
        self._httpd.serve_forever()

    def stop(self) -> None:
        # flip the refuse flag before teardown: keep-alive handler threads
        # outlive shutdown() and must answer 503 reason=stopping from here
        self._httpd.photon_stopping = True
        # the loop first: no refresh launches against a server tearing down
        if self.autopilot is not None:
            self.autopilot.stop()
        if self.watcher is not None:
            self.watcher.stop()
        if self.drift_evaluator is not None:
            self.drift_evaluator.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        # every close is idempotent: the command's own finally may repeat it
        for piece in (self.watchdog, self.history, self.flight):
            if piece is not None:
                piece.close()
        self.service.close()
