"""The fleet routing tier: one thin HTTP front for N entity-sharded hosts.

Counterpart of ``photon_ml_tpu/fleet/router.py``; the router is host code
(stdlib HTTP, pooled connections, fan-out threads) and runs unchanged in
front of hosts whose tables live on a CUDA card.

Each serving host (``serve_game --fleet-shard I --fleet-shard-count N``)
packs ~1/N of every random-effect coordinate's dense coefficient table
(``fleet/sharding.py`` decides which ids land where). This router is the
piece that makes the fleet look like ONE server:

- ``POST /score`` — resolves each record's shard(s) from its raw entity
  ids and fans out over persistent per-host connections. Records whose
  entities all live on one shard are scored there outright (that host's
  f32 totals ARE the response — bit-identical to an unsharded server by
  construction). Records spanning shards are scored everywhere involved
  with ``margins=true`` and the router re-runs the ONE score-summation
  contract, :func:`photon_ml_tpu_torch.game.model.sum_coordinate_margins`,
  over
  each coordinate's owner-shard margins — f32 margins widened to double
  in JSON are exact, and the f64-accumulate-then-f32 reduction is the
  same arithmetic the host's trace performs, so merged totals are
  bit-identical too.
- ``GET/POST /rank`` — fans the request to EVERY host (each ranks its own
  item shard) and merges the per-shard top-k by score. Exact per-item
  scores require the user side of the model to be host-invariant — the
  fixed effect is replicated, so this holds for the standard retrieval
  setup (item coordinate = the only random effect); a model with
  user-side RE coordinates is refused rather than silently mis-ranked.
- ``POST /reload`` — the coordinated two-phase activation: every host
  validates + canaries + warms the candidate (``phase=prepare``), the
  router gates ONCE over all verdicts (any refusal, or disagreeing
  candidate lineages, aborts the epoch with the incumbent serving
  fleet-wide), then activates everywhere. The single-host watcher +
  canary gate generalize exactly here: gate at the router, activate
  everywhere.
- ``GET /metrics`` — the fleet fold: every host's ``/metrics`` text,
  scraped over the SAME pooled leg connections, plus the router's own
  registry through
  :func:`photon_ml_tpu_torch.telemetry.aggregate.aggregate_text` (counters
  and histogram series sum; host-owned gauges — queue depth, brownout
  level, rank items — are tagged ``shard="I"``, ``replica="J"`` and fan
  out). ``GET /statusz`` is the human topology page (``fleet/observe.py``).
  ``GET /history`` is the fleet timeline: the hosts' retained rings folded
  against the router's own (``FleetObserver.history``), and ``GET
  /advisor`` the hot-shard advisor's status (``fleet/advisor.py``), both
  armed by ``serve_fleet`` (404 when not).

**Elastic fleet**: each shard can run a REPLICA GROUP of R hosts
(``serve_fleet --replicas R``; the host list is shard-major). A failed
primary leg retries on a backup replica instead of shedding; a merely
SLOW primary is hedged — the backup fires after a p99-derived delay,
first answer wins, the loser's outcome is consumed. Routing goes through
a versioned bucket→shard map (``fleet/sharding.py::ShardMap``: crc32 →
one of 4096 virtual buckets → owning shard); the map's content hash
rides every leg (``X-Photon-Shard-Map``) and every response next to
``lineage``, and a router/host disagreement is refused (503
``reason=shard_map_mismatch``) exactly like mixed lineage. ``POST
/reshard`` drives a NEW map through the same two-phase epoch machinery:
every host repacks its shard view under the candidate (phase 1 — any
refusal aborts with the incumbent map serving fleet-wide), then the
router drains its in-flight fan-outs, activates everywhere, swaps its
own map atomically and reopens — f32 responses stay bit-identical
before, during and after the move.

Failure mapping: a shard whose EVERY replica is dead (connection
failure, fan-out timeout, injected ``fleet.fanout`` fault) becomes a
typed :class:`~photon_ml_tpu_torch.serving.overload.Shed` with
``reason="upstream"`` → **503** + a ``Retry-After`` jittered
deterministically per request id (no wall-clock randomness — lockstep
clients spread instead of stampeding); a request whose deadline budget
is already spent sheds ``reason="deadline"`` and a leg's socket timeout
is capped by the remaining budget, so a fan-out cannot outlive its own
deadline. A host's own 429/503 passes through with its reason. Every
response carries the model content lineage, and a fan-out whose legs
disagree is refused (503 ``reason=mixed_lineage``) — the
no-mixed-lineage invariant is enforced per response, not just promised
by the activation protocol.
"""

from __future__ import annotations

import collections
import contextlib
import http.client
import json
import threading
import time
import urllib.parse
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.fleet.observe import (  # noqa: F401  (re-exported)
    FleetObserver,
    fold_fleet_snapshots,
    tag_host_owned,
)
from photon_ml_tpu_torch.fleet.sharding import (
    ShardMap,
    retry_jitter_s,
    stable_hash_u32,
)
from photon_ml_tpu_torch.game.model import sum_coordinate_margins
from photon_ml_tpu_torch.resilience.faults import fault_point
from photon_ml_tpu_torch.serving import overload as _overload
from photon_ml_tpu_torch.serving.http import (
    DEADLINE_HEADER,
    LEG_SUMMARY_HEADER,
    REQUEST_ID_HEADER,
    SHARD_MAP_HEADER,
    ShardMapMismatch,
    new_request_id,
    parse_leg_summary,
    shed_status,
)
from photon_ml_tpu_torch.telemetry import metrics as _metrics
from photon_ml_tpu_torch.telemetry import tracing as _tracing

#: requests the router answered, by endpoint (score | rank | reload)
_FLEET_REQUESTS = _metrics.counter(
    "photon_fleet_requests_total",
    "Requests served by the fleet router, by endpoint",
    labels=("endpoint",))

#: one per-host fan-out leg's round trip (connect reuse included)
_FANOUT_SECONDS = _metrics.histogram(
    "photon_fleet_fanout_seconds",
    "Per-host leg latency of a fleet router fan-out", labels=("shard",))

#: legs lost to a dead/slow/faulted host (mapped to 503 reason=upstream)
_UPSTREAM_ERRORS = _metrics.counter(
    "photon_fleet_upstream_errors_total",
    "Fan-out legs that failed (connection error, timeout, injected "
    "fleet.fanout fault) — each maps to a typed 503 reason=upstream",
    labels=("shard",))

#: fan-outs refused because host legs answered with different model
#: content lineages — the invariant two-phase activation exists to keep
_MIXED_LINEAGE = _metrics.counter(
    "photon_fleet_mixed_lineage_total",
    "Fleet responses refused because fan-out legs disagreed on model "
    "lineage (503 reason=mixed_lineage)")

#: two-phase /reload outcomes (activated | aborted)
_EPOCHS = _metrics.counter(
    "photon_fleet_epochs_total",
    "Coordinated two-phase reload epochs, by outcome "
    "(activated | aborted)", labels=("outcome",))

#: configured host count (shards × replicas)
_FLEET_HOSTS = _metrics.gauge(
    "photon_fleet_hosts",
    "Serving hosts behind the fleet router (shard count × replicas)")

#: legs retried on a backup replica after the primary failed outright —
#: each retry is a shed AVOIDED (at R=1 the same failure is a 503)
_REPLICA_RETRIES = _metrics.counter(
    "photon_fleet_replica_retries_total",
    "Fan-out legs retried on a backup replica after the primary "
    "replica failed", labels=("shard",))

#: backups fired because the primary outlived the p99-derived hedge
#: delay (tail attack: first answer wins, the loser is consumed)
_HEDGES = _metrics.counter(
    "photon_fleet_hedges_total",
    "Hedge backups fired against a slow primary replica",
    labels=("shard",))

#: hedges where the BACKUP answered first — the hedge paid for itself
_HEDGE_WINS = _metrics.counter(
    "photon_fleet_hedge_wins_total",
    "Hedged legs won by the backup replica", labels=("shard",))

#: live-reshard epochs (two-phase shard-map activation), by outcome
_SHARDMAP_EPOCHS = _metrics.counter(
    "photon_fleet_shardmap_epochs_total",
    "Live reshard epochs (two-phase bucket→shard map activation), by "
    "outcome (activated | aborted)", labels=("outcome",))

#: version of the governing bucket→shard map (starts at 1; each
#: activated reshard epoch advances it)
_SHARDMAP_VERSION = _metrics.gauge(
    "photon_fleet_shardmap_version",
    "Version of the fleet's governing bucket-to-shard map")


def _consume_result(fut) -> None:
    """Done-callback for a hedge loser: the in-flight HTTP exchange
    cannot be cancelled, so it runs to completion in the hedge pool,
    returns its pooled connection through ``HostClient``'s normal
    give-back, and its outcome (including an exception) is consumed
    here — nothing strands, nothing double-counts."""
    if fut.cancelled():
        return
    fut.exception()


class MixedLineageError(RuntimeError):
    """Fan-out legs answered from different model generations — the
    response is refused (503 ``reason=mixed_lineage``) rather than
    stitched together from two models."""


class HostClient:
    """Persistent-connection JSON client for one serving host.

    Connections are pooled and reused across requests (the stdlib
    ``urllib`` one-connection-per-request pattern is exactly the socket
    churn the tail-latency push removed client-side). A request that dies
    on a stale keep-alive — the server closed an idle connection under
    us — is retried ONCE on a fresh connection; a fresh connection
    failing means the host is actually gone, and the caller maps that to
    the typed upstream 503.
    """

    def __init__(self, url: str, shard: int, *, timeout_s: float = 30.0):
        self.url = url.rstrip("/")
        self.shard = int(shard)
        self.timeout_s = float(timeout_s)
        parsed = urllib.parse.urlsplit(self.url)
        self._host = parsed.hostname
        self._port = parsed.port or 80
        self._lock = threading.Lock()
        self._free: list = []  # guarded-by: _lock

    def _take(self):
        with self._lock:
            if self._free:
                return self._free.pop()
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=self.timeout_s)

    def _give(self, conn) -> None:
        with self._lock:
            self._free.append(conn)

    def request(self, method: str, path: str, payload=None,
                headers: Optional[Mapping[str, str]] = None,
                timeout_s: Optional[float] = None,
                raw: bool = False,
                headers_out: Optional[dict] = None) -> "tuple[int, dict]":
        """One JSON request → ``(status, body)``. Raises ``OSError`` /
        ``http.client.HTTPException`` when the host is unreachable past
        the bounded reconnect (the caller owns the upstream mapping).
        ``timeout_s`` caps THIS exchange below the pool-wide default —
        the router passes the request's remaining deadline budget, so a
        leg can never outlive the deadline it is serving.
        ``raw=True`` returns the body as decoded TEXT instead of parsed
        JSON (the observer scrapes ``/metrics`` exposition over these
        same pooled connections — and through the same ``fleet.fanout``
        chaos site). ``headers_out`` receives the response headers the
        caller cares about (the leg-summary stage breakdown)."""
        # the fleet chaos site: one visit per LEG (not per reconnect
        # attempt) — an injected fault is a host that cannot be reached
        fault_point("fleet.fanout", host=self.url, path=path)
        budget = (self.timeout_s if timeout_s is None
                  else max(1e-3, min(float(timeout_s), self.timeout_s)))
        body = None if payload is None else json.dumps(payload).encode()
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        last: Optional[BaseException] = None
        for attempt in range(2):
            conn = self._take()
            conn.timeout = budget
            if getattr(conn, "sock", None) is not None:
                # a pooled connection froze its timeout at connect time;
                # re-arm the live socket with this exchange's budget
                conn.sock.settimeout(budget)
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
                if headers_out is not None:
                    summary = resp.getheader(LEG_SUMMARY_HEADER)
                    if summary is not None:
                        headers_out[LEG_SUMMARY_HEADER] = summary
                if raw:
                    self._give(conn)
                    return resp.status, data.decode()
                status, out = resp.status, json.loads(data or b"{}")
                if status == 503 and out.get("reason") == "stopping":
                    # the host is DRAINING: it answered a complete
                    # exchange but is closing this socket — don't pool
                    # it, and retry once on a provably fresh connection
                    # (a host restarted on the same port answers it; a
                    # truly gone host refuses → the upstream mapping)
                    conn.close()
                    last = ConnectionError(
                        f"host {self.url} is stopping")
                    continue
                self._give(conn)
                return status, out
            except (OSError, http.client.HTTPException) as e:
                # a pooled connection can be stale (server-side idle
                # close); retry once on a provably fresh one
                conn.close()
                last = e
        raise ConnectionError(
            f"host {self.url} unreachable after reconnect: {last!r}")

    def close(self) -> None:
        with self._lock:
            conns, self._free = self._free, []
        for conn in conns:
            conn.close()


class FleetRouter:
    """Endpoint logic of the routing tier, HTTP-free (the handler is
    thin, like ``serving/http.py``'s). One instance fronts N hosts; host
    *i* must be serving fleet shard ``(i, N)``."""

    def __init__(self, host_urls: Sequence[str], *,
                 replicas: int = 1,
                 hedge_delay_ms: float = 0.0,
                 fanout_timeout_s: float = 30.0,
                 default_timeout_ms: float = 0.0):
        if not host_urls:
            raise ValueError("a fleet router needs at least one host url")
        self.replicas = int(replicas)
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if len(host_urls) % self.replicas:
            raise ValueError(
                f"{len(host_urls)} hosts cannot form replica groups of "
                f"{self.replicas} (the host list is shard-major: "
                f"[s0r0, s0r1, s1r0, s1r1, ...])")
        self.n_shards = len(host_urls) // self.replicas
        self.fanout_timeout_s = float(fanout_timeout_s)
        #: fixed hedge delay in ms; 0 = adaptive (p99 of this shard's
        #: recent leg latencies — a hedge should fire on TAIL legs only)
        self.hedge_delay_ms = float(hedge_delay_ms)
        #: ``clients[s][r]`` = replica r of shard s; every replica of a
        #: group serves the same shard view of the same model
        self.clients = [
            [HostClient(host_urls[s * self.replicas + r], shard=s,
                        timeout_s=fanout_timeout_s)
             for r in range(self.replicas)]
            for s in range(self.n_shards)]
        self.default_timeout_ms = float(default_timeout_ms)
        #: the governing bucket→shard map. Starts at the canonical
        #: default (bucket b → b mod N — crc32-equivalent whenever N
        #: divides the bucket count) and is swapped ATOMICALLY under the
        #: drain barrier by an activated reshard epoch (readers see one
        #: whole reference or the other — never a torn map).
        self.shard_map = ShardMap.default(
            self.n_shards)  # guarded-by: _epoch_lock
        #: fan-out worker pool — sized so every shard of two concurrent
        #: requests can be in flight; legs are short-lived, the pool is
        #: process-lifetime
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * self.n_shards),
            thread_name_prefix="photon-fleet-fanout")
        #: replica attempts run on their OWN pool: a leg (running on
        #: _pool) blocks on its replica futures, so sharing one pool
        #: could deadlock with every worker waiting on a queued attempt
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=max(8, 4 * self.n_shards * self.replicas),
            thread_name_prefix="photon-fleet-hedge")
        self._lock = threading.Lock()
        #: recent per-shard leg latencies (seconds) feeding the adaptive
        #: hedge delay; guarded-by: _lat_lock
        self._lat_lock = threading.Lock()
        self._latency = [collections.deque(maxlen=128)
                         for _ in range(self.n_shards)]
        #: legs in flight against each shard right now — the observer
        #: samples this into photon_fleet_shard_load at scrape time
        self._shard_inflight = [0] * self.n_shards  # guarded-by: _lat_lock
        #: serializes two-phase epochs (model reload / live reshard)
        self._epoch_lock = threading.Lock()
        #: the drain barrier: reshard activation waits for in-flight
        #: fan-outs to land and briefly parks new ones, so no response
        #: is ever assembled across two map generations
        self._flight = threading.Condition(threading.Lock())
        self._inflight = 0  # guarded-by: _flight
        self._paused = False  # guarded-by: _flight
        #: model coordinate walk [(cid, entity_type|None)] in order,
        #: fetched from a host's /healthz (refreshed after activation)
        self._coordinates: Optional[list] = None  # guarded-by: _lock
        self._rank_info: Optional[dict] = None  # guarded-by: _lock
        self.n_requests = 0  # guarded-by: _lock
        #: the observability plane — scrapes hosts over THESE pooled
        #: clients, owns /statusz and the optional SLO tracker (no
        #: threads until attach_slo asks for a tick loop)
        self.observer = FleetObserver(self)
        #: the read-only hot-shard advisor behind GET /advisor (serve_fleet
        #: arms it over the observer's history ring)
        self.advisor = None
        _FLEET_HOSTS.set(len(host_urls))
        _SHARDMAP_VERSION.set(self.shard_map.version)

    # --- observability taps ----------------------------------------------
    @property
    def fanout_pool(self) -> ThreadPoolExecutor:
        """The fan-out leg executor, exposed read-only for occupancy
        probes."""
        return self._pool

    @property
    def hedge_pool(self) -> ThreadPoolExecutor:
        """The replica-attempt executor (hedge_pool resource)."""
        return self._hedge_pool

    def latency_snapshot(self) -> "list[list[float]]":
        """Copy of each shard's recent-leg latency window (seconds)."""
        with self._lat_lock:
            return [list(d) for d in self._latency]

    def shard_load(self) -> "list[int]":
        """Legs currently in flight against each shard."""
        with self._lat_lock:
            return list(self._shard_inflight)

    # --- deadlines (same contract as ServingService) ----------------------
    def resolve_deadline(self,
                         budget_ms: "str | float | None") -> Optional[float]:
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

    def _leg_headers(self, request_id: str,
                     deadline: Optional[float],
                     shard_map: Optional[ShardMap] = None) -> dict:
        """Propagated request identity + the REMAINING deadline budget —
        a downstream host spends the same budget the caller measures.
        ``shard_map`` stamps the map generation this fan-out was ROUTED
        under; a host serving a different map refuses the leg (503
        ``reason=shard_map_mismatch``) instead of answering for rows it
        may not own."""
        headers = {REQUEST_ID_HEADER: request_id}
        if deadline is not None:
            headers[DEADLINE_HEADER] = f"{self.remaining_ms(deadline):.1f}"
        if shard_map is not None:
            headers[SHARD_MAP_HEADER] = shard_map.map_hash
        return headers

    # --- the drain barrier ------------------------------------------------
    @contextlib.contextmanager
    def _traffic(self):
        """Every /score and /rank fan-out runs inside this gate. A
        reshard epoch's activation step drains it (waits for in-flight
        fan-outs, briefly parks arrivals), swaps the map, and reopens —
        so a response is never assembled across two map generations and
        no client sees an error for the swap."""
        with self._flight:
            while self._paused:
                self._flight.wait(timeout=1.0)
            self._inflight += 1
        try:
            yield
        finally:
            with self._flight:
                self._inflight -= 1
                self._flight.notify_all()

    def _pause_traffic(self, timeout_s: float) -> bool:
        """Park new fan-outs and wait for in-flight ones to land.
        Returns False (gate reopened by the caller) if the drain did not
        complete within ``timeout_s``."""
        limit = time.monotonic() + timeout_s
        with self._flight:
            self._paused = True
            while self._inflight:
                remaining = limit - time.monotonic()
                if remaining <= 0:
                    return False
                self._flight.wait(timeout=remaining)
        return True

    def _resume_traffic(self) -> None:
        with self._flight:
            self._paused = False
            self._flight.notify_all()

    # --- topology ---------------------------------------------------------
    def topology(self, refresh: bool = False) -> "tuple[list, dict]":
        """``([(cid, entity_type|None), ...], rank_info)`` from a host's
        /healthz — which entity types route, in which order margins
        merge, and whether fleet ranking is supportable."""
        with self._lock:
            if self._coordinates is not None and not refresh:
                return self._coordinates, self._rank_info
        body = self._leg(0, "GET", "/healthz")
        coords = body.get("coordinates")
        if not coords:
            raise RuntimeError(
                "host 0 reports no active model coordinates — is the "
                "fleet serving yet?")
        coordinates = [(cid, etype) for cid, etype in coords]
        rank_info = body.get("rank") or {}
        with self._lock:
            self._coordinates = coordinates
            self._rank_info = rank_info
        return coordinates, rank_info

    # --- fan-out machinery ------------------------------------------------
    def _replica_order(self, request_id: Optional[str]) -> tuple:
        """The deterministic replica walk for one request: primary =
        hash of the request id (spreads load across the group), backups
        in rotation. No wall-clock randomness — the same request id
        always lands on the same primary."""
        if self.replicas == 1:
            return (0,)
        start = (stable_hash_u32(f"replica:{request_id}") % self.replicas
                 if request_id else 0)
        return tuple((start + i) % self.replicas
                     for i in range(self.replicas))

    def _hedge_delay_s(self, shard: int) -> float:
        """When to fire the backup against a still-pending primary: the
        fixed ``hedge_delay_ms`` when configured, else the p99 of this
        shard's recent leg latencies (a hedge should chase TAIL legs —
        ~1% extra load by construction). Until enough samples exist the
        delay is the fan-out timeout, i.e. effectively no hedging."""
        if self.hedge_delay_ms > 0:
            return self.hedge_delay_ms / 1e3
        with self._lat_lock:
            samples = sorted(self._latency[shard])
        if len(samples) < 8:
            return self.fanout_timeout_s
        p99 = samples[min(len(samples) - 1, int(0.99 * len(samples)))]
        return max(0.005, p99)

    def _fanout_leg(self, shard: int, method: str, path: str, payload,
                    headers, request_id: Optional[str],
                    timeout_s: Optional[float],
                    parent_span: Optional[int] = None,
                    ) -> "tuple[int, dict]":
        """One shard's exchange across its replica group: primary first;
        a primary that FAILS is retried on the next replica (counted in
        ``photon_fleet_replica_retries_total``); a primary that is merely
        SLOW is hedged — the backup fires after the hedge delay, the
        first answer wins, and the loser's outcome is consumed (its
        pooled connection returns through the normal give-back).

        Every attempt — primary, retry, hedge — is a ``fleet.leg`` span
        parented on the request's fan-out span (``parent_span``; replica
        attempts run on the hedge pool, where contextvars don't follow),
        so the merged ``trace.jsonl`` shows hedges and retries as
        SIBLINGS under one tree. The host's stage breakdown rides back in
        the leg-summary header and lands as ``host.*`` child spans."""
        group = self.clients[shard]
        label = str(shard)

        def attempt(replica: int, kind: str) -> "tuple[int, dict]":
            with _tracing.span_under(parent_span, "fleet.leg",
                                     shard=label, replica=str(replica),
                                     kind=kind) as sp:
                headers_out: dict = {}
                t0 = time.monotonic()
                out = group[replica].request(method, path, payload,
                                             headers=headers,
                                             timeout_s=timeout_s,
                                             headers_out=headers_out)
                with self._lat_lock:
                    self._latency[shard].append(time.monotonic() - t0)
                summary = parse_leg_summary(
                    headers_out.get(LEG_SUMMARY_HEADER))
                host_span = summary.pop("span", None)
                if host_span is not None:
                    # the host-side span id: joins this leg to the
                    # host's OWN trace file when the two are merged
                    sp.set(host_span=host_span)
                for stage, seconds in summary.items():
                    _tracing.record_span("host." + stage,
                                         seconds=seconds,
                                         parent_id=sp.span_id,
                                         shard=label,
                                         replica=str(replica))
            return out

        if len(group) == 1:
            return attempt(0, "primary")
        order = self._replica_order(request_id)
        pending: dict = {}  # future -> replica
        errors: list = []
        next_i = 0

        def launch(kind: str) -> None:
            nonlocal next_i
            replica = order[next_i]
            next_i += 1
            if kind != "primary":
                try:
                    # the replica-failover chaos surface: an injected
                    # fault means the backup path itself is down, and
                    # the leg degrades to the R=1 outcome
                    fault_point("fleet.replica", shard=label,
                                replica=str(replica), path=path,
                                kind=kind)
                except Exception as e:
                    errors.append(e)
                    return
                if kind == "retry":
                    _REPLICA_RETRIES.labels(shard=label).inc()
            pending[self._hedge_pool.submit(attempt, replica,
                                            kind)] = replica

        launch("primary")
        hedged = False
        start = time.monotonic()
        while True:
            if not pending:
                if next_i < len(order):
                    launch("retry")
                    continue
                raise (errors[-1] if errors else
                       ConnectionError(f"every replica of shard {shard} "
                                       f"failed"))
            timeout = None
            if not hedged and next_i < len(order):
                timeout = max(0.0, self._hedge_delay_s(shard)
                              - (time.monotonic() - start))
            done, _ = wait(set(pending), timeout=timeout,
                           return_when=FIRST_COMPLETED)
            if not done:
                # the primary outlived the hedge delay: fire the backup,
                # first answer wins
                hedged = True
                _HEDGES.labels(shard=label).inc()
                launch("hedge")
                continue
            winner = None
            for fut in done:
                replica = pending.pop(fut)
                try:
                    winner = (replica, fut.result())
                except Exception as e:
                    errors.append(e)
            if winner is None:
                continue
            for loser in pending:
                loser.add_done_callback(_consume_result)
            replica, out = winner
            if hedged and replica != order[0]:
                _HEDGE_WINS.labels(shard=label).inc()
            return out

    @staticmethod
    def _check_status(shard: int, method: str, path: str, status: int,
                      body: dict) -> dict:
        if status in (429, 503):
            reason = body.get("reason", "queue_full")
            if reason == "shard_map_mismatch":
                # the host refused the map generation this fan-out was
                # routed under — surfaced like mixed lineage, not a shed
                raise ShardMapMismatch(
                    body.get("error",
                             f"shard {shard} refused the routed shard "
                             f"map"))
            # the HOST already counted this shed; re-raise the typed
            # refusal without double-counting
            raise _overload.Shed(reason,
                                 body.get("error", f"shard {shard} shed"))
        if status != 200:
            raise RuntimeError(f"fleet shard {shard} {method} {path} -> "
                               f"{status}: {body.get('error', body)!r}")
        return body

    def _leg(self, shard: int, method: str, path: str, payload=None,
             headers=None, request_id: Optional[str] = None,
             deadline: Optional[float] = None,
             parent_span: Optional[int] = None) -> dict:
        """One per-shard leg: timed, replica-failed-over, hedged,
        deadline-bounded, upstream-mapped, shed-passthrough."""
        timeout_s = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # the budget is already spent — shedding here is a
                # DEADLINE refusal, not an upstream failure: no host was
                # lost, the caller simply ran out of time
                raise _overload.shed(
                    "deadline",
                    message=f"deadline expired before shard {shard} leg")
            timeout_s = remaining
        with self._lat_lock:
            self._shard_inflight[shard] += 1
        try:
            return self._timed_leg(shard, method, path, payload, headers,
                                   request_id, timeout_s, deadline,
                                   parent_span)
        finally:
            with self._lat_lock:
                self._shard_inflight[shard] -= 1

    def _timed_leg(self, shard: int, method: str, path: str, payload,
                   headers, request_id: Optional[str],
                   timeout_s: Optional[float],
                   deadline: Optional[float],
                   parent_span: Optional[int]) -> dict:
        with _FANOUT_SECONDS.labels(shard=str(shard)).time() as timer:
            try:
                status, body = self._fanout_leg(shard, method, path,
                                                payload, headers,
                                                request_id, timeout_s,
                                                parent_span=parent_span)
            except Exception as e:
                timer.discard()
                if deadline is not None and time.monotonic() >= deadline:
                    raise _overload.shed(
                        "deadline",
                        message=f"deadline expired during shard {shard} "
                                f"leg: {e!r}") from e
                _UPSTREAM_ERRORS.labels(shard=str(shard)).inc()
                raise _overload.shed(
                    "upstream",
                    message=f"fleet shard {shard} unreachable on every "
                            f"replica: {e!r}",
                    # deterministic per-request jitter (no wall-clock
                    # randomness): synchronized clients spread their
                    # retries instead of stampeding in lockstep
                    retry_after_s=retry_jitter_s(
                        request_id or f"{method} {path}")) from e
        return self._check_status(shard, method, path, status, body)

    def _host_leg(self, shard: int, replica: int, method: str, path: str,
                  payload=None, headers=None) -> dict:
        """One SPECIFIC host's leg (no failover, no hedge): two-phase
        epochs must reach every replica of every shard — preparing 'any
        one replica of shard s' would split the group's lineage."""
        client = self.clients[shard][replica]
        with _FANOUT_SECONDS.labels(shard=str(shard)).time() as timer:
            try:
                status, body = client.request(method, path, payload,
                                              headers=headers)
            except Exception as e:
                timer.discard()
                _UPSTREAM_ERRORS.labels(shard=str(shard)).inc()
                raise _overload.shed(
                    "upstream",
                    message=f"fleet shard {shard} replica {replica} "
                            f"({client.url}) unreachable: {e!r}",
                    retry_after_s=2.0) from e
        return self._check_status(shard, method, path, status, body)

    def _gather(self, legs: "list[tuple]") -> list:
        """Run legs concurrently; returns bodies in leg order, raising
        the FIRST leg failure (after every future settles — no leg is
        left running against a dead request). The caller's open span
        (fleet.score / fleet.rank) is captured HERE, on the request
        thread, and handed to each leg explicitly — pool threads don't
        inherit the tracing contextvars."""
        parent = _tracing.current_span_id()
        futures = [self._pool.submit(self._leg, *leg, parent_span=parent)
                   for leg in legs]
        results, first_error = [], None
        for fut in futures:
            try:
                results.append(fut.result())
            except BaseException as e:  # re-raised below, nothing swallowed
                results.append(None)
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return results

    @staticmethod
    def _check_lineage(bodies: Sequence[dict]) -> Optional[str]:
        lineages = {body.get("lineage") for body in bodies}
        if len(lineages) > 1:
            _MIXED_LINEAGE.inc()
            raise MixedLineageError(
                f"fan-out legs answered from different model lineages "
                f"{sorted(str(x) for x in lineages)} — refusing to stitch "
                f"a mixed response (is a reload epoch half-activated?)")
        return next(iter(lineages)) if lineages else None

    # --- /score -----------------------------------------------------------
    @staticmethod
    def _shards_of(record: dict, coordinates: Sequence[tuple],
                   shard_map: ShardMap) -> tuple:
        """The sorted shard set a record's present entity ids map to
        under ``shard_map`` — crc32 → virtual bucket → owning shard
        (empty metadata → shard 0: any host scores it exactly — every
        coordinate falls back to the replicated fixed effect + zeros)."""
        meta = record.get("metadataMap") or {}
        shards = {shard_map.shard_of(str(meta[etype]))
                  for _cid, etype in coordinates
                  if etype is not None and meta.get(etype) not in (None, "")}
        return tuple(sorted(shards)) if shards else (0,)

    def _check_shard_map(self, expected: ShardMap,
                         bodies: Sequence[dict]) -> None:
        """Every leg must have answered under the map this fan-out was
        routed with — the shard-map twin of :meth:`_check_lineage`
        (defense in depth: hosts already refuse a mismatched
        ``X-Photon-Shard-Map`` header)."""
        hashes = {body.get("shard_map") for body in bodies}
        hashes.discard(None)  # unsharded hosts don't stamp one
        if hashes - {expected.map_hash}:
            raise ShardMapMismatch(
                f"fan-out routed under shard map {expected.map_hash} but "
                f"legs answered under {sorted(hashes)} — refusing a "
                f"mixed-map response (is a reshard epoch half-activated?)")

    def score(self, payload: dict,
              request_id: Optional[str] = None,
              deadline: Optional[float] = None) -> dict:
        """Fleet ``/score``: partition → fan out → merge. Single-shard
        records use the owner host's totals verbatim; cross-shard records
        merge per-coordinate margins through ``sum_coordinate_margins``
        (bit-identical either way)."""
        if request_id is None:
            request_id = new_request_id()
        if "record" in payload:
            records = [payload["record"]]
        else:
            records = payload.get("records")
        if not isinstance(records, list) or not records:
            raise ValueError("payload needs 'records': [non-empty list] "
                             "or 'record': {...}")
        if deadline is not None and time.monotonic() >= deadline:
            raise _overload.shed(
                "deadline", message="deadline expired before fan-out")
        coordinates, _ = self.topology()
        with self._traffic():
            # the map snapshot, the routing decisions and the fan-out all
            # happen inside the drain barrier: a reshard epoch cannot
            # swap the map under a half-routed request
            shard_map = self.shard_map
            groups: dict[tuple, list[int]] = {}
            for i, rec in enumerate(records):
                groups.setdefault(
                    self._shards_of(rec, coordinates, shard_map),
                    []).append(i)
            headers = self._leg_headers(request_id, deadline,
                                        shard_map=shard_map)
            legs, plans = [], []
            for shard_set, idxs in groups.items():
                recs = [records[i] for i in idxs]
                if len(shard_set) == 1:
                    plans.append(("direct", shard_set, idxs, [len(legs)]))
                    legs.append((shard_set[0], "POST", "/score",
                                 {"records": recs}, headers,
                                 request_id, deadline))
                else:
                    # the record spans shards: every involved host scores
                    # it and returns per-coordinate margins; the router
                    # keeps, per coordinate, the margin of the shard that
                    # OWNS that coordinate's entity id
                    plans.append(("margins", shard_set, idxs,
                                  list(range(len(legs),
                                             len(legs) + len(shard_set)))))
                    for s in shard_set:
                        legs.append((s, "POST", "/score",
                                     {"records": recs, "margins": True},
                                     headers, request_id, deadline))
            with _tracing.span("fleet.score", request_id=request_id,
                               batch=len(records), legs=len(legs)):
                bodies = self._gather(legs)
        lineage = self._check_lineage(bodies)
        self._check_shard_map(shard_map, bodies)
        scores: list = [None] * len(records)
        merged = 0
        version = None
        for mode, shard_set, idxs, leg_ids in plans:
            if mode == "direct":
                body = bodies[leg_ids[0]]
                if version is None or shard_set[0] == 0:
                    version = body.get("version")
                for j, i in enumerate(idxs):
                    scores[i] = body["scores"][j]
                continue
            merged += len(idxs)
            by_shard = {s: bodies[leg_id]
                        for s, leg_id in zip(shard_set, leg_ids)}
            primary = by_shard[shard_set[0]]
            if version is None:
                version = primary.get("version")
            margins_of = {s: dict(b["margins"])
                          for s, b in by_shard.items()}
            offsets = np.asarray(primary["offsets"], np.float32)
            merged_margins = []
            for cid, etype in coordinates:
                vals = np.empty(len(idxs), np.float32)
                for j, i in enumerate(idxs):
                    meta = records[i].get("metadataMap") or {}
                    raw = None if etype is None else meta.get(etype)
                    owner = (shard_set[0] if raw in (None, "")
                             else shard_map.shard_of(str(raw)))
                    vals[j] = np.float32(margins_of[owner][cid][j])
                merged_margins.append(vals)
            # THE score-summation contract, re-run over the owner-shard
            # margins: same f64 accumulation, same coordinate order, same
            # f32 inputs ⇒ the same f32 totals the hosts would produce
            totals = sum_coordinate_margins(offsets, merged_margins)
            for j, i in enumerate(idxs):
                scores[i] = float(totals[j])
        with self._lock:
            self.n_requests += 1
        _FLEET_REQUESTS.labels(endpoint="score").inc()
        out = {"scores": scores, "version": version, "lineage": lineage,
               "shard_map": shard_map.map_hash,
               "request_id": request_id,
               "fanout": {"legs": len(legs), "merged": merged}}
        if deadline is not None:
            out["deadline_ms"] = round(self.remaining_ms(deadline), 1)
        return out

    # --- /rank ------------------------------------------------------------
    def rank(self, payload: dict,
             request_id: Optional[str] = None,
             deadline: Optional[float] = None) -> dict:
        """Fleet ``/rank``: fan the request to every host (each ranks its
        own item shard) and merge the top-k by score (ties break by shard
        then within-shard rank — single-host tie order is the global item
        axis, unrecoverable across a hash partition; real trained scores
        are distinct). Models with user-side random-effect coordinates
        are refused: a sharded user store would zero the user's margin on
        foreign hosts."""
        if request_id is None:
            request_id = new_request_id()
        _coordinates, rank_info = self.topology()
        if not rank_info:
            raise ValueError("ranking is not enabled on the fleet's hosts "
                             "(start them with --rank-item-coordinate)")
        if rank_info.get("user_re_coordinates"):
            raise ValueError(
                f"fleet ranking requires the item coordinate to be the "
                f"only random effect; user-side RE coordinates "
                f"{rank_info['user_re_coordinates']} would rank with the "
                f"user's margin zeroed on foreign shards")
        try:
            k = int(payload.get("k", min(10, int(rank_info["max_k"]))))
        except (TypeError, ValueError):
            raise ValueError(
                f"bad k {payload.get('k')!r} (want an integer)") from None
        if deadline is not None and time.monotonic() >= deadline:
            raise _overload.shed(
                "deadline", message="deadline expired before fan-out")
        leg_payload = {key: payload[key]
                       for key in ("record", "user") if key in payload}
        leg_payload["k"] = k
        with self._traffic():
            shard_map = self.shard_map
            headers = self._leg_headers(request_id, deadline,
                                        shard_map=shard_map)
            legs = [(s, "POST", "/rank", leg_payload, headers,
                     request_id, deadline)
                    for s in range(self.n_shards)]
            with _tracing.span("fleet.rank", request_id=request_id, k=k,
                               legs=len(legs)):
                bodies = self._gather(legs)
        lineage = self._check_lineage(bodies)
        self._check_shard_map(shard_map, bodies)
        ranked = []  # (-score, shard, within-shard rank, id)
        for shard, body in enumerate(bodies):
            for pos, (item, score) in enumerate(zip(body["ids"],
                                                    body["scores"])):
                ranked.append((-float(score), shard, pos, str(item)))
        ranked.sort()
        top = ranked[:k]
        with self._lock:
            self.n_requests += 1
        _FLEET_REQUESTS.labels(endpoint="rank").inc()
        out = {"ids": [item for _s, _sh, _p, item in top],
               "scores": [-neg for neg, _sh, _p, _i in top],
               "k": k, "lineage": lineage,
               "shard_map": shard_map.map_hash,
               "request_id": request_id,
               "version": bodies[0].get("version")}
        if deadline is not None:
            out["deadline_ms"] = round(self.remaining_ms(deadline), 1)
        return out

    # --- two-phase /reload ------------------------------------------------
    def reload(self, payload: dict,
               request_id: Optional[str] = None) -> dict:
        """Coordinated two-phase activation. ``model_dir`` names one
        candidate for every host; ``model_dirs`` (length N) names
        per-host candidates — the ``refresh_game --fleet-shards`` patch
        layout. Phase 1 (``prepare``) runs each host's full
        validate+canary+warm gate; ANY refusal — or the prepared
        candidates disagreeing on lineage — aborts the epoch (prepared
        versions retired, incumbent serving fleet-wide, 409 up). Phase 2
        activates every host's prepared version."""
        if request_id is None:
            request_id = new_request_id()
        dirs = payload.get("model_dirs")
        if dirs is None:
            model_dir = payload.get("model_dir")
            if not model_dir:
                raise ValueError("payload needs 'model_dir' (one for the "
                                 "whole fleet) or 'model_dirs' (one per "
                                 "host)")
            dirs = [model_dir] * self.n_shards
        if len(dirs) != self.n_shards:
            raise ValueError(f"'model_dirs' must name {self.n_shards} "
                             f"dirs (one per shard), got {len(dirs)}")
        headers = self._leg_headers(request_id, None)
        _FLEET_REQUESTS.labels(endpoint="reload").inc()
        with self._epoch_lock, \
                _tracing.span("fleet.reload", request_id=request_id):
            # --- phase 1: EVERY host (all replicas of all shards)
            # validates, canaries and warms — preparing only one replica
            # per group would split the group's lineage on failover
            prepared, errors = self._prepare_epoch(
                {(s, r): {"model_dir": dirs[s], "phase": "prepare"}
                 for s in range(self.n_shards)
                 for r in range(self.replicas)}, headers)
            lineages = {body["lineage"] for body in prepared.values()}
            if not errors and len(lineages) > 1:
                errors[(-1, -1)] = (
                    f"prepared candidates disagree on lineage "
                    f"{sorted(str(x) for x in lineages)}")
            if errors:
                # --- abort: retire whatever prepared; incumbent serves
                self._abort(prepared, headers)
                _EPOCHS.labels(outcome="aborted").inc()
                raise RuntimeError(
                    f"two-phase reload aborted — incumbent keeps serving "
                    f"fleet-wide; refusals: "
                    + "; ".join(self._host_name(s, r) + f": {err}"
                                for (s, r), err in sorted(errors.items())))
            # --- phase 2: activate everywhere ---------------------------
            activations = self._activate_epoch(prepared, headers)
        _EPOCHS.labels(outcome="activated").inc()
        # coordinate structure may have changed (it rarely does) — the
        # next request routes on the fresh topology either way
        self.topology(refresh=True)
        hosts = sorted(activations)
        return {"lineage": next(iter(lineages)),
                "versions": [activations[h]["version"] for h in hosts],
                "previous": [activations[h].get("previous")
                             for h in hosts],
                "request_id": request_id}

    def _host_name(self, shard: int, replica: int) -> str:
        if shard < 0:
            return "fleet"
        if self.replicas == 1:
            return f"shard {shard}"
        return f"shard {shard} replica {replica}"

    def _prepare_epoch(self, payloads: "dict[tuple, dict]",
                       headers: dict) -> "tuple[dict, dict]":
        """Fan a phase-1 prepare to every named host; returns
        ``(prepared, errors)`` keyed by ``(shard, replica)``."""
        futures = {key: self._pool.submit(self._host_leg, key[0], key[1],
                                          "POST", "/reload", body, headers)
                   for key, body in payloads.items()}
        prepared: dict = {}
        errors: dict = {}
        for key, fut in futures.items():
            try:
                prepared[key] = fut.result()
            except Exception as e:
                errors[key] = repr(e)
        return prepared, errors

    def _activate_epoch(self, prepared: "dict[tuple, dict]",
                        headers: dict) -> "dict[tuple, dict]":
        """Fan phase 2 to every prepared host, raising the first
        failure (after every future settles)."""
        futures = {key: self._pool.submit(
            self._host_leg, key[0], key[1], "POST", "/reload",
            {"phase": "activate", "version": body["version"]}, headers)
            for key, body in prepared.items()}
        activations: dict = {}
        first_error = None
        for key, fut in futures.items():
            try:
                activations[key] = fut.result()
            except BaseException as e:
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return activations

    def _abort(self, prepared: "dict[tuple, dict]",
               headers: dict) -> None:
        """Best-effort retire of every prepared-but-unactivated version.
        A host that cannot be reached keeps the version registered (never
        ACTIVE — it pins some memory until the next successful epoch or
        restart, it cannot serve)."""
        for (s, r), body in prepared.items():
            try:
                self._host_leg(s, r, "POST", "/reload",
                               {"phase": "abort",
                                "version": body["version"]},
                               headers)
            except Exception:
                pass  # the abort is advisory; the version was never active

    # --- live resharding --------------------------------------------------
    def reshard(self, payload: dict,
                request_id: Optional[str] = None) -> dict:
        """LIVE RESHARD: drive a new bucket→shard map through the same
        two-phase epoch as a model reload. ``payload`` carries either
        ``moves`` ({bucket: new_shard} — the explicit O(moved) form) or a
        full ``shard_map`` dict. Phase 1 has every host repack its shard
        view under the candidate map (the active model's content,
        re-bucketed — hosts report per-direction row-movement counters);
        ANY refusal aborts fleet-wide with the incumbent map serving.
        Phase 2 drains the router's in-flight fan-outs (the drain
        barrier), activates everywhere, swaps the router's map
        atomically, and reopens — f32 responses are bit-identical
        before, during and after, and no response ever mixes maps."""
        if request_id is None:
            request_id = new_request_id()
        incumbent = self.shard_map
        moves = payload.get("moves")
        if moves is not None:
            if not isinstance(moves, Mapping) or not moves:
                raise ValueError("'moves' must be a non-empty mapping of "
                                 "{bucket: new_shard}")
            try:
                candidate = incumbent.with_moves(
                    {int(b): int(s) for b, s in moves.items()})
            except (TypeError, ValueError) as e:
                raise ValueError(f"bad reshard moves: {e}") from None
        elif payload.get("shard_map") is not None:
            candidate = ShardMap.from_dict(payload["shard_map"])
            if candidate.n_shards != self.n_shards:
                raise ValueError(
                    f"candidate map names {candidate.n_shards} shards, "
                    f"this fleet has {self.n_shards}")
        else:
            raise ValueError("payload needs 'moves' ({bucket: new_shard}) "
                             "or a full 'shard_map'")
        n_moved_buckets = len(incumbent.moved_buckets(candidate))
        headers = self._leg_headers(request_id, None)
        _FLEET_REQUESTS.labels(endpoint="reshard").inc()
        with self._epoch_lock, \
                _tracing.span("fleet.reshard", request_id=request_id,
                              moved_buckets=n_moved_buckets):
            # --- phase 1: every host repacks under the candidate map ----
            prepared, errors = self._prepare_epoch(
                {(s, r): {"phase": "prepare",
                          "shard_map": candidate.as_dict()}
                 for s in range(self.n_shards)
                 for r in range(self.replicas)}, headers)
            if errors:
                self._abort(prepared, headers)
                _SHARDMAP_EPOCHS.labels(outcome="aborted").inc()
                raise RuntimeError(
                    f"reshard epoch aborted — incumbent map "
                    f"{incumbent.map_hash} keeps serving fleet-wide; "
                    f"refusals: "
                    + "; ".join(self._host_name(s, r) + f": {err}"
                                for (s, r), err in sorted(errors.items())))
            # --- phase 2: drain, activate everywhere, swap, reopen ------
            if not self._pause_traffic(self.fanout_timeout_s):
                self._resume_traffic()
                self._abort(prepared, headers)
                _SHARDMAP_EPOCHS.labels(outcome="aborted").inc()
                raise RuntimeError(
                    f"reshard epoch aborted — in-flight fan-outs did not "
                    f"drain within {self.fanout_timeout_s}s; incumbent "
                    f"map {incumbent.map_hash} keeps serving fleet-wide")
            try:
                activations = self._activate_epoch(prepared, headers)
                self.shard_map = candidate
                _SHARDMAP_VERSION.set(candidate.version)
            finally:
                # on an activation failure the router keeps the incumbent
                # map: hosts that did activate will REFUSE its hash
                # (shard_map_mismatch) rather than serve mixed — refusal,
                # never silent wrongness
                self._resume_traffic()
        _SHARDMAP_EPOCHS.labels(outcome="activated").inc()
        moved = {"moved_in": 0, "moved_out": 0, "retained": 0}
        for body in prepared.values():
            for key in moved:
                moved[key] += int((body.get("moved") or {}).get(key, 0))
        hosts = sorted(activations)
        return {"shard_map": candidate.map_hash,
                "map_version": candidate.version,
                "previous": incumbent.map_hash,
                "moved_buckets": n_moved_buckets,
                "moved": moved,
                "moved_hosts": {self._host_name(s, r):
                                prepared[(s, r)].get("moved")
                                for (s, r) in hosts},
                "versions": [activations[h]["version"] for h in hosts],
                "request_id": request_id}

    # --- health + metrics -------------------------------------------------
    def healthz(self) -> dict:
        hosts = []
        for s in range(self.n_shards):
            for r in range(self.replicas):
                client = self.clients[s][r]
                entry = {"shard": s, "replica": r, "url": client.url}
                try:
                    status, body = client.request("GET", "/healthz")
                    if status != 200:
                        raise RuntimeError(f"/healthz -> {status}")
                    entry.update(
                        status=body.get("status"),
                        version=body.get("version"),
                        lineage=body.get("model_lineage_id"),
                        fleet_shard=body.get("fleet_shard"),
                        shard_map=(body.get("shard_map") or {}).get("hash"))
                except Exception as e:
                    entry.update(status="unreachable", error=repr(e))
                hosts.append(entry)
        lineages = {h.get("lineage") for h in hosts
                    if h.get("status") == "ok"}
        maps = {h.get("shard_map") for h in hosts
                if h.get("status") == "ok"} - {None}
        # per-shard replica coverage — the operator's first question
        # about a degraded fleet is "which shard, how much redundancy
        # left", not "which host"
        replicas_up = [0] * self.n_shards
        for h in hosts:
            if h.get("status") == "ok":
                replicas_up[h["shard"]] += 1
        return {"status": "ok" if all(h.get("status") == "ok"
                                      for h in hosts) else "degraded",
                "n_shards": self.n_shards,
                "replicas": self.replicas,
                "requests": self.n_requests,
                "mixed_lineage": len(lineages) > 1,
                "shard_map": {"hash": self.shard_map.map_hash,
                              "version": self.shard_map.version,
                              "mixed": bool(maps
                                            - {self.shard_map.map_hash})},
                "shard_replicas_up": replicas_up,
                "hosts": hosts,
                "shed": _overload.shed_counts()}

    def readyz(self) -> "tuple[int, dict]":
        """Ready iff every SHARD has at least one ready replica — a
        fleet missing a whole shard serves wrong-by-omission scores for
        that shard's entities, so it is not ready, merely alive. A group
        down to fewer replicas than configured is degraded-but-ready
        (that is exactly what the redundancy is for)."""
        reasons = []
        uncovered = []
        for s in range(self.n_shards):
            group_reasons = []
            for r in range(self.replicas):
                try:
                    status, body = self.clients[s][r].request("GET",
                                                              "/readyz")
                    if status == 200:
                        group_reasons = []
                        break
                    group_reasons.append(
                        f"{self._host_name(s, r)}: "
                        f"{','.join(body.get('reasons', []))}")
                except Exception as e:
                    group_reasons.append(
                        f"{self._host_name(s, r)}: unreachable ({e!r})")
            if group_reasons:
                uncovered.append(s)
            reasons.extend(group_reasons)
        body = {"ready": not reasons, "reasons": reasons,
                "n_shards": self.n_shards, "replicas": self.replicas}
        if uncovered:
            # the typed refusal: a shard with ZERO live replicas means
            # wrong-by-omission scores, the one thing /readyz gates
            body["reason"] = "shard_uncovered"
            body["uncovered_shards"] = uncovered
        return (200 if not reasons else 503), body

    def metrics_text(self) -> str:
        """The fleet-folded exposition: the router's own registry first
        (chief semantics), then every live host's snapshot — scraped
        over the POOLED leg connections — with host-owned gauges tagged
        ``shard="I"``, ``replica="J"`` so they fan out per host (the JAX
        router's fold, byte for byte on the same texts). A host failing
        mid-scrape leaves a
        ``photon_fleet_scrape_errors_total`` annotation, never a 500."""
        return self.observer.metrics_text()

    def statusz(self) -> dict:
        """The fleet topology page (``GET /statusz``) — delegated to the
        observability plane."""
        return self.observer.statusz()

    def close(self) -> None:
        self.observer.close()
        self._pool.shutdown(wait=True)
        self._hedge_pool.shutdown(wait=True)
        for group in self.clients:
            for client in group:
                client.close()


# ---------------------------------------------------------------------------
# the HTTP front (thin marshaling, like serving/http.py's handler)
# ---------------------------------------------------------------------------


def _make_handler(router: FleetRouter):
    class Handler(BaseHTTPRequestHandler):
        # persistent connections, like the serving front end (every
        # reply carries Content-Length)
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY, as the serving front end sets it: a reply goes out
        # as two writes (headers, body), and with Nagle the body waits for
        # the client's delayed ACK, ~40 ms a keep-alive request
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _request_id(self) -> str:
            inbound = self.headers.get(REQUEST_ID_HEADER)
            self.request_id = inbound.strip() if inbound \
                else new_request_id()
            return self.request_id

        def _reply(self, status: int, body: dict,
                   headers: Optional[dict] = None) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            rid = getattr(self, "request_id", None)
            if rid is not None:
                self.send_header(REQUEST_ID_HEADER, rid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _payload(self) -> dict:
            length = int(self.headers.get("Content-Length") or 0)
            if not length:
                return {}
            return json.loads(self.rfile.read(length) or b"{}")

        def _dispatch(self, rid: str, fn, payload: dict,
                      deadline: Optional[float]) -> None:
            # the root of the merged trace: fleet.score/rank and every
            # fleet.leg (hedges and retries included) nest under this
            # one request-id-tagged span; its outcome feeds the SLO
            # burn tracker when one is attached
            headers = None
            t0 = time.monotonic()
            with _tracing.span("fleet.request", request_id=rid):
                try:
                    out = fn(payload, request_id=rid, deadline=deadline)
                    status = 200
                except _overload.Shed as e:
                    out = {"error": str(e), "reason": e.reason,
                           "request_id": rid}
                    status = shed_status(e)
                    headers = {"Retry-After":
                               str(max(1, round(e.retry_after_s)))}
                except MixedLineageError as e:
                    out = {"error": str(e), "reason": "mixed_lineage",
                           "request_id": rid}
                    status = 503
                except ShardMapMismatch as e:
                    out = {"error": str(e), "reason": "shard_map_mismatch",
                           "request_id": rid}
                    status = 503
                except ValueError as e:
                    out, status = {"error": str(e)}, 400
                except Exception as e:
                    out, status = {"error": repr(e)}, 500
            router.observer.observe_request(time.monotonic() - t0,
                                            ok=status == 200)
            self._reply(status, out, headers=headers)

        def do_GET(self):  # noqa: N802
            rid = self._request_id()
            parsed = urllib.parse.urlsplit(self.path)
            if parsed.path == "/rank":
                qs = urllib.parse.parse_qs(parsed.query)
                payload = {key: values[0] for key, values in qs.items()
                           if values}
                try:
                    deadline = router.resolve_deadline(
                        self.headers.get(DEADLINE_HEADER))
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                self._dispatch(rid, router.rank, payload, deadline)
            elif parsed.path == "/healthz":
                self._reply(200, router.healthz())
            elif parsed.path == "/readyz":
                status, body = router.readyz()
                self._reply(status, body)
            elif parsed.path == "/metrics":
                from photon_ml_tpu_torch.telemetry.prometheus import (
                    CONTENT_TYPE,
                )

                data = router.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif parsed.path == "/statusz":
                self._reply(200, router.statusz())
            elif parsed.path == "/history":
                # the fleet timeline: the hosts' rings folded against the
                # router's own with the metrics_fold merge
                qs = urllib.parse.parse_qs(parsed.query)
                try:
                    window = int((qs.get("window") or ["0"])[0])
                    series = tuple(
                        s for s in (qs.get("series") or [""])[0].split(",")
                        if s)
                    raw = (qs.get("raw") or ["0"])[0] not in ("", "0")
                    body = router.observer.history(
                        window=window, series=series, include_prom=raw)
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                except RuntimeError as e:
                    self._reply(404, {"error": str(e)})
                    return
                self._reply(200, body)
            elif parsed.path == "/advisor":
                if router.advisor is None:
                    self._reply(404, {"error": "hot-shard advisor "
                                               "not armed"})
                    return
                self._reply(200, router.advisor.status())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            rid = self._request_id()
            try:
                payload = self._payload()
                deadline = router.resolve_deadline(
                    self.headers.get(DEADLINE_HEADER))
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            if self.path == "/score":
                self._dispatch(rid, router.score, payload, deadline)
            elif self.path == "/rank":
                self._dispatch(rid, router.rank, payload, deadline)
            elif self.path == "/reload":
                try:
                    self._reply(200, router.reload(payload,
                                                   request_id=rid))
                except Exception as e:
                    # an aborted epoch is a CONFLICT: the incumbent is
                    # untouched on every host, exactly like a single
                    # host's rejected /reload
                    self._reply(409, {"error": repr(e)})
            elif self.path == "/reshard":
                try:
                    self._reply(200, router.reshard(payload,
                                                    request_id=rid))
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                except Exception as e:
                    # an aborted reshard epoch is a CONFLICT too: the
                    # incumbent map keeps serving fleet-wide
                    self._reply(409, {"error": repr(e)})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

    return Handler


class RouterServer:
    """Threaded HTTP wrapper for :class:`FleetRouter` — the same
    test-friendly lifecycle as ``serving/http.py::GameServer``."""

    def __init__(self, router: FleetRouter, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_handler(router))
        #: start/stop are operator-lifecycle calls from one control thread
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "RouterServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="photon-fleet-router")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        self.router.close()
