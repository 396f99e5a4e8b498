"""On-host telemetry history: a bounded ring of periodic metric snapshots.

Counterpart of ``photon_ml_tpu/telemetry/history.py``. ``/metrics`` is a
point in time; this module keeps the minutes before it. A
:class:`HistorySampler` snapshots a closed subset of the process registry
(:data:`WATCHED_FAMILIES`), derives the operator-facing series
(:data:`HISTORY_SERIES`: shed rate, hedge rate, per-shard p50/p99, compile
count, ...) and keeps the last ``capacity`` snapshots in a ring. ``GET
/history?series=&window=`` serves the ring on a serving host
(``serving/http.py``) and on the fleet router (``fleet/router.py``); the
router folds the hosts' rings into one fleet timeline with
:func:`fold_history`, through the counter / gauge / histogram merge of
:mod:`photon_ml_tpu_torch.telemetry.aggregate` that ``tools/metrics_fold.py``
applies offline.

Sampling takes an injectable tick: :meth:`HistorySampler.sample` accepts a
monotonic ``now``, so tests drive the clock instead of sleeping. The series
names are a closed set, so the ring's size is bounded whatever the
traffic. The snapshot's JSON (``/history``) and its fields are the JAX
package's.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Callable, Iterable, Optional, Sequence

from photon_ml_tpu_torch.telemetry.metrics import (
    default_registry,
    quantile_from_buckets,
)
from photon_ml_tpu_torch.telemetry.prometheus import (
    ParsedSnapshot,
    parse_text,
    render,
)

__all__ = [
    "HISTORY_SERIES",
    "WATCHED_FAMILIES",
    "HistorySampler",
    "derive_series",
    "fold_history",
    "history_payload",
    "subset_text",
]

#: metric families the history ring retains — a CLOSED set. Everything
#: else on the registry stays scrape-only; retaining a family costs ring
#: bytes on every host forever, so additions are a reviewed decision
#: (mirrors the leg-summary stage vocabulary in ``serving/http.py``).
WATCHED_FAMILIES = (
    "photon_compiles_total",
    "photon_connections_open",
    "photon_fleet_hedges_total",
    "photon_fleet_requests_total",
    "photon_fleet_shard_load",
    "photon_fleet_shard_p50_seconds",
    "photon_fleet_shard_p99_seconds",
    "photon_fleet_upstream_errors_total",
    "photon_resource_saturation",
    "photon_resource_utilization",
    "photon_serving_queue_depth",
    "photon_serving_request_latency_seconds",
    "photon_serving_requests_total",
    "photon_shed_total",
    "photon_slo_burn_total",
)

#: derived series a snapshot carries — the CLOSED query vocabulary for
#: ``GET /history?series=``. Unknown names are a 400, never an empty
#: timeline, so a typo'd dashboard fails loudly.
HISTORY_SERIES = (
    "compiles",
    "duty_cycle",
    "hedge_rate",
    "latency_p50",
    "latency_p99",
    "open_connections",
    "queue_depth",
    "requests",
    "resource_util",
    "shard_binding",
    "shard_load",
    "shard_p50",
    "shard_p99",
    "shed_rate",
    "slo_burn",
    "upstream_errors",
)

#: series names (and flight-recorder field names) must look like this
SERIES_NAME_RE = re.compile(r"\A[a-z][a-z0-9_]{0,59}\Z")

DEFAULT_CAPACITY = 240

_SUFFIXES = ("_bucket", "_sum", "_count")


def _family_of(series_name: str) -> str:
    for suffix in _SUFFIXES:
        if series_name.endswith(suffix):
            return series_name[: -len(suffix)]
    return series_name


def subset_text(text: str,
                families: Sequence[str] = WATCHED_FAMILIES) -> str:
    """Exposition ``text`` reduced to the watched families (HELP/TYPE
    headers kept). The result round-trips through
    :func:`~photon_ml_tpu_torch.telemetry.prometheus.parse_text` like any
    scrape, which is what lets :func:`fold_history` reuse the aggregate
    merge path unchanged."""
    keep = frozenset(families)
    lines = []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            name = parts[2] if len(parts) > 2 else ""
        else:
            name = _family_of(line.split("{", 1)[0].split(None, 1)[0])
        if name in keep:
            lines.append(line)
    return "\n".join(lines) + "\n" if lines else ""


def _counter_sum(parsed: ParsedSnapshot, name: str) -> float:
    return float(sum(v for _labels, v in parsed.get(name, ())))


def _labeled_gauge(parsed: ParsedSnapshot, name: str,
                   label: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for labels, value in parsed.get(name, ()):
        if label in labels:
            out[labels[label]] = float(value)
    return out


def _labeled_max(parsed: ParsedSnapshot, name: str,
                 label: str) -> dict[str, float]:
    """Per-``label`` maxima of gauge ``name`` — on folded text a
    host-owned gauge fans out per host, and the capacity question is
    "how saturated is the WORST instance", never the average."""
    out: dict[str, float] = {}
    for labels, value in parsed.get(name, ()):
        key = labels.get(label)
        if key is not None and float(value) > out.get(key, float("-inf")):
            out[key] = float(value)
    return out


def _shard_binding(parsed: ParsedSnapshot) -> dict[str, str]:
    """Per-shard binding resource: the resource with the highest
    utilization among this shard's fanned-out
    ``photon_resource_utilization`` series (ties break to the
    lexicographically first resource — deterministic, like every fold).
    Host-tier snapshots carry no ``shard`` label, so the dict is empty
    there and populated exactly where it means something: the folded
    fleet timeline."""
    best: dict[str, tuple[float, str]] = {}
    for labels, value in parsed.get("photon_resource_utilization", ()):
        shard = labels.get("shard")
        resource = labels.get("resource")
        if shard is None or resource is None:
            continue
        cur = best.get(shard)
        value = float(value)
        if cur is None or value > cur[0] \
                or (value == cur[0] and resource < cur[1]):
            best[shard] = (value, resource)
    return {shard: resource for shard, (_v, resource) in best.items()}


def _hist_cumulative(parsed: ParsedSnapshot,
                     name: str) -> tuple[list[float], list[float]]:
    """Summed-over-labels cumulative bucket counts for histogram
    ``name`` as ``(finite_uppers, cumulative_counts_incl_inf)``."""
    by_upper: dict[float, float] = {}
    for labels, value in parsed.get(name + "_bucket", ()):
        le = labels.get("le", "+Inf")
        upper = float("inf") if le == "+Inf" else float(le)
        by_upper[upper] = by_upper.get(upper, 0.0) + float(value)
    uppers = sorted(u for u in by_upper if u != float("inf"))
    cum = [by_upper[u] for u in uppers]
    cum.append(by_upper.get(float("inf"), cum[-1] if cum else 0.0))
    return uppers, cum


def _window_quantile(prev: Optional[ParsedSnapshot], cur: ParsedSnapshot,
                     name: str, q: float) -> Optional[float]:
    """Quantile of the observations that arrived BETWEEN two snapshots
    (bucket-count deltas), so the timeline shows the latency of each
    interval rather than a since-boot average. ``None`` when the
    interval saw no observations."""
    uppers, cum = _hist_cumulative(cur, name)
    if prev is not None:
        p_uppers, p_cum = _hist_cumulative(prev, name)
        if p_uppers == uppers:
            cum = [max(0.0, c - p) for c, p in zip(cum, p_cum)]
    if not uppers or cum[-1] <= 0:
        return None
    return float(quantile_from_buckets(uppers, cum, q))


def _delta(prev: Optional[ParsedSnapshot], cur: ParsedSnapshot,
           name: str) -> float:
    base = _counter_sum(prev, name) if prev is not None else 0.0
    return max(0.0, _counter_sum(cur, name) - base)


def derive_series(prev: Optional[ParsedSnapshot], cur: ParsedSnapshot,
                  dt_s: float) -> dict:
    """The :data:`HISTORY_SERIES` values for one interval, computed from
    two parsed watched-subset snapshots. This is the ONE derivation path
    — the router's fleet timeline calls it on *folded* text, so a
    derived fleet signal is by construction the same function of the
    folded families that each host applies to its own."""
    dt = max(float(dt_s), 1e-9)
    requests = _delta(prev, cur, "photon_serving_requests_total")
    shed = _delta(prev, cur, "photon_shed_total")
    hedges = _delta(prev, cur, "photon_fleet_hedges_total")
    fleet_requests = _delta(prev, cur, "photon_fleet_requests_total")
    return {
        "compiles": _counter_sum(cur, "photon_compiles_total"),
        # device-seconds per wall second: on host text this is one duty
        # cycle in [0, 1]; on folded text the fanned-out per-host gauges
        # SUM, so the fleet reads in device-seconds/second (N hosts
        # flat-out = N.0) — capacity, not a percentage
        "duty_cycle": float(sum(
            v for labels, v in cur.get("photon_resource_utilization", ())
            if labels.get("resource") == "device")),
        "hedge_rate": hedges / max(fleet_requests, 1.0),
        "latency_p50": _window_quantile(
            prev, cur, "photon_serving_request_latency_seconds", 0.50),
        "latency_p99": _window_quantile(
            prev, cur, "photon_serving_request_latency_seconds", 0.99),
        "open_connections": float(sum(
            v for _l, v in cur.get("photon_connections_open", ()))),
        "queue_depth": float(sum(
            v for _l, v in cur.get("photon_serving_queue_depth", ()))),
        "requests": requests,
        # worst-instance utilization per resource — the binding axis of
        # the USE plane (max across hosts on folded text: the capacity
        # question is about the most constrained instance)
        "resource_util": _labeled_max(
            cur, "photon_resource_utilization", "resource"),
        # shard → its most-utilized resource, readable only on folded
        # text (host-owned gauges carry shard labels there); what the
        # hot-shard advisor stamps on detections
        "shard_binding": _shard_binding(cur),
        "shard_load": _labeled_gauge(
            cur, "photon_fleet_shard_load", "shard"),
        "shard_p50": _labeled_gauge(
            cur, "photon_fleet_shard_p50_seconds", "shard"),
        "shard_p99": _labeled_gauge(
            cur, "photon_fleet_shard_p99_seconds", "shard"),
        "shed_rate": shed / max(shed + requests, 1.0),
        "slo_burn": _delta(prev, cur, "photon_slo_burn_total"),
        "upstream_errors": _delta(
            prev, cur, "photon_fleet_upstream_errors_total"),
    }


def history_payload(snapshots: Sequence[dict], *, source: str,
                    capacity: int, window: int = 0,
                    series: Iterable[str] = (),
                    include_prom: bool = False) -> dict:
    """The ``GET /history`` response body: the last ``window`` snapshots
    (0 = all retained), each reduced to the requested ``series`` (empty
    = all). ``include_prom`` (the ``?raw=1`` form) ships each snapshot's
    watched-subset exposition text too — what the router's fold
    consumes. Raises :class:`ValueError` on a name outside the closed
    vocabulary — the handlers map that to a 400."""
    wanted = tuple(series)
    for name in wanted:
        if name not in HISTORY_SERIES:
            raise ValueError(
                f"unknown history series {name!r}: the vocabulary is "
                f"closed ({', '.join(HISTORY_SERIES)})")
    snaps = list(snapshots)
    if window:
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        snaps = snaps[-window:]
    out = []
    for snap in snaps:
        values = snap["series"]
        if wanted:
            values = {k: values[k] for k in wanted}
        row = {"tick": snap["tick"], "ts": snap["ts"], "series": values}
        if include_prom:
            row["prom"] = snap["prom"]
        out.append(row)
    return {"source": source, "capacity": capacity,
            "series": list(wanted or HISTORY_SERIES), "snapshots": out}


class HistorySampler:
    """Bounded ring of watched-subset snapshots over one registry.

    ``sample(now=None)`` is the injectable tick: it renders the watched
    subset, derives the interval's :data:`HISTORY_SERIES`, appends one
    snapshot and notifies listeners — all under one lock discipline
    (ring mutation under ``_lock``; the registry read itself is
    internally consistent per family). ``start(period_s)`` runs the
    tick on a daemon thread for production; tests call ``sample``
    directly with a driven clock and never sleep.
    """

    def __init__(self, *, registry=None, capacity: int = DEFAULT_CAPACITY,
                 source: str = "host",
                 pre_sample: Optional[Callable[[], None]] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self._registry = registry if registry is not None \
            else default_registry()
        self._capacity = int(capacity)
        self._source = source
        self._pre_sample = pre_sample
        self._lock = threading.Lock()
        self._ring: list[dict] = []  # guarded-by: _lock
        self._listeners: list[Callable[[dict], None]] = []  # guarded-by: _lock
        self._prev_parsed: Optional[ParsedSnapshot] = None  # guarded-by: _lock
        self._prev_ts: Optional[float] = None  # guarded-by: _lock
        self._tick = 0  # guarded-by: _lock
        self._stop = threading.Event()  # guarded-by: caller
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def source(self) -> str:
        return self._source

    def add_listener(self, fn: Callable[[dict], None]) -> Callable[[], None]:
        """Call ``fn(snapshot)`` after every sample (advisor ticks, the
        flight recorder's history lane, watchdog pets). Listener
        exceptions are swallowed like the event bus's — observation
        never takes down sampling."""
        with self._lock:
            self._listeners.append(fn)

        def _remove() -> None:
            with self._lock:
                if fn in self._listeners:
                    self._listeners.remove(fn)
        return _remove

    def sample(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else float(now)
        if self._pre_sample is not None:
            try:
                self._pre_sample()
            except Exception:
                pass  # heat refresh is best-effort; the snapshot still lands
        prom = subset_text(render(self._registry))
        parsed = parse_text(prom)
        with self._lock:
            dt = (now - self._prev_ts) if self._prev_ts is not None else 0.0
            self._tick += 1
            snap = {
                "tick": self._tick,
                "ts": now,
                "series": derive_series(self._prev_parsed, parsed, dt),
                "prom": prom,
            }
            self._prev_parsed = parsed
            self._prev_ts = now
            self._ring.append(snap)
            if len(self._ring) > self._capacity:
                del self._ring[: len(self._ring) - self._capacity]
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(snap)
            except Exception:
                pass
        return snap

    def snapshots(self, window: int = 0) -> list[dict]:
        with self._lock:
            snaps = list(self._ring)
        return snaps[-window:] if window else snaps

    def payload(self, *, window: int = 0, series: Iterable[str] = (),
                include_prom: bool = False) -> dict:
        return history_payload(self.snapshots(), source=self._source,
                               capacity=self._capacity, window=window,
                               series=series, include_prom=include_prom)

    def payload_json(self, *, window: int = 0,
                     series: Iterable[str] = (),
                     include_prom: bool = False) -> bytes:
        return json.dumps(
            self.payload(window=window, series=series,
                         include_prom=include_prom),
            sort_keys=True).encode("utf-8")

    def start(self, period_s: float) -> None:
        """Tick every ``period_s`` on a daemon thread (production mode —
        the serving mains arm this; tests drive :meth:`sample`)."""
        if period_s <= 0 or self._thread is not None:
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(period_s):
                self.sample()
        self._thread = threading.Thread(
            target=_loop, name="photon-history-sampler", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)


def fold_history(fold_texts: Callable[[str, Sequence[tuple]], str],
                 router_snaps: Sequence[dict],
                 host_snaps: Sequence[tuple[int, int, Sequence[dict]]],
                 ) -> list[dict]:
    """Fold per-host history rings into one fleet timeline.

    ``fold_texts(router_text, [(shard, replica, text), ...])`` supplies
    the merge — the router passes
    :func:`photon_ml_tpu_torch.fleet.observe.fold_fleet_snapshots`, i.e. the
    EXACT aggregate semantics ``tools/metrics_fold.py`` applies offline
    (injected as a callable so telemetry never imports fleet). Rings
    tick on independent clocks, so rows align by distance from the
    newest snapshot; the folded timeline is as long as the shortest
    ring, and each row re-derives :data:`HISTORY_SERIES` from the
    folded text with :func:`derive_series` — fleet counters sum, fleet
    quantiles come from summed buckets, never from averaged host
    quantiles."""
    rows = len(router_snaps)
    for _shard, _replica, snaps in host_snaps:
        rows = min(rows, len(snaps))
    folded: list[dict] = []
    prev_parsed: Optional[ParsedSnapshot] = None
    prev_ts: Optional[float] = None
    for offset in range(rows, 0, -1):
        router_snap = router_snaps[-offset]
        members = [(shard, replica, snaps[-offset]["prom"])
                   for shard, replica, snaps in host_snaps]
        text = fold_texts(router_snap["prom"], members)
        parsed = parse_text(text)
        ts = float(router_snap["ts"])
        dt = (ts - prev_ts) if prev_ts is not None else 0.0
        folded.append({
            "tick": router_snap["tick"],
            "ts": ts,
            "series": derive_series(prev_parsed, parsed, dt),
            "prom": text,
        })
        prev_parsed, prev_ts = parsed, ts
    return folded
