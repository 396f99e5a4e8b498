"""The fleet observability plane: one endpoint observes N×R hosts.

Counterpart of ``photon_ml_tpu/fleet/observe.py``:

- **Live metrics fold**: :class:`FleetObserver` scrapes every host's
  ``/metrics`` over the router's pooled connections
  (``HostClient.request(raw=True)``; each scrape visits the
  ``fleet.fanout`` fault site like any other leg) and folds the texts
  through :func:`photon_ml_tpu_torch.telemetry.aggregate.aggregate_text`:
  counters and histograms sum, host-owned gauges fan out tagged
  ``shard="I"``, ``replica="J"`` (:func:`tag_host_owned`). A host that
  fails mid-scrape is counted in
  ``photon_fleet_scrape_errors_total{shard,replica}`` and the partial fold
  is served.
- **Per-shard heat**: the router's leg-latency windows and in-flight leg
  counts as ``photon_fleet_shard_{p50,p99}_seconds{shard}`` and
  ``photon_fleet_shard_load{shard}``, refreshed at scrape time.
- **SLO burn rate**: :class:`SloBurnTracker`, multi-window and
  tick-driven (the clock is injectable), posting edge-triggered
  ``slo_burn_alert`` events on the bus.
- **Topology**: :meth:`FleetObserver.statusz` (the router's ``GET
  /statusz``): the shard map, per-host lineage, health and last scrape,
  per-shard replica coverage and heat, the SLO state.
- **Retained history**: :meth:`FleetObserver.history` (the router's ``GET
  /history``) folds every host's ``/history?raw=1`` ring against the
  router's own ring (:meth:`FleetObserver.attach_history`) with the same
  merge, then derives the closed series vocabulary from the folded text
  (:func:`photon_ml_tpu_torch.telemetry.history.fold_history`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional, Sequence

from photon_ml_tpu_torch.telemetry import metrics as _metrics

#: host scrapes that failed during a fleet /metrics fold — the partial
#: fold is served with this annotation instead of a 500
_SCRAPE_ERRORS = _metrics.counter(
    "photon_fleet_scrape_errors_total",
    "Host registry scrapes that failed during a fleet /metrics fold "
    "(the partial fold is served; the hole is annotated here)",
    labels=("shard", "replica"))

#: per-shard leg-latency percentiles from the router's hedging deques —
#: the hot-shard signal
_SHARD_P50 = _metrics.gauge(
    "photon_fleet_shard_p50_seconds",
    "Median fan-out leg latency per shard (router's recent-leg window)",
    labels=("shard",))
_SHARD_P99 = _metrics.gauge(
    "photon_fleet_shard_p99_seconds",
    "p99 fan-out leg latency per shard (the hedge-delay signal)",
    labels=("shard",))

#: legs in flight against each shard right now (sampled at scrape)
_SHARD_LOAD = _metrics.gauge(
    "photon_fleet_shard_load",
    "Fan-out legs currently in flight against each shard",
    labels=("shard",))


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------


def tag_host_owned(text: str, tags) -> str:
    """Append label ``tags`` — one ``(key, value)`` pair or a sequence of
    them — to every host-owned gauge series of an exposition text
    (``metrics.mark_host_owned`` declares which). Training renders tag at
    render time (``render(host_tag=...)``); the fleet re-tags hosts'
    already-rendered scrapes — same labels, same fan-out semantics."""
    from photon_ml_tpu_torch.telemetry.metrics import host_owned_gauges
    from photon_ml_tpu_torch.telemetry.prometheus import parse_text, render

    if tags and isinstance(tags[0], str):
        tags = (tags,)
    extra = dict(tags)
    snapshot = parse_text(text)
    owned = host_owned_gauges()
    for name, fam in snapshot.families.items():
        if fam.get("type") != "gauge" or name not in owned:
            continue
        snapshot[name] = [({**labels, **extra}, v)
                          for labels, v in snapshot.get(name, ())]
    return render(snapshot)


def fold_fleet_snapshots(router_text: str,
                         host_snapshots: Sequence[tuple]) -> str:
    """The fleet metric fold: router snapshot (chief-first), then each
    ``(shard, replica, text)`` host snapshot in shard-major order with
    host-owned gauges tagged ``shard="I"``, ``replica="J"`` (distinct
    label sets, so every replica's gauge survives the merge's gauge
    owner semantics), through the ONE merge code path
    (``telemetry/aggregate.py``). Feeding the same texts in the same
    order offline (the JAX package's ``tools/metrics_fold.py``) is
    byte-identical."""
    from photon_ml_tpu_torch.telemetry.aggregate import aggregate_text

    texts = [router_text]
    for shard, replica, text in host_snapshots:
        if text:
            texts.append(tag_host_owned(
                text, (("shard", str(shard)), ("replica", str(replica)))))
    return aggregate_text(texts)


# ---------------------------------------------------------------------------
# SLO burn rate
# ---------------------------------------------------------------------------


class SloBurnTracker:
    """Multi-window SLO burn-rate tracking, tick-driven and pure.

    ``observe(seconds, ok)`` classifies each request against the latency
    objective (an error is always bad). ``tick(now=...)`` closes the
    current accumulation bucket and evaluates every window: burn rate =
    (bad fraction over the window) / (1 - target) — burn 1.0 spends the
    error budget exactly at the sustainable rate; the default thresholds
    (14.4× over the short window, 6× over the long) are the classic
    fast/slow-burn paging pair. Crossing a threshold posts ONE
    edge-triggered ``slo_burn_alert`` on the bus (→
    ``photon_slo_burn_total{window}`` where a telemetry bridge listens) and
    re-arms when the window drops back under.

    Time is ``time.monotonic()`` by default and injectable everywhere
    (``tick(now=...)``), so tests drive synthetic regressions through
    real code without sleeping. Windows are ``(name, span_s,
    threshold)`` triples; bucket history is bounded by the longest
    window.
    """

    DEFAULT_WINDOWS = (("5m", 300.0, 14.4), ("1h", 3600.0, 6.0))

    def __init__(self, bus, *, objective_s: float, target: float = 0.999,
                 windows: Optional[Sequence[tuple]] = None):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        self.bus = bus
        self.objective_s = float(objective_s)
        self.target = float(target)
        self.windows = tuple(windows if windows is not None
                             else self.DEFAULT_WINDOWS)
        self._horizon = max(span for _name, span, _thr in self.windows)
        self._lock = threading.Lock()
        self._good = 0  # guarded-by: _lock
        self._bad = 0  # guarded-by: _lock
        #: closed (tick_time, good, bad) buckets, newest last
        self._buckets: collections.deque = collections.deque()  # guarded-by: _lock  # pruned to the longest window at every tick
        #: per-window "currently burning" latch (edge-triggered alerts)
        self._active = {name: False
                        for name, _s, _t in self.windows}  # guarded-by: _lock
        self._status: list = []  # guarded-by: _lock

    def observe(self, seconds: float, ok: bool = True) -> None:
        """One request's outcome: bad = an error OR a latency past the
        objective. Cheap (a lock + an increment) — safe on the hot path."""
        bad = (not ok) or float(seconds) > self.objective_s
        with self._lock:
            if bad:
                self._bad += 1
            else:
                self._good += 1

    def tick(self, now: Optional[float] = None) -> list:
        """Close the current bucket and evaluate every window; returns
        the alerts fired THIS tick (also posted on the bus)."""
        now = time.monotonic() if now is None else float(now)
        alerts = []
        with self._lock:
            self._buckets.append((now, self._good, self._bad))
            self._good = self._bad = 0
            while self._buckets and self._buckets[0][0] < now - self._horizon:
                self._buckets.popleft()
            status = []
            for name, span, threshold in self.windows:
                good = bad = 0
                for t, g, b in self._buckets:
                    if t >= now - span:
                        good += g
                        bad += b
                total = good + bad
                bad_fraction = bad / total if total else 0.0
                burn = bad_fraction / (1.0 - self.target)
                burning = total > 0 and burn >= threshold
                if burning and not self._active[name]:
                    alerts.append({"window": name,
                                   "burn_rate": round(burn, 3),
                                   "threshold": threshold,
                                   "bad": bad, "total": total})
                self._active[name] = burning
                status.append({"window": name, "span_s": span,
                               "burn_rate": round(burn, 3),
                               "threshold": threshold,
                               "burning": burning,
                               "bad": bad, "total": total})
            self._status = status
        for alert in alerts:
            self.bus.post("slo_burn_alert",
                          objective_ms=self.objective_s * 1e3,
                          target=self.target, **alert)
        return alerts

    def status(self) -> list:
        """Per-window burn state as of the last tick (for ``/statusz``)."""
        with self._lock:
            return [dict(entry) for entry in self._status]


# ---------------------------------------------------------------------------
# the observer
# ---------------------------------------------------------------------------


class FleetObserver:
    """The router's observability surface: pooled-connection scrapes,
    heat-gauge refresh, scrape bookkeeping for ``/statusz``, and the
    optional SLO tracker. Constructed by every :class:`~photon_ml_tpu_torch.
    fleet.router.FleetRouter` (no threads, no cost until scraped);
    :meth:`attach_slo` adds burn-rate tracking and, with ``tick_s > 0``,
    the tick thread serve_fleet runs it on."""

    def __init__(self, router):
        self.router = router
        #: attach_slo/close are operator-lifecycle calls from one
        #: control thread (like RouterServer start/stop)
        self.slo: Optional[SloBurnTracker] = None  # guarded-by: caller
        #: the router-side history ring (serve_fleet arms it): the fleet
        #: timeline folds the hosts' rings against its snapshots
        self.history_sampler = None  # guarded-by: caller
        self._lock = threading.Lock()
        #: (shard, replica) -> {"t": monotonic stamp, "ok", "error"}
        self._last_scrape: dict = {}  # guarded-by: _lock
        self._tick_thread: Optional[
            threading.Thread] = None  # guarded-by: caller
        self._stop = threading.Event()

    # --- SLO --------------------------------------------------------------
    def attach_slo(self, tracker: SloBurnTracker,
                   tick_s: float = 0.0) -> "FleetObserver":
        self.slo = tracker
        if tick_s > 0:
            self._tick_thread = threading.Thread(
                target=self._tick_loop, args=(float(tick_s),),
                daemon=True, name="photon-fleet-slo")
            self._tick_thread.start()
        return self

    def _tick_loop(self, tick_s: float) -> None:
        while not self._stop.wait(tick_s):
            self.slo.tick()

    def observe_request(self, seconds: float, ok: bool = True) -> None:
        """Feed one routed request's outcome to the SLO tracker (no-op
        without one attached)."""
        if self.slo is not None:
            self.slo.observe(seconds, ok=ok)

    def close(self) -> None:
        self._stop.set()
        if self._tick_thread is not None:
            self._tick_thread.join()
            self._tick_thread = None

    # --- scraping ---------------------------------------------------------
    def scrape(self) -> "list[tuple[int, int, str]]":
        """Every live host's raw ``/metrics`` text over the pooled
        connections, shard-major ``(shard, replica, text)``. A failed or
        timed-out host contributes NOTHING except a
        ``photon_fleet_scrape_errors_total{shard,replica}`` increment
        and a failed last-scrape entry — the fold stays partial, never
        raises. Each scrape is a leg: it visits the ``fleet.fanout``
        fault site, so chaos coverage includes scraping through
        faults."""
        snapshots = []
        for s, group in enumerate(self.router.clients):
            for r, client in enumerate(group):
                try:
                    status, text = client.request("GET", "/metrics",
                                                  raw=True)
                    if status != 200:
                        raise RuntimeError(f"/metrics -> {status}")
                    snapshots.append((s, r, text))
                    self._note(s, r, ok=True)
                except Exception as e:
                    _SCRAPE_ERRORS.labels(shard=str(s),
                                          replica=str(r)).inc()
                    self._note(s, r, ok=False, error=repr(e))
        return snapshots

    def _note(self, shard: int, replica: int, ok: bool,
              error: Optional[str] = None) -> None:
        with self._lock:
            self._last_scrape[(shard, replica)] = {
                "t": time.monotonic(), "ok": ok, "error": error}

    # --- retained history -------------------------------------------------
    def attach_history(self, sampler) -> "FleetObserver":
        """Arm the router-side history ring (a
        :class:`~photon_ml_tpu_torch.telemetry.history.HistorySampler` whose
        ``pre_sample`` refreshes the heat gauges, so every snapshot
        carries shard p50/p99/load)."""
        self.history_sampler = sampler
        return self

    def scrape_history(self) -> "list[tuple[int, int, list]]":
        """Every live host's retained ring (``GET /history?raw=1`` over
        the pooled connections), shard-major ``(shard, replica,
        snapshots)``. Failure semantics mirror :meth:`scrape`: a dead
        host is annotated and skipped, the fold stays partial."""
        import json as _json

        rings = []
        for s, group in enumerate(self.router.clients):
            for r, client in enumerate(group):
                try:
                    status, text = client.request(
                        "GET", "/history?raw=1", raw=True)
                    if status != 200:
                        raise RuntimeError(f"/history -> {status}")
                    rings.append((s, r, _json.loads(text)["snapshots"]))
                    self._note(s, r, ok=True)
                except Exception as e:
                    _SCRAPE_ERRORS.labels(shard=str(s),
                                          replica=str(r)).inc()
                    self._note(s, r, ok=False, error=repr(e))
        return rings

    def history(self, *, window: int = 0, series=(),
                include_prom: bool = False) -> dict:
        """The fleet timeline (router ``GET /history``): per-host rings
        folded against the router's own ring through
        :func:`fold_fleet_snapshots` — the EXACT merge semantics
        ``tools/metrics_fold.py`` applies offline — then re-derived into
        the closed series vocabulary
        (:func:`photon_ml_tpu_torch.telemetry.history.fold_history`)."""
        from photon_ml_tpu_torch.telemetry.history import (
            fold_history,
            history_payload,
        )

        sampler = self.history_sampler
        if sampler is None:
            raise RuntimeError("history sampler not armed on the router")
        folded = fold_history(fold_fleet_snapshots, sampler.snapshots(),
                              self.scrape_history())
        return history_payload(folded, source="fleet",
                               capacity=sampler.capacity, window=window,
                               series=series, include_prom=include_prom)

    # --- heat -------------------------------------------------------------
    @staticmethod
    def _quantile(ordered: "list[float]", q: float) -> float:
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

    def refresh_heat(self) -> None:
        """Publish the router's per-shard latency window and in-flight
        leg counts as gauges — sampled at scrape time, so the exported
        heat is exactly what the fold serves."""
        latencies = self.router.latency_snapshot()
        loads = self.router.shard_load()
        for s, samples in enumerate(latencies):
            label = str(s)
            _SHARD_LOAD.labels(shard=label).set(float(loads[s]))
            if samples:
                ordered = sorted(samples)
                _SHARD_P50.labels(shard=label).set(
                    self._quantile(ordered, 0.50))
                _SHARD_P99.labels(shard=label).set(
                    self._quantile(ordered, 0.99))

    # --- the fold ---------------------------------------------------------
    def metrics_text(self) -> str:
        """The fleet-folded exposition. Scrapes FIRST (so this round's
        scrape errors are already in the router registry), refreshes the
        heat gauges, then folds — the same texts, same order, same
        tagging as an offline fold of the same snapshots."""
        from photon_ml_tpu_torch.telemetry.prometheus import render

        snapshots = self.scrape()
        self.refresh_heat()
        return fold_fleet_snapshots(render(), snapshots)

    # --- topology ---------------------------------------------------------
    def statusz(self) -> dict:
        """The fleet topology page: shard map generation, per-host
        health/lineage/last-scrape, per-shard replica coverage and heat,
        SLO burn state."""
        router = self.router
        health = router.healthz()
        now = time.monotonic()
        with self._lock:
            scrape = {key: dict(info)
                      for key, info in self._last_scrape.items()}
        hosts = []
        for entry in health["hosts"]:
            entry = dict(entry)
            info = scrape.get((entry["shard"], entry["replica"]))
            if info is None:
                entry["last_scrape"] = None
            else:
                last = {"age_s": round(now - info["t"], 3),
                        "ok": info["ok"]}
                if info["error"]:
                    last["error"] = info["error"]
                entry["last_scrape"] = last
            hosts.append(entry)
        latencies = router.latency_snapshot()
        loads = router.shard_load()
        shards = []
        for s, samples in enumerate(latencies):
            heat = {"shard": s, "load": loads[s],
                    "samples": len(samples)}
            if samples:
                ordered = sorted(samples)
                heat["p50_s"] = round(self._quantile(ordered, 0.50), 6)
                heat["p99_s"] = round(self._quantile(ordered, 0.99), 6)
            shards.append(heat)
        return {
            "status": health["status"],
            "n_shards": router.n_shards,
            "replicas": router.replicas,
            "requests": health["requests"],
            "shard_map": health["shard_map"],
            "shard_replicas_up": health["shard_replicas_up"],
            "mixed_lineage": health["mixed_lineage"],
            "hosts": hosts,
            "shards": shards,
            "slo": None if self.slo is None else self.slo.status(),
        }
