"""Hot-shard advisor: which shard of the fleet runs hot, and what to move.

Counterpart of ``photon_ml_tpu/fleet/advisor.py``. It reads only the
router's retained history ring
(:mod:`photon_ml_tpu_torch.telemetry.history`), never fresh scrapes, so its
advice is a function of evidence an operator can replay (``GET /history``
shows the ticks that tripped it), and it recommends a
:meth:`~photon_ml_tpu_torch.fleet.sharding.ShardMap.rebalanced` move list
without driving ``/reshard`` itself.

Detection is latched with hysteresis: a shard must hold a skew ratio (its
p99, or its smoothed in-flight load, against the median of its peers) at
or above ``enter_ratio`` for ``sustain_ticks`` consecutive history ticks to
latch hot (one ``hot_shard_detected`` event, ``photon_hot_shard{shard}`` =
1), and below ``exit_ratio`` for ``sustain_ticks`` ticks to clear. A ratio
that moves between the two thresholds flips nothing.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from photon_ml_tpu_torch.telemetry import metrics as _metrics

#: 1 while the advisor currently flags the shard hot (hysteresis-latched
#: skew vs peer shards), 0 after it cools — the edge-triggered
#: ``hot_shard_detected`` event marks each rising edge
_HOT = _metrics.gauge(
    "photon_hot_shard",
    "1 while the hot-shard advisor flags the shard (sustained p99/load "
    "skew vs peer shards, hysteresis-latched), else 0",
    labels=("shard",))

#: smoothing constant for the load ratio — in-flight leg counts are
#: small integers, so compare (load+1)/(median+1) rather than divide by
#: a frequently-zero median
_LOAD_SMOOTH = 1.0

#: latency floor for the p99 ratio denominator: below this the fleet is
#: effectively idle and a "ratio" is noise, not skew
DEFAULT_MIN_P99_S = 1e-4


class HotShardAdvisor:
    """Sustained per-shard skew detection over the history ring.

    ``tick()`` consumes the ring's NEWEST snapshot (at most once per
    snapshot — re-ticks on the same history tick are no-ops, so wiring
    it as a sampler listener and calling it from a poll loop cannot
    double-count sustain evidence) and returns the list of rising-edge
    detections. ``status()`` is the ``GET /advisor`` body.
    """

    def __init__(self, *, history, shard_map_fn: Callable,
                 bus=None, enter_ratio: float = 2.0,
                 exit_ratio: float = 1.25, sustain_ticks: int = 3,
                 min_p99_s: float = DEFAULT_MIN_P99_S):
        if exit_ratio >= enter_ratio:
            raise ValueError(
                f"hysteresis needs exit_ratio < enter_ratio, got "
                f"exit={exit_ratio} enter={enter_ratio}")
        if sustain_ticks <= 0:
            raise ValueError(
                f"sustain_ticks must be > 0, got {sustain_ticks}")
        self._history = history
        self._shard_map_fn = shard_map_fn
        self._bus = bus
        self.enter_ratio = float(enter_ratio)
        self.exit_ratio = float(exit_ratio)
        self.sustain_ticks = int(sustain_ticks)
        self.min_p99_s = float(min_p99_s)
        self._lock = threading.Lock()
        self._last_history_tick = 0  # guarded-by: _lock
        self._above: dict[int, int] = {}  # guarded-by: _lock
        self._below: dict[int, int] = {}  # guarded-by: _lock
        self._hot: set[int] = set()  # guarded-by: _lock
        self._last_skew: dict[int, dict] = {}  # guarded-by: _lock
        self._ticks = 0  # guarded-by: _lock
        self._detections = 0  # guarded-by: _lock

    # ------------------------------------------------------------------
    # skew
    # ------------------------------------------------------------------

    @staticmethod
    def _median(values: "list[float]") -> float:
        ordered = sorted(values)
        n = len(ordered)
        mid = n // 2
        if n % 2:
            return ordered[mid]
        return (ordered[mid - 1] + ordered[mid]) / 2.0

    def _skew_of(self, snapshot: dict) -> dict[int, dict]:
        """Per-shard skew evidence from one history snapshot: each
        shard's p99 and smoothed load against the MEDIAN of the other
        shards (median, not mean — one hot shard must not drag the
        baseline it is measured against)."""
        series = snapshot.get("series", {})
        p99 = {int(k): float(v)
               for k, v in (series.get("shard_p99") or {}).items()}
        load = {int(k): float(v)
                for k, v in (series.get("shard_load") or {}).items()}
        # the capacity plane's bottleneck attribution (history series
        # ``shard_binding``): which resource is most utilized on each
        # shard's hosts — "unknown" when the fleet predates the
        # saturation sampler or it is not armed
        binding = {str(k): str(v)
                   for k, v in (series.get("shard_binding") or {}).items()}
        shards = sorted(set(p99) | set(load))
        out: dict[int, dict] = {}
        if len(shards) < 2:
            return out  # skew needs peers to be skewed against
        for s in shards:
            peer_p99 = [p99.get(o, 0.0) for o in shards if o != s]
            peer_load = [load.get(o, 0.0) for o in shards if o != s]
            p99_base = max(self._median(peer_p99), self.min_p99_s)
            p99_ratio = p99.get(s, 0.0) / p99_base
            load_ratio = ((load.get(s, 0.0) + _LOAD_SMOOTH)
                          / (self._median(peer_load) + _LOAD_SMOOTH))
            out[s] = {"p99_s": p99.get(s, 0.0),
                      "p99_ratio": round(p99_ratio, 4),
                      "load": load.get(s, 0.0),
                      "load_ratio": round(load_ratio, 4),
                      "skew": round(max(p99_ratio, load_ratio), 4),
                      "binding_resource": binding.get(str(s), "unknown")}
        return out

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------

    def tick(self) -> "list[dict]":
        """Consume the newest history snapshot; return rising-edge
        detections (also posted as ``hot_shard_detected`` bus events and
        reflected in ``photon_hot_shard{shard}``)."""
        snaps = self._history.snapshots(window=1)
        if not snaps:
            return []
        snap = snaps[-1]
        detections: list[dict] = []
        cleared: list[int] = []
        with self._lock:
            if snap["tick"] <= self._last_history_tick:
                return []  # already consumed — sustain needs NEW evidence
            self._last_history_tick = snap["tick"]
            self._ticks += 1
            skew = self._skew_of(snap)
            self._last_skew = skew
            for s, evidence in skew.items():
                score = evidence["skew"]
                if score >= self.enter_ratio:
                    self._above[s] = self._above.get(s, 0) + 1
                else:
                    self._above[s] = 0
                if score < self.exit_ratio:
                    self._below[s] = self._below.get(s, 0) + 1
                else:
                    self._below[s] = 0
                if (s not in self._hot
                        and self._above[s] >= self.sustain_ticks):
                    self._hot.add(s)
                    self._detections += 1
                    detections.append({
                        "shard": s, "history_tick": snap["tick"],
                        "sustained_ticks": self._above[s], **evidence})
                elif (s in self._hot
                        and self._below[s] >= self.sustain_ticks):
                    self._hot.discard(s)
                    cleared.append(s)
            for s in list(self._above):
                if s not in skew:  # shard left the topology
                    self._above.pop(s, None)
                    self._below.pop(s, None)
                    if s in self._hot:
                        self._hot.discard(s)
                        cleared.append(s)
        for s in cleared:
            _HOT.labels(shard=str(s)).set(0.0)
            if self._bus is not None:
                self._bus.post("hot_shard_cleared", shard=s)
        for det in detections:
            _HOT.labels(shard=str(det["shard"])).set(1.0)
            if self._bus is not None:
                self._bus.post("hot_shard_detected", **det)
        return detections

    # ------------------------------------------------------------------
    # advice
    # ------------------------------------------------------------------

    def recommendation(self) -> Optional[dict]:
        """The advised (NOT executed) move list while any shard is hot:
        the minimal-movement ``ShardMap.rebalanced(n_shards + 1)``
        scale-out, i.e. exactly the buckets an operator would POST to
        ``/reshard`` after standing up one more shard. ``None`` while
        the fleet is cool."""
        with self._lock:
            hot = sorted(self._hot)
            skew = self._last_skew
            bindings = {str(s): skew[s].get("binding_resource", "unknown")
                        for s in hot if s in skew}
        if not hot:
            return None
        smap = self._shard_map_fn()
        target = smap.rebalanced(smap.n_shards + 1)
        moves = {b: target.buckets[b] for b in smap.moved_buckets(target)}
        from_hot = sum(1 for b in moves if smap.buckets[b] in hot)
        return {
            "kind": "scale_out",
            "n_shards": target.n_shards,
            "base_version": smap.version,
            "base_hash": smap.map_hash,
            "n_moves": len(moves),
            "moves_from_hot": from_hot,
            # the binding resource of each hot shard, so the operator
            # reading the advice knows WHAT the extra shard relieves
            # (scale-out cures device/queue pressure; a connection-bound
            # shard may want --max-connections raised instead)
            "binding_resources": bindings,
            "moves": {str(b): moves[b] for b in sorted(moves)},
        }

    def status(self) -> dict:
        """The ``GET /advisor`` body — hot set, per-shard evidence from
        the last consumed tick, hysteresis parameters, and the current
        recommendation."""
        with self._lock:
            hot = sorted(self._hot)
            skew = {str(s): dict(v) for s, v in self._last_skew.items()}
            ticks = self._ticks
            detections = self._detections
            history_tick = self._last_history_tick
        return {
            "hot": hot,
            "shards": skew,
            "ticks": ticks,
            "detections": detections,
            "history_tick": history_tick,
            "params": {"enter_ratio": self.enter_ratio,
                       "exit_ratio": self.exit_ratio,
                       "sustain_ticks": self.sustain_ticks},
            "recommendation": self.recommendation(),
        }
