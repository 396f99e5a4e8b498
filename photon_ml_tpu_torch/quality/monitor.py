"""Online model-quality monitors: live score distribution vs baseline.

Counterpart of ``photon_ml_tpu/quality/monitor.py`` (host-side). The
port's :class:`~photon_ml_tpu_torch.serving.engine.ScoringEngine` hands
each scored batch to its version's monitor after the copy to the host,
outside the bucket graphs, and skips it while brownout sheds ``quality``.

The serving engine hands every scored batch's host-side facts — total
scores, per-coordinate cold-start (fallback-row) hits, per-shard feature
coverage — to a :class:`QualityMonitor` (one per model version, attached
by the registry at load time). The monitor accumulates them into
``photon_quality_*`` metric families AND into its own host accumulators;
the metric updates are a handful of numpy reductions and counter
increments per batch, off the device programs entirely, so the f32
bit-parity and zero-recapture contracts are untouched.

A :class:`DriftEvaluator` — a background ``Event.wait`` thread, started
by ``serve_game --quality-poll-s`` — periodically folds the ACTIVE
version's accumulators against its train-time baseline
(:mod:`photon_ml_tpu_torch.quality.baseline`, the one home of the PSI/KS
arithmetic) into
``photon_quality_drift_score{coordinate, kind}`` gauges and posts a
``quality_drift_detected`` event on the registry's bus when the
total-score PSI crosses the threshold. Gauges are host-owned.
"""

from __future__ import annotations

import threading
from typing import Mapping, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.quality.baseline import (
    QualityBaseline,
    bin_scores,
    ks_statistic,
    population_stability_index,
)
from photon_ml_tpu_torch.telemetry import metrics as _metrics

#: kinds rendered into the drift gauge; ``coordinate`` is the coordinate
#: id for cold_start, the feature-shard id for coverage, and the
#: ``__total__`` sentinel for whole-score-distribution kinds
TOTAL_COORDINATE = "__total__"

#: PSI rule-of-thumb default: > 0.25 is conventionally "significant
#: population shift"; serve_game exposes it as --drift-threshold
DEFAULT_DRIFT_THRESHOLD = 0.25

_SCORED_ROWS = _metrics.counter(
    "photon_quality_scored_rows_total",
    "Rows whose scores the online quality monitor accumulated (engine "
    "side — warmup padding excluded)")
_SCORE_BINS = _metrics.counter(
    "photon_quality_scores_total",
    "Live total-score histogram over the active baseline's equal-mass "
    "bins (bin = index into quality-baseline.json scoreBins)",
    labels=("bin",))
_COLD_START = _metrics.counter(
    "photon_quality_cold_start_total",
    "Scored rows that landed on a coordinate's zero fallback row "
    "(unknown or missing entity id — the GLMix cold-start path)",
    labels=("coordinate",))
_COVERAGE = _metrics.gauge(
    "photon_quality_feature_coverage_ratio",
    "Running mean fraction of nonzero design cells in live requests, "
    "per feature shard (compare with the baseline's coverage)",
    labels=("shard",))
_metrics.mark_host_owned("photon_quality_feature_coverage_ratio")
_DRIFT = _metrics.gauge(
    "photon_quality_drift_score",
    "Live-vs-baseline drift of the active model's predictions: "
    "PSI/KS/mean_shift of the total-score distribution "
    "(coordinate=__total__), per-coordinate cold-start rate deltas, "
    "per-shard coverage deltas", labels=("coordinate", "kind"))
_metrics.mark_host_owned("photon_quality_drift_score")


class QualityMonitor:
    """Per-model-version accumulator of live prediction-quality signals.

    Thread-safe (serving scores from HTTP worker threads); all updates
    are host numpy over arrays the engine already holds. Without a
    baseline the score histogram has no bins, but cold-start, coverage
    and row counting still accumulate — partial observability beats
    none."""

    def __init__(self, baseline: Optional[QualityBaseline] = None):
        self.baseline = baseline
        self._lock = threading.Lock()
        self._edges = (np.asarray(baseline.edges, np.float64)
                       if baseline is not None and baseline.edges else None)
        self._counts = (np.zeros(len(baseline.proportions), np.float64)
                        if baseline is not None and baseline.proportions
                        else None)  # guarded-by: _lock
        self._rows = 0  # guarded-by: _lock
        self._score_sum = 0.0  # guarded-by: _lock
        self._cold: dict[str, int] = {}  # guarded-by: _lock
        self._cov_nnz: dict[str, int] = {}  # guarded-by: _lock
        self._cov_cells: dict[str, int] = {}  # guarded-by: _lock

    # --- accumulation (engine side) ---------------------------------------
    def observe(self, scores: np.ndarray,
                cold: Mapping[str, int] = (),
                coverage: Mapping[str, Tuple[int, int]] = ()) -> None:
        """Fold one scored batch in: ``scores`` are the engine's final
        per-row totals, ``cold`` per-coordinate fallback-row hit counts,
        ``coverage`` per-shard ``(nonzero cells, total cells)``."""
        scores = np.asarray(scores, np.float64)
        n = int(scores.size)
        if n == 0:
            return
        binned = (bin_scores(scores, self._edges)
                  if self._edges is not None else None)
        with self._lock:
            self._rows += n
            self._score_sum += float(scores.sum())
            if binned is not None and self._counts is not None:
                self._counts += binned
            for cid, c in dict(cold).items():
                self._cold[cid] = self._cold.get(cid, 0) + int(c)
            for sid, (nnz, cells) in dict(coverage).items():
                self._cov_nnz[sid] = self._cov_nnz.get(sid, 0) + int(nnz)
                self._cov_cells[sid] = (self._cov_cells.get(sid, 0)
                                        + int(cells))
            cov_view = {sid: (self._cov_nnz[sid], self._cov_cells[sid])
                        for sid in self._cov_cells}
        # metric exports outside the monitor lock (registry children take
        # their own locks; ordering across families is not load-bearing)
        _SCORED_ROWS.inc(n)
        if binned is not None:
            for i, c in enumerate(binned):
                if c:
                    _SCORE_BINS.labels(bin=str(i)).inc(float(c))
        for cid, c in dict(cold).items():
            if c:
                _COLD_START.labels(coordinate=cid).inc(int(c))
        for sid, (nnz, cells) in cov_view.items():
            if cells:
                _COVERAGE.labels(shard=sid).set(nnz / cells)

    # --- evaluation (background side) -------------------------------------
    @property
    def n_rows(self) -> int:
        with self._lock:
            return self._rows

    def drift_scores(self, min_rows: int = 1) -> dict:
        """``{(coordinate, kind): score}`` of the live accumulation vs
        the baseline; empty without a baseline or below ``min_rows``
        (drift over a handful of requests is noise, not signal)."""
        b = self.baseline
        if b is None:
            return {}
        with self._lock:
            rows = self._rows
            counts = None if self._counts is None else self._counts.copy()
            score_sum = self._score_sum
            cold = dict(self._cold)
            cov = {sid: (self._cov_nnz[sid], self._cov_cells[sid])
                   for sid in self._cov_cells}
        if rows < max(min_rows, 1):
            return {}
        out: dict = {}
        if counts is not None and counts.sum() > 0:
            out[(TOTAL_COORDINATE, "psi")] = population_stability_index(
                b.proportions, counts)
            out[(TOTAL_COORDINATE, "ks")] = ks_statistic(
                b.proportions, counts)
        out[(TOTAL_COORDINATE, "mean_shift")] = (
            abs(score_sum / rows - b.mean_score)
            / max(b.std_score, 1e-9))
        for cid, base_rate in (b.cold_rates or {}).items():
            out[(cid, "cold_start")] = abs(cold.get(cid, 0) / rows
                                           - base_rate)
        for sid, base_cov in (b.coverage or {}).items():
            nnz, cells = cov.get(sid, (0, 0))
            if cells:
                out[(sid, "coverage")] = abs(nnz / cells - base_cov)
        return out


class DriftEvaluator:
    """Background evaluator: periodically renders the active version's
    drift into gauges and raises the alarm past the threshold.

    Waiting uses ``threading.Event.wait`` (serving code never sleeps —
    hygiene) and evaluation reads only host accumulators — zero device
    work, zero effect on the score path."""

    def __init__(self, registry, *,
                 threshold: float = DEFAULT_DRIFT_THRESHOLD,
                 min_rows: int = 50, poll_s: float = 30.0):
        self.registry = registry
        self.threshold = float(threshold)
        self.min_rows = int(min_rows)
        self.poll_s = float(poll_s)
        #: the evaluator thread and synchronous callers (tests, a manual
        #: evaluate_once) both touch these — the lock-discipline pass
        #: flagged the bare writes, so they now share a lock
        self._lock = threading.Lock()
        self.n_detections = 0  # guarded-by: _lock
        self._stop = threading.Event()
        #: start/stop are operator-lifecycle calls from one control thread
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller
        self.last: dict = {}  # guarded-by: _lock

    def evaluate_once(self) -> dict:
        """One evaluation pass: compute drift scores for the active
        version, set the gauges, post ``quality_drift_detected`` when the
        total-score PSI crosses the threshold. Directly callable — the
        thread loop is just this on a timer, and tests drive it
        synchronously."""
        sm = self.registry.active_or_none()
        monitor = None if sm is None else getattr(sm.engine, "monitor",
                                                  None)
        if monitor is None:
            return {}
        scores = monitor.drift_scores(min_rows=self.min_rows)
        rank_drift = self._rank_drift(sm, monitor.baseline)
        if rank_drift is not None:
            scores.update(rank_drift)
        for (coordinate, kind), value in scores.items():
            _DRIFT.labels(coordinate=coordinate, kind=kind).set(value)
        psi = scores.get((TOTAL_COORDINATE, "psi"))
        if psi is not None and psi > self.threshold:
            with self._lock:
                self.n_detections += 1
            # the payload names WHAT drifted (coordinate/kind/drift) so a
            # bus subscriber — the feedback autopilot above all — can act
            # without re-scraping /metrics; psi/ks stay for back-compat
            self.registry.bus.post(
                "quality_drift_detected", version=sm.version,
                kind="psi", coordinate=TOTAL_COORDINATE,
                drift=round(psi, 6),
                psi=round(psi, 6),
                ks=round(scores.get((TOTAL_COORDINATE, "ks"), 0.0), 6),
                threshold=self.threshold, rows=monitor.n_rows)
        if rank_drift is not None:
            # the ranked workload's alarm rides the SAME event path — one
            # subscriber (and the bridge counter) covers both kinds
            for (coordinate, kind), value in rank_drift.items():
                if kind == "rank_overlap" and value > self.threshold:
                    with self._lock:
                        self.n_detections += 1
                    self.registry.bus.post(
                        "quality_drift_detected", version=sm.version,
                        kind="rank_overlap", coordinate=coordinate,
                        drift=round(value, 6), threshold=self.threshold)
        with self._lock:
            self.last = {f"{c}/{k}": v for (c, k), v in scores.items()}
        return scores

    def _rank_drift(self, sm, baseline) -> "Optional[dict]":
        """``{(item coordinate, "rank_overlap"): 1 - mean overlap}`` of
        the probe users' LIVE top-k against the reference lists the full
        model load pinned (quality/baseline.py) — None when the version
        has no rank engine or no reference. Re-ranks the probes through
        the active engine: a patched item table that reshuffles retrieval
        shows up here even when the score distribution stays flat."""
        rank_engine = getattr(sm, "rank_engine", None)
        if rank_engine is None or baseline is None \
                or not baseline.rank_probes or baseline.rank_k < 1:
            return None
        from photon_ml_tpu_torch.quality.baseline import (
            rank_probe_records,
            topk_overlap,
        )

        users = list(baseline.rank_probes)
        k = min(baseline.rank_k, rank_engine.max_k)
        try:
            results = rank_engine.rank(
                rank_probe_records(users, rank_engine.user_entity_types),
                [k] * len(users))
        except Exception:
            import logging

            logging.getLogger(__name__).exception(
                "rank-drift probe ranking failed; skipping this pass")
            return None
        overlap = float(np.mean([
            topk_overlap(baseline.rank_probes[u], ids)
            for u, (ids, _) in zip(users, results)])) if users else 1.0
        return {(rank_engine.index.coordinate_id, "rank_overlap"):
                1.0 - overlap}

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "DriftEvaluator":
        def loop() -> None:
            while not self._stop.wait(self.poll_s):
                try:
                    self.evaluate_once()
                except Exception:
                    import logging

                    logging.getLogger(__name__).exception(
                        "drift evaluation failed; will retry")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="photon-quality-drift")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
