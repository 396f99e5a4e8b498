"""Drift-triggered refresh autopilot: the loop's trigger (counterpart of
``photon_ml_tpu/feedback/autopilot.py``).

Subscribes to the registry bus; on ``quality_drift_detected`` (whose
payload now names the drifted coordinate, kind and score —
quality/monitor.py) it runs the full learn leg of the loop on a worker
thread:

1. flush the in-process request logs and **join** the logged traffic to
   the configured label source (:func:`~photon_ml_tpu_torch.feedback.joiner.
   join_feedback` — the ``feedback.join`` fault site lives there);
2. **refresh** via ``cli/refresh_game.py::run`` in-process, on the
   serving process's ``device`` (the card unless it serves on the CPU):
   warm-started from the serving model's run dir, restricted to ONLY the
   drifted coordinate (``--refresh-coordinates``): its touched entities
   re-solve (kernel 2), the fixed effect retrains (kernel 1), every other
   random-effect coordinate carries bit-identically with zero solves (a
   ``__total__``/PSI drift refreshes all coordinates);
3. **publish**: the refresh writes into a staging dir under the publish
   root and one ``os.rename`` makes the complete run — full model,
   ``data-manifest.json``, quality baseline, ``patch/`` and, with
   ``fleet_shards=N``, the per-host ``patch-shard-I/`` set — appear
   atomically in the watch directory, where the single-host watcher
   (``serving/watcher.py``) or the router-side fleet watcher
   (``fleet/watcher.py``) discovers and activates it. The published run
   becomes the prior for the NEXT refresh (lineage chains).

The device is a constructor argument, not a field of
:class:`AutopilotConfig`, so a config file of the JAX package loads
unchanged.

Guards — a wedged or faulted refresh must never block serving:

- the bus listener only flips state and spawns a daemon worker; joins
  and refreshes never run on the posting (drift-evaluator) thread;
- **debounce**: events within ``debounce_s`` of the last launch are
  suppressed (the drift evaluator re-posts every poll while drifted);
- **max refresh rate**: launches are floored ``min_interval_s`` apart,
  and at most one refresh is ever in flight;
- the ``feedback.refresh_launch`` fault site fires before any work; any
  stage's failure counts into ``photon_feedback_aborts_total{stage}``,
  the staging dir is discarded, and the incumbent keeps serving.

``photon_feedback_refreshes_total`` counts completed loops and
``photon_freshness_lag_seconds`` gauges publish-time freshness (now
minus the newest joined request's wall timestamp). Waiting uses
``threading.Event.wait``: this is serving-adjacent code and never
sleeps.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
from typing import Optional, Sequence

from photon_ml_tpu_torch.feedback.joiner import join_feedback
from photon_ml_tpu_torch.quality.monitor import TOTAL_COORDINATE
from photon_ml_tpu_torch.resilience.faults import fault_point
from photon_ml_tpu_torch.telemetry import metrics as _metrics

logger = logging.getLogger(__name__)

_REFRESHES = _metrics.counter(
    "photon_feedback_refreshes_total",
    "Completed autopilot loops: drift event -> join -> refresh of the "
    "drifted coordinate -> model + patches published to the watch dir")
_ABORTS = _metrics.counter(
    "photon_feedback_aborts_total",
    "Autopilot loops aborted with the incumbent serving, by stage "
    "(launch = faulted/guarded before work, join = joiner failed or too "
    "few rows, refresh = refresh_game failed, publish = staged run "
    "could not move into the watch dir)", labels=("stage",))
_LAG = _metrics.gauge(
    "photon_freshness_lag_seconds",
    "Freshness lag at the last autopilot publish: wall seconds from the "
    "newest JOINED request to the refreshed model landing in the watch "
    "dir (activation adds one watcher poll on top)")
_metrics.mark_host_owned("photon_freshness_lag_seconds")


class AutopilotAbort(RuntimeError):
    """A guarded, counted abort of one loop (incumbent keeps serving)."""


@dataclasses.dataclass
class AutopilotConfig:
    """Everything one refresh launch needs, round-trippable as JSON
    (``serve_game --autopilot-config config.json``). The training-side
    fields mirror ``refresh_game``'s flags; ``prior_dir`` advances to
    each published run so lineage chains across loops."""

    prior_dir: str
    publish_dir: str
    feature_shards: str
    coordinates: tuple
    update_sequence: str
    grid: tuple
    labels: Optional[str] = None
    task: str = "LOGISTIC_REGRESSION"
    evaluators: str = ""
    data_validation: str = "VALIDATE_FULL"
    fleet_shards: int = 0
    refresh_sweeps: int = 1
    min_rows: int = 1
    debounce_s: float = 30.0
    min_interval_s: float = 300.0
    #: restrict the touched-entity solve to the event's coordinate
    #: (``--refresh-coordinates``); False refreshes every coordinate
    drifted_only: bool = True

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AutopilotConfig":
        d = dict(d)
        d["coordinates"] = tuple(d.get("coordinates", ()))
        d["grid"] = tuple(d.get("grid", ()))
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "AutopilotConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


class FeedbackAutopilot:
    """Bus subscriber that turns drift events into published refreshes.

    ``reqlog_dirs`` name the request-log directories to join (every
    fleet host's, in the fleet topology); ``reqlogs`` are the in-process
    :class:`~photon_ml_tpu_torch.serving.reqlog.RequestLog` handles to
    flush before joining (a cross-machine deployment passes none and
    relies on segment cadence). ``device`` is where the refresh solves
    (``refresh_game --device``): the serving process's own.
    """

    def __init__(self, bus, config: AutopilotConfig, *,
                 reqlog_dirs: Sequence[str],
                 reqlogs: Sequence = (), device: str = "cuda"):
        self.bus = bus
        self.config = config
        self.device = device
        self.reqlog_dirs = list(reqlog_dirs)
        self.reqlogs = list(reqlogs)
        self._lock = threading.Lock()
        self._busy = False  # guarded-by: _lock
        self._last_launch: Optional[float] = None  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self.n_refreshes = 0  # guarded-by: _lock
        self.n_aborts = 0  # guarded-by: _lock
        self.n_suppressed = 0  # guarded-by: _lock
        self.last_result: Optional[dict] = None  # guarded-by: _lock
        self._stop = threading.Event()
        #: start/stop are operator-lifecycle calls from one control thread
        self._unsubscribe = None  # guarded-by: caller
        self._worker: Optional[threading.Thread] = None  # guarded-by: caller

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "FeedbackAutopilot":
        self._unsubscribe = self.bus.subscribe(self._on_event)
        return self

    def stop(self, timeout_s: float = 60.0) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None
        self._stop.set()
        worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout_s)

    # --- the trigger (drift-evaluator thread: flip state and hand off) ----
    def _on_event(self, event) -> None:
        if event.name != "quality_drift_detected" or self._stop.is_set():
            return
        now = time.monotonic()
        with self._lock:
            window = max(self.config.debounce_s, 0.0)
            floor = max(self.config.min_interval_s, 0.0)
            if self._busy or (
                    self._last_launch is not None
                    and now - self._last_launch < max(window, floor)):
                self.n_suppressed += 1
                return
            self._busy = True
            self._last_launch = now
            self._seq += 1
            seq = self._seq
        self._worker = threading.Thread(
            target=self._run, args=(dict(event.payload), seq),
            daemon=True, name="photon-feedback-refresh")
        self._worker.start()

    # --- the loop body (worker thread) ------------------------------------
    def _run(self, payload: dict, seq: int) -> None:
        coordinate = payload.get("coordinate") or TOTAL_COORDINATE
        staging = os.path.join(self.config.publish_dir, ".staging",
                               f"refresh-{seq:04d}")
        stage = "launch"
        try:
            # chaos site: a faulted launch aborts before ANY work — the
            # incumbent serves on, the next drift event retries
            fault_point("feedback.refresh_launch", coordinate=coordinate)
            stage = "join"
            os.makedirs(staging, exist_ok=True)
            self._drain_reqlogs()
            joined_path = os.path.join(staging, "joined.avro")
            join = join_feedback(self.reqlog_dirs, self.config.labels,
                                 joined_path)
            if join.joined < max(self.config.min_rows, 1):
                raise AutopilotAbort(
                    f"joined {join.joined} rows < min_rows "
                    f"{self.config.min_rows} — not enough feedback to "
                    f"refresh on")
            stage = "refresh"
            from photon_ml_tpu_torch.cli import refresh_game

            run_dir = os.path.join(staging, "run")
            argv = [
                "--prior-dir", self.config.prior_dir,
                "--training-data", joined_path,
                "--output-dir", run_dir,
                "--task", self.config.task,
                "--feature-shards", self.config.feature_shards,
                "--coordinates", *self.config.coordinates,
                "--update-sequence", self.config.update_sequence,
                "--grid", *self.config.grid,
                "--evaluators", self.config.evaluators,
                "--data-validation", self.config.data_validation,
                "--refresh-sweeps", str(self.config.refresh_sweeps),
                "--device", self.device,
            ]
            if self.config.drifted_only and coordinate != TOTAL_COORDINATE:
                argv += ["--refresh-coordinates", coordinate]
            if self.config.fleet_shards > 0:
                argv += ["--fleet-shards", str(self.config.fleet_shards)]
            result = refresh_game.run(argv)
            stage = "publish"
            entry = os.path.join(self.config.publish_dir,
                                 f"refresh-{seq:04d}")
            # one rename publishes the COMPLETE run (model + manifest +
            # baseline + patches) — the watchers never see it half-built
            os.rename(run_dir, entry)
            self.config.prior_dir = entry
            if join.last_ts is not None:
                _LAG.set(max(time.time() - join.last_ts, 0.0))  # photon-lint: disable=tel-wall-clock -- freshness lag anchors to the log's wall-clock ts (possibly another machine's); a monotonic timer cannot span processes
            _REFRESHES.inc()
            with self._lock:
                self.n_refreshes += 1
                self.last_result = {"entry": entry, "join": join.as_dict(),
                                    "solved": result["solved"],
                                    "coordinate": coordinate}
            logger.info(
                "autopilot refresh %d published %s (coordinate %s, "
                "joined %d rows, solved %s)", seq, entry, coordinate,
                join.joined, result["solved"])
        except Exception as e:
            _ABORTS.labels(stage=stage).inc()
            with self._lock:
                self.n_aborts += 1
            level = (logging.WARNING if isinstance(e, AutopilotAbort)
                     else logging.ERROR)
            logger.log(level,
                       "autopilot refresh %d aborted at stage %s "
                       "(incumbent keeps serving): %r", seq, stage, e)
        finally:
            shutil.rmtree(staging, ignore_errors=True)
            with self._lock:
                self._busy = False

    def _drain_reqlogs(self, timeout_s: float = 10.0) -> None:
        """Flush the in-process logs and wait for their segments to land
        (``Event.wait`` polling — the joiner reads only durable files)."""
        for rl in self.reqlogs:
            rl.flush()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(rl.stats()["buffered"] == 0 for rl in self.reqlogs):
                return
            if self._stop.wait(0.05):
                return

    # --- introspection ----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"refreshes": self.n_refreshes, "aborts": self.n_aborts,
                    "suppressed": self.n_suppressed, "busy": self._busy,
                    "last": self.last_result}
