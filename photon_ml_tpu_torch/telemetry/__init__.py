"""Telemetry: metrics registry, Prometheus exposition, span tracing, and
the run's telemetry lifecycle.

Counterpart of ``photon_ml_tpu/telemetry/__init__.py``:

- :mod:`~photon_ml_tpu_torch.telemetry.metrics` — thread-safe labeled
  Counter/Gauge/Histogram families in a process-global registry (a copy);
- :mod:`~photon_ml_tpu_torch.telemetry.prometheus` — ``/metrics`` text
  exposition and the matching parser;
- :mod:`~photon_ml_tpu_torch.telemetry.tracing` — nested spans →
  ``trace.jsonl`` (``timed()`` stages ride it; a copy);
- :mod:`~photon_ml_tpu_torch.telemetry.bridge` — the EventBus → registry
  translator (a copy);
- :mod:`~photon_ml_tpu_torch.telemetry.device` — the host-RSS / CUDA
  memory gauge sampler;
- :mod:`~photon_ml_tpu_torch.telemetry.profiling` — per-call execute
  accounting with the kernels' analytic work, and build counts;
- :mod:`~photon_ml_tpu_torch.telemetry.aggregate` — the fleet fold (at
  sweep boundaries over ``parallel/multihost.py``, and offline through
  ``tools/metrics_fold.py``), the chief's ``--metrics-port`` listener and
  the trace merge;
- the retained plane of the serving commands:
  :mod:`~photon_ml_tpu_torch.telemetry.history` (the ring behind ``GET
  /history`` and its fleet fold),
  :mod:`~photon_ml_tpu_torch.telemetry.saturation` (USE gauges over a
  closed set of resources) and
  :mod:`~photon_ml_tpu_torch.telemetry.flightrec` (the black box and its
  stall watchdog).

:class:`TelemetrySession` is the drivers' one-call lifecycle: configure the
global tracer into ``--telemetry-dir``, bind the bridge, turn on the
profiling accounting, start the sampler and (``--telemetry-poll-s``) the
periodic ``metrics.prom`` snapshot writer, stand up the fleet aggregator
under ``--metrics-port``, and on close dump a final ``metrics.prom`` next
to the trace — with, on the chief of a folding run, the matching
``metrics.aggregate.prom``. ``photon_build_info`` carries ``torch_version``
where the JAX package's carries ``jax_version``.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Optional

from photon_ml_tpu_torch.telemetry import (  # noqa: F401
    bridge,
    metrics,
    profiling,
    tracing,
)
from photon_ml_tpu_torch.telemetry.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
    default_registry,
    quantile_from_buckets,
)
from photon_ml_tpu_torch.telemetry.tracing import (  # noqa: F401
    GLOBAL_TRACER,
    Tracer,
    annotate,
    span,
)

logger = logging.getLogger(__name__)


def emit_build_info(registry: Optional[MetricsRegistry] = None) -> None:
    """Register the ``photon_build_info{version, process, torch_version}``
    info-style gauge (constant 1; the payload rides the labels). Every
    driver emits it at startup, so one fleet scrape shows a mixed-version
    fleet at a glance. Idempotent per label set."""
    import torch

    from photon_ml_tpu_torch import __version__
    from photon_ml_tpu_torch.parallel import multihost

    reg = registry if registry is not None else default_registry()
    try:
        process = str(multihost.process_index())
    except Exception:
        process = "0"
    reg.gauge(
        "photon_build_info",
        "Constant 1; build/version info rides the labels (a fleet scrape "
        "shows mixed-version fleets at a glance)",
        labels=("version", "process", "torch_version")).labels(
            version=__version__, process=process,
            torch_version=torch.__version__).set(1.0)


def record_optimizer_trace(coordinate_id: str, result, *, sweep: int = 0,
                           ) -> None:
    """Fold one coordinate solve's optimizer trace into telemetry: the
    per-iteration (loss, |grad|) table goes into ``trace.jsonl`` as an
    ``optimizer_trace`` annotation under the current span, and the
    iteration/convergence summary lands in the registry.

    ``result`` is one lane's
    :class:`~photon_ml_tpu_torch.optimize.OptimizerResult`. Call sites gate
    on :func:`tracing.enabled`: reading its tensors is a device sync, which
    a run without telemetry must not pay.
    """
    import numpy as np

    iterations = int(result.iterations)
    converged = bool(result.converged)
    metrics.counter(
        "photon_optimizer_iterations_total",
        "Optimizer iterations spent, per coordinate",
        labels=("coordinate",)).labels(coordinate=coordinate_id).inc(
            max(iterations, 0))
    metrics.gauge(
        "photon_optimizer_converged",
        "1 when the coordinate's last solve converged",
        labels=("coordinate",)).labels(coordinate=coordinate_id).set(
            1.0 if converged else 0.0)
    values = np.asarray(result.values.detach().cpu(), np.float64)
    gnorms = np.asarray(result.grad_norms.detach().cpu(), np.float64)
    if values.size == 0:
        return  # per-iteration tracking off
    n = min(iterations + 1, len(values))
    finite = np.isfinite(values[:n])
    if finite.any():
        last = int(np.nonzero(finite)[0][-1])
        metrics.gauge(
            "photon_optimizer_final_loss",
            "Objective value at the coordinate's last recorded iteration",
            labels=("coordinate",)).labels(coordinate=coordinate_id).set(
                float(values[last]))
        metrics.gauge(
            "photon_optimizer_final_grad_norm",
            "Gradient norm at the coordinate's last recorded iteration",
            labels=("coordinate",)).labels(coordinate=coordinate_id).set(
                float(gnorms[last]))
    tracing.annotate(
        "optimizer_trace", coordinate=coordinate_id, sweep=sweep,
        iterations=iterations, converged=converged,
        values=[float(v) for v in values[:n]],
        grad_norms=[float(g) for g in gnorms[:n]])


class _NullSession:
    """Telemetry disabled: every lifecycle call is a no-op."""

    enabled = False

    def close(self) -> None:
        pass


class TelemetrySession:
    """One run's telemetry lifecycle (built by the drivers from
    ``--telemetry-dir`` / ``--telemetry-poll-s`` / ``--metrics-port``).

    With ``metrics_port``, every process of the job installs the fleet
    fold hook (the fold is a collective, so the flag — shared by the whole
    job's command line — must act symmetrically) and the chief additionally
    serves ``GET /metrics`` with the latest aggregate. With a telemetry dir
    AND a positive poll interval, ``metrics.prom`` is re-snapshotted
    push-gateway-style every interval, so batch runs are observable
    mid-flight rather than only at exit.
    """

    enabled = True

    def __init__(self, telemetry_dir: Optional[str] = None,
                 poll_interval_s: float = 0.0, bus=None,
                 registry: Optional[MetricsRegistry] = None,
                 metrics_port: int = 0):
        if bus is None:
            from photon_ml_tpu_torch.events import GLOBAL_BUS as bus
        self.telemetry_dir = telemetry_dir
        self.registry = registry if registry is not None \
            else default_registry()
        # session components: built here, torn down in close() — both
        # calls come from the one driver thread that owns the session
        self._unbind = bridge.bind(bus=bus, registry=self.registry)  # guarded-by: caller
        profiling.set_accounting(True)
        self._accounting = True  # guarded-by: caller
        self._sampler = None  # guarded-by: caller
        self._owns_tracer = False  # guarded-by: caller
        self._aggregator = None  # guarded-by: caller
        self._server = None  # guarded-by: caller
        self._unhook = lambda: None  # guarded-by: caller
        self._snap_stop: Optional[threading.Event] = None  # guarded-by: caller
        self._snap_thread: Optional[threading.Thread] = None  # guarded-by: caller
        if telemetry_dir:
            os.makedirs(telemetry_dir, exist_ok=True)
            tracing.configure(os.path.join(telemetry_dir, "trace.jsonl"),
                              bus=bus)
            self._owns_tracer = True
        if poll_interval_s > 0:
            from photon_ml_tpu_torch.telemetry.device import DeviceStatsSampler

            self._sampler = DeviceStatsSampler(
                poll_interval_s, registry=self.registry).start()
            if telemetry_dir:
                # push-gateway-style periodic snapshot on the same cadence
                # (Event.wait, not sleep — shutdown is immediate and the
                # resilience sleep-hygiene rule holds)
                self._snap_stop = threading.Event()
                self._snap_thread = threading.Thread(
                    target=self._snapshot_loop, args=(poll_interval_s,),
                    daemon=True, name="photon-telemetry-snapshot")
                self._snap_thread.start()
        if metrics_port:
            from photon_ml_tpu_torch.telemetry.aggregate import (
                FleetMetricsAggregator,
                MetricsHTTPServer,
                install_sweep_hook,
                is_chief,
            )

            self._aggregator = FleetMetricsAggregator(registry=self.registry)
            self._unhook = install_sweep_hook(
                lambda **info: self._aggregator.fold())
            if is_chief():
                self._server = MetricsHTTPServer(
                    self._aggregator.latest, port=metrics_port).start()

    @property
    def metrics_url(self) -> Optional[str]:
        """The chief's live scrape URL (None off-chief / without
        ``--metrics-port``)."""
        return None if self._server is None else self._server.url

    def _snapshot_loop(self, interval_s: float) -> None:
        while not self._snap_stop.wait(interval_s):
            try:
                self.dump_metrics()
            except Exception:  # the writer must never kill the run
                logger.debug("periodic metrics snapshot failed",
                             exc_info=True)

    def _local_text(self) -> str:
        """This process's snapshot, host-tagged on multi-process jobs —
        the one renderer behind dumps, the periodic writer and the fold,
        so offline folds of the dumps reproduce the live fold exactly."""
        from photon_ml_tpu_torch.telemetry.aggregate import process_tag
        from photon_ml_tpu_torch.telemetry.prometheus import render

        tag = process_tag()
        return render(self.registry,
                      host_tag=None if tag is None else ("process", tag))

    def dump_metrics(self, text: Optional[str] = None) -> Optional[str]:
        """Write the registry snapshot as ``<dir>/metrics.prom`` (atomic
        tmp+rename — a scraper never reads a torn file); returns the path
        (None when no telemetry dir)."""
        if not self.telemetry_dir:
            return None
        return _write_atomic(
            os.path.join(self.telemetry_dir, "metrics.prom"),
            text if text is not None else self._local_text())

    def close(self) -> None:
        if self._snap_stop is not None:
            self._snap_stop.set()
            self._snap_thread.join()
            self._snap_stop = self._snap_thread = None
        if self._sampler is not None:
            self._sampler.close()
            self._sampler = None
        text = self._local_text()
        self.dump_metrics(text=text)
        if self._aggregator is not None:
            # final collective fold over the EXACT texts just dumped, so
            # tools/metrics_fold.py over the metrics.prom files reproduces
            # metrics.aggregate.prom byte-for-byte. Skipped when close()
            # runs on an exception path: the job is dying and a collective
            # here would hang against processes that never reach it.
            if sys.exc_info()[0] is None:
                try:
                    agg = self._aggregator.fold(local_text=text)
                except Exception:
                    logger.warning("final fleet metrics fold failed",
                                   exc_info=True)
                    agg = None
                if agg is not None and self.telemetry_dir:
                    _write_atomic(os.path.join(self.telemetry_dir,
                                               "metrics.aggregate.prom"),
                                  agg)
            if self._server is not None:
                self._server.stop()
                self._server = None
            self._unhook()
            self._unhook = lambda: None
            self._aggregator = None
        if self._owns_tracer:
            tracing.close()
            self._owns_tracer = False
        self._unbind()
        self._unbind = lambda: None
        if self._accounting:
            profiling.set_accounting(False)
            self._accounting = False


def _write_atomic(path: str, text: str) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def start_telemetry(telemetry_dir: Optional[str] = None,
                    poll_interval_s: float = 0.0, bus=None,
                    metrics_port: int = 0):
    """Driver entry: a live :class:`TelemetrySession` when anything is
    enabled, else an inert null session (so callers always hold something
    with ``close()``)."""
    if not telemetry_dir and poll_interval_s <= 0 and not metrics_port:
        return _NullSession()
    return TelemetrySession(telemetry_dir=telemetry_dir,
                            poll_interval_s=poll_interval_s, bus=bus,
                            metrics_port=metrics_port)
