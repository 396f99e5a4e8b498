"""Resource saturation: USE-method gauges over a closed vocabulary.

Counterpart of ``photon_ml_tpu/telemetry/saturation.py``. The history ring
(:mod:`~photon_ml_tpu_torch.telemetry.history`) says what happened; this
module says which resource binds right now. Every serving-path resource
gets three gauges:

- ``photon_resource_utilization{resource=...}``: busy fraction in [0, 1]
  (device duty cycle, queue depth over ``--max-queue``, pool workers busy
  over pool size, open connections over ``--max-connections``);
- ``photon_resource_saturation{resource=...}``: waiting work (queue depth,
  pending pool tasks, buffered request-log records);
- ``photon_resource_errors{resource=...}``: errors of the resource over the
  last sampling interval (sheds, refused connections, dropped log
  records). Probes report cumulative counts; the sampler takes deltas.

The resource names (:data:`RESOURCES`) are a closed set, so the gauges'
cardinality is bounded whatever the traffic. :class:`SaturationSampler`
has no thread of its own: the serving commands call its ``sample`` as the
history sampler's ``pre_sample``, so every retained snapshot carries fresh
gauges and the router's fold ships them fleet-wide.

Probes are plain callables returning a small dict, built where the
serving pieces are wired (``cli/serve_game.py``, ``cli/serve_fleet.py``):
telemetry imports neither serving nor fleet. This module supplies the
generic probes (:func:`queue_probe`, :func:`executor_probe`,
:func:`busy_probe`) and the device's busy seconds.

**The device's busy time in the port.** :func:`device_busy_seconds` keeps
the JAX semantics: the ``_sum`` of ``photon_execute_latency_seconds``
(``telemetry/profiling.py``) plus the ``execute`` stage of
``photon_serving_stage_seconds``. On the card that stage's wall covers a
chunk's host-to-device copies, the CUDA-graph replay and the copy back,
whose ``.cpu()`` waits for the device (``serving/engine.py``), so the
``device`` resource's utilization is the share of wall time the engine
spends in that leg, not the card's own busy share.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Mapping, Optional

from photon_ml_tpu_torch.telemetry import metrics as _metrics

__all__ = [
    "RESOURCES",
    "SaturationSampler",
    "busy_probe",
    "device_busy_seconds",
    "executor_probe",
    "queue_probe",
]

#: the closed resource vocabulary: every serving-path resource the
#: capacity plane accounts for
RESOURCES = (
    "device",
    "batcher_queue",
    "rank_batcher_queue",
    "http_connections",
    "handler_threads",
    "saver_pool",
    "router_pool",
    "hedge_pool",
    "reqlog",
)

_UTILIZATION = _metrics.gauge(
    "photon_resource_utilization",
    "USE-method utilization per serving-path resource (busy fraction in "
    "[0, 1]: device duty cycle, queue depth / capacity, pool active / "
    "size, open connections / budget)",
    labels=("resource",))
_SATURATION = _metrics.gauge(
    "photon_resource_saturation",
    "USE-method saturation per serving-path resource (waiting work: "
    "queue depth, pending pool tasks, buffered log records)",
    labels=("resource",))
_ERRORS = _metrics.gauge(
    "photon_resource_errors",
    "USE-method errors attributed to each serving-path resource over "
    "the last sampling interval (sheds, refused connections, drops)",
    labels=("resource",))
# each host saturates on its own pressure: a fleet fold fans these out per
# host instead of letting one host's value stand for all
for _fam in ("photon_resource_utilization", "photon_resource_saturation",
             "photon_resource_errors"):
    _metrics.mark_host_owned(_fam)


def _clamp01(value: float) -> float:
    return 0.0 if value < 0.0 else (1.0 if value > 1.0 else float(value))


def queue_probe(depth_fn: Callable[[], int],
                capacity_fn: Callable[[], Optional[int]],
                errors_fn: Optional[Callable[[], float]] = None,
                ) -> Callable[[], dict]:
    """A bounded queue: utilization = depth / capacity (0 when unbounded),
    saturation = depth, errors = the caller's cumulative refusals."""
    def probe() -> dict:
        depth = float(depth_fn())
        cap = capacity_fn()
        out = {"utilization": _clamp01(depth / cap) if cap else 0.0,
               "saturation": depth}
        if errors_fn is not None:
            out["errors"] = float(errors_fn())
        return out
    return probe


def executor_probe(executor, size: Optional[int] = None,
                   ) -> Callable[[], dict]:
    """A stdlib ``ThreadPoolExecutor``: utilization = busy workers / pool
    size, saturation = queued tasks not started. It reads three private
    attributes (``_idle_semaphore``, ``_threads``, ``_work_queue``), here
    only, and reads zeros if the stdlib renames them."""
    def probe() -> dict:
        cap = size if size is not None \
            else getattr(executor, "_max_workers", 0)
        try:
            idle = executor._idle_semaphore._value
            spawned = len(executor._threads)
            pending = executor._work_queue.qsize()
        except AttributeError:  # pragma: no cover - stdlib drift
            return {"utilization": 0.0, "saturation": 0.0}
        active = max(0, spawned - idle)
        return {"utilization": _clamp01(active / cap) if cap else 0.0,
                "saturation": float(pending)}
    return probe


def busy_probe(busy_seconds_fn: Callable[[], float],
               errors_fn: Optional[Callable[[], float]] = None,
               ) -> Callable[[], dict]:
    """A duty-cycle resource: the callable returns cumulative busy
    seconds; the sampler turns the interval's delta over wall time into
    utilization (clamped to [0, 1]: busy intervals of several threads can
    overlap)."""
    def probe() -> dict:
        out: dict = {"busy_seconds": float(busy_seconds_fn())}
        if errors_fn is not None:
            out["errors"] = float(errors_fn())
        return out
    return probe


def device_busy_seconds(registry=None) -> float:
    """Cumulative device busy seconds of this process: the ``_sum`` of
    ``photon_execute_latency_seconds`` (``profile_fn``-wrapped training
    calls) plus ``photon_serving_stage_seconds{stage="execute"}`` (the
    serving engines, which count their captures through
    ``record_compile`` and time their device leg as that stage). The two
    sources never time the same call. See the module docstring for what
    the execute stage covers on the card."""
    reg = registry if registry is not None else _metrics.default_registry()
    total = 0.0
    fam = reg.get("photon_execute_latency_seconds")
    if fam is not None:
        total += sum(child.sum for _labels, child in fam.children())
    stages = reg.get("photon_serving_stage_seconds")
    if stages is not None:
        idx = (stages.label_names.index("stage")
               if "stage" in stages.label_names else None)
        total += sum(child.sum for values, child in stages.children()
                     if idx is not None and values[idx] == "execute")
    return float(total)


class SaturationSampler:
    """The three USE gauges of every registered probe, on each tick.

    ``add_probe(resource, probe)`` registers a callable returning a dict
    with any of ``utilization``, ``saturation``, ``errors`` (cumulative;
    deltas are taken here) and ``busy_seconds`` (cumulative; turned into
    utilization over the interval). A name outside :data:`RESOURCES`
    raises. ``sample(now=)`` runs every probe and sets the gauges; a probe
    that raises reads zeros for that tick.
    """

    def __init__(self, *, registry=None):
        self._registry = registry if registry is not None \
            else _metrics.default_registry()
        self._utilization = self._registry.gauge(
            "photon_resource_utilization", _UTILIZATION.help,
            labels=("resource",))
        self._saturation = self._registry.gauge(
            "photon_resource_saturation", _SATURATION.help,
            labels=("resource",))
        self._errors = self._registry.gauge(
            "photon_resource_errors", _ERRORS.help, labels=("resource",))
        self._lock = threading.Lock()
        self._probes: dict[str, Callable[[], dict]] = {}  # guarded-by: _lock
        self._prev_errors: dict[str, float] = {}  # guarded-by: _lock
        self._prev_busy: dict[str, float] = {}  # guarded-by: _lock
        self._prev_ts: Optional[float] = None  # guarded-by: _lock

    def add_probe(self, resource: str,
                  probe: Callable[[], dict]) -> None:
        if resource not in RESOURCES:
            raise ValueError(
                f"unknown resource {resource!r}: the saturation "
                f"vocabulary is closed ({', '.join(RESOURCES)})")
        with self._lock:
            self._probes[resource] = probe

    def resources(self) -> tuple:
        """The probed resources, sorted."""
        with self._lock:
            return tuple(sorted(self._probes))

    def sample(self, now: Optional[float] = None) -> dict:
        """One tick: run every probe, set the gauges and return
        ``{resource: {utilization, saturation, errors}}``."""
        now = time.monotonic() if now is None else float(now)
        out: dict[str, dict] = {}
        with self._lock:
            probes = dict(self._probes)
            dt = (now - self._prev_ts) if self._prev_ts is not None else 0.0
            self._prev_ts = now
        for resource, probe in probes.items():
            try:
                raw: Mapping = probe() or {}
            except Exception:
                raw = {}
            util = float(raw.get("utilization", 0.0))
            busy = raw.get("busy_seconds")
            with self._lock:
                if busy is not None:
                    prev = self._prev_busy.get(resource)
                    self._prev_busy[resource] = float(busy)
                    if prev is not None and dt > 0:
                        util = _clamp01((float(busy) - prev) / dt)
                    else:
                        util = 0.0
                errors_cum = float(raw.get("errors", 0.0))
                prev_err = self._prev_errors.get(resource, errors_cum)
                self._prev_errors[resource] = errors_cum
            values = {
                "utilization": _clamp01(util),
                "saturation": max(0.0, float(raw.get("saturation", 0.0))),
                "errors": max(0.0, errors_cum - prev_err),
            }
            self._utilization.labels(resource=resource).set(
                values["utilization"])
            self._saturation.labels(resource=resource).set(
                values["saturation"])
            self._errors.labels(resource=resource).set(values["errors"])
            out[resource] = values
        return out
