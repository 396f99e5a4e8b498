"""EventBus → MetricsRegistry bridge (a copy of
``photon_ml_tpu/telemetry/bridge.py``: it is pure Python).

The subsystems built before telemetry already *narrate* themselves on the
event bus — ``serving_request`` per scored request, ``retry_attempt`` /
``retry_exhausted`` around every transient-fault recovery,
``stage_started``/``stage_finished`` from ``timed()``, divergence-guard
verdicts, model registry lifecycle. This module turns that narration into
real metric families by subscribing ONE translating listener, so none of
those call sites needed touching to join the metrics story.

Cardinality discipline: event payloads carry unbounded detail (file paths,
error reprs); labels must not. The bridge keeps only bounded-vocabulary
labels — the retry ``op`` is truncated at its first ``:`` (``avro.read:
part-00007.avro`` → ``avro.read``), stage/span/coordinate names are the
small fixed sets the code declares.

``bind(bus, registry)`` is idempotent per (bus, registry) pair — the model
registry binds at construction and the drivers' ``--telemetry-dir`` path
binds again without double-counting.
"""

from __future__ import annotations

from typing import Callable, Optional

from photon_ml_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    default_registry,
    mark_host_owned,
)

#: attribute stashed on the bus holding the registries already bridged to it
#: (strong refs on purpose: identity checks must not race id() reuse)
_BOUND_ATTR = "_telemetry_bridged_registries"


def _op_family(op: str) -> str:
    """``avro.read:part-00007.avro`` → ``avro.read`` (bounded label)."""
    return str(op).split(":", 1)[0]


def _make_listener(reg: MetricsRegistry) -> Callable:
    # families declared once, up front, so /metrics shows them at zero
    # before the first event arrives
    serving_requests = reg.counter(
        "photon_serving_requests_total",
        "Scored /score requests (one per request, any batch size)")
    serving_rows = reg.counter(
        "photon_serving_scored_rows_total",
        "Individual records scored across all requests")
    retry_attempts = reg.counter(
        "photon_retry_attempts_total",
        "Failed attempts that will be retried", labels=("op",))
    retry_exhausted = reg.counter(
        "photon_retry_exhausted_total",
        "Operations that failed past their retry budget", labels=("op",))
    retry_recovered = reg.counter(
        "photon_retry_recoveries_total",
        "Operations that succeeded after at least one failed attempt",
        labels=("op",))
    stage_seconds = reg.histogram(
        "photon_stage_seconds", "timed() stage durations",
        labels=("stage",),
        buckets=(0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0))
    span_seconds = reg.histogram(
        "photon_span_seconds", "Completed span durations by span name",
        labels=("span",),
        buckets=(0.001, 0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0))
    divergences = reg.counter(
        "photon_divergence_detected_total",
        "Non-finite coordinate steps detected by the guard",
        labels=("coordinate",))
    rollbacks = reg.counter(
        "photon_coordinate_rollbacks_total",
        "Guard rollback-retries", labels=("coordinate",))
    freezes = reg.counter(
        "photon_coordinate_freezes_total",
        "Coordinates frozen at their last good model",
        labels=("coordinate",))
    reloads = reg.counter(
        "photon_model_reloads_total",
        "Model versions loaded and registered")
    reload_rejects = reg.counter(
        "photon_model_reload_rejects_total",
        "Candidate model dirs rejected by validation")
    active_version = reg.gauge(
        "photon_model_active_version",
        "Currently active serving model version (0 = none)")
    # host-owned: a serving fleet mid-rollout legitimately has processes
    # on different versions — the aggregate must show every one, not
    # whichever host's gauge merged last
    mark_host_owned("photon_model_active_version")
    training_runs = reg.counter(
        "photon_training_runs_total",
        "Training driver invocations", labels=("driver",))
    supervisor_faults = reg.counter(
        "photon_supervisor_faults_total",
        "Fleet liveness faults detected by the supervisor",
        labels=("reason",))  # "exit" | "stall" — a closed vocabulary
    supervisor_restarts = reg.counter(
        "photon_supervisor_restarts_total",
        "Whole-fleet restarts performed by the supervisor")
    supervisor_exhausted = reg.counter(
        "photon_supervisor_exhausted_total",
        "Supervised runs abandoned past their restart budget or deadline")
    drift_events = reg.counter(
        "photon_quality_drift_events_total",
        "quality_drift_detected events: the live score distribution's "
        "PSI vs the active model's baseline crossed the drift threshold")
    canary_evals = reg.counter(
        "photon_quality_canary_evals_total",
        "Canary shadow-scoring evaluations at activation time, by "
        "verdict (pass | divergent | rejected — a closed vocabulary)",
        labels=("verdict",))
    brownout_changes = reg.counter(
        "photon_brownout_changes_total",
        "Serving brownout level transitions (up = degrading under "
        "pressure, down = recovering — a closed vocabulary)",
        labels=("direction",))
    slo_burns = reg.counter(
        "photon_slo_burn_total",
        "SLO burn-rate alerts fired by the fleet tracker, by burn "
        "window (the tracker's fixed window names — a closed vocabulary)",
        labels=("window",))

    def listener(event) -> None:
        name, p = event.name, event.payload
        if name == "serving_request":
            serving_requests.inc()
            serving_rows.inc(float(p.get("batch", 1)))
        elif name == "retry_attempt":
            retry_attempts.labels(op=_op_family(p.get("op", "op"))).inc()
        elif name == "retry_exhausted":
            retry_exhausted.labels(op=_op_family(p.get("op", "op"))).inc()
        elif name == "retry_succeeded":
            retry_recovered.labels(op=_op_family(p.get("op", "op"))).inc()
        elif name == "stage_finished":
            stage_seconds.labels(stage=str(p.get("stage", ""))).observe(
                float(p.get("seconds", 0.0)))
        elif name == "span_finished":
            span_seconds.labels(span=str(p.get("span", ""))).observe(
                float(p.get("seconds", 0.0)))
        elif name == "divergence_detected":
            divergences.labels(
                coordinate=str(p.get("coordinate", ""))).inc()
        elif name == "coordinate_rollback":
            rollbacks.labels(coordinate=str(p.get("coordinate", ""))).inc()
        elif name == "coordinate_frozen":
            freezes.labels(coordinate=str(p.get("coordinate", ""))).inc()
        elif name == "model_loaded":
            reloads.inc()
        elif name == "model_reload_rejected":
            reload_rejects.inc()
        elif name == "model_activated":
            active_version.set(float(p.get("version") or 0))
        elif name == "training_started":
            training_runs.labels(driver=str(p.get("driver", ""))).inc()
        elif name == "supervisor_fault_detected":
            supervisor_faults.labels(
                reason=str(p.get("reason", "unknown"))).inc()
        elif name == "supervisor_restart":
            supervisor_restarts.inc()
        elif name == "supervisor_exhausted":
            supervisor_exhausted.inc()
        elif name == "quality_drift_detected":
            drift_events.inc()
        elif name == "canary_evaluated":
            canary_evals.labels(
                verdict=str(p.get("verdict", "pass"))).inc()
        elif name == "brownout_changed":
            direction = ("up" if float(p.get("level", 0))
                         > float(p.get("previous", 0)) else "down")
            brownout_changes.labels(direction=direction).inc()
        elif name == "slo_burn_alert":
            slo_burns.labels(window=str(p.get("window", ""))).inc()

    return listener


def bind(bus=None, registry: Optional[MetricsRegistry] = None,
         ) -> Callable[[], None]:
    """Subscribe the translating listener; returns an unbind callable.

    Idempotent per (bus, registry): a second bind of the same pair is a
    no-op returning a no-op unbinder, so the serving registry, the CLI
    telemetry session, and tests can all bind defensively.
    """
    if bus is None:
        from photon_ml_tpu_torch.events import GLOBAL_BUS as bus
    registry = registry if registry is not None else default_registry()
    bound: list = getattr(bus, _BOUND_ATTR, None)
    if bound is None:
        bound = []
        setattr(bus, _BOUND_ATTR, bound)
    if any(r is registry for r in bound):
        return lambda: None
    bound.append(registry)
    unsubscribe = bus.subscribe(_make_listener(registry))

    def unbind() -> None:
        unsubscribe()
        try:
            bound.remove(registry)
        except ValueError:
            pass

    return unbind
