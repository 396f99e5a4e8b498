"""Inline config DSLs of the command-line tools (counterpart of
``photon_ml_tpu/cli/config.py``; the same grammar):

**Feature shard** (``--feature-shards``, comma-separated)::

    shardId=bag1+bag2            # bags; intercept on by default
    shardId=bag1+bag2|noIntercept
    shardId=*                    # every feature in the record

**Coordinate** (``--coordinates``, one argument per coordinate)::

    coordId=fixed,shard=global,optimizer=LBFGS,reg=L2,maxIter=80,tol=1e-6
    coordId=random,entity=userId,shard=user,reg=L2,activeUpper=1000,
           activeLower=1,maxFeatures=500,buckets=histogram
    coordId=fixed,shard=global,reg=ELASTIC_NET,alpha=0.5,variance=SIMPLE,
           downsample=0.5,downsampleMode=binary
    coordId=random,entity=userId,shard=user,projector=RANDOM,projectedDim=64,
           cacheBuckets=false
    coordId=factored,entity=userId,shard=user,projectedDim=8,
           factoredIterations=2,lamProjection=1

**Regularization weights** (``--grid``)::

    coordId=0.1;1;10  [space-separated groups → cartesian product]

The resilience flags (:func:`add_resilience_flags`: retries, retry
deadline, divergence policy) and serve_game's model-quality and ranking
flags (:func:`add_quality_flags`, :func:`add_rank_flags`) are ported, and
the supervision flags live beside the supervisor
(:func:`~photon_ml_tpu_torch.resilience.supervisor.add_supervision_flags`);
so is the fleet router's group (:class:`RouterConfig`,
:func:`add_router_flags`, serve_fleet's), and the telemetry group
(:class:`TelemetryConfig`, :func:`add_telemetry_flags`,
:func:`install_telemetry`) with serve_game's and serve_fleet's retained
group (:class:`RetainedConfig`, :func:`add_retained_flags`).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Mapping, Optional, Sequence

from photon_ml_tpu_torch.game.data import RandomEffectDatasetConfig
from photon_ml_tpu_torch.game.estimator import (
    FactoredRandomEffectCoordinateConfig,
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.game.projector import ProjectorType
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfig
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.sampling import (
    BinaryClassificationDownSampler,
    DownSampler,
)
from photon_ml_tpu_torch.types import (
    OptimizerType,
    RegularizationType,
    VarianceComputationType,
)


def parse_feature_shard_config(spec: str) -> FeatureShardConfig:
    spec = spec.strip()
    if "=" not in spec:
        raise ValueError(f"feature shard spec needs shardId=bags, got {spec!r}")
    shard_id, rhs = spec.split("=", 1)
    has_intercept = True
    if "|" in rhs:
        rhs, flag = rhs.split("|", 1)
        if flag == "noIntercept":
            has_intercept = False
        elif flag != "intercept":
            raise ValueError(f"unknown shard flag {flag!r}")
    bags = None if rhs == "*" else tuple(b for b in rhs.split("+") if b)
    return FeatureShardConfig(shard_id=shard_id.strip(), feature_bags=bags,
                              has_intercept=has_intercept)


def _parse_kv(parts: Sequence[str]) -> dict[str, str]:
    out = {}
    for p in parts:
        if not p:
            continue
        if "=" not in p:
            raise ValueError(f"expected key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def _optimization(kv: dict) -> GLMOptimizationConfiguration:
    reg_type = RegularizationType(kv.pop("reg", "NONE").upper())
    alpha = float(kv.pop("alpha", 0.5))
    optimizer = OptimizerType(kv.pop("optimizer", "LBFGS").upper())
    opt_cfg = OptimizerConfig(
        max_iterations=int(kv.pop("maxIter", 80)),
        tolerance=float(kv.pop("tol", 1e-6)),
        history=int(kv.pop("history", 10)),
    )
    variance = VarianceComputationType(kv.pop("variance", "NONE").upper())
    return GLMOptimizationConfiguration(
        optimizer=optimizer,
        regularization=RegularizationContext(reg_type, alpha=alpha),
        optimizer_config=opt_cfg,
        variance_type=variance,
    )


def parse_coordinate_config(spec: str):
    """Returns (coordinateId, a Fixed/Random/FactoredRandomEffect
    CoordinateConfig)."""
    spec = spec.strip()
    if "=" not in spec:
        raise ValueError(f"coordinate spec needs coordId=kind,..., got {spec!r}")
    cid, rhs = spec.split("=", 1)
    cid = cid.strip()
    parts = rhs.split(",")
    kind = parts[0].strip()
    kv = _parse_kv(parts[1:])
    if kind == "fixed":
        shard = kv.pop("shard")
        downsampler = None
        if "downsample" in kv:
            rate = float(kv.pop("downsample"))
            mode = kv.pop("downsampleMode", "binary")
            cls = (BinaryClassificationDownSampler if mode == "binary"
                   else DownSampler)
            downsampler = cls(rate=rate)
        cfg = FixedEffectCoordinateConfig(
            feature_shard_id=shard, optimization=_optimization(kv),
            downsampler=downsampler)
    elif kind in ("random", "factored"):
        entity = kv.pop("entity")
        shard = kv.pop("shard")
        cache = kv.pop("cacheBuckets", "true").lower()
        if cache not in ("true", "false"):
            raise ValueError(
                f"cacheBuckets must be true or false, got {cache!r}")
        if kind == "factored":
            # the learned projection is the RANDOM projector; a redundant
            # projector=RANDOM is accepted, anything else refused
            projector = kv.pop("projector", "RANDOM").upper()
            if projector != "RANDOM":
                raise ValueError(
                    f"factored coordinates always use the RANDOM projector "
                    f"(the projection is the trained object); got "
                    f"projector={projector!r}")
            projector_type = ProjectorType.RANDOM
        else:
            projector_type = ProjectorType(
                kv.pop("projector", "INDEX_MAP").upper())
        buckets = kv.pop("buckets", "geometric").lower()
        ds = RandomEffectDatasetConfig(
            random_effect_type=entity,
            feature_shard_id=shard,
            active_data_upper_bound=(int(kv.pop("activeUpper"))
                                     if "activeUpper" in kv else None),
            active_data_lower_bound=int(kv.pop("activeLower", 1)),
            max_active_features=(int(kv.pop("maxFeatures"))
                                 if "maxFeatures" in kv else None),
            projector_type=projector_type,
            projected_dim=(int(kv.pop("projectedDim"))
                           if "projectedDim" in kv else None),
            cache_device_buckets=cache == "true",
            bucket_strategy=buckets,
            max_sample_buckets=int(kv.pop("maxSampleBuckets", 8)),
            max_feature_buckets=int(kv.pop("maxFeatureBuckets", 4)),
        )
        if kind == "factored":
            cfg = FactoredRandomEffectCoordinateConfig(
                dataset=ds,
                lam_projection=float(kv.pop("lamProjection", 0.0)),
                n_factored_iterations=int(kv.pop("factoredIterations", 2)),
                optimization=_optimization(kv))
        else:
            cfg = RandomEffectCoordinateConfig(
                dataset=ds, optimization=_optimization(kv))
    else:
        raise ValueError(
            f"coordinate kind must be fixed|random|factored, got {kind!r}")
    if kv:
        raise ValueError(f"unknown coordinate options {sorted(kv)} in {spec!r}")
    return cid, cfg


def parse_grid(specs: Sequence[str]) -> list[Mapping[str, float]]:
    """``coordId=0.1;1;10`` groups → cartesian product of per-coordinate
    lambda lists."""
    axes: list[tuple[str, list[float]]] = []
    for spec in specs:
        cid, rhs = spec.split("=", 1)
        axes.append((cid.strip(), [float(x) for x in rhs.split(";") if x]))
    out = []
    for combo in itertools.product(*(vals for _, vals in axes)):
        out.append({cid: v for (cid, _), v in zip(axes, combo)})
    return out or [{}]


# ---------------------------------------------------------------------------
# Resilience configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """The drivers' retry/divergence knobs.

    ``max_retries`` is retries, not attempts (0 = try once); it budgets
    both the retry policy and the divergence guard's rollback-retries.
    ``on_divergence``: ``fail`` (raise with an actionable message — the
    default), ``rollback`` (roll back + regularization backoff, freeze
    after the budget), ``freeze`` (freeze immediately).
    """

    max_retries: int = 2
    retry_deadline_s: Optional[float] = None
    on_divergence: str = "fail"
    reg_backoff: float = 10.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.on_divergence not in ("fail", "rollback", "freeze"):
            raise ValueError(
                f"on_divergence must be fail|rollback|freeze, "
                f"got {self.on_divergence!r}")

    def retry_policy(self):
        from photon_ml_tpu_torch.resilience import RetryPolicy

        return RetryPolicy(max_attempts=self.max_retries + 1,
                           deadline_s=self.retry_deadline_s)

    def guard(self, bus=None):
        from photon_ml_tpu_torch.resilience import (
            DivergenceGuard,
            DivergencePolicy,
        )

        return DivergenceGuard(
            DivergencePolicy(mode=self.on_divergence,
                             max_retries=self.max_retries,
                             reg_backoff=self.reg_backoff),
            bus=bus)


def add_resilience_flags(parser) -> None:
    """The drivers' shared resilience flags."""
    parser.add_argument(
        "--max-retries", type=int, default=2,
        help="retries (not attempts) for transient faults: Avro file "
             "reads, checkpoint save/load and the patch publish — and the "
             "divergence guard's per-coordinate rollback budget")
    parser.add_argument(
        "--retry-deadline-s", type=float, default=None,
        help="hard wall-clock deadline across one operation's retries "
             "(the retry never sleeps into a deadline it would blow)")
    parser.add_argument(
        "--on-divergence", choices=["fail", "rollback", "freeze"],
        default="fail",
        help="when a coordinate step produces NaN/Inf: fail = raise with "
             "an actionable error (default); rollback = roll back to the "
             "last good state, bump the coordinate's regularization and "
             "retry (freeze after --max-retries failures); freeze = lock "
             "the coordinate at its last good model immediately and "
             "continue degraded")


def resilience_from_args(args) -> ResilienceConfig:
    return ResilienceConfig(max_retries=args.max_retries,
                            retry_deadline_s=args.retry_deadline_s,
                            on_divergence=args.on_divergence)


def install_resilience(config: ResilienceConfig):
    """Install the process-wide retry policy and build the run's guard."""
    from photon_ml_tpu_torch.resilience import set_default_policy

    set_default_policy(config.retry_policy())
    return config.guard()


# ---------------------------------------------------------------------------
# Telemetry configuration (the six training, scoring and serving commands)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """The drivers' telemetry knobs, round-trippable through a JSON config
    file like :class:`ResilienceConfig`.

    ``telemetry_dir`` (None = disabled) receives ``trace.jsonl`` (the span
    tree) while the run is live and ``metrics.prom`` (the registry
    snapshot) at close; ``poll_interval_s`` (0 = disabled) starts the
    host-RSS/device-memory gauge sampler at that period AND, when a
    telemetry dir is set, re-snapshots ``metrics.prom`` on the same cadence
    (push-gateway-style, so batch runs are observable mid-flight);
    ``metrics_port`` (0 = disabled) serves the live fleet-wide aggregate
    from ``GET /metrics`` on the chief and, at >1 process, enables the
    collective registry fold at sweep boundaries.
    """

    telemetry_dir: Optional[str] = None
    poll_interval_s: float = 0.0
    metrics_port: int = 0

    def __post_init__(self):
        if self.poll_interval_s < 0:
            raise ValueError(f"poll_interval_s must be >= 0, "
                             f"got {self.poll_interval_s}")
        if not 0 <= self.metrics_port < 65536:
            raise ValueError(f"metrics_port must be in [0, 65535], "
                             f"got {self.metrics_port}")

    # --- config-file round-trip ------------------------------------------
    def as_dict(self) -> dict:
        return {"telemetryDir": self.telemetry_dir,
                "pollIntervalS": self.poll_interval_s,
                "metricsPort": self.metrics_port}

    @classmethod
    def from_dict(cls, d: Mapping) -> "TelemetryConfig":
        return cls(telemetry_dir=d.get("telemetryDir"),
                   poll_interval_s=float(d.get("pollIntervalS", 0.0)),
                   metrics_port=int(d.get("metricsPort", 0)))


def add_telemetry_flags(parser) -> None:
    """The shared driver flags: train_game, train_glm, score_game,
    refresh_game, serve_game and serve_fleet."""
    parser.add_argument(
        "--telemetry-dir", default=None,
        help="enable span tracing + metric export into this directory: "
             "trace.jsonl (nested spans: stages, coordinate-descent sweeps "
             "and steps, optimizer traces) streamed during the run, "
             "metrics.prom (Prometheus text snapshot of every counter/"
             "gauge/histogram) written at exit — plus, on the chief of a "
             "--metrics-port run, metrics.aggregate.prom (the fleet fold; "
             "tools/metrics_fold.py reproduces it offline). Default: "
             "telemetry off (zero per-step device syncs)")
    parser.add_argument(
        "--telemetry-poll-s", type=float, default=0.0,
        help="poll interval for the host-RSS / device-memory gauge "
             "sampler (seconds; 0 disables — device memory_stats can "
             "synchronize with the backend, so this is strictly opt-in). "
             "With --telemetry-dir, also re-snapshots metrics.prom at the "
             "same period so batch runs are scrapeable mid-flight")
    parser.add_argument(
        "--metrics-port", type=int, default=0,
        help="serve GET /metrics on this port (chief process only; 0 "
             "disables). In a --multihost run the endpoint returns the "
             "FLEET aggregate — counters and histogram buckets summed "
             "across every process, per-host gauges fanned out under a "
             "process label — refreshed by a collective registry fold at "
             "each coordinate-descent sweep / GLM lambda boundary")


def telemetry_from_args(args, *, subdir: Optional[str] = None,
                        ) -> TelemetryConfig:
    """``subdir`` relocates a non-chief process's telemetry under
    ``workers/proc-N`` — N processes appending to one trace.jsonl would
    interleave records from different runs of the id counter."""
    tdir = args.telemetry_dir
    if tdir and subdir:
        tdir = os.path.join(tdir, subdir)
    return TelemetryConfig(telemetry_dir=tdir,
                           poll_interval_s=args.telemetry_poll_s,
                           metrics_port=args.metrics_port)


def install_telemetry(config: TelemetryConfig):
    """Start the run's telemetry session (a no-op session when everything
    is disabled) — the one call every driver makes after parsing flags.
    Callers own ``session.close()``."""
    from photon_ml_tpu_torch.telemetry import start_telemetry

    return start_telemetry(telemetry_dir=config.telemetry_dir,
                           poll_interval_s=config.poll_interval_s,
                           metrics_port=config.metrics_port)


class DriverTelemetry:
    """A command's telemetry lifecycle, as the JAX mains wire it: the
    session (:func:`install_telemetry`, before the command's first event,
    so the bridge sees the whole run), ``photon_build_info``, a root span
    named after the command and, for the training commands
    (``started`` given), the ``training_started`` / ``training_finished``
    events. :meth:`close` belongs in the command's ``finally``: it closes
    the root span, posts ``training_finished`` and closes the session
    (whose final fold is skipped on an exception path)."""

    def __init__(self, args, driver: str, *, subdir: Optional[str] = None,
                 started: Optional[dict] = None):
        import contextlib

        from photon_ml_tpu_torch.events import GLOBAL_BUS
        from photon_ml_tpu_torch.telemetry import emit_build_info, tracing

        self.driver = driver
        self._bus = GLOBAL_BUS
        self._training = started is not None
        self.session = install_telemetry(
            telemetry_from_args(args, subdir=subdir))
        emit_build_info()
        self._root = contextlib.ExitStack()
        self._root.enter_context(tracing.span(driver))
        if self._training:
            GLOBAL_BUS.post("training_started", driver=driver, **started)

    def close(self) -> None:
        self._root.close()
        if self._training:
            self._bus.post("training_finished", driver=self.driver)
            self._training = False
        self.session.close()


# ---------------------------------------------------------------------------
# Retained-telemetry configuration (serve_game and serve_fleet)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetainedConfig:
    """The serving mains' retained-telemetry knobs (history ring +
    black-box flight recorder), round-trippable through a JSON config
    file like :class:`TelemetryConfig`.

    The history sampler is ALWAYS armed on a serving host (a ring of
    ``history_capacity`` snapshots behind ``GET /history``);
    ``history_period_s`` (0 = manual ticks only, what tests drive)
    starts the periodic sampler thread. ``flight_dir`` (None = disabled)
    arms the flight recorder: the last ``flight_capacity`` spans/events/
    logs/history snapshots, dumped atomically to ``flight-<ts>.jsonl``
    on fault-site trip, unhandled exception, SIGTERM and watchdog stall
    (``watchdog_timeout_s`` > 0 arms the in-process stall watchdog,
    petted by history samples).
    """

    history_capacity: int = 240
    history_period_s: float = 0.0
    flight_dir: Optional[str] = None
    flight_capacity: int = 512
    watchdog_timeout_s: float = 0.0

    def __post_init__(self):
        if self.history_capacity <= 0:
            raise ValueError(f"history_capacity must be > 0, "
                             f"got {self.history_capacity}")
        if self.history_period_s < 0:
            raise ValueError(f"history_period_s must be >= 0, "
                             f"got {self.history_period_s}")
        if self.flight_capacity <= 0:
            raise ValueError(f"flight_capacity must be > 0, "
                             f"got {self.flight_capacity}")
        if self.watchdog_timeout_s < 0:
            raise ValueError(f"watchdog_timeout_s must be >= 0, "
                             f"got {self.watchdog_timeout_s}")

    # --- config-file round-trip ------------------------------------------
    def as_dict(self) -> dict:
        return {"historyCapacity": self.history_capacity,
                "historyPeriodS": self.history_period_s,
                "flightDir": self.flight_dir,
                "flightCapacity": self.flight_capacity,
                "watchdogTimeoutS": self.watchdog_timeout_s}

    @classmethod
    def from_dict(cls, d: Mapping) -> "RetainedConfig":
        return cls(
            history_capacity=int(d.get("historyCapacity", 240)),
            history_period_s=float(d.get("historyPeriodS", 0.0)),
            flight_dir=d.get("flightDir"),
            flight_capacity=int(d.get("flightCapacity", 512)),
            watchdog_timeout_s=float(d.get("watchdogTimeoutS", 0.0)))


def add_retained_flags(parser) -> None:
    """The retained-telemetry flags (serve_game, serve_fleet)."""
    parser.add_argument(
        "--history-capacity", type=int, default=240,
        help="snapshots retained by the on-host telemetry history ring "
             "served from GET /history (closed series vocabulary: "
             "requests, shed_rate, hedge_rate, shard p50/p99, compiles, "
             "...). The ring is always armed; this bounds its memory")
    parser.add_argument(
        "--history-period-s", type=float, default=0.0,
        help="period of the history sampler thread (seconds; 0 = no "
             "thread, snapshots only on demand — tests drive the "
             "injectable tick directly). Each snapshot derives the "
             "interval's series from the watched registry subset")
    parser.add_argument(
        "--flight-dir", default=None,
        help="arm the black-box flight recorder: keep the last "
             "--flight-capacity span/event/log/history records in a "
             "preallocated ring and dump them ATOMICALLY to "
             "flight-<ts>.jsonl in this directory on fault-site trip, "
             "unhandled exception, SIGTERM, or watchdog stall "
             "(tools/postmortem.py renders the incident report). "
             "Default: off")
    parser.add_argument(
        "--flight-capacity", type=int, default=512,
        help="flight-recorder ring capacity (records)")
    parser.add_argument(
        "--watchdog-timeout-s", type=float, default=0.0,
        help="with --flight-dir and --history-period-s > 0: dump a "
             "watchdog_stall flight record when history sampling stops "
             "making progress for this long (seconds; 0 disables). The "
             "fleet supervisor's heartbeat-stall detection triggers the "
             "same dump class out-of-process")


def retained_from_args(args) -> RetainedConfig:
    return RetainedConfig(
        history_capacity=args.history_capacity,
        history_period_s=args.history_period_s,
        flight_dir=args.flight_dir,
        flight_capacity=args.flight_capacity,
        watchdog_timeout_s=args.watchdog_timeout_s)


# ---------------------------------------------------------------------------
# Model-quality configuration (serve_game)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """serve_game's model-quality knobs.

    ``canary_gate`` refuses divergent candidates at activation
    (``canary_bound`` None = the table dtype's documented score
    tolerance, see quality/canary.py); ``quality_poll_s`` (0 = disabled)
    runs the background drift evaluator at that period, raising
    ``quality_drift_detected`` past ``drift_threshold`` (PSI).
    """

    canary_gate: bool = False
    canary_bound: Optional[float] = None
    quality_poll_s: float = 0.0
    drift_threshold: float = 0.25

    def __post_init__(self):
        if self.quality_poll_s < 0:
            raise ValueError(f"quality_poll_s must be >= 0, "
                             f"got {self.quality_poll_s}")
        if self.canary_bound is not None and self.canary_bound < 0:
            raise ValueError(f"canary_bound must be >= 0, "
                             f"got {self.canary_bound}")

    def canary(self):
        from photon_ml_tpu_torch.quality import CanaryConfig

        return CanaryConfig(gate=self.canary_gate, bound=self.canary_bound)


def add_quality_flags(parser) -> None:
    """The serve_game model-quality flags (drift monitoring + canary)."""
    parser.add_argument(
        "--canary-gate", action="store_true",
        help="REFUSE a /reload or watch-dir candidate — exactly like a "
             "validation failure, the incumbent keeps serving — when its "
             "shadow scores over a reservoir of recent live requests "
             "diverge from the incumbent's past the bound. Without the "
             "flag the divergence is still measured and annotated onto "
             "the activation")
    parser.add_argument(
        "--canary-bound", type=float, default=None,
        help="max relative score divergence the canary accepts; default "
             "= the configured --table-dtype's documented score "
             "tolerance (bf16 1e-2, int8 5e-2; float32 takes 5e-2). "
             "Widen it for intended large model changes")
    parser.add_argument(
        "--quality-poll-s", type=float, default=0.0,
        help="period of the background drift evaluator: fold the live "
             "score distribution against the active model's train-time "
             "quality-baseline.json into photon_quality_drift_score "
             "gauges, posting quality_drift_detected past "
             "--drift-threshold (0 disables; evaluation is host-side "
             "accumulator reads — never touches the score path)")
    parser.add_argument(
        "--drift-threshold", type=float, default=0.25,
        help="total-score PSI above which quality_drift_detected fires "
             "(rule of thumb: >0.25 = significant population shift)")


def quality_from_args(args) -> QualityConfig:
    return QualityConfig(canary_gate=args.canary_gate,
                         canary_bound=args.canary_bound,
                         quality_poll_s=args.quality_poll_s,
                         drift_threshold=args.drift_threshold)


# ---------------------------------------------------------------------------
# Ranked-retrieval configuration (serve_game)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RankConfig:
    """serve_game's ``/rank`` knobs.

    ``item_coordinate`` names the random-effect coordinate whose entity
    axis ``/rank`` retrieves over (None = ranking disabled — ``/rank``
    answers 400); ``max_k`` bounds the requestable k and sizes the
    power-of-two k buckets whose ranking programs are captured at warmup.
    """

    item_coordinate: Optional[str] = None
    max_k: int = 128

    def __post_init__(self):
        if self.max_k < 1:
            raise ValueError(f"max_k must be >= 1, got {self.max_k}")



def add_rank_flags(parser) -> None:
    """The serve_game ranked-retrieval flags."""
    parser.add_argument(
        "--rank-item-coordinate", default=None, metavar="COORD",
        help="enable GET /rank?user=...&k=...: the random-effect "
             "coordinate whose entity axis is the ITEM vocabulary — its "
             "dense serving table is re-packed item-major (same "
             "--table-dtype, dequantized in the ranking program) and "
             "each request batch scores every item and sorts them "
             "stably on the device. "
             "Default: ranking disabled")
    parser.add_argument(
        "--rank-max-k", type=int, default=128,
        help="largest requestable k (/rank k past it is a 400); also "
             "sizes the power-of-two k buckets whose ranking programs "
             "are captured at warmup")


def rank_from_args(args) -> RankConfig:
    return RankConfig(item_coordinate=args.rank_item_coordinate,
                      max_k=args.rank_max_k)



# ---------------------------------------------------------------------------
# Fleet-routing configuration (serve_fleet; shard flags on serve_game)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """The fleet router's knobs (``serve_fleet``), round-trippable through
    a JSON config file like :class:`ResilienceConfig`.

    ``fleet_shards`` is N — how many entity-sharded shard groups the
    router fronts; ``replicas`` is R — how many serving hosts per shard
    group (each serving the SAME ``--fleet-shard I --fleet-shard-count
    N`` view; R ≥ 2 turns a dead host into a replica retry instead of a
    503, and lets the router hedge slow legs); ``hedge_delay_ms`` fixes
    when the backup replica fires against a still-pending primary (0 =
    adaptive: the p99 of the shard's recent leg latencies);
    ``fanout_timeout_s`` bounds each per-host leg (a slower host becomes
    a typed 503 ``reason=upstream``, never a hang);
    ``request_timeout_ms`` is the router-side default deadline for
    requests carrying no ``X-Photon-Deadline-Ms`` of their own (0 =
    none), propagated to hosts as the REMAINING budget.

    ``slo_objective_ms`` arms the fleet SLO burn-rate tracker
    (``fleet/observe.py``): a routed request slower than the objective
    (or failed) spends error budget against ``slo_target``; the tracker
    ticks every ``slo_tick_s`` and posts edge-triggered
    ``slo_burn_alert`` events on the bus. 0 = no tracker.
    """

    fleet_shards: int = 2
    replicas: int = 1
    hedge_delay_ms: float = 0.0
    fanout_timeout_s: float = 30.0
    request_timeout_ms: float = 0.0
    slo_objective_ms: float = 0.0
    slo_target: float = 0.999
    slo_tick_s: float = 10.0

    def __post_init__(self):
        if self.fleet_shards < 1:
            raise ValueError(f"fleet_shards must be >= 1, "
                             f"got {self.fleet_shards}")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, "
                             f"got {self.replicas}")
        if self.hedge_delay_ms < 0:
            raise ValueError(f"hedge_delay_ms must be >= 0, "
                             f"got {self.hedge_delay_ms}")
        if self.fanout_timeout_s <= 0:
            raise ValueError(f"fanout_timeout_s must be > 0, "
                             f"got {self.fanout_timeout_s}")
        if self.slo_objective_ms < 0:
            raise ValueError(f"slo_objective_ms must be >= 0, "
                             f"got {self.slo_objective_ms}")
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError(f"slo_target must be in (0, 1), "
                             f"got {self.slo_target}")
        if self.slo_tick_s <= 0:
            raise ValueError(f"slo_tick_s must be > 0, "
                             f"got {self.slo_tick_s}")

    # --- config-file round-trip ------------------------------------------
    def as_dict(self) -> dict:
        return {"fleetShards": self.fleet_shards,
                "replicas": self.replicas,
                "hedgeDelayMs": self.hedge_delay_ms,
                "fanoutTimeoutS": self.fanout_timeout_s,
                "requestTimeoutMs": self.request_timeout_ms,
                "sloObjectiveMs": self.slo_objective_ms,
                "sloTarget": self.slo_target,
                "sloTickS": self.slo_tick_s}

    @classmethod
    def from_dict(cls, d: Mapping) -> "RouterConfig":
        return cls(fleet_shards=int(d.get("fleetShards", 2)),
                   replicas=int(d.get("replicas", 1)),
                   hedge_delay_ms=float(d.get("hedgeDelayMs", 0.0)),
                   fanout_timeout_s=float(d.get("fanoutTimeoutS", 30.0)),
                   request_timeout_ms=float(d.get("requestTimeoutMs", 0.0)),
                   slo_objective_ms=float(d.get("sloObjectiveMs", 0.0)),
                   slo_target=float(d.get("sloTarget", 0.999)),
                   slo_tick_s=float(d.get("sloTickS", 10.0)))


def add_router_flags(parser) -> None:
    """The serve_fleet routing-tier flags."""
    parser.add_argument(
        "--fleet-shards", type=int, default=2, metavar="N",
        help="how many entity-sharded serving hosts to launch behind the "
             "router: raw entity ids hash to shards via "
             "fleet/sharding.py, each host packs only its ~1/N slice of "
             "every dense coefficient table")
    parser.add_argument(
        "--replicas", type=int, default=1, metavar="R",
        help="serving hosts PER SHARD (R×N hosts total): at R >= 2 a "
             "dead host becomes a replica retry instead of a 503 "
             "reason=upstream, and slow legs are hedged (backup fired "
             "after the p99-derived hedge delay, first answer wins)")
    parser.add_argument(
        "--hedge-delay-ms", type=float, default=0.0,
        help="fixed hedge delay for slow-leg backups (0 = adaptive: the "
             "p99 of the shard's recent leg latencies; only meaningful "
             "with --replicas >= 2)")
    parser.add_argument(
        "--fanout-timeout-s", type=float, default=30.0,
        help="per-host fan-out leg timeout; a slower or dead host maps "
             "to a typed 503 (reason=upstream) instead of a hang, and a "
             "request's remaining deadline budget caps each leg below "
             "this")
    parser.add_argument(
        "--slo-objective-ms", type=float, default=0.0,
        help="latency objective arming the fleet SLO burn-rate tracker: "
             "a routed request slower than this (or failed) spends error "
             "budget; crossing a burn-rate threshold posts slo_burn_alert "
             "on the event bus. 0 = no tracker")
    parser.add_argument(
        "--slo-target", type=float, default=0.999,
        help="SLO success-rate target (the error budget is 1 - target); "
             "burn rate 1.0 spends the budget exactly at the sustainable "
             "rate")
    parser.add_argument(
        "--slo-tick-s", type=float, default=10.0,
        help="how often the burn-rate tracker closes a bucket and "
             "evaluates its alert windows")


def router_from_args(args) -> RouterConfig:
    return RouterConfig(fleet_shards=args.fleet_shards,
                        replicas=args.replicas,
                        hedge_delay_ms=args.hedge_delay_ms,
                        fanout_timeout_s=args.fanout_timeout_s,
                        request_timeout_ms=args.request_timeout_ms,
                        slo_objective_ms=args.slo_objective_ms,
                        slo_target=args.slo_target,
                        slo_tick_s=args.slo_tick_s)

