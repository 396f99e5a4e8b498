"""GAME online serving from the command line (counterpart of
``photon_ml_tpu/cli/serve_game.py``).

Load a trained GAME model once, answer ``/score`` at low latency, hot-swap
new versions through ``/reload`` without dropping traffic::

    python -m photon_ml_tpu_torch serve_game --model-dir run \\
        --feature-shards 'global=g|intercept,item=it|noIntercept' --port 8080

The tables and the bucket graphs live on ``--device`` (the card unless
``--device cpu``; no card raises). Margins accumulate in float64 on either
device, so f32 scores equal ``score_game``'s. ``--watch-dir`` applies the
full models and coefficient patches published into a directory,
``--reqlog-dir`` logs every served request to Avro segments, and
``--max-connections`` refuses connections past a budget with a typed 503.
``--rank-item-coordinate`` (with ``--rank-max-k``) serves ``/rank``
through a rank micro-batcher; ``--canary-gate`` (``--canary-bound``)
refuses a candidate whose shadow scores over recent requests diverge from
the incumbent's; ``--quality-poll-s`` runs the drift evaluator against the
active version's ``quality-baseline.json``, posting
``quality_drift_detected`` past ``--drift-threshold``. ``--fleet-shard I
--fleet-shard-count N`` serves shard I of an entity-sharded fleet: the
tables hold only the ids the shard owns, and per-host patches of other
shards are refused (``serve_fleet`` puts a router in front).
``--telemetry-dir`` writes the ``serving.*`` request spans to
``trace.jsonl`` and ``metrics.prom`` at exit, ``--telemetry-poll-s``
samples host and device memory (``GET /metrics`` is always live).
The retained plane is always armed: a history ring of
``--history-capacity`` snapshots behind ``GET /history`` (ticked every
``--history-period-s``; 0 ticks only by hand), each carrying the USE
gauges of the host's resources (``telemetry/saturation.py``).
``--flight-dir`` adds the black box (the last ``--flight-capacity``
records, dumped to ``flight-<ts>.jsonl`` on a fault-site trip, an
unhandled exception, SIGTERM or a stall of ``--watchdog-timeout-s``).
``--autopilot-config`` closes the freshness loop in-process
(:class:`~photon_ml_tpu_torch.feedback.autopilot.FeedbackAutopilot`, on
the registry's bus): on ``quality_drift_detected`` it joins this server's
request log (``--reqlog-dir`` required) to the configured labels, runs
``refresh_game`` for the drifted coordinate on this server's
``--device``, and publishes the run where ``--watch-dir`` finds it.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.cli.config import (
    add_quality_flags,
    add_rank_flags,
    add_retained_flags,
    add_telemetry_flags,
    install_telemetry,
    parse_feature_shard_config,
    quality_from_args,
    rank_from_args,
    retained_from_args,
    telemetry_from_args,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch serve_game",
        description="Serve a saved GAME model over HTTP (GPU)")
    p.add_argument("--model-dir", required=True,
                   help="a train_game output dir (containing best/ or a "
                        "model-metadata.json directly); also the default "
                        "for /reload")
    p.add_argument("--feature-shards", required=True,
                   help="same shard specs used at training time")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 = ephemeral")
    p.add_argument("--max-batch", type=int, default=1024,
                   help="largest padded batch bucket; bigger requests are "
                        "chunked")
    p.add_argument("--table-dtype",
                   choices=["float32", "bfloat16", "int8"],
                   default="float32",
                   help="storage dtype of the dense per-entity coefficient "
                        "tables: bfloat16 halves and int8 (per-row scales) "
                        "quarters the resident bytes, at ~1e-2 and ~5e-2 "
                        "relative score error; float32 keeps batch "
                        "bit-parity")
    p.add_argument("--microbatch", type=int, default=64,
                   help="microbatcher max coalesced batch; 0 disables the "
                        "batcher (single requests hit the engine directly)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="microbatcher linger after the first queued request")
    p.add_argument("--max-queue", type=int, default=1024,
                   help="admission-control bound on the microbatcher "
                        "queue: a submit against a full queue is shed with "
                        "a typed 429 + Retry-After; 0 = unbounded")
    p.add_argument("--request-timeout-ms", type=float, default=0.0,
                   help="server-side deadline for requests that carry no "
                        "X-Photon-Deadline-Ms header; an expired request "
                        "is shed (429, reason=deadline) before it reaches "
                        "the engine. 0 = none")
    p.add_argument("--brownout-poll-s", type=float, default=1.0,
                   help="poll interval of the brownout controller watching "
                        "queue pressure; 0 disables it")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip capturing the bucket graphs at startup (the "
                        "first request of each size then captures)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tables and bucket programs live "
                        "(default: the GPU; there is no fall-back to the "
                        "CPU)")
    p.add_argument("--fleet-shard", type=int, default=None, metavar="I",
                   help="serve fleet shard I of --fleet-shard-count N: "
                        "the tables pack only the raw ids this shard owns "
                        "(fleet/sharding.py), ~1/N of the device bytes, "
                        "and per-host patches of other shards are "
                        "refused; put a serve_fleet router in front. "
                        "Default: unsharded")
    p.add_argument("--fleet-shard-count", type=int, default=None,
                   metavar="N",
                   help="the fleet's shard count (required with "
                        "--fleet-shard)")
    p.add_argument("--watch-dir", metavar="DIR",
                   help="poll DIR for new model versions (full "
                        "train_game / refresh_game output dirs or "
                        "coefficient-patch dirs) and apply each through "
                        "the validate-then-activate path, in sorted name "
                        "order; a rejected candidate leaves the active "
                        "version serving")
    p.add_argument("--watch-poll-s", type=float, default=10.0,
                   help="poll interval of --watch-dir (seconds)")
    p.add_argument("--reqlog-dir", metavar="DIR",
                   help="log sampled requests to rotated Avro segments "
                        "under DIR (request id, records, scores, the "
                        "version and lineage that served them, stage "
                        "timings), written off the request path. Default: "
                        "no request log")
    p.add_argument("--reqlog-sample", type=float, default=1.0,
                   help="request-log sampling rate in [0, 1], decided "
                        "per request id (1.0 logs every request the "
                        "budget allows)")
    p.add_argument("--reqlog-segment-records", type=int, default=256,
                   help="requests per request-log segment file")
    p.add_argument("--reqlog-max-mb", type=float, default=64.0,
                   help="on-disk request-log budget; the oldest segments "
                        "rotate out past it")
    p.add_argument("--max-connections", type=int, default=0, metavar="N",
                   help="connection budget (0 = unlimited): a connection "
                        "past it gets one typed 503 reason=connections "
                        "with Connection: close, counted in "
                        "photon_connections_refused_total and shown by "
                        "/readyz as connections_exhausted")
    p.add_argument("--autopilot-config", metavar="JSON",
                   help="close the freshness loop in-process: a "
                        "feedback.AutopilotConfig JSON file (prior_dir, "
                        "publish_dir, labels, the training-time specs, "
                        "debounce/min-interval guards). On "
                        "quality_drift_detected the autopilot joins this "
                        "host's request log (--reqlog-dir required) to "
                        "the labels, refreshes ONLY the drifted "
                        "coordinate on --device, and publishes into "
                        "publish_dir — point --watch-dir there and the "
                        "loop closes")
    add_quality_flags(p)
    add_rank_flags(p)
    add_retained_flags(p)
    add_telemetry_flags(p)
    return p


def build_server(argv: Optional[Sequence[str]] = None):
    """Parse flags → a started-but-not-serving :class:`GameServer` (the
    programmatic entry; :func:`run` serves it forever). The server's
    ``telemetry`` session is the caller's to close after ``stop()``."""
    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    if args.autopilot_config and not args.reqlog_dir:
        raise SystemExit("--autopilot-config needs --reqlog-dir "
                         "(the autopilot joins the request log)")
    if args.max_connections < 0:
        raise ValueError(f"max_connections must be >= 0, got "
                         f"{args.max_connections}")
    # /metrics is always live (the registry is process-global); the session
    # adds the trace file and the memory sampler when the flags ask
    from photon_ml_tpu_torch.telemetry import emit_build_info

    telemetry = install_telemetry(telemetry_from_args(args))
    emit_build_info()
    try:
        server = _build(args)
    except BaseException:
        telemetry.close()
        raise
    server.telemetry = telemetry
    return server


def _build(args):
    """The server of parsed ``args``: registry (the model loaded), batchers,
    service, watcher and drift evaluator."""
    from photon_ml_tpu_torch.serving import (
        GameServer,
        MicroBatcher,
        ModelRegistry,
        OverloadController,
        ServingService,
    )
    from photon_ml_tpu_torch.serving.http import ConnectionTracker
    from photon_ml_tpu_torch.serving.reqlog import RequestLog
    from photon_ml_tpu_torch.serving.watcher import ModelDirectoryWatcher

    quality = quality_from_args(args)
    rank = rank_from_args(args)
    shard_configs = tuple(parse_feature_shard_config(s)
                          for s in args.feature_shards.split(","))
    fleet_shard = None
    if args.fleet_shard is not None or args.fleet_shard_count is not None:
        if args.fleet_shard is None or args.fleet_shard_count is None:
            raise SystemExit("--fleet-shard and --fleet-shard-count go "
                             "together (I of N)")
        fleet_shard = (args.fleet_shard, args.fleet_shard_count)
    registry = ModelRegistry(shard_configs, max_batch=args.max_batch,
                             warmup=not args.no_warmup,
                             table_dtype=args.table_dtype,
                             device=args.device,
                             canary=quality.canary(),
                             rank_coordinate=rank.item_coordinate,
                             rank_max_k=rank.max_k,
                             fleet_shard=fleet_shard)
    registry.load(args.model_dir)
    batcher = None
    if args.microbatch > 0:
        batcher = MicroBatcher(
            lambda records: registry.active().score(records),
            max_batch=args.microbatch, max_wait_ms=args.max_wait_ms,
            max_queue=args.max_queue if args.max_queue > 0 else None)
    rank_batcher = None
    if rank.item_coordinate and args.microbatch > 0:
        def rank_fn(entries):
            # entries are opaque (record, k) pairs; the results ride a 1-D
            # object array, the batcher's shape contract
            results = registry.active().rank([r for r, _ in entries],
                                             [k for _, k in entries])
            out = np.empty(len(results), dtype=object)
            for i, res in enumerate(results):
                out[i] = res
            return out

        rank_batcher = MicroBatcher(
            rank_fn, coerce=lambda v: v, max_batch=8,
            max_wait_ms=args.max_wait_ms,
            max_queue=args.max_queue if args.max_queue > 0 else None)
    connections = ConnectionTracker(max_connections=args.max_connections)
    overload = None
    if batcher is not None and args.brownout_poll_s > 0:
        overload = OverloadController(
            batcher, poll_s=args.brownout_poll_s,
            connections=connections).start()
    reqlog = None
    if args.reqlog_dir:
        reqlog = RequestLog(
            args.reqlog_dir, sample_rate=args.reqlog_sample,
            segment_records=args.reqlog_segment_records,
            max_bytes=int(args.reqlog_max_mb * (1 << 20)))
    service = ServingService(registry, default_model_dir=args.model_dir,
                             batcher=batcher, rank_batcher=rank_batcher,
                             default_timeout_ms=args.request_timeout_ms,
                             overload=overload, connections=connections,
                             reqlog=reqlog)
    watcher = None
    if args.watch_dir:
        watcher = ModelDirectoryWatcher(registry, args.watch_dir,
                                        poll_s=args.watch_poll_s)
    drift = None
    if quality.quality_poll_s > 0:
        # live score distribution vs the active version's train-time
        # baseline, on a background thread (host accumulators only)
        from photon_ml_tpu_torch.quality import DriftEvaluator

        drift = DriftEvaluator(registry, threshold=quality.drift_threshold,
                               poll_s=quality.quality_poll_s)
    autopilot = None
    if args.autopilot_config:
        from photon_ml_tpu_torch.feedback import (
            AutopilotConfig,
            FeedbackAutopilot,
        )

        autopilot = FeedbackAutopilot(
            registry.bus, AutopilotConfig.load(args.autopilot_config),
            reqlog_dirs=[args.reqlog_dir], reqlogs=[reqlog],
            device=args.device)
    server = GameServer(service, host=args.host, port=args.port,
                        watcher=watcher, drift_evaluator=drift,
                        autopilot=autopilot)
    try:
        _arm_retained(args, server, connections, reqlog)
    except BaseException:
        server.stop()
        raise
    return server


def _arm_retained(args, server, connections, reqlog) -> None:
    """The retained plane on ``server``: the USE probes of the host's
    resources (sampled as the history ring's ``pre_sample``, so every
    snapshot carries them), the always-armed ring behind ``/history``,
    and with ``--flight-dir`` the flight recorder and its stall
    watchdog. The probes are built here: telemetry imports no serving
    module."""
    import logging

    from photon_ml_tpu_torch.events import GLOBAL_BUS
    from photon_ml_tpu_torch.serving import overload as serving_overload
    from photon_ml_tpu_torch.telemetry.history import HistorySampler
    from photon_ml_tpu_torch.telemetry.saturation import (
        SaturationSampler,
        busy_probe,
        device_busy_seconds,
        executor_probe,
        queue_probe,
    )
    from photon_ml_tpu_torch.telemetry.tracing import GLOBAL_TRACER

    retained = retained_from_args(args)
    service = server.service
    batcher, rank_batcher = service.batcher, service.rank_batcher
    saturation = SaturationSampler()
    saturation.add_probe("device", busy_probe(device_busy_seconds))
    if batcher is not None:
        saturation.add_probe("batcher_queue", queue_probe(
            batcher.queue_depth, lambda: batcher.max_queue,
            lambda: serving_overload.shed_counts()["queue_full"]))
    if rank_batcher is not None:
        saturation.add_probe("rank_batcher_queue", queue_probe(
            rank_batcher.queue_depth, lambda: rank_batcher.max_queue))

    def connections_probe() -> dict:
        stats = connections.stats()
        return {"utilization": connections.utilization(),
                "saturation": float(stats["open"]),
                "errors": float(stats["refused"])}

    def handler_threads_probe() -> dict:
        # the threading server spawns a thread a connection (no fixed
        # pool): active request threads against the connection budget
        stats = connections.stats()
        budget = connections.max_connections
        return {"utilization": (stats["active"] / budget if budget
                                else 0.0),
                "saturation": float(stats["active"])}

    saturation.add_probe("http_connections", connections_probe)
    saturation.add_probe("handler_threads", handler_threads_probe)
    if reqlog is not None:
        def reqlog_probe() -> dict:
            stats = reqlog.stats()
            return {"utilization": (min(1.0, stats["bytes"]
                                        / reqlog.max_bytes)
                                    if reqlog.max_bytes else 0.0),
                    "saturation": float(stats["buffered"]),
                    "errors": float(stats["dropped"])}

        saturation.add_probe("reqlog", reqlog_probe)
        saturation.add_probe("saver_pool", executor_probe(reqlog.writer))
    sampler = HistorySampler(capacity=retained.history_capacity,
                             source="host", pre_sample=saturation.sample)
    server.saturation = saturation
    service.history = server.history = sampler
    if retained.flight_dir:
        from photon_ml_tpu_torch.telemetry.flightrec import (
            FlightRecorder,
            Watchdog,
        )

        # the dump's context header is the host's live /healthz (active
        # version and lineage, captures): what the postmortem
        # reconstructs the final epoch from
        recorder = FlightRecorder(
            retained.flight_dir, capacity=retained.flight_capacity,
            source="host", context_fn=service.healthz,
            tracer=GLOBAL_TRACER)
        recorder.install(bus=GLOBAL_BUS, tracer=GLOBAL_TRACER,
                         sampler=sampler,
                         logger=logging.getLogger("photon_ml_tpu_torch"))
        server.flight = recorder
        if retained.watchdog_timeout_s > 0 and retained.history_period_s > 0:
            watchdog = Watchdog(recorder,
                                timeout_s=retained.watchdog_timeout_s)
            sampler.add_listener(lambda _snap: watchdog.pet())
            watchdog.start(retained.history_period_s)
            server.watchdog = watchdog
    sampler.start(retained.history_period_s)


def run(argv: Optional[Sequence[str]] = None) -> dict:
    server = build_server(argv)
    if server.flight is not None:
        # the process-level triggers belong to the main: a signal handler
        # installs only from the main thread, and build_server may run
        # anywhere
        server.flight.install_sigterm()
        server.flight.install_excepthook()
    version = server.service.registry.active_version
    rank_on = server.service.registry.rank_coordinate is not None
    endpoints = ("/score" + (" /rank" if rank_on else "")
                 + " /healthz /readyz /metrics /reload /history")
    print(f"serving GAME model version {version} on {server.url} "
          f"({endpoints})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        server.telemetry.close()
    return {"url": server.url, "version": version}


if __name__ == "__main__":
    run()
