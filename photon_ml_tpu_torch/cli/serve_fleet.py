"""Fleet serving from the command line: ``python -m photon_ml_tpu_torch
serve_fleet``.

Counterpart of ``photon_ml_tpu/cli/serve_fleet.py``. Launches a local
N-host serving fleet in one process: N entity-sharded ``serve_game``
servers (each packing its 1/N slice of every random-effect table on
``--device``) behind a :class:`~photon_ml_tpu_torch.fleet.router.
FleetRouter`, which serves ``/score``, ``/rank``, ``/healthz``,
``/readyz``, ``/metrics``, ``/statusz``, ``/reload`` and ``/reshard``::

    python -m photon_ml_tpu_torch serve_fleet --model-dir run \\
        --feature-shards 'global=g|intercept,item=it|noIntercept' \\
        --fleet-shards 4 --port 8080

f32 replies equal one unsharded server's bit for bit. A production fleet
runs the same pieces across machines: one ``serve_game --fleet-shard I
--fleet-shard-count N`` per host and a router pointed at their URLs;
nothing in the protocol assumes shared memory.

In-process hosts share the process-global metrics registry and brownout
state, so their brownout controllers stay off here (a distributed fleet
keeps them: each machine degrades on its own pressure); the router's
``/metrics`` still folds every host's snapshot with host-owned gauges
fanned out per shard. ``--telemetry-dir`` writes the router's and the
hosts' spans (``fleet.*``, ``serving.*``) to one ``trace.jsonl``, and
``--telemetry-poll-s`` / ``--metrics-port`` work as in the other commands.
The retained plane (:func:`arm_router_plane`): every host keeps its own
``/history`` ring (``--history-capacity``, ``--history-period-s``); the
router keeps one more, whose snapshots carry the shard heat and the USE
gauges of its two executors, folds the hosts' rings into the fleet
timeline behind its ``/history``, and ticks the read-only hot-shard
advisor behind ``/advisor`` off each snapshot. ``--flight-dir`` arms one
black box for the fleet's process. ``--autopilot-config`` closes the
freshness loop fleet-wide: one
:class:`~photon_ml_tpu_torch.feedback.autopilot.FeedbackAutopilot` on the
shared bus joins every host's request log (``--reqlog-dir`` required),
refreshes the drifted coordinate on ``--device`` with ``--fleet-shards``
= this fleet's shard count, and publishes the per-shard patch set where
``--router-watch-dir`` finds it; a host the refresh did not touch
activates its empty patch without a capture.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from typing import Optional, Sequence

from photon_ml_tpu_torch.cli.config import (
    RetainedConfig,
    add_retained_flags,
    add_router_flags,
    add_telemetry_flags,
    install_telemetry,
    retained_from_args,
    router_from_args,
    telemetry_from_args,
)

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch serve_fleet",
        description="Serve a saved GAME model from an entity-sharded "
                    "N-host fleet behind one router (GPU)")
    p.add_argument("--model-dir", required=True,
                   help="a train_game output dir; every host loads it, "
                        "packing only its shard's entity rows")
    p.add_argument("--feature-shards", required=True,
                   help="same shard specs used at training time")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="router port; 0 = ephemeral. Hosts always bind "
                        "ephemeral ports")
    p.add_argument("--max-batch", type=int, default=1024)
    p.add_argument("--table-dtype",
                   choices=["float32", "bfloat16", "int8"],
                   default="float32",
                   help="per-host table storage dtype (serve_game "
                        "--table-dtype); int8 at N hosts is ~4N times "
                        "fewer resident bytes a host than one f32 host")
    p.add_argument("--microbatch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--max-queue", type=int, default=1024)
    p.add_argument("--request-timeout-ms", type=float, default=0.0,
                   help="router-side deadline of requests with no "
                        "X-Photon-Deadline-Ms; the remaining budget is "
                        "propagated to every fan-out leg")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every host's tables and bucket programs "
                        "live (default: the GPU; there is no fall-back "
                        "to the CPU)")
    p.add_argument("--rank-item-coordinate", default=None, metavar="COORD",
                   help="enable fleet /rank: every host indexes its item "
                        "shard, the router merges the per-shard top-k "
                        "(the item coordinate must be the only random "
                        "effect)")
    p.add_argument("--rank-max-k", type=int, default=128)
    p.add_argument("--reqlog-dir", metavar="DIR", default=None,
                   help="per-host request logs: host I writes its "
                        "segments under DIR/host-I (serve_game "
                        "--reqlog-dir)")
    p.add_argument("--reqlog-sample", type=float, default=1.0)
    p.add_argument("--reqlog-segment-records", type=int, default=256)
    p.add_argument("--quality-poll-s", type=float, default=0.0,
                   help="per-host drift evaluator period (serve_game "
                        "--quality-poll-s); in-process hosts share one "
                        "event bus, so any host's drift event reaches "
                        "the fleet autopilot")
    p.add_argument("--drift-threshold", type=float, default=0.25)
    p.add_argument("--canary-gate", action="store_true",
                   help="per-host canary gate on reload candidates; under "
                        "the router's two-phase epoch one host's refusal "
                        "aborts the activation fleet-wide")
    p.add_argument("--canary-bound", type=float, default=None)
    p.add_argument("--autopilot-config", metavar="JSON",
                   help="close the freshness loop fleet-wide: a "
                        "feedback.AutopilotConfig JSON file. One "
                        "autopilot (subscribed to the shared bus) joins "
                        "every host's request log (--reqlog-dir "
                        "required), refreshes the drifted coordinate on "
                        "--device with --fleet-shards = this fleet's "
                        "shard count, and publishes the per-shard patch "
                        "set where --router-watch-dir discovers it")
    p.add_argument("--router-watch-dir", metavar="DIR",
                   help="poll DIR on the router for published per-shard "
                        "patch sets (patch-shard-0..N-1, stamps verified) "
                        "or full model dirs, and drive each through the "
                        "two-phase fleet epoch (fleet/watcher.py)")
    p.add_argument("--router-watch-poll-s", type=float, default=10.0)
    p.add_argument("--max-connections", type=int, default=0, metavar="N",
                   help="connection budget of each serving host (0 = "
                        "unlimited; serve_game --max-connections)")
    add_retained_flags(p)
    add_router_flags(p)
    add_telemetry_flags(p)
    return p


@dataclasses.dataclass
class RouterPlane:
    """The router's retained plane (:func:`arm_router_plane`)."""

    history: object  # HistorySampler, source "router"
    saturation: object  # SaturationSampler over the two executors
    advisor: object  # HotShardAdvisor (GET /advisor)
    flight: object = None  # FlightRecorder (--flight-dir)
    watchdog: object = None  # Watchdog (--watchdog-timeout-s)

    def close(self) -> None:
        for piece in (self.watchdog, self.history, self.flight):
            if piece is not None:
                piece.close()


def arm_router_plane(router, retained: RetainedConfig) -> RouterPlane:
    """Arm ``router``'s retained plane: a history ring whose every snapshot
    carries fresh shard heat and the USE gauges of the fan-out and hedge
    executors (``pre_sample``), attached to the observer for the fleet
    timeline; the hot-shard advisor ticking off each snapshot; and, with
    ``retained.flight_dir``, the fleet's flight recorder and its stall
    watchdog. The ring ticks every ``retained.history_period_s`` (0: by
    hand, ``plane.history.sample()``)."""
    from photon_ml_tpu_torch.events import GLOBAL_BUS
    from photon_ml_tpu_torch.fleet.advisor import HotShardAdvisor
    from photon_ml_tpu_torch.telemetry.history import HistorySampler
    from photon_ml_tpu_torch.telemetry.saturation import (
        SaturationSampler,
        executor_probe,
    )
    from photon_ml_tpu_torch.telemetry.tracing import GLOBAL_TRACER

    saturation = SaturationSampler()
    saturation.add_probe("router_pool", executor_probe(router.fanout_pool))
    saturation.add_probe("hedge_pool", executor_probe(router.hedge_pool))

    def pre_sample() -> None:
        # heat first, so the snapshot's shard series and the USE gauges
        # describe the same instant
        router.observer.refresh_heat()
        saturation.sample()

    sampler = HistorySampler(capacity=retained.history_capacity,
                             source="router", pre_sample=pre_sample)
    router.observer.attach_history(sampler)
    advisor = HotShardAdvisor(history=sampler,
                              shard_map_fn=lambda: router.shard_map,
                              bus=GLOBAL_BUS)
    router.advisor = advisor
    sampler.add_listener(lambda _snap: advisor.tick())
    plane = RouterPlane(history=sampler, saturation=saturation,
                        advisor=advisor)
    if retained.flight_dir:
        from photon_ml_tpu_torch.telemetry.flightrec import (
            FlightRecorder,
            Watchdog,
        )

        # the dump's context header is the fleet's /statusz: the shard
        # map, each host's lineage, the SLO state
        plane.flight = FlightRecorder(
            retained.flight_dir, capacity=retained.flight_capacity,
            source="fleet", context_fn=router.observer.statusz,
            tracer=GLOBAL_TRACER)
        plane.flight.install(bus=GLOBAL_BUS, tracer=GLOBAL_TRACER,
                             sampler=sampler,
                             logger=logging.getLogger("photon_ml_tpu_torch"))
        if retained.watchdog_timeout_s > 0 and retained.history_period_s > 0:
            watchdog = Watchdog(plane.flight,
                                timeout_s=retained.watchdog_timeout_s)
            sampler.add_listener(lambda _snap: watchdog.pet())
            watchdog.start(retained.history_period_s)
            plane.watchdog = watchdog
    sampler.start(retained.history_period_s)
    return plane


class FleetHandle:
    """The started fleet: the router server, the N × R host servers, the
    optional loop pieces (the router-side patch watcher, the autopilot),
    the router's retained plane and the telemetry session, with one
    :meth:`stop`."""

    def __init__(self, router_server, hosts, telemetry):
        self.router_server = router_server
        self.hosts = hosts
        self.telemetry = telemetry
        self.watcher = None  # FleetPatchWatcher (--router-watch-dir)
        self.autopilot = None  # FeedbackAutopilot (--autopilot-config)
        self.history = None  # the router's HistorySampler
        self.saturation = None  # the router's SaturationSampler
        self.advisor = None  # HotShardAdvisor (GET /advisor)
        self.flight = None  # FlightRecorder (--flight-dir)
        self.watchdog = None  # flight Watchdog (--watchdog-timeout-s)

    def attach_plane(self, plane: RouterPlane) -> None:
        self.history, self.saturation = plane.history, plane.saturation
        self.advisor, self.flight = plane.advisor, plane.flight
        self.watchdog = plane.watchdog

    @property
    def url(self) -> str:
        return self.router_server.url

    @property
    def router(self):
        return self.router_server.router

    def host_urls(self) -> list:
        return [h.url for h in self.hosts]

    def serve_forever(self) -> None:
        self.router_server.serve_forever()

    def stop(self) -> None:
        # the loop first: no refresh launch or epoch against a fleet
        # tearing down
        if self.autopilot is not None:
            self.autopilot.stop()
        if self.watcher is not None:
            self.watcher.stop()
        for piece in (self.watchdog, self.history, self.flight):
            if piece is not None:
                piece.close()
        self.router_server.stop()
        for host in self.hosts:
            host.stop()
        self.telemetry.close()


def build_fleet(argv: Optional[Sequence[str]] = None) -> FleetHandle:
    """Parse flags → a started fleet (router and hosts), the router not
    yet serving forever (the programmatic entry)."""
    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    if args.autopilot_config and not args.reqlog_dir:
        raise SystemExit("--autopilot-config needs --reqlog-dir (the "
                         "autopilot joins the hosts' request logs)")
    config = router_from_args(args)
    telemetry = install_telemetry(telemetry_from_args(args))

    from photon_ml_tpu_torch.cli import serve_game
    from photon_ml_tpu_torch.fleet.router import FleetRouter, RouterServer
    from photon_ml_tpu_torch.fleet.sharding import shard_counts

    n = config.fleet_shards
    host_argv_common = [
        "--model-dir", args.model_dir,
        "--feature-shards", args.feature_shards,
        "--host", args.host, "--port", "0",
        "--max-batch", str(args.max_batch),
        "--table-dtype", args.table_dtype,
        "--microbatch", str(args.microbatch),
        "--max-wait-ms", str(args.max_wait_ms),
        "--max-queue", str(args.max_queue),
        "--max-connections", str(args.max_connections),
        "--device", args.device,
        # brownout state is process-global: N in-process hosts sharing it
        # would shed each other's work
        "--brownout-poll-s", "0",
        "--fleet-shard-count", str(n),
        # every host keeps its own /history ring (the router's timeline
        # folds them); the flight recorder stays one for the process (a
        # distributed fleet passes --flight-dir to each serve_game)
        "--history-capacity", str(args.history_capacity),
        "--history-period-s", str(args.history_period_s),
    ]
    if args.no_warmup:
        host_argv_common.append("--no-warmup")
    if args.rank_item_coordinate:
        host_argv_common += ["--rank-item-coordinate",
                             args.rank_item_coordinate,
                             "--rank-max-k", str(args.rank_max_k)]
    if args.quality_poll_s > 0:
        host_argv_common += ["--quality-poll-s", str(args.quality_poll_s),
                             "--drift-threshold",
                             str(args.drift_threshold)]
    if args.canary_gate:
        host_argv_common.append("--canary-gate")
    if args.canary_bound is not None:
        host_argv_common += ["--canary-bound", str(args.canary_bound)]
    hosts, reqlog_dirs = [], []
    try:
        # shard-major host order ([s0r0, s0r1, s1r0, ...]): every replica
        # of a group serves the same shard view of the same model
        for i in range(n):
            for _r in range(config.replicas):
                host_argv = host_argv_common + ["--fleet-shard", str(i)]
                if args.reqlog_dir:
                    # one log a host (a real fleet has one a machine)
                    reqlog_dirs.append(os.path.join(args.reqlog_dir,
                                                    f"host-{len(hosts)}"))
                    host_argv += [
                        "--reqlog-dir", reqlog_dirs[-1],
                        "--reqlog-sample", str(args.reqlog_sample),
                        "--reqlog-segment-records",
                        str(args.reqlog_segment_records)]
                hosts.append(serve_game.build_server(host_argv).start())
        router = FleetRouter(
            [h.url for h in hosts],
            replicas=config.replicas,
            hedge_delay_ms=config.hedge_delay_ms,
            fanout_timeout_s=config.fanout_timeout_s,
            default_timeout_ms=config.request_timeout_ms)
        if config.slo_objective_ms > 0:
            from photon_ml_tpu_torch.events import GLOBAL_BUS
            from photon_ml_tpu_torch.fleet.observe import SloBurnTracker

            router.observer.attach_slo(
                SloBurnTracker(GLOBAL_BUS,
                               objective_s=config.slo_objective_ms / 1e3,
                               target=config.slo_target),
                tick_s=config.slo_tick_s)
        plane = arm_router_plane(router, retained_from_args(args))
        try:
            server = RouterServer(router, host=args.host, port=args.port)
        except BaseException:
            plane.close()
            raise
    except BaseException:
        for h in hosts:
            h.stop()
        telemetry.close()
        raise
    handle = FleetHandle(server.start(), hosts, telemetry)
    handle.attach_plane(plane)
    if args.router_watch_dir:
        from photon_ml_tpu_torch.fleet.watcher import FleetPatchWatcher

        handle.watcher = FleetPatchWatcher(
            router, args.router_watch_dir,
            poll_s=args.router_watch_poll_s).start()
    if args.autopilot_config:
        from photon_ml_tpu_torch.events import GLOBAL_BUS
        from photon_ml_tpu_torch.feedback import (
            AutopilotConfig,
            FeedbackAutopilot,
        )

        # in-process hosts share GLOBAL_BUS (each registry's default bus),
        # so one subscription hears every host's drift evaluator; the
        # autopilot joins all the logs and cuts per-shard patches
        ap_config = AutopilotConfig.load(args.autopilot_config)
        if ap_config.fleet_shards == 0:
            ap_config.fleet_shards = n
        handle.autopilot = FeedbackAutopilot(
            GLOBAL_BUS, ap_config, reqlog_dirs=reqlog_dirs,
            reqlogs=[h.service.reqlog for h in hosts
                     if h.service.reqlog is not None],
            device=args.device).start()
    # startup balance check: heavy skew means constant or duplicated ids,
    # not bad luck; logged, never fatal
    all_ids = set()
    for h in hosts:
        for store in h.service.registry.active().stores.values():
            all_ids.update(store.row_of_id)
    if all_ids:
        logger.info("fleet shard balance (entities/host): %s",
                    shard_counts(sorted(all_ids), n))
    return handle


def run(argv: Optional[Sequence[str]] = None) -> dict:
    fleet = build_fleet(argv)
    if fleet.flight is not None:
        # the process-level triggers belong to the main (a signal handler
        # installs only from the main thread)
        fleet.flight.install_sigterm()
        fleet.flight.install_excepthook()
    rank_on = bool(fleet.hosts[0].service.registry.rank_coordinate)
    endpoints = ("/score" + (" /rank" if rank_on else "")
                 + " /healthz /readyz /metrics /statusz /reload /reshard"
                 + " /history /advisor")
    router = fleet.router
    print(f"serving GAME fleet ({router.n_shards} shards x "
          f"{router.replicas} replicas) on {fleet.url} ({endpoints}); "
          f"hosts: {', '.join(fleet.host_urls())}", flush=True)
    try:
        fleet.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        fleet.stop()
    return {"url": fleet.url, "hosts": fleet.host_urls()}


if __name__ == "__main__":
    run()
