"""GAME online serving from the command line (counterpart of
``photon_ml_tpu/cli/serve_game.py``).

Load a trained GAME model once, answer ``/score`` at low latency, hot-swap
new versions through ``/reload`` without dropping traffic::

    python -m photon_ml_tpu_torch serve_game --model-dir run \\
        --feature-shards 'global=g|intercept,item=it|noIntercept' --port 8080

The tables and the bucket graphs live on ``--device`` (the card unless
``--device cpu``; no card raises). Margins accumulate in float64 on either
device, so f32 scores equal ``score_game``'s. Flags of the reference that
the port does not run yet (fleet shards, the directory watcher, the request
log, the autopilot, the connection budget, the canary and quality monitor,
ranked retrieval, retained telemetry, telemetry) are accepted by the parser
and raise :class:`NotImplementedError` naming the flag when given away from
their default.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from photon_ml_tpu_torch.cli.config import (
    add_unported_flags,
    parse_feature_shard_config,
    refuse_unported,
)

#: the reference's flags this command does not run yet, with their argparse
#: settings and the reference defaults (which are accepted)
_UNPORTED_FLAGS = {
    "--fleet-shard": {"type": int, "default": None},
    "--fleet-shard-count": {"type": int, "default": None},
    "--watch-dir": {"default": None},
    "--watch-poll-s": {"type": float, "default": 10.0},
    "--reqlog-dir": {"default": None},
    "--reqlog-sample": {"type": float, "default": 1.0},
    "--reqlog-segment-records": {"type": int, "default": 256},
    "--reqlog-max-mb": {"type": float, "default": 64.0},
    "--autopilot-config": {"default": None},
    "--max-connections": {"type": int, "default": 0},
    "--canary-gate": {"action": "store_true"},
    "--canary-bound": {"type": float, "default": None},
    "--quality-poll-s": {"type": float, "default": 0.0},
    "--drift-threshold": {"type": float, "default": 0.25},
    "--rank-item-coordinate": {"default": None},
    "--rank-max-k": {"type": int, "default": 128},
    "--history-capacity": {"type": int, "default": 240},
    "--history-period-s": {"type": float, "default": 0.0},
    "--flight-dir": {"default": None},
    "--flight-capacity": {"type": int, "default": 512},
    "--watchdog-timeout-s": {"type": float, "default": 0.0},
    "--telemetry-dir": {"default": None},
    "--telemetry-poll-s": {"type": float, "default": 0.0},
    "--metrics-port": {"type": int, "default": 0},
}


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
    add_unported_flags(p, _UNPORTED_FLAGS)
    return p


def build_server(argv: Optional[Sequence[str]] = None):
    """Parse flags → a started-but-not-serving :class:`GameServer` (the
    programmatic entry; :func:`run` serves it forever)."""
    from photon_ml_tpu_torch.serving import (
        GameServer,
        MicroBatcher,
        ModelRegistry,
        OverloadController,
        ServingService,
    )
    from photon_ml_tpu_torch.serving.http import ConnectionTracker

    args = build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    refuse_unported(args, _UNPORTED_FLAGS)
    shard_configs = tuple(parse_feature_shard_config(s)
                          for s in args.feature_shards.split(","))
    registry = ModelRegistry(shard_configs, max_batch=args.max_batch,
                             warmup=not args.no_warmup,
                             table_dtype=args.table_dtype,
                             device=args.device)
    registry.load(args.model_dir)
    batcher = None
    if args.microbatch > 0:
        batcher = MicroBatcher(
            lambda records: registry.active().score(records),
            max_batch=args.microbatch, max_wait_ms=args.max_wait_ms,
            max_queue=args.max_queue if args.max_queue > 0 else None)
    connections = ConnectionTracker()
    overload = None
    if batcher is not None and args.brownout_poll_s > 0:
        overload = OverloadController(
            batcher, poll_s=args.brownout_poll_s,
            connections=connections).start()
    service = ServingService(registry, default_model_dir=args.model_dir,
                             batcher=batcher,
                             default_timeout_ms=args.request_timeout_ms,
                             overload=overload, connections=connections)
    return GameServer(service, host=args.host, port=args.port)


def run(argv: Optional[Sequence[str]] = None) -> dict:
    server = build_server(argv)
    version = server.service.registry.active_version
    print(f"serving GAME model version {version} on {server.url} "
          f"(/score /healthz /readyz /metrics /reload)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return {"url": server.url, "version": version}


if __name__ == "__main__":
    run()
