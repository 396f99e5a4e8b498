"""Fleet serving: entity-sharded hosts behind one routing tier.

Counterpart of ``photon_ml_tpu/fleet/``. One serving host holds one shard
(``1/N``) of every random-effect coordinate's coefficient table on its
device (``serve_game --fleet-shard I --fleet-shard-count N``); a stdlib
HTTP router in front resolves each record's shard from its raw entity ids,
fans out over pooled per-host connections, and merges per-coordinate
margins through the same ``sum_coordinate_margins`` reduction the engine
runs, so f32 scores equal an unsharded host's bit for bit. Model rollout
and reshards are two-phase epochs: every host prepares, the router gates
once, then activates everywhere; any refusal aborts with the incumbent
serving fleet-wide.

- :mod:`~photon_ml_tpu_torch.fleet.sharding`: the one entity-id → shard
  hashing home (and :class:`~photon_ml_tpu_torch.fleet.sharding.ShardMap`);
- :mod:`~photon_ml_tpu_torch.fleet.router`: the routing tier
  (``/score``, ``/rank``, ``/reload``, ``/reshard``, ``/healthz``,
  ``/readyz``, ``/metrics``, ``/statusz``);
- :mod:`~photon_ml_tpu_torch.fleet.observe`: the ``/metrics`` fold, shard
  heat, the SLO burn tracker and ``/statusz``;
- :mod:`~photon_ml_tpu_torch.fleet.watcher`: router-side pickup of
  published per-shard patch sets;
- :mod:`~photon_ml_tpu_torch.fleet.advisor`: the hot-shard advisor
  behind the router's ``/advisor`` (its ``/history`` is the retained
  plane of ``telemetry/history.py``);
- ``python -m photon_ml_tpu_torch serve_fleet``: a router and N local
  hosts in one process.
"""

from photon_ml_tpu_torch.fleet.sharding import (  # noqa: F401
    ShardMap,
    crc_bucket,
    owns_id,
    partition_by_shard,
    shard_of_id,
    stable_hash_u32,
)
