"""The port's elastic fleet against the JAX package's, on the CPU at a tiny
size: the versioned shard map, replica groups, deadline budgets and the
live reshard.

- ``fleet/sharding.py``'s decisions equal the JAX module's on 10,000 ids
  for N in {1, 2, 3, 4, 7}: ``shard_of_id``, the partitions and counts,
  ``ShardMap.default`` / ``with_moves`` / ``rebalanced``, ``map_hash``, the
  round trip through ``from_dict`` and ``retry_jitter_s``; ``RouterConfig``
  round-trips and refuses as the JAX one does;
- a 2-shard x 2-replica fleet of the port's hosts answers ``/score`` and
  ``/rank`` as one unsharded port host does, bit for bit; a stopped replica
  is a replica retry, not a 503; a ``fleet.replica`` fault that exhausts
  the group is a typed 503 ``reason=upstream`` whose ``Retry-After`` is
  the JAX router's; a spent deadline sheds ``reason=deadline``;
- ``/reshard`` moves exactly the reassigned buckets' rows, scores stay bit
  for bit, and an injected refusal keeps the incumbent map fleet-wide.

No test reads a wall clock."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import photon_ml_tpu.fleet.sharding as jsh
from photon_ml_tpu.cli.config import RouterConfig as JRouterConfig
from photon_ml_tpu.io.data_reader import write_training_examples
import photon_ml_tpu_torch.fleet.sharding as tsh
from photon_ml_tpu_torch.cli import serve_fleet as t_fleet
from photon_ml_tpu_torch.cli import serve_game as t_serve
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.cli.config import RouterConfig
from photon_ml_tpu_torch.resilience import FaultPlan, injected
from photon_ml_tpu_torch.telemetry.prometheus import parse_text, render
from test_fleet_elastic import COMMON, SHARDS, _records

CPU = ["--device", "cpu"]
IDS = [f"u{i}" for i in range(9_000)] + [f"song/{i}" for i in range(999)] \
    + [""]


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _refused(url, payload, headers=None):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, payload, headers=headers)
    return (err.value.code, json.loads(err.value.read()),
            err.value.headers.get("Retry-After"))


def _metric(name, labels):
    """One series of the process registry (0 when absent)."""
    for got, value in parse_text(render()).get(name, ()):
        if all(got.get(k) == v for k, v in labels.items()):
            return value
    return 0.0


# --- the sharding module ------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_sharding_decisions_equal_jax(n):
    assert len(IDS) == 10_000
    for fn in ("stable_hash_u32", "bucket_of_id"):
        assert [getattr(tsh, fn)(i) for i in IDS] == \
            [getattr(jsh, fn)(i) for i in IDS]
    assert [tsh.shard_of_id(i, n) for i in IDS] == \
        [jsh.shard_of_id(i, n) for i in IDS]
    assert [tsh.crc_bucket(i, 1 << 16) for i in IDS] == \
        [jsh.crc_bucket(i, 1 << 16) for i in IDS]
    assert tsh.partition_by_shard(IDS, n) == jsh.partition_by_shard(IDS, n)
    assert tsh.shard_counts(IDS, n) == jsh.shard_counts(IDS, n)
    vocab = {raw: k for k, raw in enumerate(IDS)}
    for shard in range(n):
        assert tsh.owns_id(IDS[shard], (shard, n)) == \
            jsh.owns_id(IDS[shard], (shard, n))
        assert tsh.shard_vocab(vocab, (shard, n)) == \
            jsh.shard_vocab(vocab, (shard, n))
    rng = np.random.default_rng(n)
    moves = {int(b): int(s) for b, s in zip(
        rng.choice(tsh.N_BUCKETS, 64, replace=False),
        rng.integers(0, n, 64))}
    maps = []
    for mod in (tsh, jsh):
        base = mod.ShardMap.default(n)
        moved = base.with_moves(moves)
        grown, shrunk = moved.rebalanced(n + 2), moved.rebalanced(
            max(1, n - 1))
        maps.append([(m.buckets, m.n_shards, m.version, m.map_hash,
                      m.as_dict()) for m in (base, moved, grown, shrunk)]
                    + [base.moved_buckets(moved), moved.moved_buckets(grown),
                       [moved.shard_of(i) for i in IDS[:2000]],
                       mod.map_shard_vocab(vocab, grown, (0, n + 2))])
        # the round trip, and the same map from the other package's dict
        other = jsh if mod is tsh else tsh
        assert mod.ShardMap.from_dict(json.loads(json.dumps(
            other.ShardMap.default(n).with_moves(moves).as_dict()))) \
            == moved
    assert maps[0] == maps[1]
    assert [tsh.retry_jitter_s(i) for i in IDS[:500]] == \
        [jsh.retry_jitter_s(i) for i in IDS[:500]]


def test_shard_map_refusals_equal_jax():
    cases = [
        lambda m: m.ShardMap(buckets=(0, 1), n_shards=2),
        lambda m: m.ShardMap(buckets=tuple([5] * m.N_BUCKETS), n_shards=2),
        lambda m: m.ShardMap.default(2).with_moves({m.N_BUCKETS: 0}),
        lambda m: m.ShardMap.default(0),
        lambda m: m.check_shard((2, 2)),
        lambda m: m.check_shard((0, 0)),
        lambda m: m.shard_of_id("u1", 0),
    ]
    for case in cases:
        errors = []
        for mod in (tsh, jsh):
            with pytest.raises(ValueError) as err:
                case(mod)
            errors.append(str(err.value))
        assert errors[0] == errors[1]
    bad = tsh.ShardMap.default(3).with_moves({1: 2}).as_dict()
    bad["buckets"][5] = (bad["buckets"][5] + 1) % 3
    for mod in (tsh, jsh):
        with pytest.raises(ValueError, match="hash mismatch"):
            mod.ShardMap.from_dict(bad)


def test_router_config_equals_jax():
    cfg = dict(fleet_shards=3, replicas=2, hedge_delay_ms=7.5,
               fanout_timeout_s=12.0, request_timeout_ms=250.0,
               slo_objective_ms=40.0, slo_target=0.99, slo_tick_s=2.0)
    a, b = RouterConfig(**cfg), JRouterConfig(**cfg)
    assert a.as_dict() == b.as_dict()
    assert RouterConfig.from_dict(json.loads(json.dumps(b.as_dict()))) == a
    for bad in (dict(replicas=0), dict(hedge_delay_ms=-1.0),
                dict(fleet_shards=0), dict(fanout_timeout_s=0.0),
                dict(slo_target=1.0), dict(slo_tick_s=0.0)):
        errors = []
        for cls in (RouterConfig, JRouterConfig):
            with pytest.raises(ValueError) as err:
                cls(**bad)
            errors.append(str(err.value))
        assert errors[0] == errors[1]


# --- the 2 x 2 fleet -----------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """One port model served by an unsharded port host and by a fleet of 2
    shards x 2 replicas, both ranking over perUser."""
    tmp = str(tmp_path_factory.mktemp("torch_fleet_elastic"))
    d0 = os.path.join(tmp, "d0.avro")
    write_training_examples(d0, _records(300, 0))
    model = os.path.join(tmp, "model")
    t_train.run(["--training-data", d0, "--output-dir", model]
                + COMMON + CPU)
    rank = ["--rank-item-coordinate", "perUser", "--rank-max-k", "8"]
    single = t_serve.build_server(
        ["--model-dir", model, "--feature-shards", SHARDS, "--port", "0",
         "--no-warmup"] + rank + CPU).start()
    fleet = t_fleet.build_fleet(
        ["--model-dir", model, "--feature-shards", SHARDS, "--port", "0",
         "--fleet-shards", "2", "--replicas", "2", "--no-warmup"]
        + rank + CPU)
    yield {"model": model, "single": single, "fleet": fleet,
           "requests": _records(40, 11, cold_users=4)}
    fleet.stop()
    single.stop()


def test_replica_fleet_scores_and_ranks_as_one_host(env):
    a = _post(env["single"].url + "/score", {"records": env["requests"]})
    b = _post(env["fleet"].url + "/score", {"records": env["requests"]})
    np.testing.assert_array_equal(np.asarray(a["scores"], np.float64),
                                  np.asarray(b["scores"], np.float64))
    assert b["lineage"] == a["lineage"] is not None
    assert b["shard_map"] == env["fleet"].router.shard_map.map_hash
    for rec in env["requests"][:4]:
        a = _post(env["single"].url + "/rank", {"record": rec, "k": 5})
        b = _post(env["fleet"].url + "/rank", {"record": rec, "k": 5})
        assert a["ids"] == b["ids"] and a["scores"] == b["scores"]


def test_healthz_reports_the_replica_topology(env):
    out = _get(env["fleet"].url + "/healthz")
    assert out["n_shards"] == 2 and out["replicas"] == 2
    assert [(h["shard"], h["replica"]) for h in out["hosts"]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [h["fleet_shard"] for h in out["hosts"]] == \
        [[0, 2], [0, 2], [1, 2], [1, 2]]
    assert out["shard_map"]["mixed"] is False
    assert out["shard_replicas_up"] == [2, 2]
    assert _get(env["fleet"].url + "/readyz")["ready"] is True


def test_a_stopped_replica_is_a_retry_and_exhaustion_a_typed_503(env):
    fleet = t_fleet.build_fleet(
        ["--model-dir", env["model"], "--feature-shards", SHARDS,
         "--port", "0", "--fleet-shards", "2", "--replicas", "2",
         "--no-warmup"] + CPU)
    try:
        before = _post(fleet.url + "/score", {"records": env["requests"]})

        def retries():
            return sum(_metric("photon_fleet_replica_retries_total",
                               {"shard": str(s)}) for s in range(2))

        r0 = retries()
        fleet.hosts[1].stop()  # shard 0, replica 1
        # request ids over both primaries: half start on the dead replica
        for i in range(8):
            out = _post(fleet.url + "/score", {"records": env["requests"]},
                        headers={"X-Photon-Request-Id": f"kill-{i}"})
            assert out["scores"] == before["scores"]
        assert retries() > r0
        ready = _get(fleet.url + "/readyz")
        assert ready["ready"] is True
        assert _get(fleet.url + "/healthz")["shard_replicas_up"] == [1, 2]
        # a request whose primary is the dead replica, for a record of its
        # shard, with the backup's launch faulted: the group is exhausted
        rid = next(r for r in (f"r{i}" for i in range(100))
                   if tsh.stable_hash_u32(f"replica:{r}") % 2 == 1)
        rec = next(r for r in env["requests"]
                   if tsh.shard_of_id(r["metadataMap"]["userId"], 2) == 0)
        plan = FaultPlan.from_json({"seed": 0, "specs": [
            {"site": "fleet.replica", "at": [0]}]})
        with injected(plan):
            status, body, retry = _refused(
                fleet.url + "/score", {"record": rec},
                headers={"X-Photon-Request-Id": rid})
        assert (status, body["reason"]) == (503, "upstream")
        assert retry == str(max(1, round(jsh.retry_jitter_s(rid))))
        out = _post(fleet.url + "/score", {"record": rec},
                    headers={"X-Photon-Request-Id": rid})
        assert len(out["scores"]) == 1
    finally:
        fleet.stop()


def test_a_spent_budget_sheds_reason_deadline(env):
    status, body, retry = _refused(
        env["fleet"].url + "/score", {"records": env["requests"][:4]},
        headers={"X-Photon-Deadline-Ms": "0"})
    assert (status, body["reason"]) == (429, "deadline") and retry
    out = _post(env["fleet"].url + "/score", {"record": env["requests"][0]},
                headers={"X-Photon-Deadline-Ms": "30000"})
    assert len(out["scores"]) == 1 and 0 < out["deadline_ms"] <= 30000


# --- live reshard ---------------------------------------------------------------

def _ids_and_donors(fleet):
    smap = fleet.router.shard_map
    ids = set()
    for h in fleet.hosts:
        for store in h.service.registry.active().stores.values():
            ids.update(store.row_of_id)
    return ids, sorted({tsh.bucket_of_id(i) for i in ids
                        if smap.shard_of(i) == 0})


def test_an_injected_refusal_keeps_the_incumbent_map(env):
    fleet = env["fleet"]
    before = _post(fleet.url + "/score", {"records": env["requests"][:8]})
    incumbent = _get(fleet.url + "/healthz")["shard_map"]
    _ids, donors = _ids_and_donors(fleet)
    plan = FaultPlan.from_json({"seed": 0, "specs": [
        {"site": "serving.reload", "at": [0]}]})
    with injected(plan):
        status, body, _ = _refused(fleet.url + "/reshard",
                                   {"moves": {str(b): 1 for b in donors[:4]}})
    assert status == 409 and "incumbent map" in body["error"]
    after_hz = _get(fleet.url + "/healthz")["shard_map"]
    assert (after_hz["hash"], after_hz["version"], after_hz["mixed"]) == \
        (incumbent["hash"], incumbent["version"], False)
    after = _post(fleet.url + "/score", {"records": env["requests"][:8]})
    assert after["scores"] == before["scores"]
    assert after["shard_map"] == incumbent["hash"]


def test_a_reshard_moves_only_the_reassigned_rows(env):
    fleet = env["fleet"]
    before = _post(fleet.url + "/score", {"records": env["requests"]})
    all_ids, donors = _ids_and_donors(fleet)
    moves = {str(b): 1 for b in donors[:4]}
    moved_buckets = {int(b) for b in moves}
    smap = fleet.router.shard_map
    moved = {i for i in all_ids if tsh.bucket_of_id(i) in moved_buckets}
    assert moved, "the moves must carry rows"
    held = [set(h.service.registry.active().stores["perUser"].row_of_id)
            for h in fleet.hosts]
    out = _post(fleet.url + "/reshard", {"moves": moves})
    assert out["previous"] == smap.map_hash
    assert out["map_version"] == smap.version + 1
    assert out["moved_buckets"] == len(moves)
    # each of the 2 replicas of each shard counts the moved rows once
    assert out["moved"] == {"moved_in": 2 * len(moved),
                            "moved_out": 2 * len(moved),
                            "retained": 2 * (len(all_ids) - len(moved))}
    for h, was in zip(fleet.hosts, held):
        now = set(h.service.registry.active().stores["perUser"].row_of_id)
        assert now ^ was == moved  # in or out: the moved rows alone
    hz = _get(fleet.url + "/healthz")["shard_map"]
    assert hz["hash"] == out["shard_map"] and hz["mixed"] is False
    after = _post(fleet.url + "/score", {"records": env["requests"]})
    assert after["scores"] == before["scores"]
    assert after["shard_map"] == out["shard_map"]
    single = _post(env["single"].url + "/score", {"records": env["requests"]})
    np.testing.assert_array_equal(np.asarray(single["scores"], np.float64),
                                  np.asarray(after["scores"], np.float64))


def test_bad_moves_are_a_400_not_an_epoch(env):
    aborted = _metric("photon_fleet_shardmap_epochs_total",
                      {"outcome": "aborted"})
    for payload in ({}, {"moves": {}}, {"moves": {"no-such-bucket": 1}},
                    {"moves": {"70000": 1}}):
        status, _body, _ = _refused(env["fleet"].url + "/reshard", payload)
        assert status == 400
    assert _metric("photon_fleet_shardmap_epochs_total",
                   {"outcome": "aborted"}) == aborted
