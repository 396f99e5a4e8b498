"""The port's entity-sharded serving fleet against the JAX package's, on the
CPU at a tiny size (N = 2 shards, 400 training records).

The models are the port's own ``train_game`` runs on ``tests/test_fleet.py``'s
data: a ``global`` + ``perUser`` + ``perSong`` model (records whose user and
song hash to different shards take the router's margin merge) and a
``global`` + ``perUser`` model refreshed with ``refresh_game --fleet-shards
2`` after one user's rows change. The contracts:

- the router's f32 ``/score`` and ``/rank`` replies equal one unsharded port
  host's bit for bit, cross-shard records included (single host ≡ JAX is
  held by ``tests/test_torch_serving.py``); a JAX router fronting the same
  port hosts answers the same scores, and its ``/healthz``, ``/readyz`` and
  ``/statusz`` have the port router's keys;
- the shard tables equal the JAX package's sharded store bit for bit in
  f32, bf16 and int8, and the hosts' row sets are disjoint with the
  unsharded table as their union;
- two-phase ``/reload``: one refusal, or one host unreachable during
  prepare, aborts fleet-wide with the incumbent serving;
- per-host patches: the port's ``partition_patch_by_shard`` and patch
  metadata equal the JAX package's, a JAX-written ``patch-shard-I`` loads on
  a port host and a port-written one on a JAX host, a host refuses a
  foreign shard's patch and an unsharded host any, and the host whose
  shard the refresh did not touch activates with zero program builds;
- ``aggregate_text`` equals the JAX fold byte for byte on the same texts.

On the card the same path runs in ``chip_smoke.py`` phase 16."""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.config import parse_feature_shard_config as j_shard
from photon_ml_tpu.continuous.refresh import (
    partition_patch_by_shard as j_partition,
)
from photon_ml_tpu.fleet.router import FleetRouter as JRouter
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.io.index import IndexMap as JIndexMap
from photon_ml_tpu.io.model_io import game_model_entity_vocabs as j_vocabs
from photon_ml_tpu.io.model_io import load_game_model as j_load_model
from photon_ml_tpu.io.pipeline import save_model_patch_atomic as j_save_patch
from photon_ml_tpu.serving import ModelRegistry as JRegistry
from photon_ml_tpu.telemetry.aggregate import aggregate_text as j_aggregate
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.cli import refresh_game as t_refresh
from photon_ml_tpu_torch.cli import serve_fleet as t_fleet
from photon_ml_tpu_torch.cli import serve_game as t_serve
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.continuous.refresh import partition_patch_by_shard
from photon_ml_tpu_torch.fleet.observe import fold_fleet_snapshots
from photon_ml_tpu_torch.fleet.sharding import shard_of_id
from photon_ml_tpu_torch.io.avro import iter_avro_file
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.io.model_io import decode_game_model
from photon_ml_tpu_torch.resilience import FaultPlan, injected
from photon_ml_tpu_torch.serving import ModelRegistry
from photon_ml_tpu_torch.telemetry.aggregate import aggregate_text
from photon_ml_tpu_torch.telemetry.prometheus import render
from test_fleet import COMMON, COMMON2, N_SONGS, N_USERS, SHARDS, SHARDS2
from test_fleet import _records

CPU = ["--device", "cpu"]
DTYPES = ("float32", "bfloat16", "int8")
#: the one user whose rows change before the refresh
MUTATED_USER = 1


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
    """(status, body, Retry-After) of a request the server refuses."""
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, payload, headers=headers)
    return (err.value.code, json.loads(err.value.read()),
            err.value.headers.get("Retry-After"))


def _bits(table):
    t = table.cpu() if isinstance(table, torch.Tensor) else table
    if isinstance(t, torch.Tensor):
        return t.view({torch.float32: torch.int32,
                       torch.bfloat16: torch.int16,
                       torch.int8: torch.int8}[t.dtype]).numpy()
    a = np.asarray(t)
    return a.view({4: np.int32, 2: np.int16, 1: np.int8}[a.dtype.itemsize])


def _rows(store, ids):
    """Each raw id's stored row bits and scale bits."""
    rows = store.rows_for(ids)
    scales = None
    if store.scales is not None:
        s = store.scales
        s = s.cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s)
        scales = s[rows].view(np.int32)
    return _bits(store.table)[rows], scales


# --- the two-random-effect fleet -------------------------------------------

@pytest.fixture(scope="module")
def env2(tmp_path_factory):
    """A global + perUser + perSong model served by one unsharded port host
    and by a port fleet of 2 shards (ranking on perSong, which the
    user-side perUser makes the router refuse)."""
    tmp = str(tmp_path_factory.mktemp("torch_fleet2"))
    d0 = os.path.join(tmp, "d0.avro")
    write_training_examples(d0, _records(400, 0, songs=True))
    model = os.path.join(tmp, "model")
    t_train.run(["--training-data", d0, "--output-dir", model]
                + COMMON2 + CPU)
    single = t_serve.build_server(
        ["--model-dir", model, "--feature-shards", SHARDS2, "--port", "0",
         "--no-warmup"] + CPU).start()
    fleet = t_fleet.build_fleet(
        ["--model-dir", model, "--feature-shards", SHARDS2, "--port", "0",
         "--fleet-shards", "2", "--no-warmup",
         "--rank-item-coordinate", "perSong", "--rank-max-k", "8"] + CPU)
    requests = _records(48, 11, cold_users=4, songs=True)
    yield {"model": model, "single": single, "fleet": fleet,
           "requests": requests}
    fleet.stop()
    single.stop()


def test_router_scores_equal_one_host_bit_for_bit(env2):
    spanning = [r for r in env2["requests"]
                if shard_of_id(r["metadataMap"]["userId"], 2)
                != shard_of_id(r["metadataMap"]["songId"], 2)]
    assert spanning, "the workload must cross shards"
    a = _post(env2["single"].url + "/score", {"records": env2["requests"]})
    b = _post(env2["fleet"].url + "/score", {"records": env2["requests"]})
    assert b["fanout"]["merged"] == len(spanning)
    np.testing.assert_array_equal(np.asarray(a["scores"], np.float64),
                                  np.asarray(b["scores"], np.float64))
    assert b["lineage"] == a["lineage"] is not None
    assert b["shard_map"] == env2["fleet"].router.shard_map.map_hash
    # one record at a time, cold users among them
    for rec in env2["requests"][:3] + env2["requests"][-3:]:
        assert (_post(env2["single"].url + "/score", {"record": rec})
                ["scores"] == _post(env2["fleet"].url + "/score",
                                    {"record": rec})["scores"])


def test_margins_reply_reproduces_the_host_totals(env2):
    from photon_ml_tpu_torch.game.model import sum_coordinate_margins

    host = env2["fleet"].hosts[0]
    out = _post(host.url + "/score",
                {"records": env2["requests"][:16], "margins": True})
    totals = sum_coordinate_margins(
        np.asarray(out["offsets"], np.float32),
        [np.asarray(v, np.float32) for _cid, v in out["margins"]])
    np.testing.assert_array_equal(totals,
                                  np.asarray(out["scores"], np.float32))
    assert out["shard_map"] == host.service.registry.shard_map_hash


def test_a_jax_router_over_port_hosts_agrees(env2):
    """The JAX router fronting the port's hosts: the same f32 scores as the
    port router, and the same keys in /healthz, /readyz and /statusz."""
    fleet = env2["fleet"]
    j = JRouter(fleet.host_urls())
    try:
        got = j.score({"records": env2["requests"]})
        want = _post(fleet.url + "/score", {"records": env2["requests"]})
        assert got["scores"] == want["scores"]
        assert got["fanout"] == want["fanout"]
        for name in ("healthz", "statusz"):
            a, b = getattr(j, name)(), _get(f"{fleet.url}/{name}")
            assert sorted(a) == sorted(b), name
            assert [sorted(h) for h in a["hosts"]] == \
                [sorted(h) for h in b["hosts"]], name
        assert sorted(j.readyz()[1]) == sorted(_get(fleet.url + "/readyz"))
    finally:
        j.close()


def test_rank_with_user_coordinates_is_refused(env2):
    status, body, _ = _refused(env2["fleet"].url + "/rank",
                               {"user": "u1", "k": 3})
    assert status == 400
    assert ("fleet ranking requires the item coordinate to be the only "
            "random effect") in body["error"]
    assert "perUser" in body["error"]


def test_hosts_hold_disjoint_rows_whose_union_is_the_table(env2):
    single = env2["single"].service.registry.active().stores
    hosts = [h.service.registry.active().stores for h in env2["fleet"].hosts]
    for cid, n in (("perUser", N_USERS), ("perSong", N_SONGS)):
        ids = [set(h[cid].row_of_id) for h in hosts]
        assert not ids[0] & ids[1]
        assert ids[0] | ids[1] == set(single[cid].row_of_id)
        assert len(ids[0] | ids[1]) == n
        for i, h in enumerate(hosts):
            assert h[cid].shard == (i, 2)
            raws = sorted(ids[i])
            np.testing.assert_array_equal(_rows(h[cid], raws)[0],
                                          _rows(single[cid], raws)[0])
        assert (hosts[0][cid].table.shape[0] + hosts[1][cid].table.shape[0]
                == single[cid].table.shape[0] + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_shard_tables_equal_the_jax_sharded_store(env2, dtype):
    """Both registries load the port's model dir as shard i of 2: each
    coordinate's rows, by raw id, and scales are bit-equal."""
    configs = tuple(parse_feature_shard_config(s) for s in SHARDS2.split(","))
    j_configs = tuple(j_shard(s) for s in SHARDS2.split(","))
    for i in range(2):
        port = ModelRegistry(configs, device="cpu", table_dtype=dtype,
                             fleet_shard=(i, 2))
        jax_ = JRegistry(j_configs, table_dtype=dtype, fleet_shard=(i, 2))
        a = port.load(env2["model"]).stores
        b = jax_.load(env2["model"]).stores
        for cid in ("perUser", "perSong"):
            assert set(a[cid].row_of_id) == set(b[cid].row_of_id)
            raws = sorted(a[cid].row_of_id) + ["foreign-or-unseen"]
            ra, sa = _rows(a[cid], raws)
            rb, sb = _rows(b[cid], raws)
            np.testing.assert_array_equal(ra, rb)
            if sa is None or sb is None:
                assert sa is None and sb is None
            else:
                np.testing.assert_array_equal(sa, sb)
        assert port.shard_map_hash == jax_.shard_map_hash


def test_metrics_fold_equals_the_jax_fold(env2):
    router = env2["fleet"].router
    snapshots = router.observer.scrape()
    assert [(s, r) for s, r, _ in snapshots] == [(0, 0), (1, 0)]
    texts = [render()] + [t for _s, _r, t in snapshots]
    assert aggregate_text(texts) == j_aggregate(texts)
    folded = fold_fleet_snapshots(texts[0], snapshots)
    assert 'shard="1"' in folded
    text = urllib.request.urlopen(env2["fleet"].url + "/metrics",
                                  timeout=60).read().decode()
    assert "photon_fleet_requests_total" in text


def test_unported_router_paths_answer_501(env2):
    # both paths are ported (tests/test_torch_retained.py holds them to the
    # JAX router): serve_fleet arms the ring and the advisor, so they answer
    # 200, and an unknown series is a 400
    fleet = env2["fleet"]
    for host in fleet.hosts:  # the hosts' rings first, then the router's
        host.history.sample()
    fleet.history.sample()
    body = _get(fleet.url + "/history?series=requests")
    assert body["source"] == "fleet" and body["series"] == ["requests"]
    assert len(body["snapshots"]) >= 1
    status = _get(fleet.url + "/advisor")
    assert status["hot"] == [] and status["recommendation"] is None
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(fleet.url + "/history?series=nope")
    assert err.value.code == 400


def test_request_id_deadline_and_typed_sheds(env2):
    url, rec = env2["fleet"].url, env2["requests"][0]
    req = urllib.request.Request(
        url + "/score", data=json.dumps({"record": rec}).encode(),
        headers={"Content-Type": "application/json",
                 "X-Photon-Request-Id": "fleet-rid-1",
                 "X-Photon-Deadline-Ms": "30000"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
        assert resp.headers["X-Photon-Request-Id"] == "fleet-rid-1"
    assert body["request_id"] == "fleet-rid-1"
    assert 0 < body["deadline_ms"] <= 30000
    status, body, _ = _refused(url + "/score", {"record": rec},
                               headers={"X-Photon-Deadline-Ms": "0"})
    assert (status, body["reason"]) == (429, "deadline")
    # a host the router cannot reach (an injected fleet.fanout fault): a
    # typed 503 with a Retry-After, and the next request serves
    plan = FaultPlan.from_json({"seed": 0, "specs": [
        {"site": "fleet.fanout", "at": [0]}]})
    with injected(plan):
        status, body, retry = _refused(url + "/score", {"record": rec})
    assert (status, body["reason"]) == (503, "upstream") and retry
    assert len(_post(url + "/score", {"record": rec})["scores"]) == 1
    # a leg stamped with a map the host does not serve
    status, body, _ = _refused(
        env2["fleet"].hosts[0].url + "/score", {"record": rec},
        headers={"X-Photon-Shard-Map": "sm9-00000000"})
    assert (status, body["reason"]) == (503, "shard_map_mismatch")


def _versions(fleet):
    return [_get(u + "/healthz")["version"] for u in fleet.host_urls()]


def test_two_phase_reload_moves_the_whole_fleet(env2):
    fleet = env2["fleet"]
    before = _post(fleet.url + "/score", {"records": env2["requests"][:8]})
    v0 = _versions(fleet)
    out = _post(fleet.url + "/reload", {"model_dir": env2["model"]})
    assert out["versions"] == [v + 1 for v in v0]
    assert out["lineage"] == before["lineage"]
    after = _post(fleet.url + "/score", {"records": env2["requests"][:8]})
    assert after["scores"] == before["scores"]


@pytest.mark.parametrize("site", ["serving.reload", "fleet.fanout"],
                         ids=["host-refuses", "host-unreachable"])
def test_one_refusal_aborts_the_epoch_fleet_wide(env2, site):
    fleet = env2["fleet"]
    before = _post(fleet.url + "/score", {"records": env2["requests"][:8]})
    v0 = _versions(fleet)
    plan = FaultPlan.from_json({"seed": 0, "specs": [
        {"site": site, "at": [0]}]})
    with injected(plan):
        status, body, _ = _refused(fleet.url + "/reload",
                                   {"model_dir": env2["model"]})
    assert status == 409 and "incumbent keeps serving" in body["error"]
    assert _versions(fleet) == v0
    after = _post(fleet.url + "/score", {"records": env2["requests"][:8]})
    assert after["scores"] == before["scores"]
    assert after["lineage"] == before["lineage"]


#: the telemetry plane's flags, ported since the fleet took them
_TELEMETRY_FLAGS = ("--metrics-port", "--telemetry-dir", "--telemetry-poll-s")
#: the retained plane's flags, with the RetainedConfig field each sets
_RETAINED_FLAGS = {
    "--flight-capacity": "flight_capacity",
    "--flight-dir": "flight_dir",
    "--history-capacity": "history_capacity",
    "--history-period-s": "history_period_s",
    "--watchdog-timeout-s": "watchdog_timeout_s",
}


#: the closed loop's flag, ported since the autopilot took it
_AUTOPILOT_FLAGS = ("--autopilot-config",)


@pytest.mark.parametrize("flag", sorted(list(_AUTOPILOT_FLAGS)
                                        + list(_TELEMETRY_FLAGS)
                                        + list(_RETAINED_FLAGS)))
def test_unported_fleet_flag_names_itself(flag):
    if flag in _RETAINED_FLAGS:
        # ported (tests/test_torch_retained.py runs the plane): they parse
        # into the retained-telemetry configuration
        from photon_ml_tpu_torch.cli.config import retained_from_args

        value = "x" if flag == "--flight-dir" else "3"
        config = retained_from_args(t_fleet.build_parser().parse_args(
            ["--model-dir", "m", "--feature-shards", SHARDS, flag, value]))
        got = getattr(config, _RETAINED_FLAGS[flag])
        assert got == type(got)(value)
        return
    if flag in _TELEMETRY_FLAGS:
        # ported (tests/test_torch_telemetry.py runs the plane): they parse
        # into the telemetry configuration
        from photon_ml_tpu_torch.cli.config import telemetry_from_args

        value = "x" if flag == "--telemetry-dir" else "1"
        config = telemetry_from_args(t_fleet.build_parser().parse_args(
            ["--model-dir", "m", "--feature-shards", SHARDS, flag, value]))
        assert value in (str(config.telemetry_dir),
                         f"{config.poll_interval_s:g}",
                         str(config.metrics_port))
        return
    # the autopilot's flag (tests/test_torch_feedback.py closes the loop
    # with it): without --reqlog-dir it is refused, naming the flag the
    # autopilot needs
    assert flag in _AUTOPILOT_FLAGS
    args = t_fleet.build_parser().parse_args(
        ["--model-dir", "m", "--feature-shards", SHARDS, flag, "x"])
    assert args.autopilot_config == "x"
    with pytest.raises(SystemExit, match="--reqlog-dir"):
        t_fleet.build_fleet(["--model-dir", "m", "--feature-shards", SHARDS,
                             flag, "x"] + CPU)


# --- per-host patches --------------------------------------------------------

@pytest.fixture(scope="module")
def patched(tmp_path_factory):
    """A global + perUser model (r0), its refresh with one user's rows
    changed and --fleet-shards 2 (r1), and a port fleet of r0 ranking
    over perUser with an unsharded host beside it."""
    tmp = str(tmp_path_factory.mktemp("torch_fleet_patch"))
    d0, d1 = os.path.join(tmp, "d0.avro"), os.path.join(tmp, "d1.avro")
    write_training_examples(d0, _records(400, 0))
    write_training_examples(d1, _records(400, 0,
                                         mutate_users=(MUTATED_USER,)))
    r0, r1 = os.path.join(tmp, "r0"), os.path.join(tmp, "r1")
    t_train.run(["--training-data", d0, "--output-dir", r0] + COMMON + CPU)
    result = t_refresh.run(["--prior-dir", r0, "--training-data", d1,
                            "--output-dir", r1, "--fleet-shards", "2"]
                           + COMMON + CPU)
    rank = ["--rank-item-coordinate", "perUser", "--rank-max-k", "8"]
    fleet = t_fleet.build_fleet(
        ["--model-dir", r0, "--feature-shards", SHARDS, "--port", "0",
         "--fleet-shards", "2"] + rank + CPU)
    single = t_serve.build_server(
        ["--model-dir", r0, "--feature-shards", SHARDS, "--port", "0",
         "--no-warmup"] + rank + CPU).start()
    yield {"tmp": tmp, "r0": r0, "r1": r1, "result": result,
           "fleet": fleet, "single": single,
           "requests": _records(60, 11, cold_users=4)}
    fleet.stop()
    single.stop()


def test_rank_equals_one_host_bit_for_bit(patched):
    """POST /rank with full records (the item features make every item's
    score distinct): ids and f32 scores equal; a featureless GET keeps
    the score multiset."""
    for rec in patched["requests"][:6] + patched["requests"][-2:]:
        a = _post(patched["single"].url + "/rank", {"record": rec, "k": 7})
        b = _post(patched["fleet"].url + "/rank", {"record": rec, "k": 7})
        assert a["ids"] == b["ids"] and a["scores"] == b["scores"]
    a = _get(patched["single"].url + "/rank?user=u1&k=7")
    b = _get(patched["fleet"].url + "/rank?user=u1&k=7")
    assert sorted(a["scores"]) == sorted(b["scores"])
    assert len(set(b["ids"])) == 7


def _shard_dirs(patched):
    return patched["result"]["shard_patch_dirs"]


def _meta(d):
    with open(os.path.join(d, "model-metadata.json")) as f:
        return json.load(f)


def test_refresh_publishes_shard_patches_partitioning_the_touched_set(
        patched):
    dirs = _shard_dirs(patched)
    assert [os.path.basename(d) for d in dirs] == ["patch-shard-0",
                                                   "patch-shard-1"]
    metas = [_meta(d) for d in dirs]
    assert [(m["fleetShard"], m["fleetShardCount"]) for m in metas] == \
        [(0, 2), (1, 2)]
    assert len({m["modelId"] for m in metas}) == 1
    assert metas[0]["parentModel"] == _meta(
        os.path.join(patched["r1"], "patch"))["parentModel"]
    touched = shard_of_id(f"u{MUTATED_USER}", 2)
    for i, d in enumerate(dirs):
        recs = list(iter_avro_file(os.path.join(
            d, "random-effect", "perUser", "coefficients",
            "part-00000.avro")))
        assert [r["modelId"] for r in recs] == (
            [f"u{MUTATED_USER}"] if i == touched else [])


def _decode(pkg, model_dir):
    """Both packages' decode of a model or patch dir: (models, vocabs,
    index maps)."""
    index_dir = os.path.join(os.path.dirname(model_dir), "feature-indexes")
    meta = _meta(model_dir)
    if pkg == "jax":
        maps = {s: JIndexMap.load(os.path.join(index_dir, f"{s}.json"))
                for s in ("global", "user")}
        vocabs = j_vocabs(model_dir, meta)
        return j_load_model(model_dir, maps, vocabs).coordinates, vocabs, maps
    maps = {s: IndexMap.load(os.path.join(index_dir, f"{s}.json"))
            for s in ("global", "user")}
    _, model, vocabs, _ = decode_game_model(model_dir, maps, metadata=meta,
                                            device="cpu")
    return model.coordinates, vocabs, maps


def test_partition_equals_jax(patched):
    """Both partitioners on the global patch (three users re-solved as if
    touched, one removed): the same per-shard entity keys, coefficients
    and removals."""
    patch = os.path.join(patched["r1"], "patch")
    removed = {"perUser": ["u3", "u4", "u7"]}
    parts = {}
    for pkg, fn in (("jax", j_partition), ("torch", partition_patch_by_shard)):
        models, vocabs, _ = _decode(pkg, patch)
        parts[pkg] = fn(models, removed, vocabs, 2)
    for (jm, jr), (tm, tr) in zip(parts["jax"], parts["torch"]):
        assert jr == tr
        assert sorted(jm) == sorted(tm)
        np.testing.assert_array_equal(np.asarray(jm["perUser"].keys),
                                      tm["perUser"].keys)
        np.testing.assert_array_equal(np.asarray(jm["perUser"].coeffs),
                                      tm["perUser"].coeffs)
    assert sum(len(r.get("perUser", [])) for _, r in parts["torch"]) == 3


def _jax_shard_patches(patched, root):
    """The JAX package's per-host patches of the refresh: its partitioner
    and writer over the global patch, with the port's ids and lineage."""
    patch = os.path.join(patched["r1"], "patch")
    meta = _meta(patch)
    models, vocabs, maps = _decode("jax", patch)
    dirs = []
    for i, (m, rm) in enumerate(j_partition(models, {}, vocabs, 2)):
        d = os.path.join(root, f"patch-shard-{i}")
        j_save_patch(d, m, maps, vocabs, task=JTask(meta["task"]),
                     parent_model=meta["parentModel"],
                     model_id=meta["modelId"], removed=rm,
                     lineage={k: meta[k] for k in ("trainedAt",
                                                   "dataManifest")},
                     fleet_shard=(i, 2))
        dirs.append(d)
    return dirs


def test_shard_patches_cross_load_between_the_packages(patched, tmp_path):
    configs = tuple(parse_feature_shard_config(s) for s in SHARDS.split(","))
    j_configs = tuple(j_shard(s) for s in SHARDS.split(","))
    jax_dirs = _jax_shard_patches(patched, str(tmp_path))
    for i, (port_dir, jax_dir) in enumerate(zip(_shard_dirs(patched),
                                                jax_dirs)):
        assert _meta(port_dir) == _meta(jax_dir)
        stores = []
        for make, d in (
                (lambda: ModelRegistry(configs, device="cpu",
                                       fleet_shard=(i, 2)), jax_dir),
                (lambda: JRegistry(j_configs, fleet_shard=(i, 2)), port_dir),
                (lambda: ModelRegistry(configs, device="cpu",
                                       fleet_shard=(i, 2)), port_dir)):
            registry = make()
            registry.load(patched["r0"])
            sm = registry.load_patch(d)
            assert sm.lineage == _meta(port_dir)["modelId"]
            stores.append(sm.stores["perUser"])
        raws = sorted(stores[2].row_of_id)
        want = _rows(stores[2], raws)[0]
        for s in stores[:2]:
            assert set(s.row_of_id) == set(raws)
            np.testing.assert_array_equal(_rows(s, raws)[0], want)


def test_hosts_refuse_foreign_and_unsharded_patches(patched):
    dirs = _shard_dirs(patched)
    host0 = patched["fleet"].hosts[0]
    v0 = _get(host0.url + "/healthz")["version"]
    status, body, _ = _refused(host0.url + "/reload", {"model_dir": dirs[1]})
    assert status == 409 and "foreign shard" in body["error"]
    assert _get(host0.url + "/healthz")["version"] == v0
    status, body, _ = _refused(patched["single"].url + "/reload",
                               {"model_dir": dirs[0]})
    assert status == 409 and "unsharded" in body["error"]


def test_per_host_patches_activate_with_no_builds_on_the_untouched_host(
        patched):
    """The router's two-phase reload of the per-host patches: one lineage
    everywhere; the host whose shard the refresh did not touch shares its
    parent's programs (the fixed effect is staged per replay), so its
    program count does not move; the patched fleet scores as the
    refreshed model served unsharded, bit for bit."""
    fleet = patched["fleet"]
    untouched = 1 - shard_of_id(f"u{MUTATED_USER}", 2)
    before = [_get(u + "/healthz")["compiles"] for u in fleet.host_urls()]
    out = _post(fleet.url + "/reload",
                {"model_dirs": list(_shard_dirs(patched))})
    after = [_get(u + "/healthz")["compiles"] for u in fleet.host_urls()]
    assert after[untouched] == before[untouched] > 0
    healths = [_get(u + "/healthz") for u in fleet.host_urls()]
    assert {h["model_lineage_id"] for h in healths} == {out["lineage"]}
    stores = [h.service.registry.active().stores["perUser"]
              for h in fleet.hosts]
    parents = [h.service.registry.get(h.service.registry.active_version - 1)
               for h in fleet.hosts]
    assert stores[untouched].table is \
        parents[untouched].stores["perUser"].table
    single = t_serve.build_server(
        ["--model-dir", patched["r1"], "--feature-shards", SHARDS,
         "--port", "0", "--no-warmup"] + CPU).start()
    try:
        a = _post(single.url + "/score", {"records": patched["requests"]})
        b = _post(fleet.url + "/score", {"records": patched["requests"]})
        np.testing.assert_array_equal(np.asarray(a["scores"], np.float64),
                                      np.asarray(b["scores"], np.float64))
        assert a["lineage"] == b["lineage"] == out["lineage"]
    finally:
        single.stop()


def test_a_patched_fleet_refuses_a_reshard(patched):
    """After per-host patches a host's model holds only its own shard's
    refreshed rows: a reshard would pack stale rows, so every host refuses
    and the incumbent map keeps serving."""
    fleet = patched["fleet"]
    incumbent = fleet.router.shard_map
    status, body, _ = _refused(fleet.url + "/reshard", {"moves": {"0": 1}})
    assert status == 409 and "per-host patch" in body["error"]
    assert fleet.router.shard_map is incumbent
    assert _get(fleet.url + "/healthz")["shard_map"]["mixed"] is False


def test_a_moved_map_takes_the_global_patch_not_the_shard_set(patched):
    """The refresh cuts its shard patches by the default placement: a
    fleet serving a moved map refuses them (the epoch aborts), and takes
    the global patch, each host applying the rows its map gives it."""
    fleet = t_fleet.build_fleet(
        ["--model-dir", patched["r0"], "--feature-shards", SHARDS,
         "--port", "0", "--fleet-shards", "2", "--no-warmup"] + CPU)
    try:
        moved = next(b for b in range(4096)
                     if fleet.router.shard_map.buckets[b] == 0
                     and b == shard_of_id(f"u{MUTATED_USER}", 4096))
        out = _post(fleet.url + "/reshard", {"moves": {str(moved): 1}})
        assert out["moved"]["moved_in"] == 1
        v0 = _versions(fleet)
        status, body, _ = _refused(
            fleet.url + "/reload", {"model_dirs": list(_shard_dirs(patched))})
        assert status == 409 and "default bucket map" in body["error"]
        assert _versions(fleet) == v0
        out = _post(fleet.url + "/reload",
                    {"model_dir": os.path.join(patched["r1"], "patch")})
        single = t_serve.build_server(
            ["--model-dir", patched["r1"], "--feature-shards", SHARDS,
             "--port", "0", "--no-warmup"] + CPU).start()
        try:
            a = _post(single.url + "/score",
                      {"records": patched["requests"]})
            b = _post(fleet.url + "/score", {"records": patched["requests"]})
            assert a["scores"] == b["scores"]
            assert b["lineage"] == a["lineage"] == out["lineage"]
        finally:
            single.stop()
    finally:
        fleet.stop()


def test_router_watch_dir_activates_a_patch_set(patched, tmp_path):
    """serve_fleet --router-watch-dir: a published refresh run dir moves
    the fleet to its lineage through the two-phase epoch; a set cut for
    another fleet shape is refused before any prepare."""
    publish = tmp_path / "publish"
    publish.mkdir()
    fleet = t_fleet.build_fleet(
        ["--model-dir", patched["r0"], "--feature-shards", SHARDS,
         "--port", "0", "--fleet-shards", "2", "--no-warmup",
         "--router-watch-dir", str(publish),
         "--router-watch-poll-s", "3600"] + CPU)
    try:
        # the poll thread's first scan (of the empty directory) is done;
        # the scans below run in this thread
        fleet.watcher.stop()
        bad = publish / "a-partial"
        bad.mkdir()
        shutil.copytree(_shard_dirs(patched)[0], bad / "patch-shard-0")
        shutil.copytree(patched["r1"], publish / "b-refresh")
        assert fleet.watcher.scan_once() == 1
        assert fleet.watcher.n_rejected == 1
        lineage = _meta(os.path.join(patched["r1"], "patch"))["modelId"]
        assert {_get(u + "/healthz")["model_lineage_id"]
                for u in fleet.host_urls()} == {lineage}
    finally:
        fleet.stop()
