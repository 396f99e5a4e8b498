"""The port's serving control plane against the JAX package's, on the CPU
at a tiny size: coefficient patches (``EntityCoefficientStore.apply_patch``
and ``ModelRegistry.load_patch``), two-phase ``/reload``, the publish-dir
watcher, the request log and the connection budget.

The models are the port's own: ``train_game`` on day 0 of
``tests/test_continuous.py``'s data (600 records, 12 users), then
``refresh_game`` on day 1 (two users mutate, one is new) and on day 2 (one
more user mutates, day 1's new user changes, another is new), each
publishing a patch whose ``parentModel`` is the run before. The contracts:
a patched table equals the JAX store's patch and a from-scratch build of
the merged model, row for row by raw id and bit for bit, in f32, bf16 and
int8; patched scores equal a direct load of the merged model and the JAX
registry's patch of the same dirs (``array_equal``, x64 on as
tests/conftest.py sets); patches chain; a refused patch leaves the active
version serving and ``versions()`` unchanged; the two-phase replies, the
watcher's counts, the request log's records and sampling, and the typed
refusal past the connection budget are the JAX package's. On the card the
same path runs in ``chip_smoke.py`` phase 12."""

import json
import os
import shutil
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import photon_ml_tpu.resilience as jres
import photon_ml_tpu_torch.resilience as tres
from photon_ml_tpu.cli.config import parse_feature_shard_config as j_shard
from photon_ml_tpu.game.model import RandomEffectModel as JREModel
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.serving import ModelRegistry as JRegistry
from photon_ml_tpu.serving.http import ConnectionTracker as JTracker
from photon_ml_tpu.serving.http import ServingService as JService
from photon_ml_tpu.serving.reqlog import RequestLog as JRequestLog
from photon_ml_tpu.serving.reqlog import iter_reqlog as j_iter_reqlog
from photon_ml_tpu.serving.store import EntityCoefficientStore as JStore
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.cli import refresh_game as t_refresh
from photon_ml_tpu_torch.cli import serve_game as t_serve
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.game.model import RandomEffectModel as TREModel
from photon_ml_tpu_torch.io.model_io import model_lineage_id
from photon_ml_tpu_torch.resilience import FaultPlan, FaultSpec, injected
from photon_ml_tpu_torch.serving import (
    ModelDirectoryWatcher,
    ModelRegistry,
    RequestLog,
    ServingService,
    iter_reqlog,
)
from photon_ml_tpu_torch.serving.http import ConnectionTracker
from photon_ml_tpu_torch.serving.store import EntityCoefficientStore
from photon_ml_tpu_torch.telemetry import metrics as tmetrics
from photon_ml_tpu_torch.types import TaskType
from test_torch_continuous import COMMON, MUTATED, N_USERS, SHARDS, _records

SHARD_CONFIGS = tuple(parse_feature_shard_config(s)
                      for s in SHARDS.split(","))
J_SHARD_CONFIGS = tuple(j_shard(s) for s in SHARDS.split(","))
DTYPES = ("float32", "bfloat16", "int8")
#: day 2: one more user mutates; day 1's new user draws other rows and a
#: second new user appears
DAY2_MUTATED = MUTATED + (5,)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's train_game on day 0, refresh_game on days 1 and 2."""
    tmp = str(tmp_path_factory.mktemp("torch_patches"))
    days = [_records(600, 0),
            _records(600, 0, mutate_users=MUTATED, new_users=1),
            _records(600, 0, mutate_users=DAY2_MUTATED, new_users=2)]
    paths = []
    for k, recs in enumerate(days):
        path = os.path.join(tmp, f"d{k}.avro")
        write_training_examples(path, recs)
        paths.append(path)
    cpu = ["--device", "cpu"]
    r = [os.path.join(tmp, f"r{k}") for k in range(3)]
    t_train.run(["--training-data", paths[0], "--output-dir", r[0]]
                + COMMON + cpu)
    for k in (1, 2):
        t_refresh.run(["--prior-dir", r[k - 1], "--training-data",
                       paths[k], "--output-dir", r[k]] + COMMON + cpu)
    requests = _records(60, 11, cold_users=4)
    # the days' new users, whom only the patched versions know
    requests += [{**rec, "metadataMap": {"userId": f"u{N_USERS + k}"}}
                 for k, rec in enumerate(requests[:2])]
    return dict(tmp=tmp, r=r, requests=requests,
                patch=[None] + [os.path.join(x, "patch") for x in r[1:]])


def _registry(**kw):
    return ModelRegistry(SHARD_CONFIGS, device="cpu", **kw)


def _bits(table):
    """A table's rows as integers of their storage width (bit equality)."""
    if isinstance(table, torch.Tensor):
        t = table.cpu()
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                torch.int8: torch.int8}[t.dtype]
        return t.view(view).numpy()
    a = np.asarray(table)
    return a.view({4: np.int32, 2: np.int16, 1: np.int8}[a.dtype.itemsize])


def _rows_by_raw(store, ids):
    """Each raw id's stored row bits and scale (the fallback row for an id
    the store does not hold)."""
    rows = store.rows_for(ids)
    scales = (None if store.scales is None
              else np.asarray(store.scales.cpu() if isinstance(
                  store.scales, torch.Tensor) else store.scales)[rows])
    return _bits(store.table)[rows], scales


def _assert_same_rows(a, b, ids):
    (ra, sa), (rb, sb) = _rows_by_raw(a, ids), _rows_by_raw(b, ids)
    np.testing.assert_array_equal(ra, rb)
    if sa is None or sb is None:
        assert sa is None and sb is None
    else:
        np.testing.assert_array_equal(sa.view(np.int32), sb.view(np.int32))


# --- the store --------------------------------------------------------------

def _wide(pkg, dim=16, n_ent=20):
    """tests/test_serving.py's wide model, in either package."""
    rng = np.random.default_rng(1)
    coeffs = rng.normal(size=(n_ent, dim)).astype(np.float32)
    cls, task = ((TREModel, TaskType) if pkg == "torch"
                 else (JREModel, JTask))
    model = cls(random_effect_type="userId", feature_shard_id="user",
                task=task.LOGISTIC_REGRESSION, dim=dim,
                keys=np.arange(n_ent * dim, dtype=np.int64),
                coeffs=coeffs.reshape(-1))
    return model, {f"u{e}": e for e in range(n_ent)}, coeffs


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_patch_equals_jax_and_a_full_build(dtype):
    """tests/test_serving.py::test_patch_matches_full_rebuild's case (touch
    u3 and u11, add uNEW, remove u5) through both packages' stores: the
    port's table equals the JAX one and a from-scratch build of the merged
    model, bit for bit by raw id; the parent's table is not written."""
    rng = np.random.default_rng(7)
    upd_rows = rng.normal(size=(3, 16)).astype(np.float32) * 3
    upd_vocab = {"u3": 0, "u11": 1, "uNEW": 2}
    stores = {}
    for pkg, store_cls, cls, task in (
            ("torch", EntityCoefficientStore, TREModel, TaskType),
            ("jax", JStore, JREModel, JTask)):
        model, vocab, coeffs = _wide(pkg)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        parent = store_cls.build(model, vocab, table_dtype=dtype, **kw)
        before = _bits(parent.table).copy()
        upd = cls(random_effect_type="userId", feature_shard_id="user",
                  task=task.LOGISTIC_REGRESSION, dim=16,
                  keys=np.arange(3 * 16, dtype=np.int64),
                  coeffs=upd_rows.reshape(-1))
        stores[pkg] = parent.apply_patch(upd, upd_vocab, removed=["u5"])
        np.testing.assert_array_equal(_bits(parent.table), before)
        assert stores[pkg].table_dtype == dtype
    merged = coeffs.copy()
    merged[3], merged[11], merged[5] = upd_rows[0], upd_rows[1], 0.0
    vocab2 = {**vocab, "uNEW": 20}
    rebuilt = EntityCoefficientStore.build(
        TREModel(random_effect_type="userId", feature_shard_id="user",
                 task=TaskType.LOGISTIC_REGRESSION, dim=16,
                 keys=np.arange(21 * 16, dtype=np.int64),
                 coeffs=np.vstack([merged, upd_rows[2:]]).reshape(-1)),
        vocab2, table_dtype=dtype, device="cpu")
    ids = list(vocab2) + [None, "unseen"]
    _assert_same_rows(stores["torch"], stores["jax"], ids)
    _assert_same_rows(stores["torch"], rebuilt, ids)
    assert stores["torch"].fallback_row == stores["jax"].fallback_row == 21
    assert stores["torch"].row_of_id == stores["jax"].row_of_id


# --- the registry -----------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_port_registry_applies_the_port_patch(runs, dtype):
    """The port's registry patches day 0 with day 1's patch: its tables
    equal a build of the merged model row for row, its scores equal a
    direct load of the merged model and the JAX registry's patch of the
    same dirs; the parent version's tables are untouched."""
    r, patch, requests = runs["r"], runs["patch"], runs["requests"]
    registry = _registry(table_dtype=dtype, warmup=True)
    v1 = registry.load(r[0])
    parent_bits = _bits(v1.stores["perUser"].table).copy()
    sm = registry.reload(patch[1])  # routed by kind
    assert registry.active_version == 2 and registry.versions() == [1, 2]
    assert sm.lineage == model_lineage_id(r[1])
    assert sm.parent_lineage == v1.lineage
    assert set(sm.load_seconds) == {"read", "apply", "capture"}
    assert sm.engine.compile_count == v1.engine.compile_count
    np.testing.assert_array_equal(_bits(v1.stores["perUser"].table),
                                  parent_bits)
    full = _registry(table_dtype=dtype).load(r[1])
    ids = sorted(full.stores["perUser"].row_of_id) + ["unseen"]
    _assert_same_rows(sm.stores["perUser"], full.stores["perUser"], ids)
    assert f"u{N_USERS}" in sm.stores["perUser"].row_of_id
    assert f"u{N_USERS}" not in v1.stores["perUser"].row_of_id
    got = sm.score(requests)
    assert np.array_equal(got, full.score(requests))
    jax_registry = JRegistry(J_SHARD_CONFIGS, table_dtype=dtype)
    jax_registry.load(r[0])
    jsm = jax_registry.reload(patch[1])
    assert jsm.lineage == sm.lineage
    assert np.array_equal(got, jsm.score(requests))


def _zero_entity(model_dir, raw):
    """Rewrite ``raw``'s perUser record with no coefficient, as the writers
    emit an entity re-solved to an all-zero row."""
    from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
    from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_AVRO

    part = os.path.join(model_dir, "random-effect", "perUser",
                        "coefficients", "part-00000.avro")
    records = read_avro_file(part)
    assert raw in {r["modelId"] for r in records}
    write_avro_file(part, ({**r, "means": []} if r["modelId"] == raw
                           else r for r in records),
                    BAYESIAN_LINEAR_MODEL_AVRO, codec="null")


def test_an_entity_re_solved_to_zero_is_zeroed_by_the_patch(runs,
                                                            tmp_path):
    """A refresh can re-solve an entity to an all-zero row (a label its
    margin already explains, under the L2 pull), which the writers emit as
    a record with no coefficient and so with no key in the decoded patch.
    The port's patched version zeroes that entity's row and scores as the
    merged model does; the JAX registry keeps the parent's row (a
    difference of the reference, ROADMAP.md Queue 3)."""
    r, requests = runs["r"], runs["requests"]
    raw = f"u{MUTATED[0]}"
    merged = str(tmp_path / "r1")
    shutil.copytree(r[1], merged)
    for d in (os.path.join(merged, "best"), os.path.join(merged, "patch")):
        _zero_entity(d, raw)
    registry = _registry()
    v1 = registry.load(r[0])
    sm = registry.reload(os.path.join(merged, "patch"))
    full = _registry().load(merged)
    _assert_same_rows(sm.stores["perUser"], full.stores["perUser"],
                      sorted(full.stores["perUser"].row_of_id))
    assert not _bits(sm.stores["perUser"].table)[
        sm.stores["perUser"].rows_for([raw])].any()
    assert _bits(v1.stores["perUser"].table)[
        v1.stores["perUser"].rows_for([raw])].any()
    mine = [q for q in requests
            if (q.get("metadataMap") or {}).get("userId") == raw]
    assert mine
    assert np.array_equal(sm.score(requests), full.score(requests))
    jax_registry = JRegistry(J_SHARD_CONFIGS)
    jax_registry.load(r[0])
    jsm = jax_registry.reload(os.path.join(merged, "patch"))
    assert not np.array_equal(np.asarray(jsm.score(mine)),
                              np.asarray(full.score(mine)))


def test_a_second_patch_chains(runs):
    r, patch, requests = runs["r"], runs["patch"], runs["requests"]
    registry = _registry()
    registry.load(r[0])
    registry.reload(patch[1])
    sm = registry.reload(patch[2])
    assert registry.versions() == [1, 2, 3]
    assert sm.lineage == model_lineage_id(r[2])
    direct = _registry().load(r[2])
    assert np.array_equal(sm.score(requests), direct.score(requests))
    assert f"u{N_USERS + 1}" in sm.stores["perUser"].row_of_id


def _fleet_shard_patch(runs):
    path = os.path.join(runs["tmp"], "fleet-shard-patch")
    if not os.path.exists(path):
        shutil.copytree(runs["patch"][1], path)
        meta_path = os.path.join(path, "model-metadata.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta.update(fleetShard=0, fleetShardCount=2)
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    return path


@pytest.mark.parametrize("case", ["lineage", "empty", "delta_publish",
                                  "fleet_shard"])
def test_refused_patch_leaves_the_active_version_serving(runs, case):
    """tests/test_continuous.py's oracle: a patch onto the wrong lineage,
    onto no version, under an injected io.delta_publish fault at every
    attempt, or for a fleet shard is refused; the active version keeps
    serving and versions() is unchanged. With the fault plan gone the
    same patch applies."""
    r, patch, requests = runs["r"], runs["patch"], runs["requests"]
    registry = _registry()
    if case == "empty":
        with pytest.raises(RuntimeError, match="active parent"):
            registry.load_patch(patch[1])
        assert registry.versions() == [] and registry.active_version is None
        return
    registry.load(r[1] if case == "lineage" else r[0])
    before = registry.active().score(requests)
    if case == "lineage":
        with pytest.raises(ValueError, match="lineage"):
            registry.reload(patch[1])
    elif case == "fleet_shard":
        with pytest.raises(ValueError, match="unsharded"):
            registry.reload(_fleet_shard_patch(runs))
    else:
        plan = FaultPlan([FaultSpec(site="io.delta_publish", rate=1.0)])
        with injected(plan), pytest.raises(Exception):
            registry.load_patch(patch[1])
        assert plan.fired("io.delta_publish")
    assert registry.active_version == 1 and registry.versions() == [1]
    assert np.array_equal(registry.active().score(requests), before)
    if case == "delta_publish":
        registry.load_patch(patch[1])
        assert registry.active_version == 2


def test_one_transient_fault_is_retried_through(runs):
    registry = _registry()
    registry.load(runs["r"][0])
    plan = FaultPlan([FaultSpec(site="io.delta_publish", at=(0,))])
    with injected(plan):
        registry.load_patch(runs["patch"][1])
    assert len(plan.fired("io.delta_publish")) == 1
    assert registry.active_version == 2


def test_two_phase_reload_replies_equal_jax(runs):
    """prepare, abort, prepare and activate, then a patch refused for its
    lineage, through both packages' services: the same replies, and the
    incumbent's scores until the activation."""
    r, patch, requests = runs["r"], runs["patch"], runs["requests"]
    services = []
    for registry, service in ((_registry(), ServingService),
                              (JRegistry(J_SHARD_CONFIGS), JService)):
        registry.load(r[0])
        services.append(service(registry, default_model_dir=r[0]))
    steps = [{"phase": "prepare", "model_dir": patch[1]},
             "score", {"phase": "abort", "version": 2},
             {"phase": "prepare", "model_dir": patch[1]},
             {"phase": "activate", "version": 3}, "score",
             {"model_dir": patch[1]}]
    replies = []
    for service in services:
        out = []
        for step in steps:
            if step == "score":
                res = service.score({"records": requests}, request_id="r")
                out.append((res["version"], res["lineage"], res["scores"]))
                continue
            try:
                out.append(service.reload(dict(step)))
            except ValueError as e:
                out.append(("refused", "lineage" in str(e)))
            out.append(service.registry.versions())
        replies.append(out)
    assert replies[0] == replies[1]
    t = replies[0]
    assert t[0]["phase"] == "prepared" and t[0]["version"] == 2
    assert t[2][0] == 1  # the incumbent served while 2 was prepared
    assert t[-2] == ("refused", True)
    # a reshard's prepare (a shard map, no model dir) on an unsharded
    # host: both packages refuse it with the same message
    from photon_ml_tpu.fleet.sharding import ShardMap

    refusals = []
    for service in services:
        with pytest.raises(ValueError) as err:
            service.reload({"phase": "prepare",
                            "shard_map": ShardMap.default(2).as_dict()})
        refusals.append(str(err.value))
    assert refusals[0] == refusals[1]
    assert "reshard needs a fleet-sharded host" in refusals[0]


# --- serve_game: the watcher, the request log, the connection budget -------

def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _post(url, body, rid=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **({"X-Photon-Request-Id": rid} if rid else {})})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _publish(src, watch, name):
    """Copy ``src`` into ``watch/name`` the way a publisher does: written
    under a hidden name, then renamed into place."""
    staging = os.path.join(watch, f".{name}.tmp")
    shutil.copytree(src, staging)
    os.rename(staging, os.path.join(watch, name))


def _wait_version(base, version, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if _get(base + "/healthz")["version"] == version:
            return
        time.sleep(0.05)


def test_watch_dir_applies_patch_then_full(runs, tmp_path):
    """tests/test_continuous.py::TestWatchDir on the port's serve_game: a
    garbage entry, day 1's patch and day 1's full run dir give version 3,
    two applied and one rejected, and the served scores are the full
    model's."""
    r, patch, requests = runs["r"], runs["patch"], runs["requests"]
    watch = str(tmp_path / "publish")
    os.makedirs(watch)
    server = t_serve.build_server([
        "--model-dir", r[0], "--feature-shards", SHARDS, "--port", "0",
        "--no-warmup", "--device", "cpu",
        "--watch-dir", watch, "--watch-poll-s", "0.2"]).start()
    try:
        base = server.url
        assert _get(base + "/healthz")["version"] == 1
        os.mkdir(os.path.join(watch, "a-garbage"))
        with open(os.path.join(watch, "a-garbage",
                               "model-metadata.json"), "w") as f:
            f.write("{ not json")
        _publish(patch[1], watch, "b-patch")
        _publish(r[1], watch, "c-full")
        _wait_version(base, 3)
        assert _get(base + "/healthz")["version"] == 3
        assert server.watcher.n_applied == 2
        assert server.watcher.n_rejected == 1
        out = _post(base + "/score", {"records": requests[:5]})
        direct = _registry().load(r[1]).score(requests[:5])
        assert out["version"] == 3
        assert np.array_equal(np.asarray(out["scores"], np.float32), direct)
    finally:
        server.stop()
    assert server.watcher._thread is None


@pytest.mark.parametrize("drive", ["scan_once", "thread"])
def test_watch_tick_fault_retries_next_tick(runs, tmp_path, drive):
    """tests/test_overload.py's ``serving.watch_tick`` case on the port's
    watcher: the faulted tick applies nothing and marks nothing seen, and
    the next tick applies the candidate. Driven tick by tick, and through
    the watcher's own thread, whose loop logs the fault and polls again."""
    watch = str(tmp_path / "publish")
    os.makedirs(watch)
    _publish(runs["r"][0], watch, "m1")
    registry = _registry()
    plan = FaultPlan([FaultSpec(site="serving.watch_tick", at=(0,))])
    with injected(plan):
        if drive == "scan_once":
            watcher = ModelDirectoryWatcher(registry, watch, poll_s=999.0)
            with pytest.raises(tres.InjectedFault):
                watcher.scan_once()
            assert registry.active_or_none() is None
            assert watcher.scan_once() == 1
        else:
            watcher = ModelDirectoryWatcher(registry, watch,
                                            poll_s=0.05).start()
            try:
                deadline = time.monotonic() + 30.0
                while watcher.n_applied == 0 \
                        and time.monotonic() < deadline:
                    time.sleep(0.02)
            finally:
                watcher.stop()
    assert len(plan.fired("serving.watch_tick")) == 1
    assert (watcher.n_applied, watcher.n_rejected) == (1, 0)
    assert registry.active_version == 1


def test_served_requests_are_logged(runs, tmp_path):
    """serve_game --reqlog-dir: one record per answered /score, each with
    the reply's scores, version and lineage, across a patch's activation;
    /healthz carries the log's counters."""
    r, patch, requests = runs["r"], runs["patch"], runs["requests"]
    log_dir = str(tmp_path / "reqlog")
    server = t_serve.build_server([
        "--model-dir", r[0], "--feature-shards", SHARDS, "--port", "0",
        "--device", "cpu", "--reqlog-dir", log_dir,
        "--reqlog-segment-records", "4"]).start()
    replies = {}
    try:
        base = server.url
        for i, rec in enumerate(requests[:10]):
            if i == 5:
                assert _post(base + "/reload",
                             {"model_dir": patch[1]})["version"] == 2
            body = {"record": rec} if i % 2 else {"records": [rec, rec]}
            replies[f"q{i}"] = _post(base + "/score", body, rid=f"q{i}")
        health = _get(base + "/healthz")
    finally:
        server.stop()
    assert health["reqlog"]["dir"] == log_dir
    logged = {e["requestId"]: e for e in iter_reqlog(log_dir)}
    assert set(logged) == set(replies)
    for rid, reply in replies.items():
        entry = logged[rid]
        assert [x["score"] for x in entry["records"]] == reply["scores"]
        assert entry["modelVersion"] == reply["version"]
        assert entry["modelLineage"] == reply["lineage"]
        # the JAX service's stages: the front end's parse, the score wall
        assert set(entry["stageMs"]) == {"parse", "score"}
    assert {e["modelVersion"] for e in logged.values()} == {1, 2}
    assert replies["q9"]["lineage"] == model_lineage_id(r[1])


def _log_n(log, n, prefix="r"):
    """tests/test_reqlog.py's workload: n one-record requests."""
    accepted = 0
    for i in range(n):
        rec = {"features": [{"name": "f.x", "term": "", "value": float(i)}],
               "metadataMap": {"userId": f"u{i}"}, "offset": None}
        accepted += int(log.log(request_id=f"{prefix}{i}", records=[rec],
                                scores=[float(i)], version=1,
                                lineage="lin", stage_ms={"parse": 0.1}))
    return accepted


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_reqlog_segments_cross_read(tmp_path, writer):
    """Segments one package writes, the other reads with equal records."""
    cls = RequestLog if writer == "torch" else JRequestLog
    log = cls(str(tmp_path), segment_records=3)
    assert _log_n(log, 7) == 7
    log.close()
    assert sorted(os.listdir(tmp_path)) == [
        "reqlog-00000001.avro", "reqlog-00000002.avro",
        "reqlog-00000003.avro"]
    ours, theirs = (list(iter_reqlog(str(tmp_path))),
                    list(j_iter_reqlog(str(tmp_path))))
    assert ours == theirs
    assert [e["requestId"] for e in ours] == [f"r{i}" for i in range(7)]
    e = ours[3]
    assert e["records"][0]["score"] == 3.0
    assert e["records"][0]["metadataMap"] == {"userId": "u3"}
    assert (e["modelVersion"], e["modelLineage"], e["stageMs"]) == (
        1, "lin", {"parse": 0.1})


def test_reqlog_samples_the_ids_jax_samples(tmp_path):
    ids = [f"req-{i}" for i in range(2000)]
    ours = RequestLog(str(tmp_path / "a"), sample_rate=0.5)
    theirs = JRequestLog(str(tmp_path / "b"), sample_rate=0.5)
    picks = [ours.should_log(i) for i in ids]
    assert picks == [theirs.should_log(i) for i in ids]
    assert 0.40 < sum(picks) / len(picks) < 0.60
    ours.close()
    theirs.close()
    with pytest.raises(ValueError, match="sample_rate"):
        RequestLog(str(tmp_path), sample_rate=1.5)
    with pytest.raises(ValueError, match="segment_records"):
        RequestLog(str(tmp_path), segment_records=0)


@pytest.mark.parametrize("case", ["rotation", "backpressure", "closed"])
def test_reqlog_budget_behaves_as_jax(tmp_path, case):
    """tests/test_reqlog.py's rotation, drops and closed log, through both
    packages: the same stats and records."""
    stats, entries = [], []
    for cls, sub in ((RequestLog, "t"), (JRequestLog, "j")):
        d = str(tmp_path / sub)
        kw = {"rotation": dict(segment_records=2, max_bytes=1200),
              "backpressure": dict(segment_records=100),
              "closed": {}}[case]
        log = cls(d, **kw)
        # the budget, in records, set alike on both logs: wide enough that
        # a slow writer drops nothing under rotation, three under
        # backpressure
        log.max_buffered = {"rotation": 100, "backpressure": 3,
                            "closed": log.max_buffered}[case]
        if case == "closed":
            log.close()
            assert _log_n(log, 1) == 0
        else:
            accepted = _log_n(log, {"rotation": 20, "backpressure": 10}[case])
            if case == "backpressure":
                assert accepted == 3 and log.stats()["buffered"] == 3
        log.close()
        log.close()  # idempotent
        st = log.stats()
        stats.append({k: st[k] for k in ("records", "dropped", "rotated",
                                         "segments", "buffered")})
        entries.append([(e["requestId"], e["records"])
                        for e in iter_reqlog(d)])
    assert stats[0] == stats[1] and entries[0] == entries[1]
    # the port's writer thread is stopped with its log
    assert not [t for t in threading.enumerate()
                if t.name.startswith("photon-reqlog")]
    if case == "rotation":
        assert stats[0]["rotated"] > 0 and stats[0]["dropped"] == 0
        assert entries[0][-1][0] == "r19"
        total = sum(os.path.getsize(os.path.join(tmp_path, "t", f))
                    for f in os.listdir(tmp_path / "t"))
        assert total <= 1200 + 1024


@pytest.mark.parametrize("at", [0, 2])
def test_reqlog_failed_segment_counts_as_dropped(tmp_path, at):
    """A fault at ``io.save.reqlog`` (the first segment, or the tail that
    close flushes) loses that segment's records, counted as drops, in both
    packages alike; the log goes on and close returns."""
    stats, entries = [], []
    for cls, res, sub in ((RequestLog, tres, "t"), (JRequestLog, jres, "j")):
        d = str(tmp_path / sub)
        plan = res.FaultPlan([res.FaultSpec("io.save.reqlog", at=[at])])
        with res.injected(plan):
            log = cls(d, segment_records=2)
            # segments are submitted in order to one writer: the fault
            # lands on the at-th segment
            assert _log_n(log, 5) == 5
            log.close()
        st = log.stats()
        stats.append({k: st[k] for k in ("records", "dropped", "segments",
                                         "buffered")})
        entries.append([e["requestId"] for e in iter_reqlog(d)])
        assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    assert stats[0] == stats[1] and entries[0] == entries[1]
    lost = {0: ["r0", "r1"], 2: ["r4"]}[at]
    assert stats[0]["dropped"] == len(lost)
    assert entries[0] == [f"r{i}" for i in range(5)
                          if f"r{i}" not in lost]


def test_connection_tracker_equals_jax():
    """tests/test_capacity.py's budget sequence through both trackers."""
    out = []
    for cls in (ConnectionTracker, JTracker):
        t = cls(max_connections=2)
        seq = [t.connect(), t.connect(), t.connect(), t.exhausted(),
               t.utilization(), t.stats()]
        t.disconnect(0.0, 0, admitted=False)
        seq.append(t.stats())
        t.disconnect(0.1, 1)
        seq += [t.exhausted(), t.connect(), t.stats()]
        out.append(seq)
    assert out[0] == out[1]
    assert out[0][:3] == [True, True, False]


def _http_exchange(sock, path="/healthz"):
    """One keep-alive GET on ``sock``: (status line, headers, body)."""
    sock.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    data = b""
    while b"\r\n\r\n" not in data:
        data += sock.recv(65536)
    head, body = data.split(b"\r\n\r\n", 1)
    lines = head.decode().split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    while len(body) < int(headers["Content-Length"]):
        body += sock.recv(65536)
    return lines[0], headers, json.loads(body)


def test_max_connections_refuses_with_a_typed_503(runs):
    """serve_game --max-connections 2: with two connections held open the
    third gets one 503 reason=connections with Connection: close and
    Retry-After, counted in photon_connections_refused_total; /readyz on
    a held connection says connections_exhausted; a freed slot admits."""
    server = t_serve.build_server([
        "--model-dir", runs["r"][0], "--feature-shards", SHARDS,
        "--port", "0", "--no-warmup", "--device", "cpu",
        "--max-connections", "2"]).start()
    refused = tmetrics.default_registry().get(
        "photon_connections_refused_total")
    before = refused.value
    host, port = server.url.rsplit("/", 1)[1].split(":")
    held = []
    try:
        for _ in range(2):
            s = socket.create_connection((host, int(port)), timeout=30)
            held.append(s)
            assert _http_exchange(s)[0].endswith("200 OK")
        extra = socket.create_connection((host, int(port)), timeout=30)
        status, headers, body = _http_exchange(extra)
        extra.close()
        assert status.split()[1] == "503"
        assert body["reason"] == "connections"
        assert headers["Connection"] == "close" and "Retry-After" in headers
        assert refused.value == before + 1
        status, _, ready = _http_exchange(held[0], "/readyz")
        assert "connections_exhausted" in ready["reasons"]
        assert ready["connections"]["refused"] == 1
        held.pop().close()
        deadline = time.monotonic() + 10
        while server.service.connections.stats()["open"] > 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        again = socket.create_connection((host, int(port)), timeout=30)
        held.append(again)
        assert _http_exchange(again)[0].endswith("200 OK")
    finally:
        for s in held:
            s.close()
        server.stop()
