"""The port's online serving (``photon_ml_tpu_torch.serving`` and
``serve_game``) against the JAX package's, on the CPU at a tiny size: one
fixed and one per-user random coordinate, trained twice (two versions) by
the JAX package's ``train_game`` on 500 seeded rows, and 60 requests of
which the last 4 name users no model has seen.

The contracts held here: the stores' bf16 and int8 tables equal the JAX
store's element for element; the port engine's scores are ``array_equal``
to the JAX engine's (x64 on, as tests/conftest.py sets) in f32, bf16 and
int8, and in f32 to the port's ``score_game``; padding, chunking and
warmup leave scores unchanged and the program count flat; the
microbatcher, the registry's hot swap and the HTTP endpoints behave as the
JAX package's do. On the card the bucket programs are CUDA graphs; that
path runs in ``chip_smoke.py`` phase 10.
"""

import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import train_game as j_train
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.serving import ModelRegistry as JRegistry
from photon_ml_tpu.serving.store import quantize_rows as j_quantize_rows
from photon_ml_tpu_torch.cli import score_game as t_score
from photon_ml_tpu_torch.cli import serve_game as t_serve
from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.io.avro import iter_avro_file
from photon_ml_tpu_torch.serving import (
    GameServer,
    MicroBatcher,
    ModelRegistry,
    ServingService,
    next_bucket,
)
from photon_ml_tpu_torch.serving.store import (
    EntityCoefficientStore,
    quantize_rows,
)

SHARDS = "global=fixed|intercept,user=user|noIntercept"
SHARD_CONFIGS = tuple(parse_feature_shard_config(s)
                      for s in SHARDS.split(","))
COORDS = ["global=fixed,shard=global,reg=L2",
          "perUser=random,entity=userId,shard=user,reg=L2"]
D_FIXED, D_USER, N_USERS = 6, 3, 9
DTYPES = ("float32", "bfloat16", "int8")


def _records(n, seed, *, cold_users=0):
    """Mixed-effect logistic records; the last ``cold_users`` name users
    outside the training universe (``uCOLD*``)."""
    prng = np.random.default_rng(777)
    w = prng.normal(size=D_FIXED)
    u = 1.5 * prng.normal(size=(N_USERS, D_USER))
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(n, D_FIXED))
    xu = rng.normal(size=(n, D_USER))
    users = rng.integers(0, N_USERS, size=n)
    margin = xf @ w + np.einsum("nd,nd->n", xu, u[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(float)
    off = rng.normal(size=n)
    out = []
    for i in range(n):
        feats = [{"name": f"fixed.x{j}", "term": "", "value": float(xf[i, j])}
                 for j in range(D_FIXED)]
        feats += [{"name": f"user.z{j}", "term": "", "value": float(xu[i, j])}
                  for j in range(D_USER)]
        uid = f"uCOLD{i}" if i >= n - cold_users else f"u{users[i]}"
        out.append({"uid": str(i), "response": float(y[i]),
                    "offset": float(off[i]) if i % 3 == 0 else None,
                    "weight": None, "features": feats,
                    "metadataMap": {"userId": uid}})
    return out


def _train(tmp, tag, seed):
    path = os.path.join(tmp, f"train-{tag}.avro")
    write_training_examples(path, _records(500, seed))
    out = os.path.join(tmp, f"run-{tag}")
    j_train.run(["--training-data", path, "--output-dir", out,
                 "--feature-shards", SHARDS, "--coordinates", *COORDS,
                 "--update-sequence", "global,perUser",
                 "--grid", "global=0.1", "perUser=1", "--evaluators", ""])
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_serving"))
    requests = _records(60, seed=11, cold_users=4)
    path = os.path.join(tmp, "requests.avro")
    write_training_examples(path, requests)
    return {"tmp": tmp, "v1": _train(tmp, "v1", 0),
            "v2": _train(tmp, "v2", 5), "requests": requests,
            "requests_avro": path}


def _registry(**kw):
    return ModelRegistry(SHARD_CONFIGS, device="cpu", **kw)


def _cold(requests):
    return [r for r in requests
            if r["metadataMap"]["userId"].startswith("uCOLD")]


# --- the store ----------------------------------------------------------------

def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(40, 7)).astype(np.float32)
    rows[5] = 0.0  # an all-zero row gets scale 1
    rows[6, 2] = 1e-30
    q, s = quantize_rows(rows)
    jq, js = j_quantize_rows(rows)
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert np.array_equal(q, jq) and np.array_equal(s, js)
    assert s[5] == 1.0 and not q[5].any()


@pytest.mark.parametrize("table_dtype", DTYPES)
def test_tables_match_jax_store(trained, table_dtype):
    """Element for element: bf16 rounding (to nearest even on both sides),
    int8 rows and scales, the raw id → row map and the zero fallback row."""
    t_sm = _registry(table_dtype=table_dtype).load(trained["v1"])
    j_sm = JRegistry(SHARD_CONFIGS, table_dtype=table_dtype).load(
        trained["v1"])
    t, j = t_sm.stores["perUser"], j_sm.stores["perUser"]
    assert t.row_of_id == dict(j.row_of_id)
    assert t.fallback_row == j.fallback_row == N_USERS
    got = t.table.float().numpy()
    want = np.asarray(j.table).astype(np.float32)
    assert t.table.dtype == {"float32": torch.float32,
                             "bfloat16": torch.bfloat16,
                             "int8": torch.int8}[table_dtype]
    assert np.array_equal(got, want)
    assert not got[t.fallback_row].any()
    if table_dtype == "int8":
        assert np.array_equal(t.scales.numpy(), np.asarray(j.scales))
    else:
        assert t.scales is None and j.scales is None
    assert t.table_bytes == j.table_bytes


def test_serving_load_matches_jax_model_io(trained):
    """One decode of each part file gives the JAX package's lineage id and
    model-derived vocabularies, and the model load_game_model gives."""
    from photon_ml_tpu.io import model_io as jio
    from photon_ml_tpu_torch.io import model_io as tio

    model_dir = tio.resolve_game_model_dir(trained["v1"])
    sm = _registry().load(trained["v1"])
    lineage = jio.model_lineage_id(model_dir)
    assert sm.lineage == tio.model_lineage_id(model_dir) == lineage
    assert sm.lineage != jio.model_lineage_id(trained["v2"])
    vocabs = jio.game_model_entity_vocabs(model_dir)
    assert sm.entity_vocabs == tio.game_model_entity_vocabs(model_dir) \
        == vocabs
    assert tio.model_kind(model_dir) == jio.model_kind(model_dir) == "model"
    plain = tio.load_game_model(model_dir, sm.index_maps, vocabs,
                                device="cpu")
    for cid, cm in plain.coordinates.items():
        got = sm.model.coordinates[cid]
        if cid == "global":
            assert torch.equal(got.model.coefficients.means,
                               cm.model.coefficients.means)
        else:
            assert np.array_equal(got.keys, cm.keys)
            assert np.array_equal(got.coeffs, cm.coeffs)


def test_rows_for_fallback_and_unknown_ids(trained):
    store = _registry().load(trained["v1"]).stores["perUser"]
    fb = store.fallback_row

    def generic(ids):
        return np.array([fb if r is None else store.row_of_id.get(r, fb)
                         for r in ids], np.int32)

    for ids in (["u1"], [None], ["nope"], [None, None, None],
                ["u0", None, "u2", "nope"], []):
        got = store.rows_for(ids)
        assert got.dtype == np.int32 and np.array_equal(got, generic(ids))
    assert store.rows_for(["nope"])[0] == fb


def test_store_refuses_what_is_not_ported(trained):
    sm = _registry().load(trained["v1"])
    model = sm.model.coordinates["perUser"]
    vocab = sm.entity_vocabs["userId"]
    with pytest.raises(NotImplementedError, match="shard"):
        EntityCoefficientStore.build(model, vocab, shard=(0, 2),
                                     device="cpu")
    with pytest.raises(NotImplementedError, match="patches"):
        sm.stores["perUser"].apply_patch(None, {})
    with pytest.raises(ValueError, match="table_dtype"):
        _registry(table_dtype="fp8")


# --- the engine ---------------------------------------------------------------

def _batch_scores(trained, tmp_path):
    out = str(tmp_path / "batch")
    t_score.run(["--data", trained["requests_avro"], "--model-dir",
                 trained["v1"], "--output-dir", out, "--feature-shards",
                 SHARDS, "--device", "cpu"])
    return np.array([r["predictionScore"] for r in iter_avro_file(
        os.path.join(out, "scores.avro"))])


@pytest.mark.parametrize("table_dtype", DTYPES)
def test_engine_matches_jax_engine_and_batch(trained, tmp_path, table_dtype):
    """The port engine equals the JAX engine bit for bit in every table
    format, cold users included; in f32 both equal the batch scorer."""
    recs = trained["requests"]
    got = _registry(table_dtype=table_dtype).load(trained["v1"]).score(recs)
    want = JRegistry(SHARD_CONFIGS, table_dtype=table_dtype).load(
        trained["v1"]).score(recs)
    assert got.dtype == np.float32 and got.shape == (60,)
    assert np.array_equal(got, np.asarray(want))
    if table_dtype == "float32":
        assert np.array_equal(got.astype(np.float64),
                              _batch_scores(trained, tmp_path))


@pytest.mark.parametrize("table_dtype", DTYPES)
def test_cold_users_score_as_records_without_ids(trained, table_dtype):
    sm = _registry(table_dtype=table_dtype).load(trained["v1"])
    cold = _cold(trained["requests"])
    assert len(cold) == 4
    anonymized = [{**r, "metadataMap": {}} for r in cold]
    assert np.array_equal(sm.score(cold), sm.score(anonymized))


def test_score_margins_sum_to_scores(trained):
    sm = _registry().load(trained["v1"])
    recs = trained["requests"][:9]
    scores, offsets, margins = sm.engine.score_margins(recs)
    assert [cid for cid, _ in margins] == ["global", "perUser"]
    total = offsets.astype(np.float64)
    for _, m in margins:
        total = total + m.astype(np.float64)
    assert np.array_equal(total.astype(np.float32), scores)
    assert np.array_equal(scores, sm.score(recs))


def test_next_bucket():
    assert [next_bucket(n) for n in (0, 1, 2, 3, 5, 8, 9, 1000)] == \
        [1, 1, 2, 4, 8, 8, 16, 1024]


def test_bucket_padding_and_chunking_are_score_invariant(trained):
    sm = _registry(max_batch=16).load(trained["v1"])
    recs = trained["requests"][:23]
    whole = sm.score(recs)  # chunks of 16 + 7 (padded to 8)
    singles = np.concatenate([sm.score([r]) for r in recs])
    assert np.array_equal(whole, singles)
    pairs = np.concatenate([sm.score(recs[i:i + 2])
                            for i in range(0, 22, 2)] + [sm.score(recs[22:])])
    assert np.array_equal(whole, pairs)
    # stale padding rows from the larger batches above change nothing
    assert np.array_equal(sm.score(recs[:3]), whole[:3])


def test_no_program_built_after_warmup(trained):
    sm = _registry(max_batch=32).load(trained["v1"])
    assert sm.engine.compile_count == 0
    assert sm.engine.warmup() == 6  # buckets 1, 2, 4, 8, 16, 32
    frozen = sm.engine.compile_count
    sizes = (1, 2, 3, 5, 7, 8, 11, 16, 23, 32, 40, 60)
    for size in sizes:
        sm.score(trained["requests"][:size])
    assert sm.engine.compile_count == frozen == 6
    assert sm.engine.n_scored >= sum(sizes)
    assert sm.engine.warmup() == 0


def test_registry_warmup_flag_builds_at_load(trained):
    sm = _registry(max_batch=8, warmup=True).load(trained["v1"])
    assert sm.engine.compile_count == 4


def test_serving_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry(SHARD_CONFIGS)


# --- the microbatcher ---------------------------------------------------------

def test_microbatcher_matches_engine(trained):
    registry = _registry(max_batch=16)
    sm = registry.load(trained["v1"])
    recs = trained["requests"][:10]
    direct = sm.score(recs)
    batcher = MicroBatcher(lambda rs: registry.active().score(rs),
                           max_batch=16, max_wait_ms=100.0)
    try:
        futures = [batcher.submit(r) for r in recs]
        got = np.array([f.result(timeout=60) for f in futures], np.float32)
    finally:
        batcher.close()
    assert np.array_equal(got, direct)
    assert batcher.n_batches <= 2 and batcher.n_coalesced >= 9


def test_microbatcher_fails_only_the_bad_batch():
    calls = [0]

    def flaky(rs):
        calls[0] += 1
        if calls[0] == 1:
            raise RuntimeError("boom")
        return np.zeros(len(rs), np.float32)

    batcher = MicroBatcher(flaky, max_batch=4, max_wait_ms=1.0)
    try:
        f1 = batcher.submit({"features": []})
        with pytest.raises(RuntimeError, match="boom"):
            f1.result(timeout=30)
        assert batcher.submit({"features": []}).result(timeout=30) == 0.0
    finally:
        batcher.close()


def test_microbatcher_sheds_a_full_queue():
    from photon_ml_tpu_torch.serving import Shed

    release = threading.Event()

    def slow(rs):
        release.wait(30)
        return np.zeros(len(rs), np.float32)

    batcher = MicroBatcher(slow, max_batch=1, max_wait_ms=0.0, max_queue=1)
    try:
        first = batcher.submit({"features": []})
        # the worker holds the first; one more fills the queue
        deadline = threading.Event()
        while batcher.queue_depth() != 0:
            deadline.wait(0.01)
        second = batcher.submit({"features": []})
        with pytest.raises(Shed) as e:
            batcher.submit({"features": []})
        assert e.value.reason == "queue_full"
        release.set()
        assert first.result(timeout=30) == second.result(timeout=30) == 0.0
    finally:
        release.set()
        batcher.close()


# --- the registry -------------------------------------------------------------

def test_hot_swap_under_concurrent_scoring(trained):
    registry = _registry(max_batch=16)
    registry.load(trained["v1"])
    recs = trained["requests"][:8]
    v1_scores = registry.active().score(recs)
    stop = threading.Event()
    failures, n_ok = [], [0]

    def loop():
        try:
            while not stop.is_set():
                scores = registry.active().score(recs)
                assert scores.shape == (8,) and np.isfinite(scores).all()
                n_ok[0] += 1
        except Exception as e:  # pragma: no cover - failure path
            failures.append(e)

    threads = [threading.Thread(target=loop) for _ in range(4)]
    for t in threads:
        t.start()
    registry.reload(trained["v2"])
    registry.active().score(recs)
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not failures and n_ok[0] > 0
    assert registry.active_version == 2
    assert not np.array_equal(v1_scores, registry.active().score(recs))
    registry.activate(1)
    assert np.array_equal(registry.active().score(recs), v1_scores)
    with pytest.raises(ValueError, match="active"):
        registry.retire(1)
    registry.retire(2)
    assert registry.versions() == [1]


def test_corrupt_candidate_rejected_active_keeps_serving(trained, tmp_path):
    registry = _registry()
    registry.load(trained["v1"])
    recs = trained["requests"][:5]
    before = registry.active().score(recs)
    events = []
    registry.bus.subscribe(lambda ev: events.append(ev.name))
    garbage = str(tmp_path / "garbage")
    shutil.copytree(trained["v1"], garbage)
    with open(os.path.join(garbage, "best", "model-metadata.json"), "w") as f:
        f.write("{ this is not json")
    with pytest.raises(Exception):
        registry.reload(garbage)
    missing = str(tmp_path / "missing-part")
    shutil.copytree(trained["v1"], missing)
    os.remove(os.path.join(missing, "best", "random-effect", "perUser",
                           "coefficients", "part-00000.avro"))
    with pytest.raises(FileNotFoundError):
        registry.reload(missing)
    patch = str(tmp_path / "patch")
    shutil.copytree(trained["v1"], patch)
    meta_path = os.path.join(patch, "best", "model-metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["kind"] = "coefficient-patch"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(NotImplementedError, match="patches"):
        registry.reload(patch)
    assert events.count("model_reload_rejected") == 3
    assert registry.active_version == 1 and registry.versions() == [1]
    assert np.array_equal(registry.active().score(recs), before)


# --- HTTP ---------------------------------------------------------------------

def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_scores_reload_and_endpoints(trained):
    """/score answers with the JAX engine's scores (singles through the
    microbatcher, a batch straight to the engine); /reload to the second
    version switches to that version's scores."""
    recs = trained["requests"]
    want = {v: np.asarray(JRegistry(SHARD_CONFIGS).load(trained[v])
                          .score(recs)) for v in ("v1", "v2")}
    server = t_serve.build_server([
        "--model-dir", trained["v1"], "--feature-shards", SHARDS,
        "--port", "0", "--max-batch", "16", "--microbatch", "8",
        "--brownout-poll-s", "0", "--device", "cpu"])
    server.start()
    try:
        url = server.url
        status, body, headers = _post(f"{url}/score", {"records": recs},
                                      {"X-Photon-Request-Id": "rid-1"})
        assert status == 200 and body["version"] == 1
        assert np.array_equal(np.array(body["scores"], np.float32),
                              want["v1"])
        assert body["request_id"] == headers["X-Photon-Request-Id"] == "rid-1"
        leg = dict(kv.split("=") for kv in
                   headers["X-Photon-Leg-Summary"].split(";"))
        assert set(leg) == {"parse", "batch_assemble", "execute", "respond"}
        status, body, _ = _post(f"{url}/score",
                                {"records": recs[:5], "margins": True})
        assert [cid for cid, _ in body["margins"]] == ["global", "perUser"]
        total = np.array(body["offsets"])
        for _, m in body["margins"]:
            total = total + np.array(m)
        assert np.array_equal(total.astype(np.float32), want["v1"][:5])
        singles = [_post(f"{url}/score", {"record": r})[1]["scores"][0]
                   for r in recs[:6]]
        assert np.array_equal(np.array(singles, np.float32), want["v1"][:6])
        status, body, _ = _post(f"{url}/reload",
                                {"model_dir": trained["v2"]})
        assert status == 200 and body["version"] == 2
        assert body["previous"] == 1
        status, body, _ = _post(f"{url}/score", {"records": recs})
        assert body["version"] == 2
        assert np.array_equal(np.array(body["scores"], np.float32),
                              want["v2"])
        status, body, _ = _post(f"{url}/reload",
                                {"model_dir": "/nonexistent"})
        assert status == 409 and body["version"] == 2
        status, body, headers = _post(f"{url}/score", {"record": recs[0]},
                                      {"X-Photon-Deadline-Ms": "0"})
        assert status == 429 and body["reason"] == "deadline"
        assert "Retry-After" in headers
        assert _post(f"{url}/score", {"records": []})[0] == 400
        health = json.loads(_get(f"{url}/healthz")[1])
        assert health["version"] == 2 and health["versions"] == [1, 2]
        assert health["coordinates"] == [["global", None],
                                         ["perUser", "userId"]]
        assert health["compiles"] == 5  # warmup: buckets 1 .. 16
        assert health["shed"]["deadline"] >= 1
        assert _get(f"{url}/readyz")[0] == 200
        status, text = _get(f"{url}/metrics")
        assert status == 200
        assert b'photon_serving_stage_seconds_count{stage="execute"}' in text
        assert b"photon_serving_table_bytes" in text
        for path in ("/rank?user=u1", "/history"):
            status, text = _get(f"{url}{path}")
            assert status == 501 and b"not ported" in text
        assert _get(f"{url}/nope")[0] == 404
    finally:
        server.stop()


def test_service_without_batcher_reports_shed_on_brownout(trained):
    from photon_ml_tpu_torch.serving import Shed, overload

    registry = _registry()
    registry.load(trained["v1"])
    service = ServingService(registry)
    try:
        overload.set_level(overload.MAX_LEVEL)
        with pytest.raises(Shed) as e:
            service.score({"record": trained["requests"][0]})
        assert e.value.reason == "brownout"
        assert service.readyz()[0] == 503
    finally:
        overload.set_level(0)
    assert service.readyz()[0] == 200
    out = service.score({"records": trained["requests"][:2]})
    assert len(out["scores"]) == 2 and out["lineage"]


def test_stopped_server_closes_its_socket(trained):
    registry = _registry()
    registry.load(trained["v1"])
    server = GameServer(ServingService(registry), port=0).start()
    server.stop()
    with pytest.raises(OSError):
        _post(f"{server.url}/score", {"record": trained["requests"][0]})


@pytest.mark.parametrize("extra", [
    ["--fleet-shard", "0"], ["--fleet-shard-count", "2"],
    ["--watch-dir", "w"], ["--watch-poll-s", "1"], ["--reqlog-dir", "r"],
    ["--reqlog-sample", "0.5"], ["--reqlog-segment-records", "8"],
    ["--reqlog-max-mb", "1"], ["--autopilot-config", "a.json"],
    ["--max-connections", "4"], ["--canary-gate"], ["--canary-bound", "1"],
    ["--quality-poll-s", "1"], ["--drift-threshold", "0.5"],
    ["--rank-item-coordinate", "perUser"], ["--rank-max-k", "8"],
    ["--history-capacity", "8"], ["--history-period-s", "1"],
    ["--flight-dir", "f"], ["--flight-capacity", "8"],
    ["--watchdog-timeout-s", "1"], ["--telemetry-dir", "t"],
    ["--telemetry-poll-s", "1"], ["--metrics-port", "9"],
], ids=lambda e: e[0][2:])
def test_unported_serve_flag_names_itself(extra):
    with pytest.raises(NotImplementedError, match=extra[0]):
        t_serve.build_server(["--model-dir", "m", "--feature-shards", SHARDS,
                              "--device", "cpu"] + extra)


def test_unported_serve_flags_at_their_default_are_accepted(trained):
    server = t_serve.build_server([
        "--model-dir", trained["v1"], "--feature-shards", SHARDS,
        "--port", "0", "--no-warmup", "--device", "cpu",
        "--max-connections", "0", "--rank-max-k", "128",
        "--drift-threshold", "0.25"]).start()
    try:
        assert server.service.registry.active().engine.compile_count == 0
    finally:
        server.stop()
