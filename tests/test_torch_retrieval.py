"""The port's ranked retrieval (``photon_ml_tpu_torch.retrieval`` and
``/rank``) on the CPU at a tiny size, against brute force and the JAX
package's ``RankingEngine``: a GLMix (fixed, per-user and per-song
coordinates, the per-song one ranked) trained by the port's ``train_game``
on 600 seeded rows of 20 users and 40 songs.

Contracts: at f32 the ranked ids and scores equal scoring every (user,
song) pair through the port's own scoring engine and sorting stably
(``array_equal``), and the ids equal the JAX engine's on the same model
directory; tied scores come back in item order; bf16 and int8 tables rank
with scores within 1e-2 and 5e-2 (relative, floor 1) of the f32 pair
scores and equal to their own format's brute force; ``ItemIndex.
apply_patch`` equals a full rebuild and keeps the padded shape while the
vocabulary grows inside it; ``/rank``'s 400s. On the card the ranking
programs are CUDA graphs; ``chip_smoke.py`` phase 14 runs them.
"""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photon_ml_tpu.serving import ModelRegistry as JRegistry
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.game.model import RandomEffectModel
from photon_ml_tpu_torch.retrieval import ItemIndex, RankingEngine, item_bucket
from photon_ml_tpu_torch.serving import (
    GameServer,
    ModelRegistry,
    ServingService,
)
from photon_ml_tpu_torch.types import TaskType
from test_torch_cli import SHARDS, _write_bench_file

SHARD_CONFIGS = tuple(parse_feature_shard_config(s)
                      for s in SHARDS.split(","))
N_USERS, N_SONGS = 20, 40
#: relative score bounds of the quantized tables (floor 1), as serving's
QUANT_TOL = {"bfloat16": 1e-2, "int8": 5e-2}


def _train_args(train, out):
    return ["--training-data", train, "--output-dir", out,
            "--feature-shards", SHARDS, "--coordinates",
            "global=fixed,shard=global,reg=L2,maxIter=25",
            "perUser=random,entity=userId,shard=item,reg=L2,maxIter=25",
            "perSong=random,entity=songId,shard=item,reg=L2,maxIter=25",
            "--update-sequence", "global,perUser,perSong",
            "--grid", "global=0.01", "perUser=1", "perSong=1",
            "--data-validation", "VALIDATE_DISABLED", "--evaluators", "",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_retrieval")
    train = _write_bench_file(str(d / "train.avro"), 600, 3,
                              users=N_USERS, songs=N_SONGS)
    out = str(d / "run")
    t_train.run(_train_args(train, out))
    return out


def _registry(run, table_dtype="float32", **kw):
    reg = ModelRegistry(SHARD_CONFIGS, table_dtype=table_dtype,
                        device="cpu", rank_coordinate="perSong",
                        rank_max_k=16, **kw)
    return reg.load(run)


def _users():
    """Request records: users with global and item-shard features, one
    cold user and one featureless known user."""
    rng = np.random.default_rng(17)
    out = []
    for i, u in enumerate(["u0", "u3", "u7", "u11", "uCOLD", "u5"]):
        feats = [] if i == 5 else (
            [{"name": f"g.x{j}", "term": "", "value": float(v)}
             for j, v in enumerate(rng.normal(size=6))]
            + [{"name": f"it.x{j}", "term": "", "value": float(v)}
               for j, v in enumerate(rng.normal(size=8))])
        out.append({"features": feats, "metadataMap": {"userId": u},
                    "offset": 0.25 if i == 2 else None})
    return out


def _brute_force(sm, record):
    """Every (record, song) pair through the scoring engine, then a stable
    descending sort: (ids, scores)."""
    items = list(sm.rank_engine.index.item_ids)
    pairs = [dict(record, metadataMap=dict(record["metadataMap"],
                                           songId=s)) for s in items]
    scores = sm.engine.score(pairs)
    order = np.argsort(-scores, kind="stable")
    return [items[i] for i in order], scores[order], dict(zip(items, scores))


def test_f32_ranks_equal_brute_force_and_jax(run):
    sm = _registry(run)
    records = _users()
    ks = [1, 5, 16, 3, 16, 7]
    got = sm.rank(records, ks)
    jsm = JRegistry(SHARD_CONFIGS, rank_coordinate="perSong",
                    rank_max_k=16).load(run)
    want_jax = jsm.rank(records, ks)
    assert sm.rank_engine.index.n_items == N_SONGS
    for rec, k, (ids, scores), (jids, jscores) in zip(
            records, ks, got, want_jax):
        bf_ids, bf_scores, _ = _brute_force(sm, rec)
        assert ids == bf_ids[:k]
        assert scores.dtype == np.float32
        assert np.array_equal(scores, bf_scores[:k])
        assert ids == list(jids)
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-6,
                                   atol=1e-6)
    # chunked past max_batch (8): each record ranks as it does alone
    many = sm.rank(records * 3, [4] * 18)
    for i, (ids, scores) in enumerate(many):
        ids1, scores1 = sm.rank([records[i % 6]], [4])[0]
        assert ids == ids1 and np.array_equal(scores, scores1)


def test_ties_come_back_in_item_order(run):
    sm = _registry(run)
    eng = sm.rank_engine
    # a featureless record scores every song alike: a full tie
    ((ids, scores),) = sm.rank([{"features": [], "metadataMap": {},
                                 "offset": None}], [16])
    assert len(set(scores.tolist())) == 1
    assert ids == list(eng.index.item_ids[:16])
    # songs sharing one coefficient row tie for a record with features
    store = sm.stores["perSong"]
    table = store.table.clone()
    twins = [store.row_of_id[s] for s in eng.index.item_ids[5:30:4]]
    table[twins] = table[store.row_of_id[eng.index.item_ids[2]]].clone()
    tied = RankingEngine(sm.engine, ItemIndex.build(
        dataclasses.replace(store, table=table), "perSong"), max_k=64)
    rec = _users()[0]
    ((ids, scores),) = tied.rank([rec], [N_SONGS])
    pos = {s: i for i, s in enumerate(tied.index.item_ids)}
    n_ties = 0
    for a in range(len(ids) - 1):
        if scores[a] == scores[a + 1]:
            n_ties += 1
            assert pos[ids[a]] < pos[ids[a + 1]]
    assert n_ties >= len(twins)


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
def test_quantized_ranks_hold_their_bounds(run, table_dtype):
    f32 = _registry(run)
    sm = _registry(run, table_dtype)
    for rec in _users()[:5]:
        ((ids, scores),) = sm.rank([rec], [16])
        bf_ids, bf_scores, _ = _brute_force(sm, rec)
        assert ids == bf_ids[:16]
        assert np.array_equal(scores, bf_scores[:16])
        _, _, exact = _brute_force(f32, rec)
        want = np.array([exact[i] for i in ids], np.float64)
        err = np.abs(scores - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= QUANT_TOL[table_dtype], err.max()


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_apply_patch_equals_rebuild(run, table_dtype):
    sm = _registry(run, table_dtype)
    store = sm.stores["perSong"]
    index = sm.rank_engine.index
    assert index.bucket == item_bucket(N_SONGS) == 64
    # re-solve three songs, add two new ones, remove one
    touched = ["s4", "s9", "s17", "sNEW0", "sNEW1"]
    vocab = {raw: i for i, raw in enumerate(touched)}
    rng = np.random.default_rng(5)
    dim = store.dim
    keys = (np.arange(len(touched))[:, None] * dim
            + np.arange(dim)[None, :]).ravel().astype(np.int64)
    update = RandomEffectModel(
        random_effect_type="songId", feature_shard_id="item",
        task=TaskType.LOGISTIC_REGRESSION, dim=dim, keys=keys,
        coeffs=rng.normal(size=keys.size).astype(np.float32))
    patched = store.apply_patch(update, vocab, removed=["s21"])
    got = index.apply_patch(patched, touched + ["s21"])
    want = ItemIndex.build(patched, "perSong")
    assert got.item_ids == want.item_ids and got.n_items == N_SONGS + 2
    assert got.bucket == index.bucket and got.matrix.shape == \
        index.matrix.shape
    assert torch.equal(got.matrix, want.matrix)
    assert (got.scales is None) == (want.scales is None)
    if got.scales is not None:
        assert torch.equal(got.scales, want.scales)
    # the parent's index is untouched (functional update)
    assert index.n_items == N_SONGS
    # a patch-derived engine shares the parent's programs: no new build
    sm.rank_engine.warmup()
    built = sm.rank_engine.compile_count
    child = RankingEngine(sm.engine, got, max_k=16,
                          share_from=sm.rank_engine)
    assert child.warmup() == 0 and child.compile_count == built
    fresh = RankingEngine(sm.engine, want, max_k=16)
    for rec in _users()[:3]:
        a = child.rank([rec], [16])[0]
        b = fresh.rank([rec], [16])[0]
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
    # the parent still ranks its own version after the child ran
    assert sm.rank([_users()[0]], [3])[0][0] == \
        _brute_force(sm, _users()[0])[0][:3]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("payload, match", [
    ({"user": "u1", "k": 0}, "k must be in"),
    ({"user": "u1", "k": 17}, "k must be in"),
    ({"user": "u1", "k": "x"}, "bad k"),
    ({"k": 3}, "needs 'user'"),
], ids=["k-zero", "k-past-max", "k-not-int", "no-user"])
def test_rank_bad_requests_are_400(run, payload, match):
    reg = ModelRegistry(SHARD_CONFIGS, device="cpu",
                        rank_coordinate="perSong", rank_max_k=16)
    reg.load(run)
    service = ServingService(reg)
    with pytest.raises(ValueError, match=match):
        service.rank(payload)
    server = GameServer(service, port=0).start()
    try:
        query = "&".join(f"{k}={v}" for k, v in payload.items())
        status, body = _get(f"{server.url}/rank?{query}")
        assert status == 400 and match.split()[0] in body["error"]
    finally:
        server.stop()


def test_rank_endpoint_serves_and_logs(run, tmp_path):
    from photon_ml_tpu_torch.serving.reqlog import RequestLog

    reg = ModelRegistry(SHARD_CONFIGS, device="cpu",
                        rank_coordinate="perSong", rank_max_k=16)
    sm = reg.load(run)
    log = RequestLog(str(tmp_path / "log"), segment_records=2)
    server = GameServer(ServingService(reg, reqlog=log), port=0).start()
    try:
        status, body = _get(f"{server.url}/rank?user=u3&k=4")
        assert status == 200 and body["k"] == 4 and body["version"] == 1
        rec = {"features": [], "metadataMap": {"userId": "u3"},
               "offset": None}
        ((ids, scores),) = sm.rank([rec], [4])
        assert body["ids"] == ids
        assert body["scores"] == [float(v) for v in scores]
        status, body2 = _post(f"{server.url}/rank",
                              {"record": _users()[1], "k": 2})
        assert status == 200 and len(body2["ids"]) == 2
        health = _get(f"{server.url}/healthz")[1]
        assert health["rank"]["items"] == N_SONGS
        assert health["rank"]["requests"] == 2
        assert health["rank"]["user_re_coordinates"] == ["perUser"]
        # ranking off: a 400, not a 501
        plain = ModelRegistry(SHARD_CONFIGS, device="cpu")
        plain.load(run)
        with pytest.raises(ValueError, match="ranking is not enabled"):
            ServingService(plain).rank({"user": "u3"})
    finally:
        server.stop()
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    logged = [r for f in sorted(os.listdir(tmp_path / "log"))
              if f.endswith(".avro")
              for r in iter_avro_file(str(tmp_path / "log" / f))]
    assert [r["kind"] for r in logged] == ["rank", "rank"]
    assert logged[0]["topk"]["ids"] == body["ids"]
