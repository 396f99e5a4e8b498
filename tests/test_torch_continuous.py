"""The port's continuous-training path against the JAX package's:
``continuous/delta.py`` (fingerprints, manifests, deltas),
``continuous/refresh.py`` and ``refresh_game``, on the data of
``tests/test_continuous.py`` (600 records; a refresh where 2 users mutate
and 1 user is new), the port on the CPU. The same touched, carried and
solved counts; carried coefficients bit-identical to the prior; merged
models equal at the GAME tolerances; lineage chained to the prior; and the
port's patch applied by the JAX package's ``ModelRegistry.load_patch``
scoring bit for bit like a full load of the port's merged model."""

import json
import os

import numpy as np
import pytest

from photon_ml_tpu.cli import refresh_game as j_refresh
from photon_ml_tpu.cli import train_game as j_train
from photon_ml_tpu.continuous import delta as j_delta
from photon_ml_tpu.game.model import RandomEffectModel as JREModel
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.io.model_io import model_lineage_id as j_lineage_id
from photon_ml_tpu.serving import ModelRegistry
from photon_ml_tpu.cli.config import parse_feature_shard_config as j_shard
from photon_ml_tpu_torch.__main__ import _COMMANDS
from photon_ml_tpu_torch.cli import refresh_game as t_refresh
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.continuous import delta as t_delta
from photon_ml_tpu_torch.game.model import RandomEffectModel as TREModel
from photon_ml_tpu_torch.io.data_reader import AvroDataReader as TReader
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.io.model_io import (
    game_model_entity_vocabs,
    load_game_model,
    model_kind,
    model_lineage_id,
)
from photon_ml_tpu_torch.io.pipeline import save_model_patch_atomic
from photon_ml_tpu_torch.resilience import FaultPlan, FaultSpec, injected
from photon_ml_tpu_torch.telemetry import metrics as tmetrics
from photon_ml_tpu_torch.types import TaskType
from test_torch_cli import (
    _margins,
    assert_baselines_close,
    assert_baselines_cross_load,
)

SHARDS = "global=fixed|intercept,user=user|noIntercept"
SHARD_IDS = ("global", "user")
COMMON = [
    "--feature-shards", SHARDS,
    "--coordinates", "global=fixed,shard=global,reg=L2",
    "perUser=random,entity=userId,shard=user,reg=L2",
    "--update-sequence", "global,perUser",
    "--grid", "global=0.1", "perUser=1",
    "--evaluators", "",
]
D_FIXED, D_USER, N_USERS = 6, 3, 12
MUTATED = (1, 3)
K_TOUCHED = len(MUTATED) + 1  # two mutated users and one new user
#: tests/test_torch_game.py's f32 GAME tolerances (fixed, random effect)
TOL = dict(rtol=1e-3, atol=1e-4)
RE_TOL = dict(rtol=2e-3, atol=5e-4)


def _records(n, seed, *, mutate_users=(), new_users=0, cold_users=0):
    """tests/test_continuous.py::_records: mixed-effect logistic records
    whose first ``n`` rows are a function of ``seed`` alone; mutated users'
    feature rows scaled by 1.25, 8 appended rows per new user, the last
    ``cold_users`` rows relabelled with ids no model has seen."""
    prng = np.random.default_rng(777)
    w = prng.normal(size=D_FIXED)
    u = 1.5 * prng.normal(size=(N_USERS + max(new_users, 1), D_USER))
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(n, D_FIXED))
    xu = rng.normal(size=(n, D_USER))
    users = rng.integers(0, N_USERS, size=n)
    xu = np.where(np.isin(users, list(mutate_users))[:, None], xu * 1.25, xu)
    margin = xf @ w + np.einsum("nd,nd->n", xu, u[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(float)
    if new_users:
        rng2 = np.random.default_rng(seed + 5000)
        m = 8 * new_users
        xf2 = rng2.normal(size=(m, D_FIXED))
        xu2 = rng2.normal(size=(m, D_USER))
        users2 = N_USERS + np.arange(new_users).repeat(8)
        margin2 = xf2 @ w + np.einsum("nd,nd->n", xu2, u[users2])
        y2 = (rng2.uniform(size=m) < 1 / (1 + np.exp(-margin2))).astype(
            float)
        xf, xu = np.concatenate([xf, xf2]), np.concatenate([xu, xu2])
        users, y = np.concatenate([users, users2]), np.concatenate([y, y2])
    out = []
    for i in range(len(y)):
        feats = [{"name": f"fixed.x{j}", "term": "", "value": float(xf[i, j])}
                 for j in range(D_FIXED)]
        feats += [{"name": f"user.z{j}", "term": "",
                   "value": float(xu[i, j])} for j in range(D_USER)]
        uid = f"uCOLD{i}" if i >= len(y) - cold_users else f"u{users[i]}"
        out.append({"uid": str(i), "response": float(y[i]), "offset": None,
                    "weight": None, "features": feats,
                    "metadataMap": {"userId": uid}})
    return out


def _solved(coordinate):
    fam = tmetrics.default_registry().get(
        "photon_refresh_solved_entities_total")
    return 0.0 if fam is None else fam.labels(coordinate=coordinate).value


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """Day 0 and day 1 data; each package's train_game on day 0 and
    refresh_game on day 1; the port's refresh also from the JAX prior."""
    tmp = str(tmp_path_factory.mktemp("torch_continuous"))
    d0, d1 = os.path.join(tmp, "d0.avro"), os.path.join(tmp, "d1.avro")
    write_training_examples(d0, _records(600, 0))
    write_training_examples(d1, _records(600, 0, mutate_users=MUTATED,
                                         new_users=1))
    p = {k: os.path.join(tmp, k) for k in ("j0", "j1", "t0", "t1", "tj1")}
    cpu = ["--device", "cpu"]
    j_train.run(["--training-data", d0, "--output-dir", p["j0"]] + COMMON)
    t_train.run(["--training-data", d0, "--output-dir", p["t0"]] + COMMON
                + cpu)
    res = {"j1": j_refresh.run(["--prior-dir", p["j0"], "--training-data",
                                d1, "--output-dir", p["j1"]] + COMMON)}
    before = _solved("perUser")
    res["t1"] = t_refresh.run(["--prior-dir", p["t0"], "--training-data", d1,
                               "--output-dir", p["t1"]] + COMMON + cpu)
    solved_delta = _solved("perUser") - before
    res["tj1"] = t_refresh.run(["--prior-dir", p["j0"], "--training-data",
                                d1, "--output-dir", p["tj1"]] + COMMON + cpu)
    return dict(tmp=tmp, d0=d0, d1=d1, paths=p, results=res,
                solved_delta=solved_delta,
                requests=_records(60, 11, cold_users=4))


def _maps(run):
    return {s: IndexMap.load(os.path.join(run, "feature-indexes",
                                          f"{s}.json")) for s in SHARD_IDS}


def _load(run, sub="best"):
    d = os.path.join(run, sub)
    vocabs = game_model_entity_vocabs(d)
    return load_game_model(d, _maps(run), vocabs, device="cpu"), vocabs


def _row(re, dense):
    """One entity's dense coefficient row (0 where absent)."""
    return re.lookup(np.full(re.dim, dense), np.arange(re.dim))


def _rows_by_raw(model, vocabs, cid="perUser"):
    re = model.coordinates[cid]
    return {raw: _row(re, dense) for raw, dense in vocabs["userId"].items()}


# --- delta: fingerprints, manifests, deltas ---------------------------------

def _read_both(records, tmp_path):
    path = str(tmp_path / "x.avro")
    write_training_examples(path, records)
    t = TReader(shard_configs=tuple(parse_feature_shard_config(s)
                                    for s in SHARDS.split(","))).read(
        path, id_columns=("userId",))
    j = JReader(shard_configs=tuple(j_shard(s) for s in SHARDS.split(","))
                ).read(path, id_columns=("userId",))
    return t, j


def test_fingerprints_and_manifest_equal_jax(tmp_path):
    (td, _, tv), (jd, _, jv) = _read_both(
        _records(200, 7, mutate_users=(2,), new_users=1), tmp_path)
    assert t_delta.entity_fingerprints(td, "userId", "user") == \
        j_delta.entity_fingerprints(jd, "userId", "user")
    coords = {"perUser": ("userId", "user")}
    tm = t_delta.build_manifest(td, coords, tv)
    jm = j_delta.build_manifest(jd, coords, jv)
    assert tm == jm
    assert t_delta.manifest_digest(tm) == j_delta.manifest_digest(jm)
    path = str(tmp_path / "m.json")
    t_delta.save_manifest(path, tm)
    assert j_delta.load_manifest(path) == jm
    assert t_delta.load_manifest(str(tmp_path / "none.json")) is None


def test_fingerprints_are_row_order_invariant(tmp_path):
    recs = _records(200, 7)
    (da, _, va), _ = _read_both(recs, tmp_path)
    order = np.random.default_rng(0).permutation(len(recs))
    (db, _, vb), _ = _read_both([recs[i] for i in order], tmp_path)
    fa = t_delta.entity_fingerprints(da, "userId", "user")
    fb = t_delta.entity_fingerprints(db, "userId", "user")
    assert ({raw: fa[d] for raw, d in va["userId"].items()}
            == {raw: fb[d] for raw, d in vb["userId"].items()})


def test_coordinate_deltas_equal_jax(tmp_path):
    coords = {"perUser": ("userId", "user")}
    (ta, _, tva), (ja, _, jva) = _read_both(_records(300, 3), tmp_path)
    (tb, _, tvb), (jb, _, jvb) = _read_both(
        _records(300, 3, mutate_users=(2, 5), new_users=1), tmp_path)
    tm_a, tm_b = (t_delta.build_manifest(ta, coords, tva),
                  t_delta.build_manifest(tb, coords, tvb))
    jm_a, jm_b = (j_delta.build_manifest(ja, coords, jva),
                  j_delta.build_manifest(jb, coords, jvb))
    for prev_t, prev_j in ((tm_a, jm_a), (None, None)):
        td = t_delta.coordinate_deltas(prev_t, tm_b)["perUser"]
        jd = j_delta.coordinate_deltas(prev_j, jm_b)["perUser"]
        assert (td.touched, td.carried) == (jd.touched, jd.carried)
    d = t_delta.coordinate_deltas(tm_a, tm_b)["perUser"]
    assert set(d.touched) == {"u2", "u5", f"u{N_USERS}"}


def test_merge_equals_jax():
    rng = np.random.default_rng(3)
    dim = 5

    def table(entities):
        keys = np.sort(np.concatenate(
            [e * dim + rng.choice(dim, 3, replace=False) for e in entities]))
        return keys.astype(np.int64), rng.normal(size=len(keys)).astype(
            np.float32)

    (pk, pc), (uk, uc) = table(range(8)), table([1, 4, 9])
    kw = dict(random_effect_type="userId", feature_shard_id="user",
              task=TaskType.LOGISTIC_REGRESSION, dim=dim)
    t = TREModel(keys=pk, coeffs=pc, **kw).merge(
        TREModel(keys=uk, coeffs=uc, **kw), drop_entities=[6])
    jkw = dict(kw, task=kw["task"].value)
    from photon_ml_tpu.types import TaskType as JTask

    jkw["task"] = JTask(jkw["task"])
    j = JREModel(keys=pk, coeffs=pc, **jkw).merge(
        JREModel(keys=uk, coeffs=uc, **jkw), drop_entities=[6])
    np.testing.assert_array_equal(t.keys, j.keys)
    np.testing.assert_array_equal(t.coeffs, np.asarray(j.coeffs))
    assert t.n_entities == j.n_entities == 8
    for e in (9, 0, 6, 4, 12):
        np.testing.assert_array_equal(_row(t, e), j.entity_rows([e])[0])


# --- refresh_game against the JAX package's ---------------------------------

def test_counts_equal_jax(loop):
    j, t, tj = (loop["results"][k] for k in ("j1", "t1", "tj1"))
    for key in ("touched", "carried", "solved"):
        assert t[key] == tj[key] == j[key], key
    assert t["solved"]["perUser"] == t["touched"]["perUser"] == K_TOUCHED
    assert t["carried"]["perUser"] == N_USERS - len(MUTATED)
    assert loop["solved_delta"] == K_TOUCHED


@pytest.mark.parametrize("refresh,prior", [("t1", "t0"), ("tj1", "j0")])
def test_carried_coefficients_bit_identical_to_prior(loop, refresh, prior):
    p = loop["paths"]
    m0, v0 = _load(p[prior])
    m1, v1 = _load(p[refresh])
    rows0, rows1 = _rows_by_raw(m0, v0), _rows_by_raw(m1, v1)
    touched = {f"u{i}" for i in MUTATED} | {f"u{N_USERS}"}
    for raw, row in rows0.items():
        if raw not in touched:
            assert np.array_equal(row, rows1[raw]), raw
    for raw in touched - {f"u{N_USERS}"}:
        assert not np.array_equal(rows0[raw], rows1[raw]), raw
    assert f"u{N_USERS}" in rows1 and f"u{N_USERS}" not in rows0


def test_merged_model_equals_jax(loop):
    """The port's refresh of the JAX prior against the JAX refresh of the
    same prior: the fixed effect and every entity row at the GAME
    tolerances."""
    p = loop["paths"]
    tm, tv = _load(p["tj1"])
    jm, jv = _load(p["j1"])
    np.testing.assert_allclose(
        tm.coordinates["global"].model.coefficients.means.numpy(),
        jm.coordinates["global"].model.coefficients.means.numpy(), **TOL)
    tr, jr = _rows_by_raw(tm, tv), _rows_by_raw(jm, jv)
    assert set(tr) == set(jr)
    for raw in tr:
        np.testing.assert_allclose(tr[raw], jr[raw], **RE_TOL, err_msg=raw)


def test_lineage_chains_to_prior(loop):
    p = loop["paths"]
    for refresh, prior in (("t1", "t0"), ("tj1", "j0")):
        with open(os.path.join(p[refresh], "best",
                               "model-metadata.json")) as f:
            md = json.load(f)
        assert md["parentModel"] == model_lineage_id(p[prior]) \
            == j_lineage_id(p[prior])
        manifest = t_delta.load_manifest(
            os.path.join(p[refresh], "data-manifest.json"))
        assert md["dataManifest"] == t_delta.manifest_digest(manifest)
        with open(os.path.join(p[refresh], "patch",
                               "model-metadata.json")) as f:
            pmd = json.load(f)
        assert pmd["kind"] == "coefficient-patch"
        assert pmd["parentModel"] == md["parentModel"]
        assert pmd["modelId"] == model_lineage_id(
            os.path.join(p[refresh], "best"))
    # the two packages' manifests of day 1 are the same document
    assert (t_delta.load_manifest(os.path.join(p["t1"], "data-manifest.json"))
            == j_delta.load_manifest(os.path.join(p["j1"],
                                                  "data-manifest.json")))


def test_refresh_writes_the_quality_baseline(loop):
    """Both packages' refresh of the JAX prior write the same run-root
    files, quality-baseline.json among them (profiled on the day-1
    training data: the runs have no validation file), held as
    tests/test_torch_cli.py holds train_game's and read across."""
    p = loop["paths"]
    assert sorted(os.listdir(p["tj1"])) == sorted(os.listdir(p["j1"]))
    ids = ("userId",)
    tm = _margins(p["tj1"], loop["d1"], SHARDS, ids)
    assert_baselines_close(p["tj1"], p["j1"], tm,
                           _margins(p["j1"], loop["d1"], SHARDS, ids),
                           len(tm["total"]))
    assert_baselines_cross_load(p["tj1"], p["j1"], SHARDS)
    with open(os.path.join(p["t1"], "quality-baseline.json")) as f:
        lineage = json.load(f)["lineage"]
    assert lineage["parentModel"] == model_lineage_id(p["t0"])


def test_patch_holds_exactly_the_solved_rows(loop):
    """Patch rows equal their merged-model rows; no carried entity rides
    the patch; the new user is in it; the metadata matches the JAX
    patch's but for the run's identities."""
    p = loop["paths"]
    merged, mv = _load(p["t1"])
    patch, pv = _load(p["t1"], "patch")
    assert model_kind(os.path.join(p["t1"], "patch")) == "coefficient-patch"
    touched = {f"u{i}" for i in MUTATED} | {f"u{N_USERS}"}
    assert set(pv["userId"]) == touched
    rows_m = _rows_by_raw(merged, mv)
    for raw, row in _rows_by_raw(patch, pv).items():
        assert np.array_equal(row, rows_m[raw]), raw
    np.testing.assert_array_equal(
        patch.coordinates["global"].model.coefficients.means.numpy(),
        merged.coordinates["global"].model.coefficients.means.numpy())
    meta = {}
    for k in ("t1", "j1"):
        with open(os.path.join(p[k], "patch", "model-metadata.json")) as f:
            meta[k] = json.load(f)
        for field in ("modelId", "parentModel", "trainedAt", "dataManifest"):
            meta[k].pop(field)
    assert meta["t1"] == meta["j1"]


def test_jax_registry_applies_the_port_patch_bit_identically(loop):
    """The cross-load: the JAX registry patches the port's prior with the
    port's patch, and scores bit for bit as its full load of the port's
    merged model — touched, untouched and cold users alike; the new user
    appends a row."""
    p = loop["paths"]
    shard_configs = tuple(j_shard(s) for s in SHARDS.split(","))
    ra = ModelRegistry(shard_configs)
    v1 = ra.load(p["t0"])
    sm = ra.reload(os.path.join(p["t1"], "patch"))  # dispatches on kind
    rb = ModelRegistry(shard_configs)
    full = rb.load(p["t1"])
    assert ra.active_version == 2
    assert np.array_equal(ra.active().score(loop["requests"]),
                          rb.active().score(loop["requests"]))
    assert sm.lineage == full.lineage
    new_raw = f"u{N_USERS}"
    assert new_raw not in v1.stores["perUser"].row_of_id
    assert new_raw in ra.active().stores["perUser"].row_of_id


def test_refresh_on_unchanged_data_solves_nothing(loop, tmp_path):
    out = str(tmp_path / "noop")
    res = t_refresh.run(["--prior-dir", loop["paths"]["t0"],
                         "--training-data", loop["d0"], "--output-dir", out,
                         "--device", "cpu"] + COMMON)
    assert res["solved"]["perUser"] == res["touched"]["perUser"] == 0
    assert res["carried"]["perUser"] == N_USERS
    with open(os.path.join(out, "patch", "model-metadata.json")) as f:
        assert sorted(json.load(f)["coordinates"]) == ["global"]
    m0, v0 = _load(loop["paths"]["t0"])
    m1, _ = _load(out)
    re0, re1 = m0.coordinates["perUser"], m1.coordinates["perUser"]
    np.testing.assert_array_equal(re0.keys, re1.keys)
    np.testing.assert_array_equal(re0.coeffs, re1.coeffs)


def test_refresh_coordinates_pins_the_others(loop, tmp_path):
    out = str(tmp_path / "pinned")
    res = t_refresh.run(["--prior-dir", loop["paths"]["t0"],
                         "--training-data", loop["d1"], "--output-dir", out,
                         "--refresh-coordinates", "perUser", "--no-patch",
                         "--device", "cpu"] + COMMON)
    assert res["solved"]["perUser"] == K_TOUCHED
    assert res["patch_dir"] is None
    assert not os.path.exists(os.path.join(out, "patch"))
    with pytest.raises(SystemExit, match="unknown random-effect"):
        t_refresh.run(["--prior-dir", loop["paths"]["t0"],
                       "--training-data", loop["d1"], "--output-dir", out,
                       "--refresh-coordinates", "global", "--device",
                       "cpu"] + COMMON)


def test_fault_mid_patch_save_retries_and_publishes(loop, tmp_path):
    src = os.path.join(loop["paths"]["t1"], "patch")
    maps = _maps(loop["paths"]["t1"])
    vocabs = game_model_entity_vocabs(src)
    models = dict(load_game_model(src, maps, vocabs,
                                  device="cpu").coordinates)
    out = str(tmp_path / "patch-copy")
    plan = FaultPlan([FaultSpec(site="io.delta_publish", at=(0,))])
    with injected(plan):
        nbytes = save_model_patch_atomic(
            out, models, maps, vocabs, task=TaskType.LOGISTIC_REGRESSION,
            parent_model="p", model_id="m")
    assert plan.fired("io.delta_publish")
    assert model_kind(out) == "coefficient-patch"
    assert nbytes == sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(out) for f in fs)
    assert [n for n in os.listdir(tmp_path) if n.endswith(".tmp")] == []


@pytest.mark.parametrize("extra,match", [
    (["--metrics-port", "9"], "--metrics-port"),
    (["--telemetry-dir", "t"], "--telemetry-dir"),
], ids=["metrics-port", "telemetry-dir"])
def test_refresh_unported_flags_name_themselves(tmp_path, extra, match):
    # the telemetry flags are ported (tests/test_torch_telemetry.py runs
    # the plane): they parse into the telemetry configuration
    from photon_ml_tpu_torch.cli.config import telemetry_from_args

    args = t_refresh.build_parser().parse_args(
        ["--prior-dir", "p", "--training-data", "x",
         "--output-dir", str(tmp_path)] + COMMON + extra)
    config = telemetry_from_args(args)
    dest = match[2:].replace("-", "_")
    assert str(getattr(args, dest)) == extra[1]
    assert extra[1] in (str(config.telemetry_dir), str(config.metrics_port))


def test_refresh_needs_a_card_unless_told(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_refresh.run(["--prior-dir", "p", "--training-data", "x",
                       "--output-dir", str(tmp_path)] + COMMON)
    assert _COMMANDS["refresh_game"] == "photon_ml_tpu_torch.cli.refresh_game"
