"""Both ``train_game`` commands on the same Avro with the options this
port's GAME path gained: an elastic-net coordinate with coefficient
variances, the RANDOM projector, a factored coordinate (and its bf16
refusal), ``--tuning RANDOM|BAYESIAN``; model directories with variances
and back-projected coordinates cross-load both ways, and checkpoints with
projector state and random-effect variances restore across the two
packages."""

import os

import numpy as np
import pytest

import photon_ml_tpu.game as jg
import photon_ml_tpu_torch.game as tg
from photon_ml_tpu.cli import train_game as j_cli
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.io.checkpoint import CheckpointManager as JManager
from photon_ml_tpu.io.checkpoint import CoordinateDescentState as JState
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.data_reader import FeatureShardConfig as JShard
from photon_ml_tpu.io.index import IndexMap as JIndexMap
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.cli import train_game as t_cli
from photon_ml_tpu_torch.hyperparameter.search import ParamRange, RandomSearch
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.io.checkpoint import CheckpointManager as TManager
from photon_ml_tpu_torch.io.checkpoint import CoordinateDescentState as TState
from photon_ml_tpu_torch.io.data_reader import AvroDataReader as TReader
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfig as TShard
from photon_ml_tpu_torch.io.index import IndexMap as TIndexMap
from photon_ml_tpu_torch.types import TaskType as TTask
from test_torch_cli import SHARDS, _write_bench_file

#: tests/test_cli.py:71's elastic-net coordinate, with variances (FULL),
#: beside an elastic-net fixed effect and an L2 perSong (SIMPLE)
EN_COORDS = [
    "global=fixed,shard=global,reg=ELASTIC_NET,alpha=0.5,variance=SIMPLE,"
    "maxIter=25",
    "perUser=random,entity=userId,shard=item,reg=ELASTIC_NET,alpha=0.7,"
    "variance=FULL,maxIter=25",
    "perSong=random,entity=songId,shard=item,reg=L2,variance=SIMPLE,"
    "maxIter=25",
]
#: tests/test_cli.py:444-475's factored coordinate and a RANDOM perSong
PROJ_COORDS = [
    "global=fixed,shard=global,reg=L2,maxIter=25",
    "perUser=factored,entity=userId,shard=item,projectedDim=2,"
    "factoredIterations=1,lamProjection=0.5,reg=L2,maxIter=25,"
    "cacheBuckets=false",
    "perSong=random,entity=songId,shard=item,reg=L2,projector=RANDOM,"
    "projectedDim=3,maxIter=25",
]
GRID = ["--grid", "global=1", "perUser=3", "perSong=3"]


def _args(train, valid, coords, extra=()):
    return ["--training-data", train, "--validation-data", valid,
            "--feature-shards", SHARDS, "--coordinates", *coords,
            "--update-sequence", "global,perUser,perSong",
            "--data-validation", "VALIDATE_DISABLED", "--evaluators", "AUC",
            *extra]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_options_data")
    return (_write_bench_file(str(d / "train.avro"), 2000, 1),
            _write_bench_file(str(d / "valid.avro"), 1000, 2))


def _both(files, tmp_path_factory, name, coords, extra=GRID):
    d = tmp_path_factory.mktemp(name)
    args = _args(*files, coords, extra)
    t_dir, j_dir = str(d / "port"), str(d / "jax")
    t_res = t_cli.run(args + ["--output-dir", t_dir, "--device", "cpu"])
    j_res = j_cli.run(args + ["--output-dir", j_dir])
    return t_res, t_dir, j_res, j_dir


KINDS = {"elastic-net": EN_COORDS, "projected": PROJ_COORDS}


@pytest.fixture(scope="module")
def run_of(files, tmp_path_factory):
    """``run_of(kind)``: both commands' (result, dir) pairs on ``kind``'s
    coordinates, each run once."""
    done = {}

    def get(kind):
        if kind not in done:
            done[kind] = (kind,) + _both(files, tmp_path_factory, kind,
                                         KINDS[kind])
        return done[kind]

    return get


def _loaders(run_dir, valid):
    """Each package's view of a run's saved model: (data, model)."""
    out = {}
    for name, reader_cls, shard_cls, imap_cls, io in (
            ("port", TReader, TShard, TIndexMap, tio),
            ("jax", JReader, JShard, JIndexMap, jio)):
        shards = tuple(shard_cls(*s) for s in (
            ("global", ("g",), True), ("item", ("it",), False)))
        maps = {s.shard_id: imap_cls.load(os.path.join(
            run_dir, "feature-indexes", f"{s.shard_id}.json"))
            for s in shards}
        reader = reader_cls(shard_configs=shards, index_maps=maps)
        vdata, _, vocabs = reader.read(valid, id_columns=("userId", "songId"))
        kw = {"device": "cpu"} if io is tio else {}
        out[name] = vdata, io.load_game_model(
            io.resolve_game_model_dir(run_dir), maps, vocabs, **kw)
    return out


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_auc_and_best_config_match(run_of, kind):
    _, t_res, _, j_res, _ = run_of(kind)
    assert t_res["best_config"] == j_res["best_config"]
    ta, ja = t_res["best_evaluation"]["AUC"], j_res["best_evaluation"]["AUC"]
    assert ta > 0.6
    # tests/test_torch_cli.py's limit for the same command
    assert abs(ta - ja) < 1e-4, (ta, ja)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_model_dirs_cross_load(run_of, files, writer, kind):
    """Either package's directory loads in both with the same coefficients
    and variances, and scores the validation file alike."""
    kind, _, t_dir, _, j_dir = run_of(kind)
    views = _loaders(t_dir if writer == "port" else j_dir, files[1])
    (tdata, tm), (jdata, jm) = views["port"], views["jax"]
    for cid, a in tm.coordinates.items():
        b = jm.coordinates[cid]
        if isinstance(a, tg.FixedEffectModel):
            np.testing.assert_array_equal(
                a.model.coefficients.means.numpy(),
                np.asarray(b.model.coefficients.means))
            va, vb = a.model.coefficients.variances, \
                b.model.coefficients.variances
            if kind == "elastic-net":
                np.testing.assert_array_equal(va.numpy(), np.asarray(vb))
            continue
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.coeffs, b.coeffs)
        assert a.projector is None  # written back in shard space
        if kind == "elastic-net":
            np.testing.assert_array_equal(a.variances, b.variances)
        else:
            assert a.variances is None and b.variances is None
    np.testing.assert_allclose(tm.score(tdata), jm.score(jdata), rtol=1e-6,
                               atol=1e-6)


def test_elastic_net_records_carry_variances_and_zeros(run_of):
    _, _, t_dir, _, _ = run_of("elastic-net")
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    part = os.path.join(t_dir, "best", "random-effect", "perUser",
                        "coefficients", "part-00000.avro")
    recs = list(iter_avro_file(part))
    assert recs and all(r["variances"] is not None for r in recs)
    for r in recs:
        assert [(e["name"], e["term"]) for e in r["means"]] == \
            [(e["name"], e["term"]) for e in r["variances"]]
    # the L1 part zeroes coefficients, which the files leave out
    n_means = sum(len(r["means"]) for r in recs)
    assert n_means < len(recs) * 8


def test_projected_model_scores_as_in_memory(run_of, files):
    """The saved (back-projected) model scores the validation file as the
    command reported (the in-memory projected model's AUC)."""
    _, t_res, t_dir, _, _ = run_of("projected")
    from photon_ml_tpu_torch.evaluation import parse_evaluators

    tdata, tm = _loaders(t_dir, files[1])["port"]
    auc = parse_evaluators(["AUC"])[0].evaluate(tm.score(tdata),
                                                tdata.labels, tdata.weights)
    assert abs(auc - t_res["best_evaluation"]["AUC"]) < 1e-6


def test_factored_refuses_bf16_designs(files, tmp_path):
    with pytest.raises(SystemExit, match="factored"):
        t_cli.run(_args(*files, PROJ_COORDS[:2], GRID[:3]) + [
            "--output-dir", str(tmp_path / "o"), "--device", "cpu",
            "--design-dtype", "bfloat16", "--update-sequence",
            "global,perUser"])


@pytest.fixture(scope="module")
def tuned(files, tmp_path_factory):
    coords = [c.replace("variance=SIMPLE,", "").replace("variance=FULL,", "")
              for c in EN_COORDS]
    out = {}
    for mode in ("RANDOM", "BAYESIAN"):
        out[mode] = _both(files, tmp_path_factory, f"tuning-{mode}", coords,
                          ["--tuning", mode, "--tuning-iterations", "3",
                           "--tuning-range", "1e-3:1e3",
                           "--output-all-models"])
    return out


@pytest.mark.parametrize("mode", ["RANDOM", "BAYESIAN"])
def test_tuning_matches_jax(tuned, files, mode):
    t_res, t_dir, j_res, _ = tuned[mode]
    assert t_res["n_configurations"] == j_res["n_configurations"] == 3
    assert sorted(os.listdir(os.path.join(t_dir, "all"))) == [
        "config-0", "config-1", "config-2"]
    best = t_res["best_config"]
    assert set(best) == {"global", "perUser", "perSong"}
    assert all(1e-3 <= v <= 1e3 for v in best.values())
    if mode == "RANDOM":
        # the search's points do not depend on the fits: the same three in
        # both packages, and the same winner
        space = {c: ParamRange(1e-3, 1e3)
                 for c in ("global", "perUser", "perSong")}
        points = RandomSearch(space).find(lambda cfg: 0.0, 3).configs
        assert best in points
        assert best == j_res["best_config"]
        assert abs(t_res["best_evaluation"]["AUC"]
                   - j_res["best_evaluation"]["AUC"]) < 1e-4
    # best/ rescored by the port gives the reported AUC
    from photon_ml_tpu_torch.evaluation import parse_evaluators

    tdata, tm = _loaders(t_dir, files[1])["port"]
    auc = parse_evaluators(["AUC"])[0].evaluate(tm.score(tdata),
                                                tdata.labels, tdata.weights)
    assert abs(auc - t_res["best_evaluation"]["AUC"]) < 1e-6


# --- checkpoints across the packages ------------------------------------------

def _state(pkg):
    rng = np.random.default_rng(3)
    keys = np.sort(rng.choice(30, 12, replace=False)).astype(np.int64)
    coeffs = rng.normal(size=12).astype(np.float32)
    var = rng.uniform(0.1, 1, size=12).astype(np.float32)
    matrix = rng.normal(size=(3, 7)).astype(np.float32)
    task = (JTask if pkg is jg else TTask).LOGISTIC_REGRESSION
    model = pkg.GameModel(coordinates={
        "perSong": pkg.RandomEffectModel(
            random_effect_type="songId", feature_shard_id="item", task=task,
            dim=3, keys=keys, coeffs=coeffs, variances=var,
            projector=pkg.RandomProjector(matrix=matrix)),
        "perUser": pkg.RandomEffectModel(
            random_effect_type="userId", feature_shard_id="item", task=task,
            dim=7, keys=keys, coeffs=-coeffs, variances=2 * var)},
        task=task)
    scores = {"perSong": rng.normal(size=5).astype(np.float32),
              "perUser": rng.normal(size=5).astype(np.float32)}
    return (JState if pkg is jg else TState)(
        sweep=1, coordinate_index=0, model=model, scores=scores)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_with_projector_and_variances_restore_across(tmp_path,
                                                                 writer):
    save_mgr, load_mgr = ((TManager, JManager) if writer == "port"
                          else (JManager, TManager))
    save_mgr(str(tmp_path)).save(
        2, _state(tg if writer == "port" else jg), fingerprint="fp")
    kw = {"device": "cpu"} if load_mgr is TManager else {}
    got = load_mgr(str(tmp_path)).restore(expected_fingerprint="fp", **kw)
    want = _state(jg)
    for cid, b in want.model.coordinates.items():
        a = got.model.coordinates[cid]
        for f in ("keys", "coeffs", "variances"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f))
        assert (a.projector is None) == (b.projector is None)
        if b.projector is not None:
            np.testing.assert_array_equal(a.projector.matrix,
                                          b.projector.matrix)
    for cid, v in want.scores.items():
        np.testing.assert_array_equal(np.asarray(got.scores[cid]), v)
    assert (got.sweep, got.coordinate_index) == (1, 0)
