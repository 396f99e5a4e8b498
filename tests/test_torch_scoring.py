"""The port's batch scoring against the JAX package's, on the CPU at a tiny
size: the grouped metrics and the evaluator grammar (``AUC:<tag>``,
``PRECISION@k:<tag>``), ``GameTransformer``, and ``score_game`` end to end
on a model directory the JAX ``train_game`` wrote (500 rows, one fixed and
one per-user random coordinate) and on one the port's ``train_game`` wrote:
the same ``scores.avro`` records, the same breakdown JSON and the same
evaluation, with the native writer and with the Python fallback. Also the
grouped evaluators through the port's ``train_game`` and ``train_glm``,
the flags ``score_game`` refuses, its device default and the module runner.
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import score_game as j_score
from photon_ml_tpu.cli import train_game as j_train
from photon_ml_tpu.evaluation import parse_evaluator as j_parse
from photon_ml_tpu.evaluation import parse_evaluators as j_parse_all
from photon_ml_tpu.evaluation.grouped import grouped_auc as j_grouped_auc
from photon_ml_tpu.evaluation.grouped import (
    grouped_precision_at_k as j_grouped_precision,
)
from photon_ml_tpu.game.transformer import GameTransformer as JTransformer
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.io.avro import read_avro_file as j_read_avro
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.data_reader import FeatureShardConfig as JShard
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.io.index import IndexMap as JIndexMap
from photon_ml_tpu_torch import native as t_native
from photon_ml_tpu_torch.__main__ import main as t_main
from photon_ml_tpu_torch.cli import score_game as t_score
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.cli import train_glm as t_train_glm
from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.evaluation import parse_evaluator as t_parse
from photon_ml_tpu_torch.evaluation import parse_evaluators as t_parse_all
from photon_ml_tpu_torch.evaluation.grouped import grouped_auc
from photon_ml_tpu_torch.evaluation.grouped import grouped_precision_at_k
from photon_ml_tpu_torch.game.transformer import GameTransformer
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.io.avro import read_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader as TReader
from photon_ml_tpu_torch.io.index import IndexMap as TIndexMap

SHARDS = "global=fixed|intercept,user=user|noIntercept"
COORDS = ["global=fixed,shard=global,reg=L2",
          "perUser=random,entity=userId,shard=user,reg=L2"]
D_FIXED, D_USER, N_USERS = 6, 3, 9
EVALUATORS = "AUC,AUC:queryId,PRECISION@3:queryId,LOGISTIC_LOSS,RMSE"
#: the JAX package computes a whole-dataset metric in its inputs' dtype
#: (f32 scores: f32 sums), the port in f64; grouped metrics are host f64
#: numpy in both
F32_METRIC_TOL = 1e-6


def _hold_evaluation(got, jax_eval, scores, labels, weights, id_tags):
    """``got`` (the port's evaluation dict) equals the JAX evaluators on
    the same scores widened to f64 to 1e-12, and the JAX command's own
    evaluation to 1e-9 (grouped) or its f32 rounding (whole-dataset)."""
    f64 = {k: np.asarray(v, np.float64) for k, v in
           (("s", scores), ("y", labels), ("w", weights))}
    assert got.keys() == jax_eval.keys()
    for name, val in got.items():
        ev = j_parse(name)
        want = float(ev.evaluate(f64["s"], f64["y"], f64["w"], id_tags))
        assert abs(val - want) <= 1e-12 * max(1.0, abs(want)), name
        tol = 1e-9 if ev.id_tag else F32_METRIC_TOL
        assert abs(val - jax_eval[name]) <= tol, name


def _records(n, seed, *, cold_users=0):
    """Mixed-effect logistic records with a ``queryId`` tag (missing on
    every seventh record) and offsets on every third; the last
    ``cold_users`` name users outside the training universe."""
    prng = np.random.default_rng(777)
    w = prng.normal(size=D_FIXED)
    u = 1.5 * prng.normal(size=(N_USERS, D_USER))
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(n, D_FIXED))
    xu = rng.normal(size=(n, D_USER))
    users = rng.integers(0, N_USERS, size=n)
    queries = rng.integers(0, 12, size=n)
    off = rng.normal(size=n)
    margin = xf @ w + np.einsum("nd,nd->n", xu, u[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(float)
    out = []
    for i in range(n):
        feats = [{"name": f"fixed.x{j}", "term": "", "value": float(xf[i, j])}
                 for j in range(D_FIXED)]
        feats += [{"name": f"user.z{j}", "term": "", "value": float(xu[i, j])}
                  for j in range(D_USER)]
        meta = {"userId": (f"uCOLD{i}" if i >= n - cold_users
                           else f"u{users[i]}")}
        if i % 7:
            meta["queryId"] = f"q{queries[i]}"
        out.append({"uid": str(i), "response": float(y[i]),
                    "offset": float(off[i]) if i % 3 == 0 else None,
                    "weight": None, "features": feats, "metadataMap": meta})
    return out


def _train_args(train, out):
    return ["--training-data", train, "--output-dir", out,
            "--feature-shards", SHARDS, "--coordinates", *COORDS,
            "--update-sequence", "global,perUser",
            "--grid", "global=0.1", "perUser=1", "--evaluators", ""]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A run dir of each package's train_game on the same 500 rows, and 80
    rows to score (4 cold users)."""
    tmp = str(tmp_path_factory.mktemp("torch_scoring"))
    train = os.path.join(tmp, "train.avro")
    write_training_examples(train, _records(500, 0))
    data = os.path.join(tmp, "data.avro")
    write_training_examples(data, _records(80, 11, cold_users=4))
    runs = {"jax": os.path.join(tmp, "run-jax"),
            "port": os.path.join(tmp, "run-port")}
    j_train.run(_train_args(train, runs["jax"]))
    t_train.run(_train_args(train, runs["port"]) + ["--device", "cpu"])
    return {"tmp": tmp, "train": train, "data": data, "runs": runs}


# --- grouped metrics and the evaluator grammar ----------------------------

def _grouped_inputs(seed):
    rng = np.random.default_rng(seed)
    n = 400
    # coarse scores: many ties, within and across groups
    scores = np.round(rng.normal(size=n), 1)
    labels = (rng.uniform(size=n) < 0.4).astype(np.float64)
    groups = rng.integers(-1, 25, size=n)  # -1 = the tag is missing
    weights = rng.uniform(0.2, 3.0, size=n)
    # a group of one class only, and a group of one row
    groups[:5], labels[:5] = 30, 1.0
    groups[5] = 31
    return scores, labels, groups, weights


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_auc_matches_jax(seed):
    scores, labels, groups, weights = _grouped_inputs(seed)
    for w in (None, weights):
        got = grouped_auc(scores, labels, groups, w)
        want = j_grouped_auc(scores, labels, groups, w)
        assert abs(got - want) <= 1e-12, (got, want)
    assert np.isnan(grouped_auc(scores[:5], labels[:5], groups[:5]))
    assert np.isnan(grouped_auc([], [], []))


@pytest.mark.parametrize("k", [1, 3, 10])
def test_grouped_precision_matches_jax(k):
    scores, labels, groups, _ = _grouped_inputs(k)
    got = grouped_precision_at_k(scores, labels, groups, k)
    want = j_grouped_precision(scores, labels, groups, k)
    assert abs(got - want) <= 1e-12, (got, want)
    assert np.isnan(grouped_precision_at_k([], [], [], k))


@pytest.mark.parametrize("spec", [
    "AUC", "auc", "RMSE", "logistic_loss", "SQUARED_LOSS", "POISSON_LOSS",
    "SMOOTHED_HINGE_LOSS", "AUC:queryId", "auc:userId", "PRECISION@5:queryId",
    "precision@1:documentId"])
def test_evaluators_match_jax(spec):
    """Parsed fields and values (tensor or array scores; rows without the
    tag dropped) equal the JAX package's, to 1e-12."""
    t_ev, j_ev = t_parse(spec), j_parse(spec)
    assert (t_ev.name, t_ev.maximize, t_ev.id_tag, t_ev.k) == \
        (j_ev.name, j_ev.maximize, j_ev.id_tag, j_ev.k)
    scores, labels, groups, weights = _grouped_inputs(5)
    tags = {"queryId": groups, "userId": groups % 7,
            "documentId": np.where(groups > 3, groups, -1)}
    want = j_ev.evaluate(scores, labels, weights, tags)
    for s in (scores, torch.as_tensor(scores)):
        got = t_ev.evaluate(s, labels, weights, tags)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (got, want)
    assert t_ev.better_than(1.0, 0.5) == j_ev.better_than(1.0, 0.5)


@pytest.mark.parametrize("spec,error", [
    ("PRECISION@0:queryId", ValueError), ("RMSE:queryId", ValueError),
    ("PRECISION@5", ValueError), ("F1", ValueError), ("", ValueError)])
def test_evaluator_errors_match_jax(spec, error):
    with pytest.raises(error):
        j_parse(spec)
    with pytest.raises(error):
        t_parse(spec)


def test_grouped_evaluator_needs_its_tag():
    ev = t_parse("AUC:queryId")
    with pytest.raises(KeyError, match="queryId"):
        ev.evaluate([0.1, 0.2], [0, 1], id_tags={"userId": np.zeros(2)})
    with pytest.raises(KeyError, match="queryId"):
        ev.evaluate([0.1, 0.2], [0, 1])


# --- GameTransformer --------------------------------------------------------

def _read(pkg, run_dir, path, id_columns=("queryId", "userId")):
    """(data, model): ``path`` read by ``pkg`` with ``run_dir``'s index maps
    and its own vocabularies, and ``run_dir``'s best model under them."""
    imap, reader = ((TIndexMap, TReader) if pkg == "torch"
                    else (JIndexMap, JReader))
    maps = {s: imap.load(os.path.join(run_dir, "feature-indexes",
                                      f"{s}.json"))
            for s in ("global", "user")}
    shards = tuple(parse_feature_shard_config(s) for s in SHARDS.split(","))
    if pkg == "jax":
        shards = tuple(JShard(c.shard_id, c.feature_bags, c.has_intercept)
                       for c in shards)
    data, _, vocabs = reader(shard_configs=shards, index_maps=maps).read(
        path, id_columns=id_columns)
    io = tio if pkg == "torch" else jio
    kw = {"device": "cpu"} if pkg == "torch" else {}
    model = io.load_game_model(io.resolve_game_model_dir(run_dir), maps,
                               vocabs, **kw)
    return data, model


def test_transformer_matches_jax(trained):
    run_dir = trained["runs"]["jax"]
    t_data, t_model = _read("torch", run_dir, trained["data"])
    j_data, j_model = _read("jax", run_dir, trained["data"])
    kw = dict(score_breakdown=True, predict_response=True)
    got = GameTransformer(model=t_model, evaluators=t_parse_all(
        EVALUATORS.split(",")), **kw).transform(t_data)
    want = JTransformer(model=j_model, evaluators=j_parse_all(
        EVALUATORS.split(",")), **kw).transform(j_data)
    assert np.array_equal(got.scores, np.asarray(want.scores))
    assert got.by_coordinate.keys() == want.by_coordinate.keys()
    for cid in got.by_coordinate:
        assert np.array_equal(got.by_coordinate[cid],
                              np.asarray(want.by_coordinate[cid]))
    # breakdown totals are the plain scores, bit for bit
    assert np.array_equal(got.scores, t_model.score(t_data))
    assert got.predictions.dtype == np.float32
    np.testing.assert_allclose(got.predictions, np.asarray(want.predictions),
                               rtol=1e-6, atol=1e-7)
    _hold_evaluation(got.evaluation.as_dict(), want.evaluation.as_dict(),
                     got.scores, t_data.labels, t_data.weights,
                     t_data.id_columns)
    plain = GameTransformer(model=t_model).transform(t_data)
    assert plain.by_coordinate is None and plain.evaluation is None
    assert np.array_equal(plain.scores, got.scores)


# --- score_game end to end --------------------------------------------------

def _score_args(trained, run_dir, out, extra=()):
    return ["--data", trained["data"], "--model-dir", run_dir,
            "--output-dir", out, "--feature-shards", SHARDS,
            "--evaluators", EVALUATORS, "--score-breakdown", *extra]


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_score_game_matches_jax(trained, tmp_path, trained_by):
    run_dir = trained["runs"][trained_by]
    t_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    t_res = t_score.run(_score_args(trained, run_dir, t_out,
                                    ["--device", "cpu"]))
    j_res = j_score.run(_score_args(trained, run_dir, j_out))
    assert t_res["n_scored"] == j_res["n_scored"] == 80
    t_recs = read_avro_file(os.path.join(t_out, "scores.avro"))
    j_recs = j_read_avro(os.path.join(j_out, "scores.avro"))
    assert [r["uid"] for r in t_recs] == [str(i) for i in range(80)]
    for field in ("uid", "label", "metadataMap"):
        assert [r[field] for r in t_recs] == [r[field] for r in j_recs]
    assert np.array_equal([r["predictionScore"] for r in t_recs],
                          [r["predictionScore"] for r in j_recs])
    with open(os.path.join(t_out, "score-breakdown.json")) as f:
        t_bd = json.load(f)
    with open(os.path.join(j_out, "score-breakdown.json")) as f:
        assert t_bd == json.load(f)
    assert set(t_res["evaluation"]) == set(EVALUATORS.split(","))
    data, _ = _read("torch", run_dir, trained["data"])
    _hold_evaluation(t_res["evaluation"], j_res["evaluation"],
                     [r["predictionScore"] for r in t_recs], data.labels,
                     data.weights, data.id_columns)
    with open(os.path.join(t_out, "metrics.jsonl")) as f:
        stages = [json.loads(line)["stage"] for line in f]
    assert stages == ["Read data", "Load model", "Score", "Write scores",
                      "evaluate"]


def test_score_game_python_fallback_writes_the_same(trained, tmp_path,
                                                    monkeypatch):
    run_dir = trained["runs"]["jax"]
    native_out, py_out = str(tmp_path / "native"), str(tmp_path / "py")
    assert t_native.available()
    t_score.run(["--data", trained["data"], "--model-dir", run_dir,
                 "--output-dir", native_out, "--feature-shards", SHARDS,
                 "--device", "cpu"])
    calls = []

    def blocked(*args, **kwargs):
        calls.append(args[0])
        return False  # the library is unavailable

    monkeypatch.setattr(t_native, "write_scoring_results", blocked)
    t_score.run(["--data", trained["data"], "--model-dir", run_dir,
                 "--output-dir", py_out, "--feature-shards", SHARDS,
                 "--device", "cpu"])
    assert len(calls) == 1
    a = read_avro_file(os.path.join(native_out, "scores.avro"))
    b = read_avro_file(os.path.join(py_out, "scores.avro"))
    assert a == b and len(a) == 80


def test_cold_users_score_their_fixed_effect(trained, tmp_path):
    """Users the model never saw score as records without an id."""
    path = str(tmp_path / "anon.avro")
    recs = _records(80, 11, cold_users=4)
    for r in recs[-4:]:
        del r["metadataMap"]["userId"]
    write_training_examples(path, recs)
    outs = {}
    for name, data in (("cold", trained["data"]), ("anon", path)):
        out = str(tmp_path / name)
        t_score.run(["--data", data, "--model-dir", trained["runs"]["jax"],
                     "--output-dir", out, "--feature-shards", SHARDS,
                     "--device", "cpu"])
        outs[name] = [r["predictionScore"] for r in read_avro_file(
            os.path.join(out, "scores.avro"))]
    assert outs["cold"] == outs["anon"]


@pytest.mark.parametrize("extra", [
    ["--multihost"], ["--telemetry-dir", "t"], ["--telemetry-poll-s", "1"],
    ["--metrics-port", "9"]], ids=lambda e: e[0][2:])
def test_score_game_unported_flag_names_itself(extra):
    args = t_score.build_parser().parse_args(
        ["--data", "d", "--model-dir", "m", "--output-dir", "o",
         "--feature-shards", SHARDS] + extra)
    if extra[0] == "--multihost":
        # ported (tests/test_torch_multihost_cli.py runs it): it parses
        assert args.multihost
        return
    # the telemetry flags are ported (tests/test_torch_telemetry.py and
    # tests/test_torch_multihost_cli.py run them): they parse into the
    # telemetry configuration
    from photon_ml_tpu_torch.cli.config import telemetry_from_args

    config = telemetry_from_args(args)
    assert extra[1] in (str(config.telemetry_dir),
                        f"{config.poll_interval_s:g}",
                        str(config.metrics_port))
    return
    with pytest.raises(NotImplementedError, match=extra[0]):
        t_score.run(["--data", "d", "--model-dir", "m", "--output-dir", "o",
                     "--feature-shards", SHARDS] + extra)


def test_score_game_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_score.run(["--data", "d", "--model-dir", "m", "--output-dir",
                     str(tmp_path / "o"), "--feature-shards", SHARDS])


def test_module_runner_lists_scoring_commands(capsys):
    with pytest.raises(SystemExit) as e:
        t_main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "score_game" in out and "serve_game" in out


# --- grouped evaluators through the training commands ------------------------

def test_train_game_selects_with_a_grouped_evaluator(trained, tmp_path):
    """The port's train_game reads the evaluator's id tag and evaluates
    with it: the same metrics as the JAX command (f32 solves on both,
    1e-4), and exactly the JAX evaluators on the port's own best model."""
    evaluators = "AUC:queryId,AUC,PRECISION@2:queryId"
    args = ["--training-data", trained["train"], "--validation-data",
            trained["data"], "--feature-shards", SHARDS,
            "--coordinates", *COORDS, "--update-sequence", "global,perUser",
            "--grid", "global=0.1;10", "perUser=1",
            "--evaluators", evaluators]
    t_dir, j_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    t_res = t_train.run(args + ["--output-dir", t_dir, "--device", "cpu"])
    j_res = j_train.run(args + ["--output-dir", j_dir])
    assert t_res["best_config"] == j_res["best_config"]
    assert set(t_res["best_evaluation"]) == set(evaluators.split(","))
    for name, val in t_res["best_evaluation"].items():
        assert abs(val - j_res["best_evaluation"][name]) < 1e-4, name
    # the in-memory model was evaluated; its saved copy scores the same
    data, model = _read("torch", t_dir, trained["data"])
    scores = model.score(data).astype(np.float64)
    for ev in j_parse_all(evaluators.split(",")):
        want = ev.evaluate(scores, data.labels.astype(np.float64),
                           data.weights.astype(np.float64), data.id_columns)
        got = t_res["best_evaluation"][ev.name]
        assert abs(got - want) <= 1e-12, ev.name


def test_train_glm_accepts_grouped_evaluators(tmp_path):
    rng = np.random.default_rng(4)
    paths = {}
    for name, n in (("train", 300), ("valid", 200)):
        x = rng.normal(size=(n, 5))
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x[:, 0] + x[:, 1])))
        q = rng.integers(0, 10, size=n)
        paths[name] = str(tmp_path / f"{name}.avro")
        write_training_examples(paths[name], (
            {"uid": str(i), "response": float(y[i]), "offset": None,
             "weight": None,
             "features": [{"name": f"x{j}", "term": "", "value": float(v)}
                          for j, v in enumerate(x[i])],
             "metadataMap": {"queryId": f"q{q[i]}"} if i % 5 else {}}
            for i in range(n)))
    evaluators = "PRECISION@2:queryId,AUC:queryId,AUC"
    out = str(tmp_path / "out")
    res = t_train_glm.run(["--training-data", paths["train"],
                           "--validation-data", paths["valid"],
                           "--output-dir", out,
                           "--regularization-weights", "10;0.1",
                           "--evaluators", evaluators, "--device", "cpu"])
    assert set(res["best_evaluation"]) == set(evaluators.split(","))
    # the best model's metrics are the JAX evaluators on its validation
    # scores, computed as the command computes them
    imap = TIndexMap.load(os.path.join(out, "feature-index.json"))
    data, _, _ = TReader(index_maps={"global": imap}).read(
        paths["valid"], id_columns=("queryId",))
    best = tio.load_glm_model(os.path.join(out, "best", "model.avro"), imap,
                              device="cpu")
    glm = t_train_glm._to_glm_data(data, "global", "float32", "cpu")
    scores = best.score(glm.design, glm.offsets).numpy().astype(np.float64)
    assert (data.id_columns["queryId"] == -1).sum() == 40
    for ev in j_parse_all(evaluators.split(",")):
        want = ev.evaluate(scores, data.labels.astype(np.float64),
                           data.weights.astype(np.float64),
                           data.id_columns)
        assert abs(res["best_evaluation"][ev.name] - want) <= 1e-12, ev.name
