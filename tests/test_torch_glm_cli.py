"""The port's ``train_glm`` CLI on the CPU against the JAX package's
(``photon_ml_tpu.cli.train_glm.run``) on the same tiny Avro files.

Three runs of each package's command cover the optimizers, sweeps and
designs: L-BFGS with L2 under STANDARDIZATION with a summary (logistic,
dense, sequential); TRON on a design wider than 4,096 columns (logistic,
chunked sparse); OWL-QN with elastic net in the batched sweep (linear,
dense). OWL-QN on a Poisson task is held against the JAX package's
in-memory sequential sweep on the same rows. They must agree on the best
lambda, the validation metric (1e-4 relative), the coefficients and the
exact zeros. The JAX command runs in f32 (its TRON cannot run with f32
designs under the x64 mode of this test process, and f32 is how it runs
on its TPU), the port in f32 too, so coefficients are held at the f32
tolerances of tests/test_torch_game.py; the f64 comparisons are
tests/test_torch_{owlqn,sparse_design,glm_slice}.py's. Also: the output
file tree, ``summary.avro``'s records, ``model.txt``'s bytes for equal
coefficients, best models that load and score alike in the other package,
``--warm-start``, the refused flags, the device default and the module
runner.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import train_glm as j_cli
from photon_ml_tpu.evaluation import parse_evaluators as j_evaluators
from photon_ml_tpu.glm import training as jt
from photon_ml_tpu.glm.problem import GLMOptimizationConfiguration as JOpt
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.io.avro import read_avro_file as j_read_avro
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.data_reader import FeatureShardConfig as JShard
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.io.index import IndexMap as JIndexMap
from photon_ml_tpu.ops.regularization import elastic_net as j_elastic_net
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizer
from photon_ml_tpu.types import INTERCEPT_KEY as J_INTERCEPT_KEY
from photon_ml_tpu.types import OptimizerType as JOptType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.__main__ import main as t_main
from photon_ml_tpu_torch.cli import train_glm as t_cli
from photon_ml_tpu_torch.convert import glm_model_from_arrays
from photon_ml_tpu_torch.evaluation import parse_evaluators as t_evaluators
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.io.data_reader import AvroDataReader as TReader
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfig as TShard
from photon_ml_tpu_torch.io.index import IndexMap as TIndexMap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 on both sides (tests/test_torch_game.py's fixed-effect limits)
W_TOL = dict(rtol=1e-3, atol=1e-4)
METRIC_RTOL = 1e-4
#: OWL-QN on the Poisson task, where both f32 solves stall (see the test)
POISSON_W_TOL = dict(rtol=1e-3, atol=1e-3)


def _write(path, task, n, seed, d=20, k=5):
    """Rows of ``k`` of ``d`` features ``x{j}`` with labels of ``task``
    from a planted model whose odd features are pure noise."""
    prm = np.random.default_rng(4242)
    w = prm.normal(size=d)
    w[1::2] = 0.0
    rng = np.random.default_rng(seed)
    cols = rng.random((n, d)).argsort(axis=1)[:, :k]
    vals = rng.normal(size=(n, k))
    m = (w[cols] * vals).sum(1) / np.sqrt(k) * 2.0
    if task == "LINEAR_REGRESSION":
        y = m + 0.5 * rng.normal(size=n)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(m / 2)).astype(np.float64)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float64)
    write_training_examples(path, (
        {"uid": str(j), "response": float(y[j]), "offset": None,
         "weight": None,
         "features": [{"name": f"x{c}", "term": "", "value": float(v)}
                      for c, v in zip(cols[j], vals[j])],
         "metadataMap": {}} for j in range(n)), codec="null")
    return path


#: name -> (task, data, extra arguments, evaluator). "wide" data has over
#: 4,096 features present, so both packages build a chunked sparse design.
CASES = {
    "lbfgs": ("LOGISTIC_REGRESSION", dict(n=300, d=20),
              ["--normalization", "STANDARDIZATION",
               "--summarization-output"], "AUC"),
    "tron_sparse": ("LOGISTIC_REGRESSION", dict(n=800, d=8000, k=12),
                    ["--optimizer", "TRON", "--max-iterations", "40"],
                    "AUC"),
    "owlqn_batched": ("LINEAR_REGRESSION", dict(n=300, d=20),
                      ["--regularization-type", "ELASTIC_NET",
                       "--elastic-net-alpha", "0.5",
                       "--sweep-mode", "batched"], "RMSE"),
}
LAMBDAS = "10;1;0.1"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("glm_cli_data")
    out = {}
    for name, (task, shape, _, _) in CASES.items():
        out[name] = (_write(str(d / f"{name}_train.avro"), task, seed=1,
                            **shape),
                     _write(str(d / f"{name}_valid.avro"), task, seed=2,
                            **{**shape, "n": 2 * shape["n"]}))
    return out


def _args(name, files):
    task, _, extra, evaluator = CASES[name]
    train, valid = files[name]
    return ["--training-data", train, "--validation-data", valid,
            "--task", task, "--regularization-weights", LAMBDAS,
            "--evaluators", evaluator] + extra


def _jax_run(args):
    """The JAX command in f32, as on its TPU (set process-wide, restored)."""
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return j_cli.run(args)
    finally:
        jax.config.update("jax_enable_x64", x64)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, files, tmp_path_factory):
    """(name, port result, port dir, JAX result, JAX dir) of one case."""
    name = request.param
    d = tmp_path_factory.mktemp(f"glm_cli_{name}")
    args = _args(name, files)
    t_dir, j_dir = str(d / "port"), str(d / "jax")
    t_res = t_cli.run(args + ["--output-dir", t_dir, "--device", "cpu"])
    j_res = _jax_run(args + ["--output-dir", j_dir])
    return name, t_res, t_dir, j_res, j_dir


def _metrics(run_dir, stage):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["stage"] == stage]


def _means(pkg, run_dir, model_dir):
    imap = (TIndexMap if pkg == "torch" else JIndexMap).load(
        os.path.join(run_dir, "feature-index.json"))
    path = os.path.join(run_dir, model_dir, "model.avro")
    if pkg == "torch":
        return tio.load_glm_model(path, imap, device="cpu")
    return jio.load_glm_model(path, imap)


def test_best_lambda_and_metric_match(runs):
    _, t_res, t_dir, j_res, _ = runs
    assert t_res["best_lambda"] == j_res["best_lambda"]
    assert t_res["output_dir"] == t_dir
    assert t_res["diagnostics_report"] is None
    (metric, tv), = t_res["best_evaluation"].items()
    jv = j_res["best_evaluation"][metric]
    assert abs(tv - jv) <= METRIC_RTOL * abs(jv), (metric, tv, jv)
    for t, j in zip(_metrics(t_dir, "validate"),
                    _metrics(runs[4], "validate")):
        assert t["regularization_weight"] == j["regularization_weight"]
        assert abs(t[metric] - j[metric]) <= METRIC_RTOL * abs(j[metric])


def test_coefficients_and_zeros_match(runs):
    name, _, t_dir, _, j_dir = runs
    for lam in ("10", "1", "0.1"):
        sub = os.path.join("all", f"lambda-{lam}")
        tw = _means("torch", t_dir, sub).coefficients.means.numpy()
        jw = np.asarray(_means("jax", j_dir, sub).coefficients.means)
        np.testing.assert_allclose(tw, jw, **W_TOL, err_msg=lam)
        np.testing.assert_array_equal(tw == 0.0, jw == 0.0, err_msg=lam)
        if name == "owlqn_batched" and lam == "10":
            assert (tw == 0.0).sum() >= 3  # L1 made exact zeros
    if name == "tron_sparse":
        assert len(TIndexMap.load(os.path.join(
            t_dir, "feature-index.json"))) > t_cli.DENSE_MAX_DIM


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_output_tree_and_files_match(runs):
    name, _, t_dir, _, j_dir = runs
    assert _tree(t_dir) == _tree(j_dir)
    with open(os.path.join(t_dir, "feature-index.json"), "rb") as a, \
            open(os.path.join(j_dir, "feature-index.json"), "rb") as b:
        assert a.read() == b.read()
    assert [m["stage"] for m in _metrics(t_dir, "Train")] == ["Train"]
    if name == "lbfgs":
        assert j_read_avro(os.path.join(t_dir, "summary.avro")) == \
            j_read_avro(os.path.join(j_dir, "summary.avro"))
    # model.txt of equal coefficients: the port's writer on the JAX run's
    # best model and the JAX run's own file are the same bytes
    imap = TIndexMap.load(os.path.join(j_dir, "feature-index.json"))
    jm = _means("jax", j_dir, "best")
    out = os.path.join(t_dir, "jax_best_model.txt")
    tio.save_glm_model_text(out, glm_model_from_arrays(
        jm.task.value, np.asarray(jm.coefficients.means), device="cpu"),
        imap)
    with open(out, "rb") as a, \
            open(os.path.join(j_dir, "best", "model.txt"), "rb") as b:
        assert a.read() == b.read()
    os.remove(out)


def _score(pkg, run_dir, valid, metric):
    """``metric`` of ``run_dir``'s best model on ``valid``, loaded and
    scored by ``pkg`` with the run's feature index."""
    if pkg == "torch":
        imap_cls, reader, shard, evs = TIndexMap, TReader, TShard, \
            t_evaluators
    else:
        imap_cls, reader, shard, evs = JIndexMap, JReader, JShard, \
            j_evaluators
    imap = imap_cls.load(os.path.join(run_dir, "feature-index.json"))
    cfg = shard("global", feature_bags=None,
                has_intercept=imap.has_intercept)
    data, _, _ = reader(shard_configs=(cfg,),
                        index_maps={"global": imap}).read(valid)
    model = _means(pkg, run_dir, "best")
    if pkg == "torch":
        glm = t_cli._to_glm_data(data, "global", "float32", "cpu")
        scores = model.score(glm.design).numpy()
    else:
        glm = j_cli._to_glm_data(data, "global")
        scores = np.asarray(model.score(glm.design))
    return scores, evs([metric])[0].evaluate(scores, data.labels)


@pytest.mark.parametrize("trained_by", ["port", "jax"])
def test_best_model_cross_loads(runs, files, trained_by):
    name, t_res, t_dir, j_res, j_dir = runs
    run_dir, res = (t_dir, t_res) if trained_by == "port" else (j_dir, j_res)
    metric = CASES[name][3]
    t_scores, t_val = _score("torch", run_dir, files[name][1], metric)
    j_scores, j_val = _score("jax", run_dir, files[name][1], metric)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-6, atol=1e-6)
    assert abs(t_val - j_val) <= 1e-6 * max(1.0, abs(j_val))
    # the reloaded model scores the validation file as the run did
    assert abs(t_val - res["best_evaluation"][metric]) <= \
        1e-6 * max(1.0, abs(t_val))


def test_poisson_elastic_net_matches_jax_sweep(files, tmp_path):
    """OWL-QN on a Poisson task through the port's CLI against the JAX
    package's sequential sweep and model selection on the same rows (its
    reader, its ``_to_glm_data``), in f32."""
    train = _write(str(tmp_path / "train.avro"), "POISSON_REGRESSION", 300,
                   3)
    valid = _write(str(tmp_path / "valid.avro"), "POISSON_REGRESSION", 150,
                   4)
    out = str(tmp_path / "port")
    res = t_cli.run(["--training-data", train, "--validation-data", valid,
                     "--output-dir", out, "--task", "POISSON_REGRESSION",
                     "--regularization-type", "ELASTIC_NET",
                     "--regularization-weights", LAMBDAS,
                     "--evaluators", "POISSON_LOSS", "--device", "cpu"])
    reader = JReader(shard_configs=(JShard("global", feature_bags=None),))
    data, maps, _ = reader.read(train)
    vdata, _, _ = JReader(shard_configs=reader.shard_configs,
                          index_maps=maps).read(valid)
    mask = np.ones(len(maps["global"]), np.float32)
    mask[maps["global"].key_to_index[J_INTERCEPT_KEY]] = 0.0
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        cfg = JOpt(optimizer=JOptType.LBFGS, regularization=j_elastic_net(0.5),
                   optimizer_config=JOptimizer(max_iterations=80))
        trained = jt.train_glm_sweep(
            JTask.POISSON_REGRESSION, j_cli._to_glm_data(data, "global"),
            [10.0, 1.0, 0.1], cfg, reg_mask=jnp.asarray(mask))
        best, trained = jt.validate_and_select(
            trained, j_evaluators(["POISSON_LOSS"]),
            j_cli._to_glm_data(vdata, "global"))
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert res["best_lambda"] == trained[best].regularization_weight
    jv = trained[best].evaluation.as_dict()["POISSON_LOSS"]
    tv = res["best_evaluation"]["POISSON_LOSS"]
    assert abs(tv - jv) <= METRIC_RTOL * abs(jv)
    x = np.asarray(j_cli._to_glm_data(data, "global").design.x, np.float64)
    y = np.asarray(data.labels, np.float64)

    def objective(w, lam):  # f64; L1 on every coefficient, L2 masked
        m = x @ w
        return (float((np.exp(m) - y * m).sum())
                + 0.25 * lam * float(((w * mask) ** 2).sum())
                + 0.5 * lam * float(np.abs(w).sum()))

    for tm in trained:
        lam = tm.regularization_weight
        tw = _means("torch", out, os.path.join(
            "all", f"lambda-{lam:g}")).coefficients.means.numpy()
        jw = np.asarray(tm.model.coefficients.means)
        np.testing.assert_array_equal(tw == 0.0, jw == 0.0)
        # both f32 solves stop on the stall rule at the value's f32 floor
        # (|f| ~ 8e2, an ulp ~ 6e-5): the same objective to 1e-7, and
        # coefficients along its flat directions up to ~5e-4 apart
        ft, fj = objective(tw.astype(np.float64), lam), objective(
            jw.astype(np.float64), lam)
        assert abs(ft - fj) <= 1e-7 * abs(fj), (lam, ft, fj)
        np.testing.assert_allclose(tw, jw, **POISSON_W_TOL)
    assert (_means("torch", out, os.path.join("all", "lambda-10"))
            .coefficients.means.numpy() == 0.0).sum() >= 3


def test_warm_start_converges_in_fewer_iterations(files, tmp_path):
    """A second run seeded from the first's best model (through the
    normalization's inverse) solves the same data in fewer iterations."""
    train, valid = files["lbfgs"]
    base = ["--training-data", train, "--regularization-weights", "1",
            "--normalization", "STANDARDIZATION", "--device", "cpu"]
    first, second = str(tmp_path / "first"), str(tmp_path / "second")
    t_cli.run(base + ["--output-dir", first])
    t_cli.run(base + ["--output-dir", second, "--warm-start", first])
    (a,), (b,) = _metrics(first, "train"), _metrics(second, "train")
    assert b["iterations"] < a["iterations"], (a, b)
    assert [m["stage"] for m in map(json.loads, open(os.path.join(
        second, "metrics.jsonl")))].count("Load warm start") == 1
    with pytest.raises(SystemExit, match="sequential"):
        t_cli.run(base + ["--output-dir", str(tmp_path / "x"),
                          "--warm-start", first, "--sweep-mode", "batched"])


_REQUIRED = ["--training-data", "x.avro", "--output-dir", "out"]


#: the multi-process and supervision flags, which run (see
#: tests/test_torch_multihost_cli.py)
_MULTI_PROCESS_FLAGS = ("--multihost", "--supervise", "--max-restarts",
                        "--heartbeat-timeout-s", "--restart-deadline-s")
#: the telemetry plane's flags, ported (tests/test_torch_telemetry.py runs
#: them): they parse
_TELEMETRY_FLAGS = ("--profile", "--debug-nans", "--telemetry-dir",
                    "--telemetry-poll-s", "--metrics-port")


@pytest.mark.parametrize("extra", [
    ["--training-diagnostics"], ["--diagnostic-bootstrap-replicates", "4"],
    ["--profile"], ["--debug-nans"], ["--multihost"],
    ["--supervise", "2"], ["--max-restarts", "1"],
    ["--heartbeat-timeout-s", "5"], ["--restart-deadline-s", "5"],
    ["--telemetry-dir", "t"], ["--telemetry-poll-s", "1"],
    ["--metrics-port", "9"],
], ids=lambda e: e[0][2:])
def test_unported_flag_names_itself(tmp_path, extra):
    if extra[0] in ("--training-diagnostics",
                    "--diagnostic-bootstrap-replicates"):
        # the diagnostics flags are ported (tests/test_torch_diagnostics.py
        # runs them): they parse, with the reference's positive-int check
        args = t_cli.build_parser().parse_args(_REQUIRED + extra)
        assert (args.training_diagnostics if len(extra) == 1
                else args.diagnostic_bootstrap_replicates == 4)
        with pytest.raises(SystemExit):
            t_cli.build_parser().parse_args(
                _REQUIRED + ["--diagnostic-bootstrap-replicates", "0"])
        return
    if extra[0] in _MULTI_PROCESS_FLAGS + _TELEMETRY_FLAGS:
        # ported (tests/test_torch_multihost_cli.py and
        # tests/test_torch_telemetry.py run them): they parse
        args = t_cli.build_parser().parse_args(_REQUIRED + extra)
        dest = extra[0][2:].replace("-", "_")
        assert getattr(args, dest) == (
            True if len(extra) == 1 else type(getattr(args, dest))(extra[1]))
        return
    with pytest.raises(NotImplementedError, match=extra[0]):
        t_cli.run(_REQUIRED + extra)


def _poison_second_lambda(monkeypatch):
    """Make the sweep's second lambda (1 of "10;1;0.1") diverge: its
    coefficients turn NaN on their way to the original space."""
    from photon_ml_tpu_torch.glm import training

    real, calls = training.to_original_space, []

    def poisoned(coeffs, normalization):
        out = real(coeffs, normalization)
        calls.append(1)
        if len(calls) != 2:
            return out
        return type(out)(means=out.means * float("nan"),
                         variances=out.variances)

    monkeypatch.setattr(training, "to_original_space", poisoned)


@pytest.mark.parametrize("extra", [
    ["--max-retries", "0"], ["--retry-deadline-s", "1"],
    ["--on-divergence", "rollback"], ["--on-divergence", "freeze"],
], ids=lambda e: e[0][2:] + ("-" + e[1] if e[0] == "--on-divergence"
                             else ""))
def test_resilience_flag_runs(files, tmp_path, monkeypatch, extra):
    """The resilience flags that were refused now run: the retry flags
    install the process's retry policy; rollback and freeze drop a
    diverged lambda from selection and save the others."""
    from photon_ml_tpu_torch.resilience import (
        get_default_policy,
        set_default_policy,
    )

    train, valid = files["lbfgs"]
    if extra[0] == "--on-divergence":
        _poison_second_lambda(monkeypatch)
    out = str(tmp_path / "out")
    previous = get_default_policy()
    try:
        res = t_cli.run(["--training-data", train, "--validation-data",
                         valid, "--output-dir", out,
                         "--regularization-weights", LAMBDAS,
                         "--evaluators", "AUC", "--device", "cpu"] + extra)
        policy = get_default_policy()
    finally:
        set_default_policy(previous)
    if extra[0] == "--max-retries":
        assert policy.max_attempts == 1
    elif extra[0] == "--retry-deadline-s":
        assert policy.deadline_s == 1.0 and policy.max_attempts == 3
    else:
        assert res["best_lambda"] != 1.0
        assert sorted(os.listdir(os.path.join(out, "all"))) == [
            "lambda-0.1", "lambda-10"]


def test_defaults_to_cuda_without_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.run(["--training-data", "x.avro", "--output-dir", out])
    assert not os.path.exists(out)


def test_divergence_names_the_lambdas(files, tmp_path, monkeypatch):
    """The default ``--on-divergence fail``: non-finite coefficients raise
    the port's DivergenceError naming the lambdas."""
    from photon_ml_tpu_torch.glm import training

    real = training.to_original_space

    def poisoned(coeffs, normalization):
        out = real(coeffs, normalization)
        return type(out)(means=out.means * float("nan"),
                         variances=out.variances)

    monkeypatch.setattr(training, "to_original_space", poisoned)
    with pytest.raises(t_cli.DivergenceError, match=r"\[1\.0\]"):
        t_cli.run(["--training-data", files["lbfgs"][0], "--output-dir",
                   str(tmp_path / "d"), "--regularization-weights", "1",
                   "--device", "cpu"])


def test_module_runner(capsys):
    with pytest.raises(SystemExit) as e:
        t_main(["--help"])
    assert e.value.code == 0
    assert "train_glm" in capsys.readouterr().out
    out = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch", "train_glm", "-h"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--regularization-weights" in out.stdout
    assert "--sweep-mode" in out.stdout
