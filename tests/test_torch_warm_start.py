"""Warm starts and partial retraining in the port against the JAX package:
``GameEstimator.fit(initial_models=..., locked=...)`` on the same data and
the same prior model (locked coordinates come back bit for bit, warm-started
ones equal the JAX fit at the GAME tolerances), and ``train_game
--model-input-dir --locked-coordinates`` in both packages on the same Avro
and prior run (the same models, lineage and ``data-manifest.json``). Also
``--checkpoint``/``--resume`` and ``--on-divergence`` through the port's
``train_game``. The port runs on the CPU."""

import json
import os
import shutil

import numpy as np
import pytest

import photon_ml_tpu.game as jg
import photon_ml_tpu_torch.game as tg
from photon_ml_tpu.cli import train_game as j_train
from photon_ml_tpu.continuous import delta as j_delta
from photon_ml_tpu.game.estimator import FixedEffectCoordinateConfig as JFixed
from photon_ml_tpu.game.estimator import RandomEffectCoordinateConfig as JRandom
from photon_ml_tpu.glm.problem import GLMOptimizationConfiguration as JOpt
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.ops.regularization import L2Regularization as JL2
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizer
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.continuous import delta as t_delta
from photon_ml_tpu_torch.convert import game_model_from_arrays
from photon_ml_tpu_torch.game.estimator import FixedEffectCoordinateConfig as TFixed
from photon_ml_tpu_torch.game.estimator import RandomEffectCoordinateConfig as TRandom
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration as TOpt
from photon_ml_tpu_torch.io.model_io import model_lineage_id
from photon_ml_tpu_torch.ops.regularization import L2Regularization as TL2
from photon_ml_tpu_torch.optimize import OptimizerConfig as TOptimizer
from photon_ml_tpu_torch.resilience import (
    DivergenceError,
    FaultPlan,
    FaultSpec,
    injected,
)
from photon_ml_tpu_torch.types import TaskType as TTask
from test_torch_continuous import COMMON, N_USERS, _load, _records, _rows_by_raw
from test_torch_resilience import _data

SEQ = ["global", "perUser"]
CONFIG = {"global": 0.1, "perUser": 1.0}
#: tests/test_torch_game.py's f32 GAME tolerances (fixed, random effect)
TOL = dict(rtol=1e-3, atol=1e-4)
RE_TOL = dict(rtol=2e-3, atol=5e-4)


def _jax_estimator(coordinates=SEQ, sweeps=1):
    cfg = JOpt(regularization=JL2,
               optimizer_config=JOptimizer(max_iterations=40))
    configs = {"global": JFixed("global", cfg),
               "perUser": JRandom(
                   jg.RandomEffectDatasetConfig("userId", "item"), cfg)}
    return jg.GameEstimator(
        task=JTask.LOGISTIC_REGRESSION,
        coordinate_configs={c: configs[c] for c in coordinates},
        update_sequence=SEQ, n_cd_iterations=sweeps)


def _torch_estimator(coordinates=SEQ, sweeps=1):
    cfg = TOpt(regularization=TL2,
               optimizer_config=TOptimizer(max_iterations=40))
    configs = {"global": TFixed("global", cfg),
               "perUser": TRandom(
                   tg.RandomEffectDatasetConfig("userId", "item"), cfg)}
    return tg.GameEstimator(
        task=TTask.LOGISTIC_REGRESSION,
        coordinate_configs={c: configs[c] for c in coordinates},
        update_sequence=SEQ, n_cd_iterations=sweeps, device="cpu")


@pytest.fixture(scope="module")
def fits():
    """A cold JAX fit (the prior), carried into the port; then in each
    package a fit with perUser locked and a warm-started fit of both
    coordinates, on another draw of the data."""
    jdata, tdata = _data(jg, 800, 1), _data(tg, 800, 1)
    jconf = jg.GameOptimizationConfiguration(CONFIG)
    tconf = tg.GameOptimizationConfiguration(CONFIG)
    jprior = dict(_jax_estimator(sweeps=2).fit(_data(jg, 800, 0),
                                               [jconf])[0].model.coordinates)
    re = jprior["perUser"]
    tprior = dict(game_model_from_arrays("LOGISTIC_REGRESSION", {
        "global": {"kind": "fixed", "feature_shard_id": "global",
                   "means": np.asarray(
                       jprior["global"].model.coefficients.means)},
        "perUser": {"kind": "random", "random_effect_type": "userId",
                    "feature_shard_id": "item", "dim": re.dim,
                    "keys": np.asarray(re.keys),
                    "coeffs": np.asarray(re.coeffs)}},
        device="cpu").coordinates)
    out = {"prior": (jprior, tprior)}
    out["locked"] = (
        _jax_estimator(["global"]).fit(jdata, [jconf], initial_models=jprior,
                                       locked=["perUser"])[0],
        _torch_estimator(["global"]).fit(tdata, [tconf],
                                         initial_models=tprior,
                                         locked=["perUser"])[0])
    out["warm"] = (
        _jax_estimator().fit(jdata, [jconf], initial_models=jprior)[0],
        _torch_estimator().fit(tdata, [tconf], initial_models=tprior)[0])
    return out


def _fe(model):
    return np.asarray(model.coordinates["global"].model.coefficients.means)


def test_locked_coordinate_comes_back_bit_identical(fits):
    jprior, tprior = fits["prior"]
    jres, tres = fits["locked"]
    re_prior, re_t = tprior["perUser"], tres.model.coordinates["perUser"]
    np.testing.assert_array_equal(re_t.keys, np.asarray(jprior["perUser"]
                                                        .keys))
    np.testing.assert_array_equal(re_t.coeffs, re_prior.coeffs)
    np.testing.assert_array_equal(re_t.coeffs, np.asarray(
        jres.model.coordinates["perUser"].coeffs))
    # the unlocked coordinate retrained against the frozen scores, as JAX's
    assert not np.array_equal(
        _fe(tres.model), _fe(tg.GameModel(tprior, TTask.LOGISTIC_REGRESSION)))
    np.testing.assert_allclose(_fe(tres.model), _fe(jres.model), **TOL)
    assert [c for _, c, _ in tres.step_seconds] == ["global"]


def test_warm_started_fit_equals_jax(fits):
    jres, tres = fits["warm"]
    np.testing.assert_allclose(_fe(tres.model), _fe(jres.model), **TOL)
    t_re, j_re = (tres.model.coordinates["perUser"],
                  jres.model.coordinates["perUser"])
    np.testing.assert_array_equal(t_re.keys, np.asarray(j_re.keys))
    np.testing.assert_allclose(t_re.coeffs, np.asarray(j_re.coeffs),
                               **RE_TOL)


def test_locked_coordinate_needs_no_config_and_no_dataset():
    est = _torch_estimator(["global"])
    assert set(est.prepare(_data(tg, 100, 0), locked=["perUser"])) == {
        "global"}
    with pytest.raises(KeyError, match="not configured, not locked"):
        est.prepare(_data(tg, 100, 0))


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(locked=["perSong"]), ValueError, "must appear in the update"),
    (dict(locked=["perUser"]), KeyError, "needs an initial model"),
    (dict(checkpoint=object(), n_configs=2), ValueError,
     "exactly one configuration"),
], ids=["locked-outside-sequence", "locked-without-model",
        "checkpoint-two-configs"])
def test_fit_argument_checks(kwargs, error, match):
    n = kwargs.pop("n_configs", 1)
    conf = tg.GameOptimizationConfiguration(CONFIG)
    with pytest.raises(error, match=match):
        _torch_estimator().fit(_data(tg, 100, 0), [conf] * n, **kwargs)


def test_on_result_fires_per_configuration():
    seen = []
    confs = [tg.GameOptimizationConfiguration(CONFIG),
             tg.GameOptimizationConfiguration({"global": 1.0,
                                               "perUser": 10.0})]
    results = _torch_estimator().fit(
        _data(tg, 200, 0), confs,
        on_result=lambda i, r: seen.append((i, r.configuration)))
    assert seen == [(0, confs[0]), (1, confs[1])]
    assert [r.configuration for r in results] == confs


def test_fingerprint_is_a_deterministic_run_description():
    """Two estimators built alike give one fingerprint (a resume accepts
    its own checkpoint); another locked set or sweep count another."""
    data = _data(tg, 100, 0)
    conf = tg.GameOptimizationConfiguration(CONFIG)
    fp = _torch_estimator().fingerprint(data, conf)
    assert fp == _torch_estimator().fingerprint(data, conf)
    assert fp != _torch_estimator(sweeps=2).fingerprint(data, conf)
    assert fp != _torch_estimator().fingerprint(data, conf, ["perUser"])
    assert json.loads(fp)["n_samples"] == 100


# --- train_game --model-input-dir --locked-coordinates ------------------------

@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A port run on day 0 (the prior); then each package's train_game on
    day 1 warm-started from it with perUser locked."""
    tmp = str(tmp_path_factory.mktemp("torch_warm_start"))
    d0, d1 = os.path.join(tmp, "d0.avro"), os.path.join(tmp, "d1.avro")
    write_training_examples(d0, _records(600, 0))
    write_training_examples(d1, _records(600, 0, mutate_users=(1, 3),
                                         new_users=1))
    p = {k: os.path.join(tmp, k) for k in ("prior", "jax", "port")}
    t_train.run(["--training-data", d0, "--output-dir", p["prior"],
                 "--device", "cpu"] + COMMON)
    warm = ["--training-data", d1, "--model-input-dir", p["prior"],
            "--locked-coordinates", "perUser"] + COMMON
    j_train.run(warm + ["--output-dir", p["jax"]])
    t_train.run(warm + ["--output-dir", p["port"], "--device", "cpu"])
    return dict(tmp=tmp, d0=d0, d1=d1, paths=p)


def test_cli_locked_warm_start_equals_jax(cli):
    p = cli["paths"]
    tm, tv = _load(p["port"])
    jm, jv = _load(p["jax"])
    pm, pv = _load(p["prior"])
    np.testing.assert_allclose(_fe(tm), _fe(jm), **TOL)
    assert not np.array_equal(_fe(tm), _fe(pm))
    rows_t, rows_j, rows_p = (_rows_by_raw(tm, tv), _rows_by_raw(jm, jv),
                              _rows_by_raw(pm, pv))
    # the locked coordinate: the prior's rows, bit for bit, in both
    for raw, row in rows_p.items():
        assert np.array_equal(rows_t[raw], row), raw
        assert np.array_equal(rows_j[raw], row), raw
    # a new user under a locked coordinate gets no model in either
    assert f"u{N_USERS}" not in rows_t and f"u{N_USERS}" not in rows_j


def test_cli_lineage_and_manifest_equal_jax(cli):
    p = cli["paths"]
    meta = {}
    for k in ("port", "jax"):
        with open(os.path.join(p[k], "best", "model-metadata.json")) as f:
            meta[k] = json.load(f)
        assert meta[k]["parentModel"] == model_lineage_id(p["prior"])
    tman = t_delta.load_manifest(os.path.join(p["port"],
                                              "data-manifest.json"))
    jman = j_delta.load_manifest(os.path.join(p["jax"],
                                              "data-manifest.json"))
    assert tman == jman
    assert (t_delta.manifest_digest(tman) == j_delta.manifest_digest(jman)
            == meta["port"]["dataManifest"] == meta["jax"]["dataManifest"])
    with open(os.path.join(p["prior"], "best", "model-metadata.json")) as f:
        prior = json.load(f)
    assert prior["parentModel"] is None
    assert isinstance(prior["trainedAt"], str)
    assert sorted(os.listdir(p["port"])) == sorted(os.listdir(p["jax"]))


def test_cli_checkpoint_resume_matches_uninterrupted(cli, tmp_path):
    args = ["--training-data", cli["d0"], "--cd-iterations", "2",
            "--checkpoint", "--device", "cpu"] + COMMON
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    t_train.run(args + ["--output-dir", full])
    t_train.run(args + ["--output-dir", cut])
    steps = sorted(os.listdir(os.path.join(cut, "checkpoints")))
    assert steps == ["step-2", "step-3", "step-4"]
    for s in steps[1:]:
        shutil.rmtree(os.path.join(cut, "checkpoints", s))
    t_train.run(args + ["--output-dir", cut, "--resume"])
    fm, fv = _load(full)
    cm, cv = _load(cut)
    np.testing.assert_allclose(_fe(cm), _fe(fm), rtol=5e-3, atol=1e-3)
    rows_f, rows_c = _rows_by_raw(fm, fv), _rows_by_raw(cm, cv)
    for raw in rows_f:
        np.testing.assert_allclose(rows_c[raw], rows_f[raw], rtol=5e-3,
                                   atol=1e-3, err_msg=raw)


def _nan_on_per_user():
    return FaultPlan([FaultSpec("optimizer.step", at=(1,), mode="nan")])


def test_cli_on_divergence_rollback_finishes(cli, tmp_path):
    out = str(tmp_path / "rollback")
    with injected(_nan_on_per_user()) as plan:
        t_train.run(["--training-data", cli["d0"], "--output-dir", out,
                     "--on-divergence", "rollback", "--device", "cpu"]
                    + COMMON)
    assert plan.fired("optimizer.step")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    (div,) = [m for m in lines if m.get("stage") == "divergence"]
    assert div["failures"] == {"perUser": 1} and div["frozen"] == []
    assert div["regularization"] == [{"global": 0.1, "perUser": 10.0}]
    assert os.path.exists(os.path.join(out, "best", "model-metadata.json"))


def test_cli_on_divergence_fail_raises(cli, tmp_path):
    with injected(_nan_on_per_user()), pytest.raises(
            DivergenceError, match="perUser"):
        t_train.run(["--training-data", cli["d0"], "--output-dir",
                     str(tmp_path), "--device", "cpu"] + COMMON)


@pytest.mark.parametrize("extra,match", [
    (["--locked-coordinates", "perUser"], "needs --model-input-dir"),
    (["--checkpoint", "--grid", "global=0.1;1"], "single-config grid"),
], ids=["locked-without-input", "checkpoint-grid"])
def test_cli_flag_checks(cli, tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        t_train.run(["--training-data", cli["d0"], "--output-dir",
                     str(tmp_path), "--device", "cpu"] + COMMON + extra)
