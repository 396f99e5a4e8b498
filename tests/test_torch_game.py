"""The slice end to end on the CPU: the port's GameEstimator.fit against the
JAX package's, on the same music-shaped data (a fixed effect and per-user,
per-song random effects), plus carrying a JAX-trained model across with
photon_ml_tpu_torch.convert.game_model_from_arrays."""

import jax
import numpy as np
import pytest
import torch

import photon_ml_tpu.game as jg
import photon_ml_tpu_torch.game as tg
from photon_ml_tpu.evaluation import parse_evaluators as j_evaluators
from photon_ml_tpu.glm.problem import GLMOptimizationConfiguration as JOpt
from photon_ml_tpu.game.estimator import FixedEffectCoordinateConfig as JFixed
from photon_ml_tpu.game.estimator import RandomEffectCoordinateConfig as JRandom
from photon_ml_tpu.ops.regularization import L2Regularization as JL2
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizer
from photon_ml_tpu.types import OptimizerType as JOptType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.convert import game_model_from_arrays
from photon_ml_tpu_torch.evaluation import parse_evaluators as t_evaluators
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration as TOpt
from photon_ml_tpu_torch.game.estimator import FixedEffectCoordinateConfig as TFixed
from photon_ml_tpu_torch.game.estimator import RandomEffectCoordinateConfig as TRandom
from photon_ml_tpu_torch.ops.regularization import L1Regularization as TL1
from photon_ml_tpu_torch.ops.regularization import L2Regularization as TL2
from photon_ml_tpu_torch.optimize import OptimizerConfig as TOptimizer
from photon_ml_tpu_torch.types import OptimizerType as TOptType
from photon_ml_tpu_torch.types import TaskType as TTask
from photon_ml_tpu_torch.types import VarianceComputationType as TVar

LAM = {"global": 0.01, "perUser": 1.0, "perSong": 1.0}
SEQ = ["global", "perUser", "perSong"]


def _arrays(n, seed, d_global=6, d_item=3, n_users=25, n_songs=15,
            task="LOGISTIC_REGRESSION"):
    """tests/test_game.py::make_music_data without the artist effect; the
    labels of ``task`` drawn from the same margins (linear: plus unit
    noise; Poisson: counts at rate exp(margin / 4))."""
    prng = np.random.default_rng(424242)
    w = prng.normal(size=d_global).astype(np.float32)
    u_user = (1.2 * prng.normal(size=(n_users, d_item))).astype(np.float32)
    u_song = (0.8 * prng.normal(size=(n_songs, d_item))).astype(np.float32)
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(n, d_global)).astype(np.float32)
    xi = rng.normal(size=(n, d_item)).astype(np.float32)
    users = rng.integers(0, n_users, size=n)
    songs = rng.integers(0, n_songs, size=n)
    margin = (xg @ w + np.einsum("nd,nd->n", xi, u_user[users])
              + np.einsum("nd,nd->n", xi, u_song[songs]))
    if task == "LINEAR_REGRESSION":
        y = (margin + rng.normal(size=n)).astype(np.float32)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(margin / 4)).astype(np.float32)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(
            np.float32)
    return y, {"global": xg, "item": xi}, {"userId": users, "songId": songs}


def _game_data(pkg, n, seed, task="LOGISTIC_REGRESSION", weighted=False):
    """The music-shaped data; ``weighted`` adds weights in [0.5, 2] and
    offsets of N(0, 0.2^2), drawn from a generator of their own."""
    y, shards, ids = _arrays(n, seed, task=task)
    extra = {}
    if weighted:
        rng = np.random.default_rng(seed + 1000)
        extra = dict(weights=rng.uniform(0.5, 2.0, size=n).astype(np.float32),
                     offsets=(0.2 * rng.normal(size=n)).astype(np.float32))

    def shard(x):
        nn, dd = x.shape
        return pkg.FeatureShard.from_coo(
            np.repeat(np.arange(nn), dd), np.tile(np.arange(dd), nn),
            np.array(x, np.float32).ravel(), nn, dd)

    return pkg.GameData.build(
        labels=y, shards={k: shard(v) for k, v in shards.items()},
        id_columns=ids, **extra)


def _jax_fit(dtype, task="LOGISTIC_REGRESSION", evaluator="AUC",
             weighted=False):
    cfg = JOpt(regularization=JL2,
               optimizer_config=JOptimizer(max_iterations=40))
    coords = {
        "global": JFixed("global", cfg, design_dtype=dtype),
        "perUser": JRandom(jg.RandomEffectDatasetConfig(
            "userId", "item", bucket_strategy="histogram",
            max_sample_buckets=4), cfg, design_dtype=dtype),
        "perSong": JRandom(jg.RandomEffectDatasetConfig("songId", "item"),
                           cfg, design_dtype=dtype),
    }
    est = jg.GameEstimator(task=JTask(task),
                           coordinate_configs=coords, update_sequence=SEQ,
                           n_cd_iterations=2)
    return est.fit(_game_data(jg, 1200, 0, task, weighted),
                   [jg.GameOptimizationConfiguration(LAM)],
                   validation=(_game_data(jg, 600, 5, task, weighted),
                               j_evaluators([evaluator])))[0]


def _torch_estimator(dtype, task="LOGISTIC_REGRESSION", **overrides):
    cfg = TOpt(regularization=TL2,
               optimizer_config=TOptimizer(max_iterations=40))
    coords = {
        "global": TFixed("global", cfg, design_dtype=dtype),
        "perUser": TRandom(tg.RandomEffectDatasetConfig(
            "userId", "item", bucket_strategy="histogram",
            max_sample_buckets=4), cfg, design_dtype=dtype),
        "perSong": TRandom(tg.RandomEffectDatasetConfig("songId", "item"),
                           cfg, design_dtype=dtype),
    }
    coords.update(overrides)
    return tg.GameEstimator(task=TTask(task),
                            coordinate_configs=coords, update_sequence=SEQ,
                            n_cd_iterations=2, device="cpu")


def _torch_fit(dtype, task="LOGISTIC_REGRESSION", evaluator="AUC",
               weighted=False):
    return _torch_estimator(dtype, task).fit(
        _game_data(tg, 1200, 0, task, weighted),
        [tg.GameOptimizationConfiguration(LAM)],
        validation=(_game_data(tg, 600, 5, task, weighted),
                    t_evaluators([evaluator])))[0]


@pytest.fixture(scope="module")
def fits():
    return {dt: (_jax_fit(dt), _torch_fit(dt))
            for dt in ("float32", "bfloat16")}


#: f32: both packages run the same L-BFGS on the same f32 data, and the
#: fixed effect lands within 1e-3 relative / 1e-4 absolute (measured ~1e-5).
#: A random-effect lane of a few dozen rows ends on the two-stall rule where
#: its objective goes flat: in f32 in the port, in f64 in this test process
#: (x64 makes the JAX value f64), so those lanes stop up to ~4e-4 apart
#: (measured, 1 to 8 CPU threads). bf16: the JAX package's own bf16 bound,
#: 1e-2 — the port's fixed effect also rounds w and wt·d1 to bf16, as its
#: kernel does, where the JAX closed form computes in f32.
TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
RE_TOL = {"float32": dict(rtol=2e-3, atol=5e-4),
          "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fixed_effect_coefficients_match_jax(fits, dtype):
    jres, tres = fits[dtype]
    jw = np.asarray(jres.model.coordinates["global"].model.coefficients.means)
    tw = tres.model.coordinates["global"].model.coefficients.means.numpy()
    np.testing.assert_allclose(tw, jw, **TOL[dtype])


@pytest.mark.parametrize("cid", ["perUser", "perSong"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_random_effect_coefficients_match_jax(fits, dtype, cid):
    jres, tres = fits[dtype]
    jm, tm = jres.model.coordinates[cid], tres.model.coordinates[cid]
    # the same bucketing gives the same (entity, feature) key table
    np.testing.assert_array_equal(tm.keys, jm.keys)
    np.testing.assert_allclose(tm.coeffs, np.asarray(jm.coeffs),
                               **RE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_validation_auc_matches_jax(fits, dtype):
    jres, tres = fits[dtype]
    assert len(tres.validation_history) == 2
    ja, ta = jres.evaluation.primary[1], tres.evaluation.primary[1]
    assert ta > 0.8
    # the AUC surface the reference's own parity target names: 1e-4
    assert abs(ta - ja) < 1e-4, (ta, ja)


#: GAME parity beyond unit-weight logistic regression, in f32: (task,
#: validation evaluator, weights and offsets). The validation metric of
#: each is held to 1e-4 relative, the AUC surface's 1e-4 of the cases
#: above (measured: 3.6e-6 to 1.7e-5, the Poisson loss the largest), the
#: coefficients to TOL's and RE_TOL's f32 rows (measured: fixed effect
#: within 1.7e-5, random-effect lanes within 1.1e-3 absolute, the
#: stall-rule lanes of TOL's note).
TASK_CASES = {
    "logistic-weighted": ("LOGISTIC_REGRESSION", "AUC", True),
    "linear": ("LINEAR_REGRESSION", "RMSE", False),
    "linear-weighted": ("LINEAR_REGRESSION", "RMSE", True),
    "poisson-weighted": ("POISSON_REGRESSION", "POISSON_LOSS", True),
}


@pytest.fixture(scope="module", params=sorted(TASK_CASES))
def task_fits(request):
    case = TASK_CASES[request.param]
    return _jax_fit("float32", *case), _torch_fit("float32", *case)


def test_task_fixed_effect_matches_jax(task_fits):
    jres, tres = task_fits
    jw = np.asarray(jres.model.coordinates["global"].model.coefficients.means)
    tw = tres.model.coordinates["global"].model.coefficients.means.numpy()
    np.testing.assert_allclose(tw, jw, **TOL["float32"])


@pytest.mark.parametrize("cid", ["perUser", "perSong"])
def test_task_random_effects_match_jax(task_fits, cid):
    jres, tres = task_fits
    jm, tm = jres.model.coordinates[cid], tres.model.coordinates[cid]
    np.testing.assert_array_equal(tm.keys, jm.keys)
    np.testing.assert_allclose(tm.coeffs, np.asarray(jm.coeffs),
                               **RE_TOL["float32"])


def test_task_validation_metric_matches_jax(task_fits):
    jres, tres = task_fits
    assert len(tres.validation_history) == 2
    (jname, jm), (tname, tm) = jres.evaluation.primary, tres.evaluation.primary
    assert tname.name == jname.name and np.isfinite(tm)
    assert abs(tm - jm) <= 1e-4 * abs(jm), (tname.name, tm, jm)


def test_tron_fit_matches_jax():
    """TRON on the fixed effect (kernel 3's plain version per CG product on
    the CPU) and on the per-user random effect (the closed-form Hvp over
    each (E, S, D) bucket), L-BFGS on the per-song one, against the JAX
    estimator (run in f32): the f32 tolerances of the L-BFGS fits above."""
    tron = dict(optimizer=JOptType.TRON, regularization=JL2,
                optimizer_config=JOptimizer(max_iterations=40))
    jcfg, jtron = JOpt(regularization=JL2, optimizer_config=JOptimizer(
        max_iterations=40)), JOpt(**tron)
    tcfg = TOpt(regularization=TL2,
                optimizer_config=TOptimizer(max_iterations=40))
    ttron = TOpt(optimizer=TOptType.TRON, regularization=TL2,
                 optimizer_config=TOptimizer(max_iterations=40))
    user = dict(bucket_strategy="histogram", max_sample_buckets=4)
    jest = jg.GameEstimator(
        task=JTask.LOGISTIC_REGRESSION, update_sequence=SEQ,
        n_cd_iterations=2, coordinate_configs={
            "global": JFixed("global", jtron),
            "perUser": JRandom(jg.RandomEffectDatasetConfig(
                "userId", "item", **user), jtron),
            "perSong": JRandom(jg.RandomEffectDatasetConfig(
                "songId", "item"), jcfg)})
    test = _torch_estimator("float32", **{
        "global": TFixed("global", ttron),
        "perUser": TRandom(tg.RandomEffectDatasetConfig(
            "userId", "item", **user), ttron)})
    assert test.coordinate_configs["perSong"].optimization == tcfg
    # the JAX package's TRON keeps its trust radius in the gradient's dtype,
    # which x64 mode (on in this test process) makes f64 under f32 designs
    # — a while_loop carry-type error; run it in f32, as on its TPU (set
    # process-wide: the estimator also compiles in worker threads)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        jres = jest.fit(_game_data(jg, 1200, 0),
                        [jg.GameOptimizationConfiguration(LAM)],
                        validation=(_game_data(jg, 600, 5),
                                    j_evaluators(["AUC"])))[0]
    finally:
        jax.config.update("jax_enable_x64", x64)
    tres = test.fit(_game_data(tg, 1200, 0),
                    [tg.GameOptimizationConfiguration(LAM)],
                    validation=(_game_data(tg, 600, 5),
                                t_evaluators(["AUC"])))[0]
    np.testing.assert_allclose(
        tres.model.coordinates["global"].model.coefficients.means.numpy(),
        np.asarray(jres.model.coordinates["global"].model.coefficients.means),
        **TOL["float32"])
    for cid in ("perUser", "perSong"):
        jm, tm = jres.model.coordinates[cid], tres.model.coordinates[cid]
        np.testing.assert_array_equal(tm.keys, jm.keys)
        np.testing.assert_allclose(tm.coeffs, np.asarray(jm.coeffs),
                                   **RE_TOL["float32"])
    assert abs(tres.evaluation.primary[1] - jres.evaluation.primary[1]) < 1e-4


def test_score_accounting_invariant(fits):
    _, tres = fits["float32"]
    data = _game_data(tg, 1200, 0)
    total = tres.model.score(data)
    # per-coordinate host scores sum to the total the model reports
    by = tres.model.score_by_coordinate(data)
    np.testing.assert_allclose(total, sum(by.values()), rtol=1e-5, atol=1e-5)


def test_jax_model_carried_across_scores_the_same(fits):
    jres, _ = fits["float32"]
    spec = {}
    for cid, m in jres.model.coordinates.items():
        if isinstance(m, jg.FixedEffectModel):
            spec[cid] = {"kind": "fixed",
                         "feature_shard_id": m.feature_shard_id,
                         "means": np.asarray(m.model.coefficients.means)}
        else:
            spec[cid] = {"kind": "random",
                         "random_effect_type": m.random_effect_type,
                         "feature_shard_id": m.feature_shard_id,
                         "dim": m.dim, "keys": np.asarray(m.keys),
                         "coeffs": np.asarray(m.coeffs)}
    port_model = game_model_from_arrays(jres.model.task.value, spec,
                                        device="cpu")
    assert list(port_model.coordinates) == SEQ
    got = port_model.score(_game_data(tg, 600, 5))
    want = jres.model.score(_game_data(jg, 600, 5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_select_best_prefers_higher_auc():
    est = _torch_estimator("float32")
    results = est.fit(
        _game_data(tg, 400, 1),
        [tg.GameOptimizationConfiguration({"global": 1e3, "perUser": 1e3,
                                           "perSong": 1e3}),
         tg.GameOptimizationConfiguration(LAM)],
        validation=(_game_data(tg, 300, 6), t_evaluators(["AUC"])))
    best = tg.GameEstimator.select_best(results)
    assert best is results[1]


@pytest.mark.parametrize("override,check", [
    ({"global": TFixed("global", TOpt(
        optimizer=TOptType.TRON, regularization=TL2,
        variance_type=TVar.SIMPLE))},
     lambda m: m.coordinates["global"].model.coefficients.variances),
    ({"global": TFixed("global", TOpt(regularization=TL1))},
     lambda m: m.coordinates["global"].model.coefficients.means),
    ({"perUser": TRandom(tg.RandomEffectDatasetConfig(
        "userId", "item", projector_type=tg.ProjectorType.RANDOM,
        projected_dim=2), TOpt(regularization=TL2))},
     lambda m: m.coordinates["perUser"].projector.matrix),
    ({"perUser": TRandom(tg.RandomEffectDatasetConfig(
        "userId", "item", cache_device_buckets=False),
        TOpt(regularization=TL2))},
     lambda m: m.coordinates["perUser"].coeffs),
], ids=["tron", "l1", "random-projector", "streaming"])
def test_unsupported_options_raise(override, check):
    """Options the port once refused (TRON with variances, L1, the RANDOM
    projector, streaming buckets) now build and fit; their parity with the
    JAX package is held in tests/test_torch_game_options.py."""
    result = _torch_estimator("float32", **override).fit(
        _game_data(tg, 200, 0), [tg.GameOptimizationConfiguration(LAM)])[0]
    got = check(result.model)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.size and np.isfinite(got).all()


def test_unsupported_fit_arguments_raise():
    """A deferred (callable) validation set, once refused, is now resolved
    at the first evaluation."""
    est = _torch_estimator("float32")
    result = est.fit(_game_data(tg, 200, 0),
                     [tg.GameOptimizationConfiguration(LAM)],
                     validation=lambda: (_game_data(tg, 100, 5),
                                         t_evaluators(["AUC"])))[0]
    assert len(result.validation_history) == 2
    assert 0.5 < result.evaluation.primary[1] <= 1.0


def _no_device_entry_points():
    from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
    from photon_ml_tpu_torch.ops.normalization import build_normalization
    from photon_ml_tpu_torch.types import NormalizationType

    cfg = TOpt(regularization=TL2)
    ones = np.ones(3)
    return {
        "estimator": lambda: tg.GameEstimator(
            task=TTask.LOGISTIC_REGRESSION,
            coordinate_configs={"global": TFixed("global", cfg)},
            update_sequence=["global"]),
        "fixed-effect-dataset": lambda: tg.FixedEffectDataset.build(
            "global", _game_data(tg, 20, 0), "global"),
        "random-effect-solver": lambda: RandomEffectSolver(
            task=TTask.LOGISTIC_REGRESSION, config=cfg),
        "normalization": lambda: build_normalization(
            NormalizationType.NONE, mean=ones, variance=ones,
            max_magnitude=ones, intercept_index=None),
        "carried-model": lambda: game_model_from_arrays(
            "LOGISTIC_REGRESSION", {}),
    }


@pytest.mark.parametrize("entry", sorted(_no_device_entry_points()))
def test_default_device_is_cuda(monkeypatch, entry):
    """Every entry point that places tensors defaults to ``cuda`` and, on a
    machine without one, raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _no_device_entry_points()[entry]()
