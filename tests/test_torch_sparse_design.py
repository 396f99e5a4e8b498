"""The chunked sparse design (photon_ml_tpu_torch.ops.design) against the
JAX package's, in float64 on the CPU: the host layouts element for element,
the three contractions, and the GLM objective's value, gradient, Hvp,
Hessian diagonal and Hessian matrix on a sparse design (with and without
STANDARDIZATION's shifts); then a GAME fit whose fixed effect is too wide
to densify, and the feature statistics of photon_ml_tpu_torch.stat."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.game as jg
import photon_ml_tpu_torch.game as tg
from photon_ml_tpu.evaluation import parse_evaluators as j_evaluators
from photon_ml_tpu.game.estimator import FixedEffectCoordinateConfig as JFixed
from photon_ml_tpu.game.estimator import RandomEffectCoordinateConfig as JRandom
from photon_ml_tpu.glm.problem import GLMOptimizationConfiguration as JOpt
from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops.design import ChunkedSparseDesign as JChunked
from photon_ml_tpu.ops.normalization import build_normalization as j_norm
from photon_ml_tpu.ops.objective import GLMData as JData
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.ops.regularization import L2Regularization as JL2
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizer
from photon_ml_tpu.stat import FeatureDataStatistics as JStats
from photon_ml_tpu.types import NormalizationType as JNT
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.evaluation import parse_evaluators as t_evaluators
from photon_ml_tpu_torch.game.estimator import FixedEffectCoordinateConfig as TFixed
from photon_ml_tpu_torch.game.estimator import RandomEffectCoordinateConfig as TRandom
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration as TOpt
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops.design import ChunkedSparseDesign as TChunked
from photon_ml_tpu_torch.ops.design import CsrDesign as TCsr
from photon_ml_tpu_torch.ops.normalization import build_normalization as t_norm
from photon_ml_tpu_torch.ops.objective import GLMData as TData
from photon_ml_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.ops.regularization import L2Regularization as TL2
from photon_ml_tpu_torch.optimize import OptimizerConfig as TOptimizer
from photon_ml_tpu_torch.stat import FeatureDataStatistics as TStats
from photon_ml_tpu_torch.types import NormalizationType as TNT
from photon_ml_tpu_torch.types import TaskType as TTask

N, D = 60, 23


def _coo(seed=0, n=N, d=D, nnz=300):
    """COO triplets with duplicate (row, col) entries, explicit zeros, the
    last 4 rows and 3 columns empty, an intercept-like column 0 in every
    other row, and one row of many entries (several chunks of one key)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n - 4, nnz)
    cols = rng.integers(1, d - 3, nnz)
    vals = rng.normal(size=nnz) * 2.0
    vals[::11] = 0.0  # explicit zeros
    rows = np.concatenate([rows, [3, 3, 3], np.full(40, 7),
                           np.arange(n - 4)])
    cols = np.concatenate([cols, [5, 5, 5], rng.integers(1, d - 3, 40),
                           np.zeros(n - 4, np.int64)])
    vals = np.concatenate([vals, [1.5, -0.5, 2.0], rng.normal(size=40),
                           np.ones(n - 4)])
    return rows, cols, vals


def _dense(rows, cols, vals, n=N, d=D):
    x = np.zeros((n, d))
    np.add.at(x, (rows, cols), vals.astype(np.float32).astype(np.float64))
    return x


@pytest.mark.parametrize("chunks", [(None, None), (8, 16), (24, 8)])
def test_layout_numpy_matches_jax(chunks):
    rows, cols, vals = _coo()
    kw = dict(row_chunk=chunks[0], col_chunk=chunks[1])
    got = TChunked.layout_numpy(rows, cols, vals, **kw)
    want = JChunked.layout_numpy(rows, cols, vals, **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k


def _designs(seed=0, **chunks):
    rows, cols, vals = _coo(seed)
    return (JChunked.from_coo(rows, cols, vals, N, D, **chunks),
            TChunked.from_coo(rows, cols, vals, N, D, device="cpu",
                              **chunks),
            _dense(rows, cols, vals))


def _squared_t(g, seed=0):
    """(X²)ᵀg entry by entry: a duplicate (row, col) squares apart, and
    the f32 values square in f32, as both packages square them."""
    rows, cols, vals = _coo(seed)
    v32 = vals.astype(np.float32)
    out = np.zeros(D)
    np.add.at(out, cols, (v32 * v32).astype(np.float64) * g[rows])
    return out


@pytest.mark.parametrize("chunks", [{}, dict(row_chunk=8, col_chunk=8)])
def test_contractions_match_jax(chunks):
    jd, td, x = _designs(**chunks)
    rng = np.random.default_rng(1)
    w, g = rng.normal(size=D), rng.normal(size=N)
    for name, arg, want in (("matvec", w, x @ w),
                            ("rmatvec", g, x.T @ g),
                            ("rmatvec_squared", g, _squared_t(g))):
        got = getattr(td, name)(torch.as_tensor(arg)).numpy()
        jgot = np.asarray(getattr(jd, name)(jnp.asarray(arg)))
        np.testing.assert_allclose(got, jgot, rtol=1e-12, atol=1e-12,
                                   err_msg=name)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    # empty rows and columns come out as exact zeros
    assert (td.matvec(torch.as_tensor(w))[-4:] == 0).all()
    assert (td.rmatvec(torch.as_tensor(g))[-3:] == 0).all()


def test_lanes_share_one_gather():
    """``(M, d)`` coefficient rows and ``(..., n)`` multipliers: each lane
    as if alone, and bit-identical on a rerun."""
    _, td, _ = _designs()
    rng = np.random.default_rng(2)
    ws = torch.as_tensor(rng.normal(size=(3, D)))
    gs = torch.as_tensor(rng.normal(size=(2, 3, N)))
    mv, rv = td.matvec(ws), td.rmatvec(gs)
    assert mv.shape == (3, N) and rv.shape == (2, 3, D)
    for m in range(3):
        torch.testing.assert_close(mv[m], td.matvec(ws[m]), rtol=1e-14,
                                   atol=1e-14)
        torch.testing.assert_close(rv[1, m], td.rmatvec(gs[1, m]),
                                   rtol=1e-14, atol=1e-14)
    assert torch.equal(td.matvec(ws), mv)
    assert torch.equal(td.rmatvec(gs), rv)


def test_csr_design_matches_dense():
    rows, cols, vals = _coo()
    td = TCsr.from_coo(rows, cols, vals, N, D, device="cpu")
    x = _dense(rows, cols, vals)
    rng = np.random.default_rng(4)
    w, g = rng.normal(size=D), rng.normal(size=N)
    np.testing.assert_allclose(td.matvec(torch.as_tensor(w)).numpy(), x @ w,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(td.rmatvec(torch.as_tensor(g)).numpy(),
                               x.T @ g, rtol=1e-12, atol=1e-12)


def _stats(x):
    return dict(mean=x.mean(0), variance=x.var(0, ddof=1),
                max_magnitude=np.abs(x).max(0), intercept_index=0)


@pytest.mark.parametrize("norm", ["NONE", "STANDARDIZATION"])
@pytest.mark.parametrize("name", ["LogisticLoss", "PoissonLoss"])
def test_objective_on_sparse_design_matches_jax(name, norm):
    jd, td, x = _designs(seed=3)
    rng = np.random.default_rng(5)
    if name == "PoissonLoss":
        y = rng.poisson(1.0, size=N).astype(np.float64)
    else:
        y = (rng.uniform(size=N) < 0.5).astype(np.float64)
    off = 0.1 * rng.normal(size=N)
    wt = rng.uniform(0.5, 2.0, size=N)
    wt[::9] = 0.0
    w = 0.2 * rng.normal(size=D)
    v = rng.normal(size=D)
    mask = np.ones(D)
    mask[0] = 0.0
    jnorm = j_norm(getattr(JNT, norm), dtype=jnp.float64, **_stats(x))
    tnorm = t_norm(getattr(TNT, norm), dtype=torch.float64, device="cpu",
                   **_stats(x))
    jobj = JObjective(loss=getattr(jl, name), normalization=jnorm,
                      reg_mask=jnp.asarray(mask))
    tobj = TObjective(loss=getattr(tl, name), normalization=tnorm,
                      reg_mask=torch.as_tensor(mask))
    jdata = JData(design=jd, labels=jnp.asarray(y), offsets=jnp.asarray(off),
                  weights=jnp.asarray(wt))
    tdata = TData(design=td, labels=torch.as_tensor(y),
                  offsets=torch.as_tensor(off), weights=torch.as_tensor(wt))
    assert not tobj.uses_kernel(tdata)
    jw, tw, l2 = jnp.asarray(w), torch.as_tensor(w), 0.7
    jv, jgrad = jobj.value_and_grad(jw, jdata, l2)
    tv, tgrad = tobj.value_and_grad(tw, tdata, l2)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-12)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-10,
                               atol=1e-12)
    for label, got, want in (
            ("hvp", tobj.hvp(tw, torch.as_tensor(v), tdata, l2),
             jobj.hvp(jw, jnp.asarray(v), jdata, l2)),
            ("hessian_diagonal", tobj.hessian_diagonal(tw, tdata, l2),
             jobj.hessian_diagonal(jw, jdata, l2)),
            ("hessian_matrix", tobj.hessian_matrix(tw, tdata, l2),
             jobj.hessian_matrix(jw, jdata, l2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-10, err_msg=label)


def _wide_game_data(pkg, n, seed, d_wide=5000, k=8, n_users=20, d_item=3):
    """A logistic fixed effect over ``d_wide`` columns with ``k`` entries a
    row (wider than 512·k and 4096: no dense design) plus an intercept
    column, and a per-user random effect on a dense 3-wide shard."""
    prm = np.random.default_rng(77)
    w = prm.normal(size=d_wide)
    u = prm.normal(size=(n_users, d_item))
    rng = np.random.default_rng(seed)
    cols = np.stack([rng.choice(d_wide - 1, k, replace=False)
                     for _ in range(n)])
    vals = rng.normal(size=(n, k))
    xi = rng.normal(size=(n, d_item))
    users = rng.integers(0, n_users, n)
    margin = ((w[cols] * vals).sum(1) / np.sqrt(k)
              + np.einsum("nd,nd->n", xi, u[users]))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    g_rows = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
    g_cols = np.concatenate([cols.ravel(), np.full(n, d_wide - 1)])
    g_vals = np.concatenate([vals.ravel(), np.ones(n)])
    shards = {
        "global": pkg.FeatureShard.from_coo(g_rows, g_cols, g_vals, n,
                                            d_wide),
        "item": pkg.FeatureShard.from_coo(
            np.repeat(np.arange(n), d_item), np.tile(np.arange(d_item), n),
            xi.ravel(), n, d_item)}
    return pkg.GameData.build(labels=y, shards=shards,
                              id_columns={"userId": users})


def test_game_fit_with_a_sparse_fixed_effect_matches_jax():
    """The wide fixed effect trains on a chunked sparse design in both
    packages; the f32 tolerances of tests/test_torch_game.py."""
    lam = {"global": 10.0, "perUser": 1.0}
    seq = ["global", "perUser"]
    jcfg = JOpt(regularization=JL2,
                optimizer_config=JOptimizer(max_iterations=100))
    tcfg = TOpt(regularization=TL2,
                optimizer_config=TOptimizer(max_iterations=100))
    jest = jg.GameEstimator(
        task=JTask.LOGISTIC_REGRESSION, update_sequence=seq,
        n_cd_iterations=2, coordinate_configs={
            "global": JFixed("global", jcfg),
            "perUser": JRandom(jg.RandomEffectDatasetConfig(
                "userId", "item"), jcfg)})
    test = tg.GameEstimator(
        task=TTask.LOGISTIC_REGRESSION, update_sequence=seq,
        n_cd_iterations=2, device="cpu", coordinate_configs={
            "global": TFixed("global", tcfg),
            "perUser": TRandom(tg.RandomEffectDatasetConfig(
                "userId", "item"), tcfg)})
    tdata = _wide_game_data(tg, 800, 0)
    assert isinstance(test.prepare(tdata)["global"].design, TChunked)
    jres = jest.fit(_wide_game_data(jg, 800, 0),
                    [jg.GameOptimizationConfiguration(lam)],
                    validation=(_wide_game_data(jg, 400, 1),
                                j_evaluators(["AUC"])))[0]
    tres = test.fit(tdata, [tg.GameOptimizationConfiguration(lam)],
                    validation=(_wide_game_data(tg, 400, 1),
                                t_evaluators(["AUC"])))[0]
    np.testing.assert_allclose(
        tres.model.coordinates["global"].model.coefficients.means.numpy(),
        np.asarray(jres.model.coordinates["global"].model.coefficients.means),
        rtol=1e-3, atol=1e-4)
    ju, tu = jres.model.coordinates["perUser"], tres.model.coordinates[
        "perUser"]
    np.testing.assert_array_equal(tu.keys, np.asarray(ju.keys))
    np.testing.assert_allclose(tu.coeffs, np.asarray(ju.coeffs), rtol=2e-3,
                               atol=5e-4)
    ta, ja = tres.evaluation.primary[1], jres.evaluation.primary[1]
    assert ta > 0.6
    assert abs(ta - ja) < 1e-4, (ta, ja)


def test_feature_statistics_match_jax():
    """Implicit zeros, explicit zeros, duplicates and a full-support column
    (min and max from the stored values alone)."""
    rows, cols, vals = _coo(seed=6)
    full = np.arange(N)
    rows = np.concatenate([rows, full])
    cols = np.concatenate([cols, np.full(N, D - 1)])
    vals = np.concatenate([vals, np.linspace(0.5, 3.0, N)])
    got = TStats.from_shard(tg.FeatureShard.from_coo(rows, cols, vals, N, D))
    want = JStats.from_shard(jg.FeatureShard.from_coo(rows, cols, vals, N,
                                                      D))
    for f in ("mean", "variance", "min", "max", "max_magnitude",
              "num_nonzeros"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.count == want.count == N
    assert got.min[D - 1] == 0.5  # full support: no implicit zero
    assert got.allreduce() is got
    names = [f"f{j}\u0001t{j % 2}" for j in range(D)]
    assert list(got.to_records(names)) == list(want.to_records(names))
