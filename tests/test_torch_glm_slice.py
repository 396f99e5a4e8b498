"""The GLM training slice on the CPU against the JAX package, in float64:
the objective's second-order methods, the sequential (TRON and L-BFGS) and
batched regularization sweeps, variances, model selection, and carrying a
JAX-trained GLM and its data across with photon_ml_tpu_torch.convert.

Both packages run the same algorithms on the same f64 data, so the
coefficients agree to summation order (1e-8), iteration counts exactly.
A dense design with identity normalization runs the port's kernel
wrappers (their plain versions on the CPU); a normalized design the closed
forms; the JAX package takes its closed forms off the TPU in both cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import parse_evaluators as j_evaluators
from photon_ml_tpu.glm import training as jt
from photon_ml_tpu.glm.problem import GLMOptimizationConfiguration as JOpt
from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.ops.design import DenseDesign as JDense
from photon_ml_tpu.ops.normalization import build_normalization as j_norm
from photon_ml_tpu.ops.objective import GLMData as JData
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.ops.regularization import L2Regularization as JL2
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizer
from photon_ml_tpu.types import NormalizationType as JNT
from photon_ml_tpu.types import OptimizerType as JOptType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch import glm as tglm
from photon_ml_tpu_torch.convert import (
    glm_data_from_arrays,
    glm_model_from_arrays,
)
from photon_ml_tpu_torch.evaluation import parse_evaluators as t_evaluators
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration as TOpt
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops.normalization import build_normalization as t_norm
from photon_ml_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.ops.regularization import L2Regularization as TL2
from photon_ml_tpu_torch.optimize import OptimizerConfig as TOptimizer
from photon_ml_tpu_torch.types import NormalizationType as TNT
from photon_ml_tpu_torch.types import OptimizerType as TOptType
from photon_ml_tpu_torch.types import TaskType as TTask
from photon_ml_tpu_torch.types import VarianceComputationType as TVar

#: f64 on both sides, the same algorithm: only summation order differs
W_TOL = dict(rtol=1e-8, atol=1e-8)
LAMBDAS = [10.0, 0.1, 1.0]
NORMS = ["NONE", "STANDARDIZATION"]


def _arrays(n=80, d=6, seed=0, task="logistic"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * np.geomspace(0.3, 3.0, d)
    x[:, 0] = 1.0  # intercept column
    w_true = rng.normal(size=d)
    m = x @ w_true / 2
    if task == "poisson":
        y = rng.poisson(np.exp(np.clip(m, -3, 3))).astype(np.float64)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float64)
    off = 0.1 * rng.normal(size=n)
    wt = rng.uniform(0.5, 2.0, size=n)
    wt[::7] = 0.0  # weight-0 (padding) rows
    return x, y, off, wt


def _data(x, y, off, wt):
    jd = JData(design=JDense(jnp.asarray(x)), labels=jnp.asarray(y),
               offsets=jnp.asarray(off), weights=jnp.asarray(wt))
    td = glm_data_from_arrays(x, y, off, wt, dtype=torch.float64,
                              device="cpu")
    return jd, td


def _norms(norm, x):
    stats = dict(mean=x.mean(0), variance=x.var(0),
                 max_magnitude=np.abs(x).max(0), intercept_index=0)
    return (j_norm(getattr(JNT, norm), dtype=jnp.float64, **stats),
            t_norm(getattr(TNT, norm), dtype=torch.float64, device="cpu",
                   **stats))


def _mask(d):
    mask = np.ones(d)
    mask[0] = 0.0  # exempt the intercept from L2
    return jnp.asarray(mask), torch.as_tensor(mask)


def _configs(optimizer, variance="NONE", max_iterations=60):
    return (JOpt(optimizer=getattr(JOptType, optimizer), regularization=JL2,
                 optimizer_config=JOptimizer(max_iterations=max_iterations),
                 variance_type=getattr(JVar, variance)),
            TOpt(optimizer=getattr(TOptType, optimizer), regularization=TL2,
                 optimizer_config=TOptimizer(max_iterations=max_iterations),
                 variance_type=getattr(TVar, variance)))


def _assert_same_sweep(jres, tres, tol=W_TOL):
    assert [m.regularization_weight for m in tres] == \
        [m.regularization_weight for m in jres]
    for jm, tm in zip(jres, tres):
        np.testing.assert_array_equal(int(tm.result.iterations),
                                      int(jm.result.iterations))
        assert bool(tm.result.converged) == bool(jm.result.converged)
        np.testing.assert_allclose(tm.model.coefficients.means.numpy(),
                                   np.asarray(jm.model.coefficients.means),
                                   **tol)
        np.testing.assert_allclose(float(tm.result.value),
                                   float(jm.result.value), rtol=1e-10)


# --- the objective's second-order methods ----------------------------------

@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", ["logistic", "poisson"])
def test_hvp_and_hessians_match_jax(name, norm):
    """hvp_operator (kernel 3's plain version for NONE, the chain-rule
    closed form for STANDARDIZATION), hessian_diagonal and hessian_matrix,
    with an L2 mask."""
    x, y, off, wt = _arrays(task=name)
    x[3, 1:] = 60.0  # a weight-0 row whose raw margin would overflow exp()
    wt[3] = 0.0
    jd, td = _data(x, y, off, wt)
    jn, tn = _norms(norm, x)
    jm, tm = _mask(x.shape[1])
    jloss, tloss = ((jl.PoissonLoss, tl.PoissonLoss) if name == "poisson"
                    else (jl.LogisticLoss, tl.LogisticLoss))
    jobj = JObjective(loss=jloss, normalization=jn, reg_mask=jm)
    tobj = TObjective(loss=tloss, normalization=tn, reg_mask=tm)
    rng = np.random.default_rng(5)
    w, v = 0.2 * rng.normal(size=x.shape[1]), rng.normal(size=x.shape[1])
    tw, tv = torch.as_tensor(w), torch.as_tensor(v)
    np.testing.assert_allclose(
        tobj.hvp_operator(tw, td, 0.7)(tv).numpy(),
        np.asarray(jobj.hvp(jnp.asarray(w), jnp.asarray(v), jd, 0.7)),
        rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        tobj.hessian_diagonal(tw, td, 0.7).numpy(),
        np.asarray(jobj.hessian_diagonal(jnp.asarray(w), jd, 0.7)),
        rtol=1e-10)
    np.testing.assert_allclose(
        tobj.hessian_matrix(tw, td, 0.7).numpy(),
        np.asarray(jobj.hessian_matrix(jnp.asarray(w), jd, 0.7)),
        rtol=1e-10, atol=1e-10)


def test_lanes_share_the_design_with_one_lambda_each():
    """w (M, d) against an (n, d) design with l2 (M,) is M objectives: the
    kernel-4 path (its plain version here) and the per-lane Hvp."""
    x, y, off, wt = _arrays()
    _, td = _data(x, y, off, wt)
    obj = TObjective(loss=tl.LogisticLoss)
    ws = torch.as_tensor(np.random.default_rng(2).normal(size=(3, 6)))
    lams = torch.tensor([0.5, 2.0, 0.0], dtype=torch.float64)
    values, grads = obj.value_and_grad(ws, td, lams)
    hv = obj.hvp_operator(ws, td, lams)(ws)
    for m in range(3):
        v, g = obj.value_and_grad(ws[m], td, float(lams[m]))
        torch.testing.assert_close(values[m], v, rtol=1e-12, atol=0)
        torch.testing.assert_close(grads[m], g, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(
            hv[m], obj.hvp(ws[m], ws[m], td, float(lams[m])),
            rtol=1e-12, atol=1e-12)


# --- the sweeps ------------------------------------------------------------

@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
def test_sequential_sweep_matches_jax(optimizer, norm):
    """Descending lambdas with warm starts, an L2 mask exempting the
    intercept; models back in original feature space."""
    x, y, off, wt = _arrays(seed=1)
    jd, td = _data(x, y, off, wt)
    jn, tn = _norms(norm, x)
    jm, tm = _mask(x.shape[1])
    jcfg, tcfg = _configs(optimizer)
    jres = jt.train_glm_sweep(JTask.LOGISTIC_REGRESSION, jd, LAMBDAS, jcfg,
                              normalization=jn, reg_mask=jm)
    tres = tglm.train_glm_sweep(TTask.LOGISTIC_REGRESSION, td, LAMBDAS, tcfg,
                                normalization=tn, reg_mask=tm)
    assert [m.regularization_weight for m in tres] == [10.0, 1.0, 0.1]
    _assert_same_sweep(jres, tres)


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
def test_batched_sweep_matches_jax(optimizer):
    """All lambdas as lanes of one solve (kernel 4's plain version for the
    objective, the per-lane kernel-3 Hvp for TRON)."""
    x, y, off, wt = _arrays(seed=3)
    jd, td = _data(x, y, off, wt)
    jcfg, tcfg = _configs(optimizer)
    jres = jt.train_glm_sweep_batched(JTask.LOGISTIC_REGRESSION, jd, LAMBDAS,
                                      jcfg)
    tres = tglm.train_glm_sweep_batched(TTask.LOGISTIC_REGRESSION, td,
                                        LAMBDAS, tcfg)
    its = [int(m.result.iterations) for m in tres]
    assert len(set(its)) > 1  # lanes stop at different iterations
    _assert_same_sweep(jres, tres)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("variance", ["SIMPLE", "FULL"])
def test_variances_match_jax(variance, norm):
    """Variances at each lambda's solution, mapped to original space with
    the squared factors."""
    x, y, off, wt = _arrays(seed=4)
    x[:, 5] = 0.0  # an all-zero column: FULL gives it variance 0 (pinv)
    jd, td = _data(x, y, off, wt)
    jn, tn = _norms(norm, x)
    jcfg, tcfg = _configs("TRON", variance)
    jres = jt.train_glm_sweep(JTask.LOGISTIC_REGRESSION, jd, LAMBDAS[:2],
                              jcfg, normalization=jn)
    tres = tglm.train_glm_sweep(TTask.LOGISTIC_REGRESSION, td, LAMBDAS[:2],
                                tcfg, normalization=tn)
    for jm, tm in zip(jres, tres):
        got = tm.model.coefficients.variances.numpy()
        want = np.asarray(jm.model.coefficients.variances)
        assert np.all(np.isfinite(got)) and np.all(got >= 0)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_run_with_variances_matches_jax():
    """One TRON solve from a (d,) start and FULL variances at its
    solution, through both packages' OptimizationProblem."""
    from photon_ml_tpu.glm.problem import OptimizationProblem as JProblem

    x, y, off, wt = _arrays(seed=9)
    jd, td = _data(x, y, off, wt)
    jcfg, tcfg = _configs("TRON", "FULL")
    jc, jr = JProblem(JObjective(loss=jl.LogisticLoss), jcfg) \
        .run_with_variances(jd, jnp.zeros(x.shape[1]), 0.5)
    tc, tr = tglm.OptimizationProblem(TObjective(loss=tl.LogisticLoss), tcfg) \
        .run_with_variances(td, torch.zeros(x.shape[1], dtype=torch.float64),
                            0.5)
    assert int(tr.iterations[0]) == int(jr.iterations)
    np.testing.assert_allclose(tc.means.numpy(), np.asarray(jc.means),
                               **W_TOL)
    np.testing.assert_allclose(tc.variances.numpy(), np.asarray(jc.variances),
                               rtol=1e-8)


def test_validate_and_select_picks_the_same_model():
    x, y, off, wt = _arrays(n=120, seed=6)
    jd, td = _data(x, y, off, wt)
    vx, vy, voff, vwt = _arrays(n=90, seed=7)
    jv, tv = _data(vx, vy, voff, vwt)
    jcfg, tcfg = _configs("LBFGS")
    lams = [100.0, 10.0, 1.0, 0.01]
    j_best, j_eval = jt.validate_and_select(
        jt.train_glm_sweep(JTask.LOGISTIC_REGRESSION, jd, lams, jcfg),
        j_evaluators(["AUC", "LOGISTIC_LOSS"]), jv)
    t_best, t_eval = tglm.validate_and_select(
        tglm.train_glm_sweep(TTask.LOGISTIC_REGRESSION, td, lams, tcfg),
        t_evaluators(["AUC", "LOGISTIC_LOSS"]), tv)
    assert t_best == j_best
    for jm, tm in zip(j_eval, t_eval):
        for (_, jval), (_, tval) in zip(jm.evaluation.results,
                                        tm.evaluation.results):
            np.testing.assert_allclose(tval, jval, rtol=1e-9)
    # grouped evaluators read their groups from id_tags (-1: no tag)
    groups = {"q": np.random.default_rng(8).integers(-1, 6, size=90)}
    specs = ["AUC:q", "PRECISION@3:q", "AUC"]
    j_best, j_eval = jt.validate_and_select(j_eval, j_evaluators(specs), jv,
                                            id_tags=groups)
    t_best, t_eval = tglm.validate_and_select(t_eval, t_evaluators(specs),
                                              tv, id_tags=groups)
    assert t_best == j_best
    for jm, tm in zip(j_eval, t_eval):
        for (_, jval), (_, tval) in zip(jm.evaluation.results,
                                        tm.evaluation.results):
            np.testing.assert_allclose(tval, jval, rtol=1e-9)


def test_jax_glm_carried_across_scores_the_same():
    x, y, off, wt = _arrays(seed=8)
    jd, td = _data(x, y, off, wt)
    jn, _ = _norms("STANDARDIZATION", x)
    jcfg, _ = _configs("TRON", "SIMPLE")
    jm = jt.train_glm_sweep(JTask.LOGISTIC_REGRESSION, jd, [1.0], jcfg,
                            normalization=jn)[0].model
    tm = glm_model_from_arrays(
        jm.task.value, np.asarray(jm.coefficients.means),
        np.asarray(jm.coefficients.variances), device="cpu")
    np.testing.assert_allclose(tm.score(td.design, td.offsets).numpy(),
                               np.asarray(jm.score(jd.design, jd.offsets)),
                               rtol=1e-12)
    np.testing.assert_allclose(
        tm.predict_mean(td.design).numpy(),
        np.asarray(jm.predict_mean(jd.design)), rtol=1e-12)
    assert tm.coefficients.variances.shape == (x.shape[1],)


def test_glm_data_from_arrays_defaults_and_dtypes():
    x, y, _, _ = _arrays(n=10)
    d = glm_data_from_arrays(x, y, dtype="bfloat16", device="cpu")
    assert d.design.x.dtype == torch.bfloat16
    assert d.labels.dtype == torch.float32
    assert torch.equal(d.weights, torch.ones(10))
    assert torch.equal(d.offsets, torch.zeros(10))


def test_glm_entry_points_default_to_cuda(monkeypatch):
    """Without a CUDA device the GLM entry points that place tensors raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _, _ = _arrays(n=10)
    for entry in (lambda: glm_data_from_arrays(x, y),
                  lambda: glm_model_from_arrays("LOGISTIC_REGRESSION",
                                                np.zeros(3))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()


def test_owlqn_still_raises():
    """L1 needs OWL-QN: TRON with an L1 part still raises, as in the JAX
    package (OWL-QN itself is held to the JAX package in
    tests/test_torch_owlqn.py)."""
    from photon_ml_tpu_torch.ops.regularization import L1Regularization

    with pytest.raises(ValueError, match="OWLQN"):
        TOpt(optimizer=TOptType.TRON, regularization=L1Regularization)
