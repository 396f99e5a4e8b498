"""One process over several slots: the port's meshes against the JAX
package's on the CPU. The JAX side runs on the conftest's 8 virtual
devices, the port's on 8 CPU slots (``make_mesh(devices=["cpu"] * 8)``);
inputs come from numpy seeds.

- the data axis: ``DistributedGLMObjective(mesh=)`` over
  ``shard_glm_data(device_put_mesh=)`` — value within rtol 1e-12, gradient
  and Hvp within rtol 1e-10 / atol 1e-12 (f64, dense and CSR), as
  ``tests/test_distributed.py`` holds the JAX objective;
- the feature axis: ``FeatureShardedGLMObjective`` over
  ``shard_glm_data_features`` (d = 17 over 8 slots: 7 padded columns) —
  the same tolerances, and its L-BFGS and TRON solves within atol 1e-6 of
  the JAX package's, the padded coefficients exactly 0;
- entity-sharded bucket solves equal the port's unsharded solve bit for
  bit (1D and 2D meshes) and the JAX mesh solve within the JAX test's atol
  2e-3;
- the 2D ``{"data": 4, "entity": 2}`` estimator fit within atol 2e-3 of
  the unsharded fit and of the JAX mesh fit (bf16 designs: 5e-3, the
  sharded design blocks bf16);
- the mesh-sharded ranking index: ids and scores equal the unsharded
  index's, ids the JAX mesh index's; static margins; a patch of a sharded
  index equals its rebuild;
- ``parse_mesh``'s refusals give the JAX package's texts, and ``train_game
  --mesh data=4,entity=2 --device cpu`` trains as the JAX CLI does;
- the score-memory guard refuses in both packages at a 1 KiB budget and
  stays quiet at the default.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import photon_ml_tpu.game as jg
import photon_ml_tpu_torch.game as tg
from photon_ml_tpu.glm.problem import GLMOptimizationConfiguration as JOpt
from photon_ml_tpu.ops.design import CsrDesign as JCsr
from photon_ml_tpu.ops.design import DenseDesign as JDense
from photon_ml_tpu.ops.losses import LogisticLoss as JLogistic
from photon_ml_tpu.ops.objective import GLMData as JData
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.ops.regularization import L2Regularization as JL2
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizer
from photon_ml_tpu.optimize import minimize_lbfgs as j_lbfgs
from photon_ml_tpu.optimize import minimize_tron as j_tron
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.cli import train_game as t_cli
from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import CoordinateDescent
from photon_ml_tpu_torch.game.estimator import (
    FixedEffectCoordinateConfig as TFixed,
)
from photon_ml_tpu_torch.game.estimator import (
    RandomEffectCoordinateConfig as TRandom,
)
from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration as TOpt
from photon_ml_tpu_torch.glm.problem import OptimizationProblem
from photon_ml_tpu_torch.ops.design import CsrDesign as TCsr
from photon_ml_tpu_torch.ops.design import DenseDesign as TDense
from photon_ml_tpu_torch.ops.losses import LogisticLoss as TLogistic
from photon_ml_tpu_torch.ops.objective import GLMData as TData
from photon_ml_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.ops.regularization import L2Regularization as TL2
from photon_ml_tpu_torch.optimize import OptimizerConfig as TOptimizer
from photon_ml_tpu_torch.parallel import distributed as tdist
from photon_ml_tpu_torch.parallel.mesh import make_mesh as t_mesh
from photon_ml_tpu_torch.types import OptimizerType as TOptType
from photon_ml_tpu_torch.types import TaskType as TTask

#: tests/test_distributed.py's tolerances (f64)
VALUE_RTOL = 1e-12
GRAD_TOL = dict(rtol=1e-10, atol=1e-12)
#: tests/test_distributed.py's solve tolerance (the shared optimum)
SOLVE_ATOL = 1e-6
#: tests/test_game.py's mesh-fit tolerances (f32 designs, bf16 designs)
FIT_ATOL = {"float32": 2e-3, "bfloat16": 5e-3}
CPU8 = ["cpu"] * 8


def _j_mesh(axes):
    from photon_ml_tpu.parallel.mesh import make_mesh

    return make_mesh(axes, devices=jax.devices())


# --- the data axis -------------------------------------------------------

def _glm_problem(n=203, d=17, seed=0, sparse=False):
    """tests/test_distributed.py::make_data: n not divisible by 8."""
    rng = np.random.default_rng(seed)
    if sparse:
        # the JAX CSR design stores f32 values: both sides get those
        x = sp.random(n, d, density=0.3, random_state=int(seed),
                      format="csr").toarray().astype(np.float32).astype(
                          np.float64)
    else:
        x = rng.normal(size=(n, d))
    labels = (rng.uniform(size=n) < 0.5).astype(np.float64)
    offsets = rng.normal(size=n) * 0.1
    weights = rng.uniform(0.5, 2.0, size=n)
    return x, labels, offsets, weights


def _j_data(x, labels, offsets, weights, sparse):
    if sparse:
        design = JCsr.from_scipy(sp.csr_matrix(x))
    else:
        design = JDense(x=jnp.asarray(x))
    return JData(design=design, labels=jnp.asarray(labels),
                 offsets=jnp.asarray(offsets), weights=jnp.asarray(weights))


def _t_data(x, labels, offsets, weights, sparse):
    if sparse:
        r, c = np.nonzero(x)
        design = TCsr(rows=torch.as_tensor(r), cols=torch.as_tensor(c),
                      values=torch.as_tensor(x[r, c]), n_rows=x.shape[0],
                      n_cols=x.shape[1])
    else:
        design = TDense(x=torch.as_tensor(x))
    return TData(design=design, labels=torch.as_tensor(labels),
                 offsets=torch.as_tensor(offsets),
                 weights=torch.as_tensor(weights))


def _mask(d):
    m = np.ones(d)
    m[0] = 0.0
    return m


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "reg-mask"])
def test_data_axis_objective_matches_jax(sparse, masked):
    """The port's sharded objective against the JAX objective on every row
    (tests/test_distributed.py holds the JAX sharded objective to the same
    at these tolerances), and its variance and margin contractions against
    the port's unsharded ones."""
    x, labels, offsets, weights = _glm_problem(sparse=sparse)
    d = x.shape[1]
    mask = _mask(d) if masked else None
    jobj = JObjective(loss=JLogistic,
                      reg_mask=None if mask is None else jnp.asarray(mask))
    tobj = TObjective(loss=TLogistic,
                      reg_mask=None if mask is None else torch.as_tensor(mask))
    tmesh = t_mesh({"data": 8}, devices=CPU8)
    jdata = _j_data(x, labels, offsets, weights, sparse)
    tdata = _t_data(x, labels, offsets, weights, sparse)
    tsh = tdist.shard_glm_data(tdata, 8, device_put_mesh=tmesh)
    assert isinstance(tsh, tdist.MeshGLMData) and tsh.n_shards == 8
    assert tsh.n_samples == 208  # padded to a multiple of 8
    tobj_dist = tdist.DistributedGLMObjective(tobj, mesh=tmesh)

    rng = np.random.default_rng(1)
    w, v = rng.normal(size=d), rng.normal(size=d)
    wt, vt = torch.as_tensor(w), torch.as_tensor(v)
    l2 = 0.7
    f_l, g_l = jobj.value_and_grad(jnp.asarray(w), jdata, l2)
    f_t, g_t = tobj_dist.value_and_grad(wt, tsh, l2)
    np.testing.assert_allclose(float(f_t), float(f_l), rtol=VALUE_RTOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_l), **GRAD_TOL)
    np.testing.assert_allclose(float(tobj_dist.value(wt, tsh, l2)),
                               float(f_l), rtol=VALUE_RTOL)
    np.testing.assert_allclose(
        tobj_dist.hvp(wt, vt, tsh, l2).numpy(),
        np.asarray(jobj.hvp(jnp.asarray(w), jnp.asarray(v), jdata, l2)),
        **GRAD_TOL)
    if sparse:
        # the port's unsharded contractions take the chunked layout
        from photon_ml_tpu_torch.ops.design import ChunkedSparseDesign

        r, c = np.nonzero(x)
        tdata = dataclasses.replace(tdata, design=ChunkedSparseDesign.from_coo(
            r, c, x[r, c], n_rows=x.shape[0], n_cols=d, device="cpu"))
    np.testing.assert_allclose(
        tobj_dist.hessian_diagonal(wt, tsh, l2).numpy(),
        tobj.hessian_diagonal(wt, tdata, l2).numpy(), **GRAD_TOL)
    np.testing.assert_allclose(
        tobj_dist.hessian_matrix(wt, tsh, l2).numpy(),
        tobj.hessian_matrix(wt, tdata, l2).numpy(), **GRAD_TOL)
    # margins in the stacked (blocks, rows) layout, the padding's included
    m_t = tobj_dist.margins(wt, tsh)
    assert tuple(m_t.shape) == (8, 26)
    np.testing.assert_allclose(m_t.numpy().ravel()[:203],
                               tobj.margins(wt, tdata).numpy(), rtol=1e-10)


def test_data_axis_lbfgs_solve_matches_jax():
    """tests/test_distributed.py::TestDistributedSolve through the port's
    OptimizationProblem: the sharded solve reaches the JAX package's."""
    from photon_ml_tpu.parallel import DistributedGLMObjective as JDist
    from photon_ml_tpu.parallel import shard_glm_data as j_shard

    x, labels, offsets, weights = _glm_problem(seed=3)
    jmesh = _j_mesh({"data": 8})
    jdist = JDist(JObjective(loss=JLogistic), jmesh)
    jsh = j_shard(_j_data(x, labels, offsets, weights, False), 8,
                  device_put_mesh=jmesh)
    cfg = JOptimizer(max_iterations=200, tolerance=1e-10)
    want = jax.jit(lambda w: j_lbfgs(
        lambda wv: jdist.value_and_grad(wv, jsh, 0.5), w, cfg))(
            jnp.zeros(x.shape[1]))
    tmesh = t_mesh({"data": 8}, devices=CPU8)
    tsh = tdist.shard_glm_data(_t_data(x, labels, offsets, weights, False),
                               8, device_put_mesh=tmesh)
    problem = OptimizationProblem(
        tdist.DistributedGLMObjective(TObjective(loss=TLogistic), mesh=tmesh),
        TOpt(regularization=TL2, optimizer_config=TOptimizer(
            max_iterations=200, tolerance=1e-10)))
    got = problem.run(tsh, torch.zeros(x.shape[1], dtype=torch.float64), 0.5)
    np.testing.assert_allclose(got.w[0].numpy(), np.asarray(want.w),
                               atol=SOLVE_ATOL)


# --- the feature axis ----------------------------------------------------

def _feature_pair(seed, sparse):
    from photon_ml_tpu.parallel import FeatureShardedGLMObjective as JTp
    from photon_ml_tpu.parallel import shard_glm_data_features as j_feat

    x, labels, offsets, weights = _glm_problem(seed=seed, sparse=sparse)
    jmesh = _j_mesh({"feature": 8})
    jdata = _j_data(x, labels, offsets, weights, sparse)
    jsh, jd_pad = j_feat(jdata, 8, device_put_mesh=jmesh)
    tmesh = t_mesh({"feature": 8}, devices=CPU8)
    tdata = _t_data(x, labels, offsets, weights, sparse)
    tsh, td_pad = tdist.shard_glm_data_features(tdata, 8,
                                                device_put_mesh=tmesh)
    assert jd_pad == td_pad == 24
    return (JTp(JObjective(loss=JLogistic), jmesh), jdata, jsh,
            tdist.FeatureShardedGLMObjective(TObjective(loss=TLogistic),
                                             tmesh), tdata, tsh)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_feature_axis_objective_matches_jax(sparse):
    jtp, jdata, jsh, ttp, tdata, tsh = _feature_pair(0, sparse)
    d = 17
    assert isinstance(tsh.design, tdist.ColumnBlocks)
    assert len(tsh.design.blocks) == 8 and tsh.design.cols_per_block == 3
    rng = np.random.default_rng(7)
    w = np.concatenate([rng.normal(size=d), np.zeros(7)])
    v = np.concatenate([rng.normal(size=d), np.zeros(7)])
    l2 = 0.7
    f_j, g_j = jtp.value_and_grad(jnp.asarray(w), jsh, l2)
    f_t, g_t = ttp.value_and_grad(torch.as_tensor(w), tsh, l2)
    np.testing.assert_allclose(float(f_t), float(f_j), rtol=VALUE_RTOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **GRAD_TOL)
    # padded columns: zero data, zero w, so a gradient of exactly 0
    np.testing.assert_array_equal(g_t.numpy()[d:], 0.0)
    np.testing.assert_allclose(
        float(ttp.value(torch.as_tensor(w), tsh, l2)), float(f_j),
        rtol=VALUE_RTOL)
    hv_t = ttp.hvp(torch.as_tensor(w), torch.as_tensor(v), tsh, l2)
    np.testing.assert_allclose(
        hv_t.numpy(), np.asarray(jtp.hvp(jnp.asarray(w), jnp.asarray(v), jsh,
                                         l2)), **GRAD_TOL)
    np.testing.assert_allclose(
        ttp.margins(torch.as_tensor(w), tsh).numpy(),
        np.asarray(jtp.margins(jnp.asarray(w), jsh)), rtol=1e-10)
    # and the unsharded objective on the real columns
    tobj = TObjective(loss=TLogistic)
    f_u, g_u = tobj.value_and_grad(torch.as_tensor(w[:d]), tdata, l2)
    np.testing.assert_allclose(float(f_t), float(f_u), rtol=VALUE_RTOL)
    np.testing.assert_allclose(g_t.numpy()[:d], g_u.numpy(), **GRAD_TOL)


def test_feature_axis_reg_mask_is_padded():
    """A mask over the real columns regularizes no padded coefficient."""
    x, labels, offsets, weights = _glm_problem(seed=4)
    tmesh = t_mesh({"feature": 8}, devices=CPU8)
    tsh, d_pad = tdist.shard_glm_data_features(
        _t_data(x, labels, offsets, weights, False), 8,
        device_put_mesh=tmesh)
    mask = torch.as_tensor(_mask(17))
    ttp = tdist.FeatureShardedGLMObjective(
        TObjective(loss=TLogistic, reg_mask=mask), tmesh)
    w = torch.as_tensor(np.random.default_rng(2).normal(size=d_pad))
    f, g = ttp.value_and_grad(w, tsh, 2.0)
    f_u, g_u = TObjective(loss=TLogistic, reg_mask=mask).value_and_grad(
        w[:17], _t_data(x, labels, offsets, weights, False), 2.0)
    np.testing.assert_allclose(float(f), float(f_u) + 0.0, rtol=VALUE_RTOL)
    np.testing.assert_allclose(g.numpy()[:17], g_u.numpy(), **GRAD_TOL)
    np.testing.assert_array_equal(g.numpy()[17:], 0.0)
    with pytest.raises(ValueError, match="identity normalization"):
        from photon_ml_tpu_torch.ops.normalization import NormalizationContext

        tdist.FeatureShardedGLMObjective(TObjective(
            loss=TLogistic, normalization=NormalizationContext(
                factors=torch.ones(17))), tmesh)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_feature_axis_solve_matches_jax(sparse, optimizer):
    seed = 8 if optimizer == "LBFGS" else 21
    jtp, _, jsh, ttp, _, tsh = _feature_pair(seed, sparse)
    l2 = 0.5
    iters = 200 if optimizer == "LBFGS" else 100
    cfg = JOptimizer(max_iterations=iters, tolerance=1e-10)
    if optimizer == "LBFGS":
        want = jax.jit(lambda w: j_lbfgs(
            lambda wv: jtp.value_and_grad(wv, jsh, l2), w, cfg))(
                jnp.zeros(24))
    else:
        want = jax.jit(lambda w: j_tron(
            lambda wv: jtp.value_and_grad(wv, jsh, l2),
            lambda wv, v: jtp.hvp(wv, v, jsh, l2), w, cfg))(jnp.zeros(24))
    problem = OptimizationProblem(ttp, TOpt(
        optimizer=TOptType(optimizer), regularization=TL2,
        optimizer_config=TOptimizer(max_iterations=iters, tolerance=1e-10)))
    got = problem.run(tsh, torch.zeros(24, dtype=torch.float64), l2).w[0]
    np.testing.assert_allclose(got.numpy()[:17], np.asarray(want.w)[:17],
                               atol=SOLVE_ATOL)
    np.testing.assert_array_equal(got.numpy()[17:], 0.0)


# --- the entity axis -----------------------------------------------------

def _mixed_data(pkg, n, n_entities, d_fixed=8, d_re=4, seed=0):
    """tests/test_game.py::make_mixed_data in either package."""
    prng = np.random.default_rng(12345)
    w_fixed = prng.normal(size=d_fixed).astype(np.float32)
    u = (1.5 * prng.normal(size=(n_entities, d_re))).astype(np.float32)
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(n, d_fixed)).astype(np.float32)
    xr = rng.normal(size=(n, d_re)).astype(np.float32)
    probs = 1.0 / np.arange(1, n_entities + 1)
    probs /= probs.sum()
    ent = rng.choice(n_entities, size=n, p=probs).astype(np.int64)
    margin = xf @ w_fixed + np.einsum("nd,nd->n", xr, u[ent])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)

    def shard(x):
        nn, dd = x.shape
        return pkg.FeatureShard.from_coo(
            np.repeat(np.arange(nn), dd), np.tile(np.arange(dd), nn),
            np.array(x, np.float32).ravel(), nn, dd)

    return pkg.GameData.build(labels=y, shards={"fixed": shard(xf),
                                                "re": shard(xr)},
                              id_columns={"entityId": ent})


@pytest.fixture(scope="module")
def bucket_solves():
    """The port's bucket solve of 37 entities unsharded, on {"entity": 8}
    (3 padded lanes) and on {"data": 4, "entity": 2}, and the JAX mesh
    solve of the same data."""
    data = _mixed_data(tg, 900, 37)
    cfg = tg.RandomEffectDatasetConfig("entityId", "re")
    ds = tg.RandomEffectDataset.build("re", data, cfg)
    opt = TOpt(regularization=TL2, optimizer_config=TOptimizer(
        max_iterations=40, tolerance=1e-8))
    offsets = np.random.default_rng(3).normal(
        size=data.n_samples).astype(np.float32)
    out = {}
    for name, axes in (("none", None), ("entity8", {"entity": 8}),
                       ("data4xentity2", {"data": 4, "entity": 2})):
        mesh = None if axes is None else t_mesh(axes, devices=CPU8)
        solver = RandomEffectSolver(task=TTask.LOGISTIC_REGRESSION,
                                    config=opt, device="cpu", mesh=mesh)
        model, scores = solver.train(ds, torch.as_tensor(offsets), lam=0.3,
                                     dim=4)
        out[name] = (model, scores.numpy())
    jdata = _mixed_data(jg, 900, 37)
    jds = jg.RandomEffectDataset.build(
        "re", jdata, jg.RandomEffectDatasetConfig("entityId", "re"))
    from photon_ml_tpu.game.random_effect import RandomEffectSolver as JSolver

    jsolver = JSolver(task=JTask.LOGISTIC_REGRESSION, config=JOpt(
        regularization=JL2, optimizer_config=JOptimizer(
            max_iterations=40, tolerance=1e-8)),
        mesh=_j_mesh({"entity": 8}))
    jmodel, jscores = jsolver.train(jds, offsets, lam=0.3, dim=4)
    out["jax"] = (jmodel, np.asarray(jscores))
    return out


@pytest.mark.parametrize("task", ["LINEAR_REGRESSION", "LOGISTIC_REGRESSION",
                                  "POISSON_REGRESSION"])
def test_entity_sharded_solve_is_bit_identical(task):
    """Two slots: every slice keeps at least two lanes, and the CPU's
    element math lands alike (see the next test), so the sharded solve
    equals the unsharded one bit for bit: the batched optimizers freeze
    each lane on its own."""
    data = _mixed_data(tg, 900, 37)
    ds = tg.RandomEffectDataset.build(
        "re", data, tg.RandomEffectDatasetConfig("entityId", "re"))
    opt = TOpt(regularization=TL2, optimizer_config=TOptimizer(
        max_iterations=40, tolerance=1e-8))
    offsets = torch.as_tensor(np.random.default_rng(3).normal(
        size=data.n_samples).astype(np.float32))
    runs = [RandomEffectSolver(
        task=TTask(task), config=opt, device="cpu",
        mesh=None if mesh is None else t_mesh(mesh, devices=["cpu"] * 2),
    ).train(ds, offsets, lam=0.3, dim=4) for mesh in (None, {"entity": 2})]
    (m0, s0), (m1, s1) = runs
    np.testing.assert_array_equal(m1.keys, m0.keys)
    np.testing.assert_array_equal(m1.coeffs, m0.coeffs)
    assert torch.equal(s1, s0)


@pytest.mark.parametrize("mesh", ["entity8", "data4xentity2"])
def test_entity_sharded_solve_on_eight_slots(bucket_solves, mesh):
    """Eight slots cut the 3- and 20-lane buckets into 1- and 3-lane
    slices. There the CPU's PyTorch kernels compute some elements by
    another path than in the whole bucket (``torch.sigmoid`` of a small
    tensor; a batched product of one lane), so lanes part at roundoff and
    the solve is held as the JAX test holds its mesh solve (atol 2e-3); the
    card's element kernels compute every element alike, which
    ``chip_smoke.py`` phase 20 (b) holds bit for bit."""
    m0, s0 = bucket_solves["none"]
    m1, s1 = bucket_solves[mesh]
    np.testing.assert_array_equal(m1.keys, m0.keys)
    np.testing.assert_allclose(m1.coeffs, m0.coeffs, atol=2e-3)
    np.testing.assert_allclose(s1, s0, atol=2e-3)


def test_entity_sharded_solve_matches_jax_mesh(bucket_solves):
    m1, s1 = bucket_solves["entity8"]
    jm, js = bucket_solves["jax"]
    np.testing.assert_array_equal(m1.keys, jm.keys)
    # tests/test_game.py's tolerance for the JAX mesh solve against its own
    # unsharded one: f32 L-BFGS trajectories part at roundoff
    np.testing.assert_allclose(m1.coeffs, jm.coeffs, atol=2e-3)
    np.testing.assert_allclose(s1, js, atol=2e-3)


def test_mesh_without_entity_axis_solves_unsharded():
    opt = TOpt(regularization=TL2)
    solver = RandomEffectSolver(task=TTask.LOGISTIC_REGRESSION, config=opt,
                                device="cpu",
                                mesh=t_mesh({"data": 8}, devices=CPU8))
    assert solver.mesh is None


def test_lane_slices_follow_the_mesh():
    """Lanes pad to the product of every axis and split entity-last, the
    JAX package's ``_lane_axes``: slice k on the slot whose (data, entity)
    index is (k // 2, k % 2)."""
    devs = [torch.device("cpu")] * 8
    mesh = t_mesh({"entity": 2, "data": 4}, devices=devs)
    solver = RandomEffectSolver(task=TTask.LOGISTIC_REGRESSION,
                                config=TOpt(), device="cpu", mesh=mesh)
    assert solver._lane_axes() == ("data", "entity")
    slices = solver._slices(37)
    assert [(lo, n) for _, lo, n in slices] == [(5 * k, 5) for k in range(8)]
    assert mesh.lane_devices(("data", "entity")) == tuple(
        mesh.device_at({"data": k // 2, "entity": k % 2}) for k in range(8))


# --- the estimator -------------------------------------------------------

def _fit(pkg, mesh, dtype):
    data = _mixed_data(pkg, 800, 11)
    if pkg is tg:
        cfg = TOpt(regularization=TL2)
        coords = {"global": TFixed("fixed", cfg, design_dtype=dtype),
                  "perEntity": TRandom(tg.RandomEffectDatasetConfig(
                      "entityId", "re"), cfg, design_dtype=dtype)}
        est = tg.GameEstimator(task=TTask.LOGISTIC_REGRESSION,
                               coordinate_configs=coords,
                               update_sequence=["global", "perEntity"],
                               n_cd_iterations=1, device="cpu", mesh=mesh)
    else:
        from photon_ml_tpu.game.estimator import (
            FixedEffectCoordinateConfig,
            RandomEffectCoordinateConfig,
        )

        cfg = JOpt(regularization=JL2)
        coords = {
            "global": FixedEffectCoordinateConfig(
                feature_shard_id="fixed", optimization=cfg,
                design_dtype=dtype),
            "perEntity": RandomEffectCoordinateConfig(
                dataset=jg.RandomEffectDatasetConfig("entityId", "re"),
                optimization=cfg, design_dtype=dtype)}
        est = jg.GameEstimator(task=JTask.LOGISTIC_REGRESSION,
                               coordinate_configs=coords,
                               update_sequence=["global", "perEntity"],
                               n_cd_iterations=1, mesh=mesh)
    grid = [pkg.GameOptimizationConfiguration(
        {"global": 0.01, "perEntity": 1.0})]
    r = est.fit(data, grid)[0]
    fe = r.model.coordinates["global"].model.coefficients.means
    fe = fe.numpy() if isinstance(fe, torch.Tensor) else np.asarray(fe)
    re = r.model.coordinates["perEntity"]
    return (np.asarray(r.model.score(data)), fe,
            (np.asarray(re.keys), np.asarray(re.coeffs)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_2d_mesh_fit_matches_unsharded_and_jax(dtype):
    """The mesh fit within the JAX test's atol of the unsharded fit, and
    within tests/test_torch_game.py's port-vs-JAX coefficient tolerances of
    the JAX mesh fit (the two packages' unsharded fits part by as much)."""
    from test_torch_game import RE_TOL, TOL

    s0, fe0, _ = _fit(tg, None, dtype)
    s1, fe1, (k1, c1) = _fit(
        tg, t_mesh({"data": 4, "entity": 2}, devices=CPU8), dtype)
    np.testing.assert_allclose(s1, s0, atol=FIT_ATOL[dtype])
    np.testing.assert_allclose(fe1, fe0, atol=FIT_ATOL[dtype])
    _, fej, (kj, cj) = _fit(jg, _j_mesh({"data": 4, "entity": 2}), dtype)
    np.testing.assert_allclose(fe1, fej, **TOL[dtype])
    np.testing.assert_array_equal(k1, kj)
    np.testing.assert_allclose(c1, cj, **RE_TOL[dtype])


def test_sharded_fixed_effect_dataset_keeps_blocks_on_slots():
    data = _mixed_data(tg, 203, 5)
    mesh = t_mesh({"data": 4, "entity": 2}, devices=CPU8)
    ds = tg.FixedEffectDataset.build("global", data, "fixed",
                                     dtype="bfloat16", device="cpu",
                                     mesh=mesh)
    assert ds.n_shards == 4 and ds.n_samples == 203
    sharded = ds.design
    assert [b.design.x.dtype for b in sharded.blocks] == [torch.bfloat16] * 4
    assert sharded.rows_per_shard == 51 and ds.labels.shape == (204,)
    bound = ds.glm_data(torch.arange(203, dtype=torch.float32))
    np.testing.assert_array_equal(
        bound.gather("offsets").numpy(), np.r_[np.arange(203), 0.0])
    # a mesh without a data axis keeps the one-device dataset
    one = tg.FixedEffectDataset.build(
        "global", data, "fixed", device="cpu",
        mesh=t_mesh({"entity": 2}, devices=["cpu"] * 2))
    assert one.n_shards == 1 and isinstance(one.design, TDense)


# --- the ranking index ---------------------------------------------------

@pytest.fixture(scope="module")
def rank_run(tmp_path_factory):
    from test_torch_cli import _write_bench_file
    from test_torch_retrieval import N_SONGS, N_USERS, _train_args

    d = tmp_path_factory.mktemp("torch_mesh_rank")
    train = _write_bench_file(str(d / "train.avro"), 600, 3, users=N_USERS,
                              songs=N_SONGS)
    out = str(d / "run")
    t_cli.run(_train_args(train, out))
    return out


@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_mesh_index_ranks_as_unsharded(rank_run, table_dtype):
    from photon_ml_tpu.retrieval import ItemIndex as JIndex
    from photon_ml_tpu.retrieval import RankingEngine as JRanking
    from photon_ml_tpu.serving import ModelRegistry as JRegistry
    from photon_ml_tpu_torch.retrieval import ItemIndex, RankingEngine
    from test_torch_retrieval import N_SONGS, SHARD_CONFIGS, _registry, _users

    sm = _registry(rank_run, table_dtype)
    store = sm.stores["perSong"]
    mesh = t_mesh({"entity": 4}, devices=["cpu"] * 4)
    sharded = ItemIndex.build(store, "perSong", mesh=mesh)
    assert sharded.bucket == 64 and len(sharded.parts) == 4
    assert all(m.shape == (16, store.dim) for m, _ in sharded.parts)
    assert torch.equal(sharded.matrix, sm.rank_engine.index.matrix)
    engine = RankingEngine(sm.engine, sharded, max_k=16)
    jsm = JRegistry(SHARD_CONFIGS, table_dtype=table_dtype,
                    rank_coordinate="perSong", rank_max_k=16).load(rank_run)
    jengine = JRanking(jsm.engine, JIndex.build(
        jsm.stores["perSong"], "perSong", mesh=_j_mesh({"entity": 4})),
        max_k=16)
    for rec in _users():
        ((ids0, s0),) = sm.rank([rec], [16])
        ((ids1, s1),) = engine.rank([rec], [16])
        assert ids1 == ids0
        np.testing.assert_array_equal(s1, s0)
        if table_dtype == "float32":
            ((jids, _),) = jengine.rank([rec], [16])
            assert ids1 == jids
    assert N_SONGS == sharded.n_items


def test_static_margins(rank_run):
    """tests/test_retrieval.py::test_static_margins: an additive
    request-independent prior shifts each item's score by its margin
    (within f32 rounding of the f64 sum); a sharded index carries it
    too."""
    from photon_ml_tpu_torch.retrieval import ItemIndex, RankingEngine
    from test_torch_retrieval import N_SONGS, _registry, _users

    sm = _registry(rank_run)
    base = RankingEngine(sm.engine, sm.rank_engine.index, max_k=64)
    static = {s: float(i) for i, s in enumerate(base.index.item_ids)}
    for mesh in (None, t_mesh({"entity": 2}, devices=["cpu"] * 2)):
        boosted = ItemIndex.build(sm.stores["perSong"], "perSong",
                                  static_margins=static, mesh=mesh)
        engine = RankingEngine(sm.engine, boosted, max_k=64)
        rec = _users()[0]
        ((ids0, s0),) = base.rank([rec], [N_SONGS])
        ((ids1, s1),) = engine.rank([rec], [N_SONGS])
        by_id0 = dict(zip(ids0, s0))
        for item, got in zip(ids1, s1):
            np.testing.assert_allclose(got, by_id0[item] + static[item],
                                       rtol=1e-5)


def test_static_margins_from_records_match_the_engine_and_jax(rank_run):
    """The helper's margins equal the serving path's own score of the item
    records with no entity ids (fixed effect and offset only), and the JAX
    helper's on the same model."""
    from photon_ml_tpu.retrieval import ItemIndex as JIndex
    from photon_ml_tpu.serving import ModelRegistry as JRegistry
    from photon_ml_tpu_torch.retrieval import ItemIndex
    from test_torch_retrieval import SHARD_CONFIGS, _registry, _users

    sm = _registry(rank_run)
    recs = {f"item{i}": {**r, "metadataMap": {}}
            for i, r in enumerate(_users()[:4])}
    static = ItemIndex.static_margins_from_records(sm.engine, recs)
    want = sm.engine.score(list(recs.values()))
    np.testing.assert_array_equal(
        np.asarray([static[r] for r in recs], np.float32),
        np.asarray(want, np.float32))
    jsm = JRegistry(SHARD_CONFIGS, rank_coordinate="perSong").load(rank_run)
    jstatic = JIndex.static_margins_from_records(jsm.engine, recs)
    np.testing.assert_allclose([static[r] for r in recs],
                               [jstatic[r] for r in recs], rtol=1e-6)


def test_sharded_index_patch_equals_rebuild(rank_run):
    from photon_ml_tpu_torch.game.model import RandomEffectModel
    from photon_ml_tpu_torch.retrieval import ItemIndex
    from photon_ml_tpu_torch.types import TaskType
    from test_torch_retrieval import _registry

    sm = _registry(rank_run)
    store = sm.stores["perSong"]
    mesh = t_mesh({"entity": 4}, devices=["cpu"] * 4)
    index = ItemIndex.build(store, "perSong", mesh=mesh,
                            static_margins={"s4": 2.0})
    touched = ["s4", "s9", "s33", "sNEW0"]
    dim = store.dim
    keys = (np.arange(len(touched))[:, None] * dim
            + np.arange(dim)[None, :]).ravel().astype(np.int64)
    update = RandomEffectModel(
        random_effect_type="songId", feature_shard_id="item",
        task=TaskType.LOGISTIC_REGRESSION, dim=dim, keys=keys,
        coeffs=np.random.default_rng(5).normal(size=keys.size)
        .astype(np.float32))
    patched = store.apply_patch(update, {r: i for i, r in enumerate(touched)})
    got = index.apply_patch(patched, touched, static_margins={"s9": 1.5})
    want = ItemIndex.build(patched, "perSong", mesh=mesh,
                           static_margins={"s4": 2.0, "s9": 1.5})
    assert got.item_ids == want.item_ids and got.bucket == index.bucket
    for (gm, _), (wm, _) in zip(got.parts, want.parts):
        assert torch.equal(gm, wm)
    assert torch.equal(got.static, want.static)
    # the parent index is untouched
    assert index.n_items == len(got.item_ids) - 1


# --- the CLI -------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "data=2,data=2", "data=x", "bogus=2", "data=0", "entity=-1,data=2",
    "data=16"])
def test_parse_mesh_refusals_match_jax(spec):
    from photon_ml_tpu.cli.train_game import parse_mesh as j_parse

    with pytest.raises(SystemExit) as j_err:
        j_parse(spec)
    with pytest.raises(SystemExit) as t_err:
        t_cli.parse_mesh(spec, "cpu" if spec != "data=16" else "cuda")
    want = str(j_err.value)
    if spec == "data=16":
        # the JAX package counts its 8 virtual devices, the port the cards
        want = want.replace("have 8", f"have {torch.cuda.device_count()}")
    assert str(t_err.value) == want
    assert t_cli.parse_mesh("") is None


def test_parse_mesh_on_the_cpu_maps_every_slot_to_it():
    mesh = t_cli.parse_mesh("data=4,entity=2", "cpu")
    assert mesh.shape == {"data": 4, "entity": 2}
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.axis_devices("data") == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="needs 8 devices, have 2"):
        t_mesh({"data": 4, "entity": 2}, devices=["cpu"] * 2)


def test_train_game_mesh_trains_as_the_jax_cli(tmp_path):
    """tests/test_cli.py::test_mesh_flag_trains_sharded in both packages:
    the port on 8 CPU slots, the JAX package on its 8 virtual devices."""
    from photon_ml_tpu.cli import train_game as j_cli
    from test_torch_cli import _bench_args, _write_bench_file

    train = _write_bench_file(str(tmp_path / "train.avro"), 600, 1)
    valid = _write_bench_file(str(tmp_path / "valid.avro"), 300, 2)
    args = _bench_args(train, valid, "float32") + [
        "--mesh", "data=4,entity=2"]
    t_res = t_cli.run(args + ["--output-dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    j_res = j_cli.run(args + ["--output-dir", str(tmp_path / "jax")])
    ta, ja = t_res["best_evaluation"]["AUC"], j_res["best_evaluation"]["AUC"]
    assert ta > 0.65
    # the 2D fit's coefficients sit within 2e-3 of the JAX fit's
    # (test_2d_mesh_fit_matches_unsharded_and_jax); the AUC moves less
    assert abs(ta - ja) < 1e-3, (ta, ja)


# --- the score-memory guard ----------------------------------------------

def _guard_problem(pkg):
    data = _mixed_data(pkg, 300, 7)
    cfg = (TOpt if pkg is tg else JOpt)(
        regularization=TL2 if pkg is tg else JL2)
    ds = pkg.RandomEffectDataset.build(
        "perEntity", data, pkg.RandomEffectDatasetConfig("entityId", "re"))
    if pkg is tg:
        coord = RandomEffectCoordinate(
            coordinate_id="perEntity", dataset=ds, data=data,
            task=TTask.LOGISTIC_REGRESSION, config=cfg, lam=0.5)
    else:
        from photon_ml_tpu.game.coordinate import RandomEffectCoordinate as JC

        coord = JC(coordinate_id="perEntity", dataset=ds, data=data,
                   task=JTask.LOGISTIC_REGRESSION, config=cfg, lam=0.5)
    return data, coord


def _cd_run(pkg, budget):
    from photon_ml_tpu.game.coordinate_descent import (
        CoordinateDescent as JCD,
    )

    data, coord = _guard_problem(pkg)
    if pkg is tg:
        return CoordinateDescent(update_sequence=["perEntity"],
                                 max_score_memory_bytes=budget).run(
            {"perEntity": coord}, data, TTask.LOGISTIC_REGRESSION,
            torch.device("cpu"))
    return JCD(update_sequence=["perEntity"],
               max_score_memory_bytes=budget).run(
        {"perEntity": coord}, data, JTask.LOGISTIC_REGRESSION)


@pytest.mark.parametrize("pkg", [tg, jg], ids=["port", "jax"])
def test_score_memory_guard_refuses_over_budget(pkg):
    with pytest.raises(ValueError, match="score decomposition needs"):
        _cd_run(pkg, 1024)


@pytest.mark.parametrize("pkg", [tg, jg], ids=["port", "jax"])
def test_score_memory_guard_quiet_at_normal_scale(pkg):
    result = _cd_run(pkg, None)
    assert result.model.coordinates["perEntity"].keys.size > 0


def test_score_memory_guard_refuses_through_the_estimator():
    data = _mixed_data(tg, 300, 7)
    cfg = TOpt(regularization=TL2)
    est = tg.GameEstimator(
        task=TTask.LOGISTIC_REGRESSION,
        coordinate_configs={"global": TFixed("fixed", cfg)},
        update_sequence=["global"], device="cpu",
        max_score_memory_bytes=1024)
    with pytest.raises(ValueError, match=r"score decomposition needs .*"
                       r"\(1\+1 vectors x 300 samples x 4 B\)"):
        est.fit(data, [tg.GameOptimizationConfiguration({"global": 0.1})])
    # the default budget on the CPU (half of 16 GiB) lets it run
    est = dataclasses.replace(est, max_score_memory_bytes=None)
    est.fit(data, [tg.GameOptimizationConfiguration({"global": 0.1})])
