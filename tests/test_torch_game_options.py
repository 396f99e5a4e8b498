"""The GAME training options of the port against the JAX package's on the
CPU: elastic net and coefficient variances in GAME coordinates, the RANDOM
projector, factored random effects, down-sampling, streaming buckets and a
deferred validation set.

Both packages parse the same coordinate specs (``cli/config.py``'s DSL)
and fit the same seeded music-shaped data (``tests/test_torch_game.py``'s
draw); the JAX package runs in this process's x64 mode, the port in f32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import photon_ml_tpu.game as jg
import photon_ml_tpu_torch.game as tg
from photon_ml_tpu.cli.config import parse_coordinate_config as j_parse
from photon_ml_tpu.evaluation import parse_evaluators as j_evaluators
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.cli.config import parse_coordinate_config as t_parse
from photon_ml_tpu_torch.evaluation import parse_evaluators as t_evaluators
from photon_ml_tpu_torch.types import TaskType as TTask
from test_torch_game import _game_data

SEQ = ["global", "perUser", "perSong"]
LAM = {"global": 1.0, "perUser": 3.0, "perSong": 3.0}
#: elastic net with variances: phase 13 (a) of chip_smoke.py at this size
EN_SPECS = [
    "global=fixed,shard=global,reg=ELASTIC_NET,alpha=0.5,variance=SIMPLE,"
    "maxIter=40",
    "perUser=random,entity=userId,shard=item,reg=ELASTIC_NET,alpha=0.7,"
    "variance=FULL,maxIter=40",
    "perSong=random,entity=songId,shard=item,reg=L2,variance=SIMPLE,"
    "maxIter=40",
]
#: the RANDOM projector and a factored coordinate: phase 13 (b)
PROJ_SPECS = [
    "global=fixed,shard=global,reg=L2,maxIter=40",
    "perUser=factored,entity=userId,shard=item,reg=L2,projectedDim=2,"
    "factoredIterations=1,lamProjection=1,maxIter=40",
    "perSong=random,entity=songId,shard=item,reg=L2,projector=RANDOM,"
    "projectedDim=2,maxIter=40",
]
#: both packages run the same OWL-QN / L-BFGS on the same f32 data, the JAX
#: package's values in f64 (x64), the port's in f32: coefficients within
#: tests/test_torch_game.py's RE_TOL f32 row (measured: 1.3e-4 fixed,
#: 2.0e-4 random, 4.8e-4 on the projected perSong), variances within 1e-3
#: relative (measured: 6.4e-5)
COEF_TOL = dict(rtol=2e-3, atol=5e-4)
VAR_RTOL = 1e-3


def _estimators(specs, **kw):
    jcfg = dict(j_parse(s) for s in specs)
    tcfg = dict(t_parse(s) for s in specs)
    return (jg.GameEstimator(task=JTask.LOGISTIC_REGRESSION,
                             coordinate_configs=jcfg, update_sequence=SEQ,
                             n_cd_iterations=1, **kw),
            tg.GameEstimator(task=TTask.LOGISTIC_REGRESSION,
                             coordinate_configs=tcfg, update_sequence=SEQ,
                             n_cd_iterations=1, device="cpu", **kw))


def _fits(specs):
    jest, test = _estimators(specs)
    jres = jest.fit(_game_data(jg, 1200, 0),
                    [jg.GameOptimizationConfiguration(LAM)],
                    validation=(_game_data(jg, 600, 5),
                                j_evaluators(["AUC"])))[0]
    tres = test.fit(_game_data(tg, 1200, 0),
                    [tg.GameOptimizationConfiguration(LAM)],
                    validation=(_game_data(tg, 600, 5),
                                t_evaluators(["AUC"])))[0]
    return jres, tres


@pytest.fixture(scope="module")
def en_fits():
    return _fits(EN_SPECS)


@pytest.fixture(scope="module")
def proj_fits():
    return _fits(PROJ_SPECS)


def _fixed(res, cid="global"):
    c = res.model.coordinates[cid].model.coefficients
    to_np = (lambda t: t.numpy()) if isinstance(c.means, torch.Tensor) \
        else np.asarray
    return to_np(c.means), (None if c.variances is None
                            else to_np(c.variances))


# --- elastic net and variances ----------------------------------------------

@pytest.mark.parametrize("cid", SEQ)
def test_elastic_net_coefficients_match_jax(en_fits, cid):
    jres, tres = en_fits
    if cid == "global":
        jw, tw = _fixed(jres)[0], _fixed(tres)[0]
    else:
        jm, tm = jres.model.coordinates[cid], tres.model.coordinates[cid]
        np.testing.assert_array_equal(tm.keys, jm.keys)
        jw, tw = np.asarray(jm.coeffs), tm.coeffs
    np.testing.assert_allclose(tw, jw, **COEF_TOL)
    # the L1 part's exact zeros: the same coefficients in both packages
    np.testing.assert_array_equal(tw == 0, jw == 0)


def test_elastic_net_makes_exact_zeros_and_keeps_padding_zero(en_fits):
    _, tres = en_fits
    m = tres.model.coordinates["perUser"]
    assert (m.coeffs == 0).sum() > 0
    # every kept key is a real (entity, feature) slot: the padded columns
    # of the buckets never reach the table
    assert len(m.keys) == len(np.unique(m.keys))
    assert tres.evaluation.primary[1] > 0.85


@pytest.mark.parametrize("cid", SEQ)
def test_variances_match_jax(en_fits, cid):
    jres, tres = en_fits
    if cid == "global":
        jv, tv = _fixed(jres)[1], _fixed(tres)[1]
    else:
        jv = np.asarray(jres.model.coordinates[cid].variances)
        tv = tres.model.coordinates[cid].variances
    assert tv is not None and tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, rtol=VAR_RTOL)


def _sigmoid_curvature(m):
    p = 1.0 / (1.0 + np.exp(-m))
    return p * (1.0 - p)


def _dense(pkg_data, shard):
    sh = pkg_data.shards[shard]
    x = np.zeros((sh.n_samples, sh.dim))
    np.add.at(x, (sh.rows(), sh.cols), sh.vals.astype(np.float64))
    return x


def test_variances_are_the_f64_hessian_at_the_port_solution(en_fits):
    """SIMPLE: 1 / the Hessian diagonal; FULL: the diagonal of its
    pseudo-inverse, both in f64 at the port's own coefficients and residual
    offsets (the sweep's order: global, perUser, perSong)."""
    _, tres = en_fits
    data = _game_data(tg, 1200, 0)
    coords = tres.model.coordinates
    xg, xi = _dense(data, "global"), _dense(data, "item")
    wg = coords["global"].model.coefficients.means.numpy().astype(np.float64)
    l2 = LAM["global"] * 0.5  # elastic net alpha 0.5: half of lambda is L2
    d2 = _sigmoid_curvature(xg @ wg)
    np.testing.assert_allclose(
        coords["global"].model.coefficients.variances.numpy(),
        1.0 / ((xg * xg).T @ d2 + l2), rtol=1e-5)
    off = xg @ wg
    for cid, col, l2, full in (("perUser", "userId", 0.3 * LAM["perUser"],
                                True),
                               ("perSong", "songId", LAM["perSong"], False)):
        m = coords[cid]
        ents = data.id_columns[col]
        got, want = [], []
        for e in np.unique(m.keys // m.dim)[:10]:
            rows = ents == e
            feats = m.keys[m.keys // m.dim == e] % m.dim
            w = np.zeros(m.dim)
            w[feats] = m.coeffs[m.keys // m.dim == e]
            x = xi[rows][:, feats]
            d2 = _sigmoid_curvature(xi[rows] @ w + off[rows])
            h = (x * d2[:, None]).T @ x + l2 * np.eye(len(feats))
            want.append(np.diag(np.linalg.pinv(h)) if full
                        else 1.0 / np.diag(h))
            got.append(m.variances[m.keys // m.dim == e])
        np.testing.assert_allclose(np.concatenate(got),
                                   np.concatenate(want), rtol=1e-4)
        off = off + m.score(data)


def _tables(seed, with_var):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(40, 14, replace=False)).astype(np.int64)
    coeffs = rng.normal(size=14).astype(np.float32)
    var = rng.uniform(0.1, 1, size=14).astype(np.float32) if with_var \
        else None
    return keys, coeffs, var


@pytest.mark.parametrize("sides", [(True, True), (True, False),
                                   (False, True)],
                         ids=["both", "base-only", "update-only"])
def test_merge_with_variances_matches_jax(sides):
    models = {}
    for pkg, name in ((jg, "jax"), (tg, "torch")):
        base, upd = (pkg.RandomEffectModel(
            random_effect_type="userId", feature_shard_id="item",
            task=(JTask if pkg is jg else TTask).LOGISTIC_REGRESSION, dim=4,
            keys=k, coeffs=c, variances=v)
            for k, c, v in (_tables(1, sides[0]), _tables(2, sides[1])))
        models[name] = base.merge(upd, drop_entities=[3])
    j, t = models["jax"], models["torch"]
    np.testing.assert_array_equal(t.keys, j.keys)
    np.testing.assert_array_equal(t.coeffs, j.coeffs)
    if all(sides):
        np.testing.assert_array_equal(t.variances, j.variances)
    else:
        assert t.variances is None and j.variances is None


def test_merge_refuses_projected_models():
    from photon_ml_tpu_torch.game.projector import RandomProjector

    k, c, _ = _tables(1, False)
    m = tg.RandomEffectModel(
        "userId", "item", TTask.LOGISTIC_REGRESSION, 4, k, c,
        projector=RandomProjector.build(6, 4, 0))
    with pytest.raises(ValueError, match="shard-space"):
        m.merge(m)


# --- the RANDOM projector and the factored coordinate -------------------------

def test_random_matrix_equals_jax_bit_for_bit():
    from photon_ml_tpu.game.projector import RandomProjector as JProj
    from photon_ml_tpu_torch.game.projector import RandomProjector as TProj

    a, b = TProj.build(37, 5, 20260729), JProj.build(37, 5, 20260729)
    np.testing.assert_array_equal(a.matrix, b.matrix)
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(6), 3)
    cols = rng.integers(0, 37, size=18)
    vals = rng.normal(size=18).astype(np.float32)
    np.testing.assert_array_equal(a.project_rows(cols, vals, rows, 6),
                                  b.project_rows(cols, vals, rows, 6))
    v = rng.normal(size=(3, 5)).astype(np.float32)
    np.testing.assert_array_equal(a.project_back(v), b.project_back(v))
    np.testing.assert_array_equal(a.project_back_variances(v ** 2),
                                  b.project_back_variances(v ** 2))
    with pytest.raises(ValueError, match="projected_dim"):
        TProj.build(4, 5, 0)


def test_projected_buckets_equal_jax():
    cfg = dict(random_effect_type="songId", feature_shard_id="item",
               projector_type="RANDOM", projected_dim=2)
    j = jg.RandomEffectDataset.build("s", _game_data(jg, 400, 1),
                                     jg.RandomEffectDatasetConfig(**{
                                         **cfg, "projector_type":
                                         jg.ProjectorType.RANDOM}))
    t = tg.RandomEffectDataset.build("s", _game_data(tg, 400, 1),
                                     tg.RandomEffectDatasetConfig(**{
                                         **cfg, "projector_type":
                                         tg.ProjectorType.RANDOM}))
    np.testing.assert_array_equal(t.projector.matrix, j.projector.matrix)
    assert len(t.buckets) == len(j.buckets)
    for a, b in zip(t.buckets, j.buckets):
        assert a.tensor_shape == b.tensor_shape and a.tensor_shape[2] == 2
        for f in ("entity_ids", "x", "labels", "weights", "sample_idx",
                  "feature_index"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("cid", ["perUser", "perSong"])
def test_projected_and_factored_fits_match_jax(proj_fits, cid):
    jres, tres = proj_fits
    jm, tm = jres.model.coordinates[cid], tres.model.coordinates[cid]
    assert tm.projector is not None and tm.dim == 2
    np.testing.assert_array_equal(tm.keys, jm.keys)
    np.testing.assert_allclose(tm.coeffs, np.asarray(jm.coeffs), **COEF_TOL)
    # perSong's matrix is the seeded one; perUser's is learned
    np.testing.assert_allclose(tm.projector.matrix, jm.projector.matrix,
                               rtol=2e-3, atol=5e-4)
    vdata = _game_data(tg, 600, 5)
    # the live projected model and its shard-space export score alike
    np.testing.assert_allclose(tm.to_shard_space().score(vdata),
                               tm.score(vdata), rtol=1e-5, atol=1e-5)
    assert abs(tres.evaluation.primary[1] - jres.evaluation.primary[1]) < 1e-4


def test_to_shard_space_matches_jax(proj_fits):
    jres, _ = proj_fits
    jm = jres.model.coordinates["perSong"]
    tm = tg.RandomEffectModel(
        jm.random_effect_type, jm.feature_shard_id, TTask.LOGISTIC_REGRESSION,
        jm.dim, np.asarray(jm.keys), np.asarray(jm.coeffs),
        variances=np.full(len(jm.keys), 0.5, np.float32),
        projector=tg.RandomProjector(jm.projector.matrix))
    jv = dataclasses.replace(jm, variances=np.full(len(jm.keys), 0.5,
                                                   np.float32))
    a, b = tm.to_shard_space(), jv.to_shard_space()
    assert a.projector is None and a.dim == b.dim
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.coeffs, b.coeffs)
    np.testing.assert_array_equal(a.variances, b.variances)
    np.testing.assert_array_equal(tm.score(_game_data(tg, 300, 9)),
                                  jm.score(_game_data(jg, 300, 9)))


def test_factored_design_matches_explicit_kron():
    from photon_ml_tpu_torch.game.factored import FactoredDesign

    rng = np.random.default_rng(0)
    n, d, n_l = 50, 6, 3
    x = rng.normal(size=(n, d))
    v = rng.normal(size=(n, n_l))
    w = rng.normal(size=(n_l * d,))
    g = rng.normal(size=(n,))
    design = FactoredDesign(x=torch.as_tensor(x), v=torch.as_tensor(v),
                            latent_dim=n_l)
    explicit = np.einsum("nl,nd->nld", v, x).reshape(n, n_l * d)
    assert design.dim == n_l * d and design.n_samples == n
    np.testing.assert_allclose(design.matvec(torch.as_tensor(w)).numpy(),
                               explicit @ w, rtol=1e-12)
    np.testing.assert_allclose(design.rmatvec(torch.as_tensor(g)).numpy(),
                               explicit.T @ g, rtol=1e-12)


def test_factored_coordinate_scores_are_its_model(proj_fits):
    """The scores a factored coordinate returns are its model's scores,
    active and passive rows alike."""
    from photon_ml_tpu_torch.game.factored import (
        FactoredRandomEffectCoordinate,
    )

    data = _game_data(tg, 1200, 0)
    cfg = t_parse(PROJ_SPECS[1])[1]
    coord = FactoredRandomEffectCoordinate(
        coordinate_id="perUser", data=data, dataset_config=cfg.dataset,
        task=TTask.LOGISTIC_REGRESSION, config=cfg.optimization, lam=3.0,
        lam_projection=cfg.lam_projection, n_factored_iterations=2)
    model, scores = coord.train(torch.zeros(data.n_samples))
    np.testing.assert_array_equal(scores.numpy(), model.score(data))
    with pytest.raises(ValueError, match="RANDOM"):
        dataclasses.replace(coord, dataset_config=dataclasses.replace(
            cfg.dataset, projector_type=tg.ProjectorType.INDEX_MAP))


# --- down-sampling ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["binary", "uniform"])
def test_downsampling_masks_over_sweeps_match_jax(mode):
    from photon_ml_tpu import sampling as js
    from photon_ml_tpu_torch import sampling as ts

    cls = {"binary": "BinaryClassificationDownSampler",
           "uniform": "DownSampler"}[mode]
    rng = np.random.default_rng(5)
    labels = (rng.uniform(size=3000) < 0.2).astype(np.float32)
    weights = rng.uniform(0.5, 2, size=3000).astype(np.float32)
    uids = np.arange(3000, dtype=np.int64)
    a, b = getattr(ts, cls)(rate=0.3, seed=7), getattr(js, cls)(rate=0.3,
                                                                 seed=7)
    draws = []
    for sweep in range(3):
        got = a.downsample(labels, weights, sweep=sweep, uids=uids)
        np.testing.assert_array_equal(
            got, b.downsample(labels, weights, sweep=sweep, uids=uids))
        draws.append(got > 0)
    assert (draws[0] != draws[1]).any()  # a fresh draw each sweep
    if mode == "binary":
        assert draws[0][labels > 0.5].all()  # positives always kept


def test_downsampled_fixed_effect_matches_jax():
    """Two sweeps of a down-sampled fixed effect: the same kept rows (each
    sweep's draw) and coefficients in both packages."""
    from photon_ml_tpu.game.coordinate import FixedEffectCoordinate as JFE
    from photon_ml_tpu_torch.game.coordinate import (
        FixedEffectCoordinate as TFE,
    )

    spec = "global=fixed,shard=global,reg=L2,maxIter=40,downsample=0.5"
    jcfg, tcfg = j_parse(spec)[1], t_parse(spec)[1]
    jd, td = _game_data(jg, 1200, 0), _game_data(tg, 1200, 0)
    jc = JFE("global", jg.FixedEffectDataset.build("global", jd, "global"),
             JTask.LOGISTIC_REGRESSION, jcfg.optimization, lam=1.0,
             downsampler=jcfg.downsampler)
    tc = TFE("global", tg.FixedEffectDataset.build("global", td, "global",
                                                   device="cpu"),
             TTask.LOGISTIC_REGRESSION, tcfg.optimization, lam=1.0,
             downsampler=tcfg.downsampler)
    ws = []
    for sweep in range(2):
        jm, _ = jc.train(np.zeros(1200, np.float32), sweep=sweep)
        tm, _ = tc.train(torch.zeros(1200), sweep=sweep)
        tw = tm.model.coefficients.means.numpy()
        np.testing.assert_allclose(
            tw, np.asarray(jm.model.coefficients.means), **COEF_TOL)
        ws.append(tw)
    assert not np.array_equal(ws[0], ws[1])


def test_downsampled_estimator_fit_matches_jax():
    specs = ["global=fixed,shard=global,reg=L2,maxIter=40,downsample=0.5,"
             "downsampleMode=uniform"] + EN_SPECS[2:]
    seq = ["global", "perSong"]
    jest = jg.GameEstimator(task=JTask.LOGISTIC_REGRESSION,
                            coordinate_configs=dict(j_parse(s) for s in specs),
                            update_sequence=seq, n_cd_iterations=2)
    test = tg.GameEstimator(task=TTask.LOGISTIC_REGRESSION,
                            coordinate_configs=dict(t_parse(s) for s in specs),
                            update_sequence=seq, n_cd_iterations=2,
                            device="cpu")
    cfgs = [{"global": 1.0, "perSong": 3.0}]
    jm = jest.fit(_game_data(jg, 1200, 0),
                  [jg.GameOptimizationConfiguration(cfgs[0])])[0].model
    tm = test.fit(_game_data(tg, 1200, 0),
                  [tg.GameOptimizationConfiguration(cfgs[0])])[0].model
    np.testing.assert_allclose(
        tm.coordinates["global"].model.coefficients.means.numpy(),
        np.asarray(jm.coordinates["global"].model.coefficients.means),
        **COEF_TOL)


# --- streaming buckets and deferred validation -------------------------------

def _port_fit(specs, validation=None, **fit_kw):
    _, test = _estimators(specs)
    return test.fit(_game_data(tg, 1200, 0),
                    [tg.GameOptimizationConfiguration(LAM)],
                    validation=validation, **fit_kw)[0]


def _assert_models_identical(a, b):
    for cid, ma in a.coordinates.items():
        mb = b.coordinates[cid]
        if isinstance(ma, tg.FixedEffectModel):
            assert torch.equal(ma.model.coefficients.means,
                               mb.model.coefficients.means)
        else:
            np.testing.assert_array_equal(ma.keys, mb.keys)
            np.testing.assert_array_equal(ma.coeffs, mb.coeffs)
            if ma.variances is not None:
                np.testing.assert_array_equal(ma.variances, mb.variances)


@pytest.mark.parametrize("specs", [EN_SPECS, PROJ_SPECS],
                         ids=["index-map", "projected"])
def test_streamed_buckets_equal_cached_bit_for_bit(specs):
    streamed = [s + ",cacheBuckets=false" if "random" in s else s
                for s in specs]
    cached = _port_fit(specs)
    got = _port_fit(streamed)
    _assert_models_identical(got.model, cached.model)
    _, test = _estimators(streamed)
    ds = test.prepare(_game_data(tg, 1200, 0))
    assert not ds["perSong"].config.cache_device_buckets
    test.fit(_game_data(tg, 1200, 0), [tg.GameOptimizationConfiguration(LAM)],
             datasets=ds)
    assert ds["perSong"]._device_cache == {}  # every bucket was dropped


def test_deferred_validation_equals_eager():
    calls = []

    def deferred():
        calls.append(1)
        return _game_data(tg, 600, 5), t_evaluators(["AUC"])

    eager = _port_fit(EN_SPECS, validation=deferred())
    lazy = _port_fit(EN_SPECS, validation=deferred)
    assert len(calls) == 2  # once for the eager fit, once at first use
    _assert_models_identical(lazy.model, eager.model)
    assert lazy.validation_history == eager.validation_history
    assert lazy.evaluation.primary[1] == eager.evaluation.primary[1]
