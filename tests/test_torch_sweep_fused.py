"""The fused whole-coordinate random-effect sweep on the CPU: the lockstep
driver of the batched optimizers, the fused sweep against the per-bucket
loop bit for bit (L-BFGS, OWL-QN, TRON; no, SIMPLE and FULL variances;
cold and warm), the port's fused solve against the JAX package's, the
deferred model tables, passive rows scored on the device, the estimator's
background build and the warm join's key-table guard."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.game as jg
import photon_ml_tpu_torch.game as tg
import photon_ml_tpu_torch.game.data as td
from photon_ml_tpu.game.coordinate import RandomEffectCoordinate as JCoordinate
from photon_ml_tpu.game.random_effect import RandomEffectSolver as JSolver
from photon_ml_tpu.glm.problem import GLMOptimizationConfiguration as JOpt
from photon_ml_tpu.ops.regularization import L2Regularization as JL2
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizer
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.game.random_effect import RandomEffectSolver
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
from photon_ml_tpu_torch.io.index import build_index_map as t_index_map
from photon_ml_tpu_torch.types import feature_key
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.ops.regularization import (
    L2Regularization,
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.optimize.common import drive
from photon_ml_tpu_torch.telemetry import profiling
from photon_ml_tpu_torch.types import (
    OptimizerType,
    TaskType,
    VarianceComputationType,
)
from test_torch_game import RE_TOL
from test_torch_game import _game_data as _music
from test_torch_pipeline import tree_records

CPU = torch.device("cpu")
LAM = 0.5
DIM = 9
ELASTIC = RegularizationContext(RegularizationType.ELASTIC_NET, alpha=0.5)
OPTIMIZERS = {
    "lbfgs": dict(optimizer=OptimizerType.LBFGS,
                  regularization=L2Regularization),
    "owlqn": dict(optimizer=OptimizerType.LBFGS, regularization=ELASTIC),
    "tron": dict(optimizer=OptimizerType.TRON,
                 regularization=L2Regularization),
}
VARIANCES = {"none": VarianceComputationType.NONE,
             "simple": VarianceComputationType.SIMPLE,
             "full": VarianceComputationType.FULL}


def _data(pkg, seed=0, n_entities=60, dim=DIM):
    """Entities of 1 to ~40 rows of 1-5 entries each, their features
    scaled by entity from 0.1 to 20 (so the buckets' lanes stop at very
    different iterations); a third of them with 1-2 rows, below the
    active-data bound of 3, so passive; a fifth of the rows at weight 0, a
    few rows without an entity id, and a second id column for another
    coordinate."""
    rng = np.random.default_rng(seed)
    sizes = rng.geometric(0.08, size=n_entities)
    sizes[::3] = rng.integers(1, 3, size=len(sizes[::3]))
    # feature scales from 0.1 to 20 by entity: lanes from well to badly
    # conditioned
    scale = 10.0 ** rng.uniform(-1.0, 1.3, size=n_entities)
    ent = rng.permutation(np.repeat(np.arange(n_entities), sizes))
    n = len(ent)
    rows, cols, vals = [], [], []
    for r in range(n):
        k = int(rng.integers(1, 6))
        rows.extend([r] * k)
        cols.extend(rng.choice(dim, size=k, replace=False).tolist())
        vals.extend((scale[ent[r]] * rng.normal(size=k)).tolist())
    ent[rng.uniform(size=n) < 0.03] = -1
    shard = pkg.FeatureShard.from_coo(
        np.array(rows, np.int64), np.array(cols, np.int32),
        np.array(vals, np.float32), n_samples=n, dim=dim)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    weights[rng.uniform(size=n) < 0.2] = 0.0
    return pkg.GameData.build(
        labels=(rng.uniform(size=n) < 0.4).astype(np.float32),
        shards={"re": shard}, weights=weights,
        id_columns={"entityId": ent,
                    "otherId": rng.integers(0, 7, size=n)})


def _config(pkg=tg, **kw):
    return pkg.RandomEffectDatasetConfig(
        "entityId", "re", bucket_strategy="histogram",
        max_sample_buckets=4, max_feature_buckets=2,
        active_data_lower_bound=3, active_data_upper_bound=24, **kw)


def _zero_row_bucket(entity_base):
    """A bucket of entities without a row: all padding."""
    shape = (3, 4, 5)
    return td.REBucket(
        entity_ids=entity_base + np.arange(3, dtype=np.int64),
        x=np.zeros(shape, np.float32),
        labels=np.zeros(shape[:2], np.float32),
        weights=np.zeros(shape[:2], np.float32),
        sample_idx=np.full(shape[:2], -1, np.int64),
        feature_index=np.full((3, 5), -1, np.int64))


def _dataset(data=None, zero_bucket=True):
    data = _data(tg) if data is None else data
    ds = tg.RandomEffectDataset.build("re", data, _config())
    if zero_bucket:
        ds = dataclasses.replace(
            ds, buckets=list(ds.buckets) + [_zero_row_bucket(
                ds.n_entities_total)], _device_cache={})
    return data, ds


def _solver(opt="lbfgs", var="none", max_iter=60):
    cfg = GLMOptimizationConfiguration(
        optimizer_config=OptimizerConfig(max_iterations=max_iter),
        variance_type=VARIANCES[var], **OPTIMIZERS[opt])
    return RandomEffectSolver(task=TaskType.LOGISTIC_REGRESSION, config=cfg,
                              device="cpu")


def _offsets(n, seed):
    return torch.as_tensor(
        0.3 * np.random.default_rng(seed).normal(size=n), dtype=torch.float32)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.int32)


def _same_model(a, b):
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(_bits(a.coeffs), _bits(b.coeffs))
    assert (a.variances is None) == (b.variances is None)
    if a.variances is not None:
        np.testing.assert_array_equal(_bits(a.variances), _bits(b.variances))


def _two_sweeps(solver, ds, n, path):
    """A cold sweep and a warm one (new offsets, the first model as the
    warm start) through ``path``: the fused ``train`` or the loop."""
    run = (solver.train if path == "fused" else
           lambda *a: solver._sweep_looped(*a[:4], DIM))
    m1, s1 = run(ds, _offsets(n, 1), LAM, None, DIM)
    m2, s2 = run(ds, _offsets(n, 2) + 0.5 * s1, LAM, m1, DIM)
    return (m1, s1), (m2, s2)


# --- (a) fused = loop, bit for bit ----------------------------------------

@pytest.mark.parametrize("var", sorted(VARIANCES))
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_fused_sweep_equals_the_bucket_loop_bit_for_bit(opt, var):
    data, ds = _dataset()
    assert len(ds.buckets) >= 3
    solver = _solver(opt, var)
    fused = _two_sweeps(solver, ds, data.n_samples, "fused")
    looped = _two_sweeps(solver, ds, data.n_samples, "looped")
    for (mf, sf), (ml, sl) in zip(fused, looped):
        _same_model(mf, ml)
        assert torch.equal(sf.view(torch.int32), sl.view(torch.int32))
        assert torch.equal(mf.coeffs_device, ml.coeffs_device)
    # the warm sweep started from the cold one's table and moved
    assert not np.array_equal(fused[0][0].coeffs, fused[1][0].coeffs)


def test_lanes_of_the_buckets_stop_at_very_different_iterations():
    data, ds = _dataset(zero_bucket=False)
    solver = _solver()
    iters = []
    for i, b in enumerate(ds.buckets):
        st = solver._statics(ds, i, b, CPU, 0, b.tensor_shape[0])
        res = solver._problem().run(
            solver._bucket_data(st, _offsets(data.n_samples, 1), CPU),
            torch.zeros(b.tensor_shape[0], b.tensor_shape[2]), LAM)
        iters.append(int(res.iterations.max()))
    assert max(iters) >= 2 * min(iters), iters


# --- (b) the driver's reads -------------------------------------------------

def _members(solver, ds, n):
    out = []
    for i, b in enumerate(ds.buckets):
        st = solver._statics(ds, i, b, CPU, 0, b.tensor_shape[0])
        data = solver._bucket_data(st, _offsets(n, 1), CPU)
        out.append((data, torch.zeros(b.tensor_shape[0],
                                      b.tensor_shape[2])))
    return out


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_drive_reads_once_a_round_as_often_as_its_longest_member(opt):
    data, ds = _dataset()
    solver = _solver(opt)
    problem = solver._problem()
    members = _members(solver, ds, data.n_samples)
    alone, results_alone = [], []
    for d, w0 in members:
        r0 = drive.reads
        results_alone.append(drive([problem.steps(d, w0, LAM)])[0])
        alone.append(drive.reads - r0)
    assert len(set(alone)) > 1, alone
    r0, k0 = drive.reads, drive.rounds
    together = drive([problem.steps(d, w0, LAM) for d, w0 in members])
    assert drive.reads - r0 == drive.rounds - k0 == max(alone)
    for a, b in zip(results_alone, together):
        assert torch.equal(a.w, b.w) and torch.equal(a.iterations,
                                                     b.iterations)


def test_a_fused_sweep_reads_as_often_as_its_longest_bucket():
    data, ds = _dataset()
    solver = _solver()
    offsets = _offsets(data.n_samples, 1)
    solver.train(ds, offsets, LAM, None, DIM)  # statics built
    r0 = drive.reads
    solver.train(ds, offsets, LAM, None, DIM)
    fused = drive.reads - r0
    r0 = drive.reads
    solver._sweep_looped(ds, offsets, LAM, None, DIM)
    looped = drive.reads - r0
    per_bucket = []
    for d, w0 in _members(solver, ds, data.n_samples):
        r1 = drive.reads
        drive([solver._problem().steps(d, w0, LAM)])
        per_bucket.append(drive.reads - r1)
    assert fused == max(per_bucket) and looped == sum(per_bucket), (
        fused, looped, per_bucket)


def test_drive_reads_once_a_device_a_round():
    seen = []

    def member(tag, n):
        for k in range(n):
            seen.append((tag, k))
            answer = yield torch.tensor(k < n - 1)
            if not answer:
                break
        return tag

    r0, k0 = drive.reads, drive.rounds
    assert drive([member("a", 2), member("b", 5), member("c", 1)]) == [
        "a", "b", "c"]
    assert drive.rounds - k0 == 5 and drive.reads - r0 == 5
    # each member advances once a round, in member order
    assert seen[:3] == [("a", 0), ("b", 0), ("c", 0)]


# --- (c) the port's fused solve against the JAX package's -----------------

def test_fused_solve_matches_jax():
    """The per-user coordinate of tests/test_torch_game.py's music data
    (its bucketing, L2, 40 iterations), solved cold and then warm from
    each package's own first model, at RE_TOL's f32 row."""
    tdata, jdata = _music(tg, 1200, 0), _music(jg, 1200, 0)
    cfg = dict(bucket_strategy="histogram", max_sample_buckets=4)
    tds = tg.RandomEffectDataset.build(
        "perUser", tdata, tg.RandomEffectDatasetConfig("userId", "item",
                                                       **cfg))
    jds = jg.RandomEffectDataset.build(
        "perUser", jdata, jg.RandomEffectDatasetConfig("userId", "item",
                                                       **cfg))
    dim = tdata.shards["item"].dim
    solver = RandomEffectSolver(
        task=TaskType.LOGISTIC_REGRESSION, config=GLMOptimizationConfiguration(
            regularization=L2Regularization,
            optimizer_config=OptimizerConfig(max_iterations=40)),
        device="cpu")
    jsolver = JSolver(task=JTask.LOGISTIC_REGRESSION, config=JOpt(
        regularization=JL2, optimizer_config=JOptimizer(max_iterations=40)))
    off = (0.3 * np.random.default_rng(1).normal(size=tdata.n_samples)
           ).astype(np.float32)
    tm = jm = None
    for sweep in range(2):
        tm, ts = solver.train(tds, torch.as_tensor(off), 1.0, tm, dim)
        jm, js = jsolver.train(jds, off, 1.0, jm, dim)
        np.testing.assert_array_equal(tm.keys, jm.keys)
        np.testing.assert_allclose(tm.coeffs, np.asarray(jm.coeffs),
                                   **RE_TOL["float32"])
        # the scores part by at most what the coefficients may: each row's
        # sum of |x_j| times RE_TOL's reach at its coefficient
        tol = RE_TOL["float32"]
        reach = tol["atol"] + tol["rtol"] * np.abs(np.asarray(jm.coeffs))
        bound = _abs_margins(tdata, tm, reach)
        gap = np.abs(ts.numpy() - np.asarray(js))
        assert np.all(gap <= bound * (1 + 1e-5) + 1e-6), float(
            (gap - bound).max())
        off = off + 0.5 * ts.numpy()


def _abs_margins(data, model, table):
    """Each row's ``Σ_j |x_j|·table[key]`` over its entity's keys (0 for
    a row without a model)."""
    absolute = dataclasses.replace(model, coeffs=table.astype(np.float32),
                                   variances=None, coeffs_device=None)
    shard = data.shards[model.feature_shard_id]
    return tg.RandomEffectModel.score(absolute, dataclasses.replace(
        data, shards={**data.shards, model.feature_shard_id:
                      dataclasses.replace(shard, vals=np.abs(shard.vals))}))


# --- (d) the deferred tables ------------------------------------------------

def test_coeffs_device_is_the_sorted_host_table():
    data, ds = _dataset()
    model, _ = _solver(var="simple").train(ds, _offsets(data.n_samples, 1),
                                           LAM, None, DIM)
    assert model.pending is not None  # nothing copied yet
    device = model.coeffs_device.clone()
    assert model.coeffs.dtype == np.float32  # the first access copies
    assert model.pending is None
    np.testing.assert_array_equal(_bits(device.numpy()), _bits(model.coeffs))
    assert np.all(np.diff(model.keys) > 0)
    assert model.variances is not None and model.variances.shape == \
        model.coeffs.shape


def _fit(seed=0):
    data = _data(tg, seed)
    cfg = GLMOptimizationConfiguration(
        regularization=L2Regularization,
        optimizer_config=OptimizerConfig(max_iterations=30),
        variance_type=VarianceComputationType.SIMPLE)
    est = tg.GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs={
            "perEntity": tg.RandomEffectCoordinateConfig(_config(), cfg),
            "perOther": tg.RandomEffectCoordinateConfig(
                tg.RandomEffectDatasetConfig("otherId", "re"), cfg)},
        update_sequence=["perEntity", "perOther"], n_cd_iterations=1,
        device="cpu")
    return est.fit(data, [tg.GameOptimizationConfiguration(
        {"perEntity": LAM, "perOther": 2.0})])[0].model


def test_materialize_copies_once_and_equals_access_per_coordinate(
        monkeypatch):
    batched, one_by_one = _fit(), _fit()
    for m in list(batched.coordinates.values()) + list(
            one_by_one.coordinates.values()):
        assert m.pending is not None
    copies = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        copies.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    batched.materialize()
    assert len(copies) == 1, copies
    batched.materialize()  # nothing left on the device
    assert len(copies) == 1
    monkeypatch.setattr(torch.Tensor, "cpu", real_cpu)
    for cid, m in batched.coordinates.items():
        assert m.pending is None
        _same_model(m, one_by_one.coordinates[cid])  # access per coordinate


def test_device_wait_reads_one_element_and_leaves_the_tables(monkeypatch):
    model = _fit()
    seen = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        seen.append(self.numel())
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    model.device_wait()
    assert seen == [1]
    assert all(m.pending is not None for m in model.coordinates.values())


def test_save_writes_the_records_and_lineage_of_the_host_tables(tmp_path):
    deferred, eager = _fit(), _fit()
    for m in eager.coordinates.values():
        m.coeffs  # noqa: B018 -- the first access copies the table
    maps = {"re": t_index_map([feature_key(f"f{i}") for i in range(DIM)],
                              add_intercept=False)}
    vocabs = {"entityId": {f"e{i}": i for i in range(60)},
              "otherId": {f"o{i}": i for i in range(7)}}
    for name, model in (("deferred", deferred), ("eager", eager)):
        tio.save_game_model(str(tmp_path / name), model, maps, vocabs)
    assert all(m.pending is None for m in deferred.coordinates.values())
    assert tree_records(tmp_path / "deferred") == tree_records(
        tmp_path / "eager")
    assert tio.model_lineage_id(str(tmp_path / "deferred")) == \
        tio.model_lineage_id(str(tmp_path / "eager"))


def test_a_pickled_model_carries_its_host_tables():
    import pickle

    model = _fit().coordinates["perEntity"]
    back = pickle.loads(pickle.dumps(model))
    assert back.coeffs_device is None and back.pending is None
    _same_model(back, model)


# --- (e) passive rows on the device -----------------------------------------

def _coordinate(pkg, data, ds, cfg):
    return (RandomEffectCoordinate if pkg is tg else JCoordinate)(
        coordinate_id="perEntity", dataset=ds, data=data,
        task=(TaskType if pkg is tg else JTask).LOGISTIC_REGRESSION,
        config=cfg, lam=LAM)


def test_passive_scores_on_the_device():
    data, ds = _dataset(zero_bucket=False)
    assert len(ds.passive_sample_idx) > 10
    coord = _coordinate(tg, data, ds, _solver().config)
    off = _offsets(data.n_samples, 1)
    runs = [coord.train(off.clone()) for _ in range(2)]
    (model, scores), (_, again) = runs
    assert model.coeffs_device is not None
    assert torch.equal(scores.view(torch.int32), again.view(torch.int32))
    passive = ds.passive_sample_idx
    host = model.score(data, sample_idx=passive)
    np.testing.assert_allclose(scores.numpy()[passive], host, rtol=1e-6,
                               atol=1e-6)
    assert np.any(host != 0)
    # the JAX package's device join on the same model and rows
    jdata = _data(jg)
    jds = jg.RandomEffectDataset.build("re", jdata, _config(jg))
    np.testing.assert_array_equal(jds.passive_sample_idx, passive)
    jcoord = _coordinate(jg, jdata, jds, JOpt(regularization=JL2))
    jmodel = jg.RandomEffectModel(
        random_effect_type="entityId", feature_shard_id="re",
        task=JTask.LOGISTIC_REGRESSION, dim=model.dim, keys=model.keys,
        coeffs=model.coeffs, coeffs_device=np.asarray(model.coeffs))
    jscores = np.asarray(jcoord._passive_scores_device(
        jmodel, jnp.zeros(data.n_samples, jnp.float32)))
    np.testing.assert_allclose(scores.numpy()[passive], jscores[passive],
                               rtol=1e-6, atol=1e-6)


def test_the_passive_join_is_rebuilt_for_another_key_table():
    data, ds = _dataset(zero_bucket=False)
    coord = _coordinate(tg, data, ds, _solver().config)
    model, scores = coord.train(_offsets(data.n_samples, 1))
    passive = ds.passive_sample_idx
    # a model of another key table: every key of entity 0's row dropped
    keep = model.keys // model.dim != model.keys[0] // model.dim
    other = dataclasses.replace(
        model, keys=model.keys[keep], coeffs=model.coeffs[keep],
        variances=None, coeffs_device=model.coeffs_device[
            torch.as_tensor(keep)])
    sc = torch.zeros_like(scores)
    coord._passive_scores_device(other, sc)
    np.testing.assert_allclose(sc.numpy()[passive],
                               other.score(data, sample_idx=passive),
                               rtol=1e-6, atol=1e-6)


# --- (f) the background build ----------------------------------------------

def test_prepare_builds_in_the_background_and_train_joins_it(monkeypatch):
    data = _data(tg)
    cfg = tg.RandomEffectCoordinateConfig(_config(), _solver().config)
    est = tg.GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs={"perEntity": cfg,
                            "stream": tg.RandomEffectCoordinateConfig(
                                dataclasses.replace(
                                    _config(), cache_device_buckets=False),
                                _solver().config)},
        update_sequence=["perEntity", "stream"], device="cpu")
    joined = []
    real = RandomEffectSolver._join_warm

    def spy(dataset):
        th = getattr(dataset, "_warm_thread", None)
        real(dataset)
        joined.append(th is not None and not th.is_alive())

    monkeypatch.setattr(RandomEffectSolver, "_join_warm", staticmethod(spy))
    ds = est.prepare(data)
    th = ds["perEntity"]._warm_thread
    assert th.daemon and getattr(ds["stream"], "_warm_thread", None) is None
    solver = RandomEffectSolver(task=est.task, config=cfg.optimization,
                                device="cpu")
    solver.train(ds["perEntity"], _offsets(data.n_samples, 1), LAM, None,
                 DIM)
    assert joined == [True]
    # the background build equals a synchronous one, entry for entry
    sync = tg.RandomEffectDataset.build("re", data, _config())
    solver._warm_compile(sync, DIM)
    built = ds["perEntity"]._device_cache
    assert set(sync._device_cache) <= set(built)
    for key, want in sync._device_cache.items():
        got = built[key]
        if isinstance(want, tre._BucketStatics):
            for f in ("x", "labels", "weights", "gather_idx", "slots",
                      "rows"):
                assert torch.equal(getattr(got, f), getattr(want, f)), key
        else:
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                if isinstance(a, torch.Tensor):
                    assert torch.equal(a, b), key
                else:
                    np.testing.assert_array_equal(a, b)


def test_two_threads_asking_for_one_image_make_it_once(monkeypatch):
    """The build threads share the data's image cache: a thread asking for
    an image another is making waits, and both get one tensor."""
    import threading

    data = _data(tg)
    made = []
    real = torch.Tensor.index_put_
    gate = threading.Event()

    def slow_put(self, *a, **kw):
        made.append(1)
        gate.wait(0.2)  # the other thread asks meanwhile
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "index_put_", slow_put)
    got = [None, None]

    def ask(k):
        got[k] = data.device_dense_shard("re", torch.bfloat16, "cpu")

    threads = [threading.Thread(target=ask, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(made) == 1 and got[0] is got[1]


def test_prepare_makes_each_image_before_the_threads_start(monkeypatch):
    """Two random effects on one shard wider than the fixed effect's dense
    rule takes (so only the random effects' cap lets its image be made):
    ``prepare`` makes the image once, before it starts the threads, and
    both coordinates' statics read that one image."""
    wide = 5000  # past DENSE_DESIGN_MAX_DIM, a few entries a row
    data = _data(tg, dim=wide)
    assert not td.choose_dense_design(data.shards["re"])
    made = []
    real = td.GameData._cached

    def counting(self, key, make):
        def counted():
            made.append(key[:2])
            return make()
        return real(self, key, counted)

    monkeypatch.setattr(td.GameData, "_cached", counting)
    started = []
    real_start = tg.estimator._start_warm_compile

    def start(solver, dataset, dim):
        started.append(list(made))
        real_start(solver, dataset, dim)

    monkeypatch.setattr(tg.estimator, "_start_warm_compile", start)
    opt = _solver().config
    est = tg.GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs={
            "perEntity": tg.RandomEffectCoordinateConfig(_config(), opt),
            "perOther": tg.RandomEffectCoordinateConfig(
                dataclasses.replace(_config(), random_effect_type="otherId"),
                opt)},
        update_sequence=["perEntity", "perOther"], device="cpu")
    ds = est.prepare(data)
    for cid in ds:
        RandomEffectSolver._join_warm(ds[cid])
    assert made.count(("dense_shard", "re")) == 1
    assert started == [made, made]
    image = data.device_dense_shard("re", torch.float32, "cpu")
    solver = RandomEffectSolver(task=est.task, config=opt, device="cpu")
    for cid in ds:
        assert solver._compact_shared(ds[cid], CPU)[0] is image


def test_the_loop_warm_starts_a_projected_dataset_as_the_model_looks_up():
    """The per-bucket loop gathers every warm start through the device join,
    a projected dataset's too: each bucket's gather equals the model's host
    lookup of its (entity, feature) slots."""
    data = _data(tg)
    ds = tg.RandomEffectDataset.build("re", data, _config(
        projector_type=tg.ProjectorType.RANDOM, projected_dim=4))
    solver = _solver()
    shard_dim = ds.projector.projected_dim
    warm, _ = solver.train(ds, _offsets(data.n_samples, 1), LAM, None)
    assert warm.projector is not None and warm.coeffs_device is None
    usable, table = solver._warm_table(ds, warm, shard_dim)
    assert usable is warm
    for i, b in enumerate(ds.buckets):
        e = b.tensor_shape[0]
        got = solver._warm_start(ds, i, b, warm, table, shard_dim, CPU, 0, e)
        ent = np.broadcast_to(b.entity_ids[:, None], b.feature_index.shape)
        want = np.where(b.feature_index >= 0,
                        warm.lookup(ent, b.feature_index), 0.0)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # a model of the other key space seeds nothing
    plain, _ = solver.train(_dataset(data, zero_bucket=False)[1],
                            _offsets(data.n_samples, 1), LAM, None, DIM)
    assert solver._warm_table(ds, plain, shard_dim)[0] is None


# --- (g) the warm join's key-table guard -----------------------------------

def test_a_warm_join_through_another_key_table_is_rebuilt():
    data, ds = _dataset()
    solver = _solver()
    off = _offsets(data.n_samples, 1)
    warm, _ = solver.train(ds, off, LAM, None, DIM)
    # a model of another key table over the same entities: entity 0's
    # features gone, every other coefficient kept
    keep = warm.keys // DIM != warm.keys[0] // DIM
    other = tg.RandomEffectModel(
        random_effect_type="entityId", feature_shard_id="re",
        task=TaskType.LOGISTIC_REGRESSION, dim=DIM, keys=warm.keys[keep],
        coeffs=warm.coeffs[keep], coeffs_device=warm.coeffs_device[
            torch.as_tensor(keep)])
    solver.train(ds, off, LAM, warm, DIM)  # joins cached for warm's table
    got, _ = solver.train(ds, off, LAM, other, DIM)
    fresh = dataclasses.replace(ds, _device_cache={})
    want, _ = solver.train(fresh, off, LAM, other, DIM)
    _same_model(got, want)
    for key, ctx in ds._device_cache.items():
        if key[0] == "warmidx":
            assert ctx[0] is other.keys


# --- telemetry ----------------------------------------------------------------

def _profiled_calls(solver, ds, n):
    from photon_ml_tpu_torch.telemetry import metrics as tmetrics

    reg = tmetrics.default_registry()

    def count(fn):
        fam = reg.get("photon_execute_latency_seconds")
        if fam is None:
            return 0
        return sum(child.count for labels, child in fam.children()
                   if labels == (fn,))

    before = {fn: count(fn) for fn in ("game.re.sweep_fused",
                                       "game.re.solve_bucket")}
    profiling.set_accounting(True)
    try:
        solver.train(ds, _offsets(n, 1), LAM, None, DIM)
    finally:
        profiling.set_accounting(False)
    return {fn: count(fn) - v for fn, v in before.items()}


def test_resident_fits_count_under_sweep_fused_streaming_under_solve_bucket():
    data, ds = _dataset()
    solver = _solver()
    assert _profiled_calls(solver, ds, data.n_samples) == {
        "game.re.sweep_fused": 1, "game.re.solve_bucket": 0}
    stream = dataclasses.replace(ds, config=dataclasses.replace(
        ds.config, cache_device_buckets=False), _device_cache={})
    assert _profiled_calls(solver, stream, data.n_samples) == {
        "game.re.sweep_fused": 0,
        "game.re.solve_bucket": len(ds.buckets)}
