"""The port's random-effect data path against the JAX package's on the CPU:
the native bucket packer (``native/bucket_pack.cc`` through
``photon_ml_tpu_torch/native.py``) against the port's numpy packer and the
JAX package's native build, the counting sort, index-only buckets and their
deferred fills, bucket statics rebuilt from the index maps
(``random_effect.py::_materialize_fat``) against the host fill bit for bit,
and the residency guard and the estimator's budget against the JAX
package's under a lowered cap."""

import dataclasses

import numpy as np
import pytest
import torch

import photon_ml_tpu.game.data as jd
import photon_ml_tpu_torch.game.data as td
import photon_ml_tpu_torch.game as tg
from photon_ml_tpu_torch import native
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.game.estimator import (
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
from photon_ml_tpu_torch.ops.objective import live_rows
from photon_ml_tpu_torch.ops.regularization import L2Regularization
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.types import TaskType
from test_torch_game import _game_data

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the native library does not build")

#: the cases of tests/test_native.py::TestNativeBucketPackParity
PACK_CASES = [
    {},
    {"bucket_strategy": "histogram", "max_sample_buckets": 3,
     "max_feature_buckets": 2},
    {"max_active_features": 4},
    {"active_data_lower_bound": 5, "active_data_upper_bound": 12},
    {"max_active_features": 3, "bucket_strategy": "histogram"},
]
PACK_IDS = ["geometric", "histogram", "max-features", "bounds",
            "max-features-histogram"]
FIELDS = ("entity_ids", "x", "labels", "weights", "sample_idx",
          "feature_index")


def _messy(pkg, seed=0, n=600, n_entities=40, dim=37):
    """Rows of 0-8 entries with duplicate (row, feature) entries, missing
    entity ids and weights (the JAX package's parity data)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(n):
        k = int(rng.integers(0, 9))
        rows.extend([r] * k)
        cols.extend(rng.integers(0, dim, size=k).tolist())
        vals.extend(rng.normal(size=k).tolist())
    shard = pkg.FeatureShard.from_coo(
        np.array(rows, np.int64), np.array(cols, np.int32),
        np.array(vals, np.float32), n_samples=n, dim=dim)
    ent = rng.integers(-1, n_entities, size=n).astype(np.int64)
    return pkg.GameData.build(
        labels=(rng.uniform(size=n) < 0.5).astype(np.float32),
        shards={"re": shard},
        weights=rng.uniform(0.5, 2.0, size=n).astype(np.float32),
        id_columns={"entityId": ent})


def _assert_same_buckets(a, b):
    assert len(a.buckets) == len(b.buckets) > 0
    for ba, bb in zip(a.buckets, b.buckets):
        for field in FIELDS:
            np.testing.assert_array_equal(
                getattr(ba, field), np.asarray(getattr(bb, field)),
                err_msg=field)
    np.testing.assert_array_equal(a.passive_sample_idx,
                                  np.asarray(b.passive_sample_idx))
    np.testing.assert_array_equal(a.passive_entity_ids,
                                  np.asarray(b.passive_entity_ids))
    assert a.n_entities_total == b.n_entities_total


@pytest.mark.parametrize("resident", [True, False],
                         ids=["index-only", "eager"])
@pytest.mark.parametrize("kw", PACK_CASES, ids=PACK_IDS)
def test_native_packer_matches_numpy_packer(kw, resident):
    data = _messy(td)
    cfg = td.RandomEffectDatasetConfig("entityId", "re",
                                       cache_device_buckets=resident, **kw)
    fast = td.RandomEffectDataset.build("re", data, cfg, use_native=True)
    slow = td.RandomEffectDataset.build("re", data, cfg, use_native=False)
    assert all(b.materialized != resident for b in fast.buckets)
    assert all(b.materialized for b in slow.buckets)
    _assert_same_buckets(fast, slow)


@pytest.mark.parametrize("kw", PACK_CASES, ids=PACK_IDS)
def test_buckets_match_the_jax_native_build(kw):
    port = td.RandomEffectDataset.build(
        "re", _messy(td), td.RandomEffectDatasetConfig("entityId", "re", **kw))
    ref = jd.RandomEffectDataset.build(
        "re", _messy(jd), jd.RandomEffectDatasetConfig("entityId", "re", **kw),
        use_native=True)
    _assert_same_buckets(port, ref)
    assert port.config.cache_device_buckets == ref.config.cache_device_buckets


def test_use_native_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    cfg = td.RandomEffectDatasetConfig("entityId", "re")
    with pytest.raises(RuntimeError, match="native bucket packer"):
        td.RandomEffectDataset.build("re", _messy(td), cfg, use_native=True)
    # auto falls back to the numpy packer, with the same buckets
    auto = td.RandomEffectDataset.build("re", _messy(td), cfg)
    monkeypatch.undo()
    _assert_same_buckets(auto, td.RandomEffectDataset.build(
        "re", _messy(td), cfg, use_native=True))


@pytest.mark.parametrize("ids", [
    np.array([3, 1, 3, 0, 2, 1, 1, 0, 3], np.int64),
    np.random.default_rng(0).integers(0, 50, size=2000),
    np.array([7], np.int64),
    np.zeros(0, np.int64),
    # sparse: a maximum above 4x the count takes the comparison sort
    np.array([10**9, 5, 10**9, 5, 0], np.int64),
], ids=["small", "dense", "one", "empty", "sparse"])
def test_counting_sort_is_a_stable_argsort(ids):
    np.testing.assert_array_equal(native.counting_sort(ids),
                                  np.argsort(ids, kind="stable"))


def _pack_inputs(data):
    """Pass A's and B's inputs for the messy data's entities, as the build
    makes them."""
    shard = data.shards["re"]
    ent = data.id_columns["entityId"]
    rows = np.flatnonzero(ent >= 0)
    rows = rows[np.argsort(ent[rows], kind="stable")]
    _, counts = np.unique(ent[rows], return_counts=True)
    starts = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    return shard, rows, starts


def test_pass_b_needs_a_stamp_array_of_its_own():
    data = _messy(td)
    shard, rows, starts = _pack_inputs(data)
    # one bucket of every entity, last first: pass B's order differs from
    # pass A's, as it does over several buckets
    sel = np.arange(len(starts) - 1)[::-1]

    def pack(scratch):
        native.re_feature_counts(shard.indptr, shard.cols, rows, starts,
                                 shard.dim, None, scratch)
        return native.re_bucket_indices(shard.indptr, shard.cols, rows,
                                        starts, sel, 40, shard.dim, None,
                                        scratch)

    good = pack(native.BucketPackScratch(shard.dim))
    aliased = native.BucketPackScratch(shard.dim)
    aliased.stamp_b = aliased.stamp_a
    bad = pack(aliased)
    # pass A left each feature stamped with the last entity that saw it:
    # pass B on the same array takes those features as already seen for
    # that entity and drops them, with no error
    np.testing.assert_array_equal(good[0], bad[0])
    assert (good[1][0] >= 0).any() and not (bad[1][0] >= 0).any()
    # a fresh scratch for a later fill gives the same maps again
    again = native.re_bucket_indices(
        shard.indptr, shard.cols, rows, starts, sel, 40, shard.dim, None,
        native.BucketPackScratch(shard.dim))
    np.testing.assert_array_equal(good[1], again[1])


def test_an_index_only_bucket_fills_once_and_only_when_read(monkeypatch):
    calls = []
    real = native.re_bucket_fill

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(native, "re_bucket_fill", counted)
    cfg = td.RandomEffectDatasetConfig("entityId", "re", max_active_features=4)
    lazy = td.RandomEffectDataset.build("re", _messy(td), cfg)
    assert not calls and len(lazy.buckets) > 1
    for b in lazy.buckets:
        e, s = b.sample_idx.shape
        assert b.tensor_shape == (e, s, b.feature_index.shape[1])
        assert not b.materialized
    eager = td.RandomEffectDataset.build(
        "re", _messy(td), cfg, use_native=False)
    for i, (b, want) in enumerate(zip(lazy.buckets, eager.buckets)):
        np.testing.assert_array_equal(b.weights, want.weights)
        np.testing.assert_array_equal(b.x, want.x)
        np.testing.assert_array_equal(b.labels, want.labels)
        assert b.materialized and len(calls) == i + 1
    lazy.buckets[0].x  # filled already: no second run
    assert len(calls) == len(lazy.buckets)


# ---------------------------------------------------------------------------
# statics rebuilt on the device
# ---------------------------------------------------------------------------

def _solver(dtype, mesh=None):
    return tre.RandomEffectSolver(
        task=TaskType.LOGISTIC_REGRESSION,
        config=GLMOptimizationConfiguration(regularization=L2Regularization),
        design_dtype=dtype, device="cpu", mesh=mesh)


def _assert_statics_equal(got, want):
    for field in ("x", "labels", "weights", "gather_idx", "slots", "rows"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        elif a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), field
    assert live_rows(got.weights) == live_rows(want.weights)


def _compact_vs_host(ds, dtype):
    solver = _solver(dtype)
    shared = solver._compact_shared(ds, torch.device("cpu"))
    assert shared is not None
    for i, b in enumerate(ds.buckets):
        was = b.materialized
        got = solver._statics_compact(ds, i, b, torch.device("cpu"), shared)
        assert b.materialized == was  # the compact path reads no fill
        e = b.tensor_shape[0]
        want = solver._statics_host(b, torch.device("cpu"), 0, e)
        _assert_statics_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, {"max_active_features": 3},
                                {"bucket_strategy": "histogram",
                                 "max_sample_buckets": 2}],
                         ids=["observed", "pruned", "histogram"])
def test_compact_statics_equal_the_host_fill(kw, dtype):
    """Pruned and observed-subset feature maps, duplicate entries."""
    ds = td.RandomEffectDataset.build(
        "re", _messy(td), td.RandomEffectDatasetConfig("entityId", "re", **kw))
    _compact_vs_host(ds, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_statics_take_the_row_gather_on_identity_maps(dtype,
                                                               monkeypatch):
    # every row holds every item feature, and the histogram strategy pads
    # no feature column
    data = _game_data(td, 400, 3)
    ds = td.RandomEffectDataset.build(
        "u", data, td.RandomEffectDatasetConfig(
            "userId", "item", bucket_strategy="histogram"))
    seen = []
    real = tre._materialize_fat

    def spy(*a, **k):
        seen.append(k["identity_cols"])
        return real(*a, **k)

    monkeypatch.setattr(tre, "_materialize_fat", spy)
    _compact_vs_host(ds, dtype)
    assert seen and all(seen)


def test_compact_statics_of_zero_row_entities():
    data = _messy(td)
    ds = td.RandomEffectDataset.build(
        "re", data, td.RandomEffectDatasetConfig("entityId", "re"))
    shape = (3, 4, 5)
    empty = td.REBucket(
        entity_ids=np.arange(3, dtype=np.int64),
        x=np.zeros(shape, np.float32), labels=np.zeros(shape[:2], np.float32),
        weights=np.zeros(shape[:2], np.float32),
        sample_idx=np.full(shape[:2], -1, np.int64),
        feature_index=np.full((3, 5), -1, np.int64))
    ds = dataclasses.replace(ds, buckets=[empty], _device_cache={})
    for dtype in ("float32", "bfloat16"):
        _compact_vs_host(ds, dtype)


def test_compact_path_is_taken_only_where_the_reference_takes_it():
    data = _messy(td)
    cfg = td.RandomEffectDatasetConfig("entityId", "re")
    ds = td.RandomEffectDataset.build("re", data, cfg)
    cpu = torch.device("cpu")
    assert _solver("float32")._compact_shared(ds, cpu) is not None
    streaming = dataclasses.replace(ds, config=dataclasses.replace(
        cfg, cache_device_buckets=False))
    assert _solver("float32")._compact_shared(streaming, cpu) is None
    assert _solver("float32")._compact_shared(
        dataclasses.replace(ds, source_data=None), cpu) is None
    from photon_ml_tpu_torch.parallel.mesh import make_mesh

    meshed = _solver("float32", mesh=make_mesh({"entity": 2},
                                               devices=["cpu"] * 2))
    assert meshed._compact_shared(ds, cpu) is None
    proj = td.RandomEffectDataset.build(
        "re", data, td.RandomEffectDatasetConfig(
            "entityId", "re", projector_type=td.ProjectorType.RANDOM,
            projected_dim=3))
    assert proj.source_data is None
    assert _solver("float32")._compact_shared(proj, cpu) is None
    # a projected build keeps its host fill
    assert all(b.materialized for b in proj.buckets)


# ---------------------------------------------------------------------------
# the residency guard and the estimator's budget
# ---------------------------------------------------------------------------

def test_resident_fat_bytes_is_the_references():
    for kw in PACK_CASES:
        port = td.RandomEffectDataset.build(
            "re", _messy(td), td.RandomEffectDatasetConfig(
                "entityId", "re", **kw))
        ref = jd.RandomEffectDataset.build(
            "re", _messy(jd), jd.RandomEffectDatasetConfig(
                "entityId", "re", **kw), use_native=True)
        assert td.resident_fat_bytes(port.buckets) \
            == jd.resident_fat_bytes(ref.buckets) > 0


@pytest.mark.parametrize("shards", [1, 4])
def test_build_guard_flips_as_the_reference_does(monkeypatch, caplog,
                                                 shards):
    fat = jd.resident_fat_bytes(jd.RandomEffectDataset.build(
        "re", _messy(jd), jd.RandomEffectDatasetConfig("entityId", "re"),
        use_native=True).buckets)
    for cap in (fat // 4 - 1, fat // 4, fat - 1, fat):
        monkeypatch.setattr(jd, "RE_FAT_CACHE_MAX_BYTES", cap)
        monkeypatch.setattr(td, "RE_FAT_CACHE_MAX_BYTES", cap)
        ref = jd.RandomEffectDataset.build(
            "re", _messy(jd), jd.RandomEffectDatasetConfig("entityId", "re"),
            use_native=True, n_entity_shards=shards)
        port = td.RandomEffectDataset.build(
            "re", _messy(td), td.RandomEffectDatasetConfig("entityId", "re"),
            n_entity_shards=shards)
        assert (port.config.cache_device_buckets
                == ref.config.cache_device_buckets
                == (fat // shards <= cap)), cap
        # the guard runs after the packer: a flipped build keeps its
        # deferred fills, which the streaming solve runs (as the
        # reference's does)
        assert not any(b.materialized for b in port.buckets)
    assert any("upload-and-drop" in r.message for r in caplog.records)


LAMS = {"global": 1.0, "perUser": 3.0, "perSong": 3.0}


def _port_estimator():
    opt = GLMOptimizationConfiguration(
        regularization=L2Regularization,
        optimizer_config=OptimizerConfig(max_iterations=30))
    coords = {
        "global": FixedEffectCoordinateConfig("global", opt),
        "perUser": RandomEffectCoordinateConfig(
            tg.RandomEffectDatasetConfig("userId", "item"), opt,
            design_dtype="bfloat16"),
        "perSong": RandomEffectCoordinateConfig(
            tg.RandomEffectDatasetConfig("songId", "item"), opt,
            design_dtype="bfloat16")}
    return tg.GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                            coordinate_configs=coords,
                            update_sequence=list(coords), device="cpu")


def _jax_estimator():
    import photon_ml_tpu.game as jg
    from photon_ml_tpu.game.estimator import (
        FixedEffectCoordinateConfig as JFixed,
        RandomEffectCoordinateConfig as JRandom,
    )
    from photon_ml_tpu.types import TaskType as JTask

    coords = {
        "global": JFixed("global"),
        "perUser": JRandom(jg.RandomEffectDatasetConfig("userId", "item")),
        "perSong": JRandom(jg.RandomEffectDatasetConfig("songId", "item"))}
    return jg.GameEstimator(task=JTask.LOGISTIC_REGRESSION,
                            coordinate_configs=coords,
                            update_sequence=list(coords))


def _budget_caps():
    """Caps between the two coordinates' resident bytes and their sum,
    below both, and above the sum."""
    data = _game_data(td, 1500, 0)
    fat = {cid: td.resident_fat_bytes(td.RandomEffectDataset.build(
        cid, data, td.RandomEffectDatasetConfig(ent, "item")).buckets)
        for cid, ent in (("perUser", "userId"), ("perSong", "songId"))}
    small, big = sorted(fat.values())
    assert small < big
    return fat, [big, small + big - 1, small + big, small - 1]


def test_budget_flips_the_coordinates_the_reference_flips(monkeypatch):
    jax_data = _game_data(jd, 1500, 0)
    fat, caps = _budget_caps()
    for cap in caps:
        monkeypatch.setattr(jd, "RE_FAT_CACHE_MAX_BYTES", cap)
        monkeypatch.setattr(td, "RE_FAT_CACHE_MAX_BYTES", cap)
        data = _game_data(td, 1500, 0)
        port = _port_estimator().prepare(data)
        jest = _jax_estimator()
        ref = {cid: jd.RandomEffectDataset.build(
            cid, jax_data, cfg.dataset, use_native=True)
            for cid, cfg in jest.coordinate_configs.items()
            if cid != "global"}
        jest._apply_fat_budget(jax_data, ref)
        flipped = {cid for cid in ref
                   if not port[cid].config.cache_device_buckets}
        assert flipped == {cid for cid in ref
                           if not ref[cid].config.cache_device_buckets}, cap
        # the flips the cap forces: none when the sum fits, the largest
        # first, every coordinate past its own cap at build time
        if cap >= sum(fat.values()):
            assert not flipped
        elif cap >= max(fat.values()):
            assert flipped == {max(fat, key=fat.get)}
        # the resident item shard's image stays; with both flipped it goes
        images = {k[1] for k in data._device_cache if k[0] == "dense_shard"}
        assert "global" in images
        assert ("item" in images) == (len(flipped) < 2), cap


def test_flipped_fit_equals_the_resident_fit(monkeypatch):
    data = _game_data(td, 1500, 0)
    valid = _game_data(td, 500, 7)
    from photon_ml_tpu_torch.evaluation import parse_evaluators

    def fit():
        est = _port_estimator()
        ds = est.prepare(data)
        res = est.fit(data, [tg.GameOptimizationConfiguration(LAMS)],
                      validation=(valid, parse_evaluators(["AUC"])),
                      datasets=ds)[0]
        return ds, res

    resident_ds, resident = fit()
    for cid in ("perUser", "perSong"):
        ds = resident_ds[cid]
        assert ds.config.cache_device_buckets
        assert not any(b.materialized for b in ds.buckets)
        assert any(k[0] == "compact" for k in ds._device_cache)
    monkeypatch.setattr(td, "RE_FAT_CACHE_MAX_BYTES", 1024)
    data.clear_device_cache()
    flipped_ds, flipped = fit()
    for cid in ("perUser", "perSong"):
        assert not flipped_ds[cid].config.cache_device_buckets
        assert flipped_ds[cid]._device_cache == {}
    for cid, ma in resident.model.coordinates.items():
        mb = flipped.model.coordinates[cid]
        if isinstance(ma, tg.FixedEffectModel):
            assert torch.equal(ma.model.coefficients.means,
                               mb.model.coefficients.means)
        else:
            np.testing.assert_array_equal(ma.keys, mb.keys)
            np.testing.assert_array_equal(ma.coeffs, mb.coeffs)
    assert resident.evaluation.primary == flipped.evaluation.primary
    np.testing.assert_array_equal(resident.model.score(valid),
                                  flipped.model.score(valid))


def test_masked_refresh_build_gives_the_numpy_packers_buckets():
    """The refresh's view reads untouched entities as id -1."""
    from photon_ml_tpu_torch.continuous.refresh import _masked_view

    data = _game_data(td, 1500, 0)
    touched = np.unique(data.id_columns["userId"])[::3]
    view, keep = _masked_view(data, "userId", touched)
    cfg = td.RandomEffectDatasetConfig("userId", "item")
    fast = td.RandomEffectDataset.build("perUser", view, cfg)
    slow = td.RandomEffectDataset.build("perUser", view, cfg, use_native=False)
    _assert_same_buckets(fast, slow)
    got = set(np.concatenate([b.entity_ids for b in fast.buckets]).tolist())
    assert got == set(touched.tolist())
