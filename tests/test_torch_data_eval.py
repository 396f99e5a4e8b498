"""The port's GAME data layer and evaluation metrics against the JAX
package's: random-effect bucketing (the numpy packing path) gives identical
buckets, the fixed-effect design densifies to the same matrix, and AUC
(ties count half), RMSE and the loss evaluators agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.game.data as jd
import photon_ml_tpu_torch.game.data as td
from photon_ml_tpu.evaluation import metrics as jm
from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu_torch.evaluation import metrics as tm
from photon_ml_tpu_torch.evaluation import parse_evaluator
from photon_ml_tpu_torch.ops import losses as tl


def _raw(n=700, dim=9, n_ent=30, seed=0):
    rng = np.random.default_rng(seed)
    nnz_per_row = rng.integers(1, 5, size=n)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = np.concatenate([rng.choice(dim, size=k, replace=False)
                           for k in nnz_per_row])
    vals = rng.normal(size=len(rows)).astype(np.float32)
    p = 1.0 / np.arange(1, n_ent + 1)
    ents = rng.choice(n_ent, size=n, p=p / p.sum())
    ents[::17] = -1  # rows without an entity
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return rows, cols, vals, n, dim, ents, y, wt


def _data(pkg, raw):
    rows, cols, vals, n, dim, ents, y, wt = raw
    shard = pkg.FeatureShard.from_coo(rows, cols, vals, n, dim)
    return pkg.GameData.build(labels=y, weights=wt, shards={"s": shard},
                              id_columns={"e": ents})


@pytest.mark.parametrize("kw", [
    {},
    {"bucket_strategy": "histogram", "max_sample_buckets": 3},
    {"active_data_upper_bound": 20, "active_data_lower_bound": 3},
    {"max_active_features": 3, "bucket_strategy": "histogram"},
], ids=["geometric", "histogram", "bounds", "max-features"])
def test_random_effect_buckets_match_jax(kw):
    raw = _raw()
    jds = jd.RandomEffectDataset.build(
        "c", _data(jd, raw), jd.RandomEffectDatasetConfig("e", "s", **kw),
        use_native=False)
    tds = td.RandomEffectDataset.build(
        "c", _data(td, raw), td.RandomEffectDatasetConfig("e", "s", **kw))
    assert len(tds.buckets) == len(jds.buckets) > 1
    for tb, jb in zip(tds.buckets, jds.buckets):
        for field in ("entity_ids", "x", "labels", "weights", "sample_idx",
                      "feature_index"):
            np.testing.assert_array_equal(getattr(tb, field),
                                          np.asarray(getattr(jb, field)),
                                          err_msg=field)
    np.testing.assert_array_equal(tds.passive_sample_idx,
                                  jds.passive_sample_idx)
    assert tds.n_entities_total == jds.n_entities_total


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fixed_effect_design_densifies_like_jax(dtype):
    raw = _raw(seed=3)
    ds = td.FixedEffectDataset.build("g", _data(td, raw), "s", dtype=dtype,
                                 device="cpu")
    want = np.asarray(jd.FixedEffectDataset.build(
        "g", _data(jd, raw), "s",
        dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ).design.x.astype(jnp.float32))
    np.testing.assert_array_equal(ds.design.x.float().numpy(), want)


def test_auc_with_ties_and_weights_matches_jax():
    rng = np.random.default_rng(5)
    scores = np.round(rng.normal(size=400), 1)  # many ties
    labels = (rng.uniform(size=400) < 0.4).astype(np.float64)
    weights = rng.uniform(0.0, 2.0, size=400)
    for w in (None, weights):
        want = float(jm.area_under_roc_curve(
            jnp.asarray(scores), jnp.asarray(labels),
            None if w is None else jnp.asarray(w)))
        got = tm.area_under_roc_curve(scores, labels, w)
        assert abs(got - want) < 1e-12


@pytest.mark.parametrize("name", ["LOGISTIC_LOSS", "SQUARED_LOSS",
                                  "POISSON_LOSS", "SMOOTHED_HINGE_LOSS",
                                  "RMSE"])
def test_loss_evaluators_match_jax(name):
    rng = np.random.default_rng(6)
    scores, weights = rng.normal(size=300), rng.uniform(0.5, 2, size=300)
    labels = (rng.uniform(size=300) < 0.5).astype(np.float64)
    if name == "RMSE":
        want = jm.root_mean_squared_error(jnp.asarray(scores),
                                          jnp.asarray(labels),
                                          jnp.asarray(weights))
    else:
        loss = {"LOGISTIC_LOSS": jl.LogisticLoss,
                "SQUARED_LOSS": jl.SquaredLoss,
                "POISSON_LOSS": jl.PoissonLoss,
                "SMOOTHED_HINGE_LOSS": jl.SmoothedHingeLoss}[name]
        want = jm.mean_pointwise_loss(loss, jnp.asarray(scores),
                                      jnp.asarray(labels),
                                      jnp.asarray(weights))
    ev = parse_evaluator(name.lower())
    assert not ev.maximize
    got = ev.evaluate(scores, labels, weights)
    assert abs(got - float(want)) < 1e-12 * max(1.0, abs(float(want)))


def test_per_group_evaluators_are_not_ported():
    """Per-group evaluators are ported now: the specs that were refused
    parse to a grouped evaluator (tests/test_torch_scoring.py holds their
    values against the JAX package's)."""
    auc = parse_evaluator("AUC:userId")
    assert (auc.name, auc.id_tag, auc.k, auc.maximize) == \
        ("AUC:userId", "userId", None, True)
    prec = parse_evaluator("PRECISION@5:userId")
    assert (prec.name, prec.id_tag, prec.k, prec.maximize) == \
        ("PRECISION@5:userId", "userId", 5, True)
    assert tl.LogisticLoss.name == "logistic"
