"""Model directories across the two packages: a GAME model saved by the JAX
package loads in the port with equal keys, coefficients and scores, and the
other way round; the same model saved by both gives byte-identical
``model-metadata.json`` and record-identical part files on both of the
port's random-effect writers (native and pure Python); GLM files go both
ways too."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.game.model as jm
import photon_ml_tpu.io.model_io as jio
import photon_ml_tpu_torch.game.model as tm
import photon_ml_tpu_torch.io.model_io as tio
from photon_ml_tpu.io.avro import read_avro_file
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.data_reader import FeatureShardConfig as JShard
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.models.coefficients import Coefficients as JCoefficients
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import native as tnative
from photon_ml_tpu_torch.io.data_reader import AvroDataReader as TReader
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfig as TShard
from photon_ml_tpu_torch.models.coefficients import Coefficients as TCoefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel as TGLM
from photon_ml_tpu_torch.types import TaskType as TTask

SHARDS = (("global", ("g",), True), ("item", ("it",), False))
IDS = ("userId", "songId")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A small bench-shaped file read by both packages: (torch read, jax
    read), each (GameData, index maps, vocabularies)."""
    rng = np.random.default_rng(7)
    records = []
    for i in range(80):
        feats = [{"name": f"g.x{k}", "term": "", "value": float(rng.normal())}
                 for k in rng.choice(10, size=4, replace=False)]
        feats += [{"name": f"it.x{k}", "term": "t" if k == 1 else "",
                   "value": float(rng.normal())}
                  for k in rng.choice(4, size=2, replace=False)]
        records.append({"uid": str(i), "response": float(i % 2),
                        "offset": float(0.1 * rng.normal()), "weight": None,
                        "features": feats,
                        "metadataMap": {"userId": f"u{i % 7}",
                                        "songId": f"s{i % 5}"}})
    path = str(tmp_path_factory.mktemp("model_io") / "data.avro")
    write_training_examples(path, records)
    t = TReader(shard_configs=tuple(TShard(*s) for s in SHARDS)).read(
        path, id_columns=IDS)
    j = JReader(shard_configs=tuple(JShard(*s) for s in SHARDS)).read(
        path, id_columns=IDS)
    return t, j


def _arrays(maps):
    """Seeded coefficients of a GAME model over the data's index maps:
    fixed-effect means and two random-effect (keys, coeffs, variances)
    tables, some entities and features absent, some coefficients 0."""
    rng = np.random.default_rng(11)
    dg, di = len(maps["global"]), len(maps["item"])
    means = rng.normal(size=dg).astype(np.float32)
    tables = {}
    for cid, n_ent in (("perUser", 7), ("perSong", 5)):
        keys = np.sort(rng.choice(n_ent * di, size=n_ent * di - 4,
                                  replace=False)).astype(np.int64)
        coeffs = rng.normal(size=len(keys)).astype(np.float32)
        coeffs[::5] = 0.0
        var = rng.uniform(0.1, 1.0, size=len(keys)).astype(np.float32)
        tables[cid] = (keys, coeffs, var)
    return means, tables, di


RE_TYPES = {"perUser": "userId", "perSong": "songId"}


def _jax_model(maps, variances=False):
    means, tables, di = _arrays(maps)
    task = JTask.LOGISTIC_REGRESSION
    coords = {"global": jm.FixedEffectModel(
        JGLM(JCoefficients(jnp.asarray(means)), task), "global")}
    for cid, (keys, coeffs, var) in tables.items():
        coords[cid] = jm.RandomEffectModel(
            random_effect_type=RE_TYPES[cid], feature_shard_id="item",
            task=task, dim=di, keys=keys, coeffs=coeffs,
            variances=var if variances else None)
    return jm.GameModel(coordinates=coords, task=task)


def _torch_model(maps):
    means, tables, di = _arrays(maps)
    task = TTask.LOGISTIC_REGRESSION
    coords = {"global": tm.FixedEffectModel(
        TGLM(TCoefficients(torch.as_tensor(means)), task), "global")}
    for cid, (keys, coeffs, _) in tables.items():
        coords[cid] = tm.RandomEffectModel(
            random_effect_type=RE_TYPES[cid], feature_shard_id="item",
            task=task, dim=di, keys=keys, coeffs=coeffs)
    return tm.GameModel(coordinates=coords, task=task)


def _assert_models_equal(t_model, j_model):
    assert list(t_model.coordinates) == list(j_model.coordinates)
    for cid, a in t_model.coordinates.items():
        b = j_model.coordinates[cid]
        assert a.feature_shard_id == b.feature_shard_id
        if isinstance(a, tm.FixedEffectModel):
            np.testing.assert_array_equal(
                a.model.coefficients.means.numpy(),
                np.asarray(b.model.coefficients.means))
        else:
            assert a.random_effect_type == b.random_effect_type
            assert a.dim == b.dim
            np.testing.assert_array_equal(a.keys, np.asarray(b.keys))
            np.testing.assert_array_equal(a.coeffs, np.asarray(b.coeffs))


@pytest.mark.parametrize("variances", [False, True],
                         ids=["no-variances", "variances"])
def test_jax_saved_model_loads_in_the_port(tmp_path, dataset, variances):
    (tdata, tmaps, tvocabs), (jdata, jmaps, jvocabs) = dataset
    out = str(tmp_path / "model")
    jio.save_game_model(out, _jax_model(jmaps, variances), jmaps, jvocabs)
    got = tio.load_game_model(out, tmaps, tvocabs, device="cpu")
    want = jio.load_game_model(out, jmaps, jvocabs)
    _assert_models_equal(got, want)
    # random-effect variances load as the JAX package loads them
    for cid in ("perUser", "perSong"):
        a, b = got.coordinates[cid].variances, want.coordinates[cid].variances
        if variances:
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            assert a is None and b is None
    np.testing.assert_allclose(got.score(tdata), want.score(jdata),
                               rtol=1e-6, atol=1e-6)


def test_port_saved_model_loads_in_jax(tmp_path, dataset):
    (tdata, tmaps, tvocabs), (jdata, jmaps, jvocabs) = dataset
    out = str(tmp_path / "model")
    tio.save_game_model(out, _torch_model(tmaps), tmaps, tvocabs)
    want = jio.load_game_model(out, jmaps, jvocabs)
    got = tio.load_game_model(out, tmaps, tvocabs, device="cpu")
    _assert_models_equal(got, want)
    # the saved model drops the zero coefficients and scores as before
    np.testing.assert_allclose(got.score(tdata), want.score(jdata),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.score(tdata),
                                  _torch_model(tmaps).score(tdata))


def _part(root, kind, cid):
    return os.path.join(root, kind, cid, "coefficients", "part-00000.avro")


@pytest.mark.parametrize("threshold", [0.0, 0.5])
@pytest.mark.parametrize("writer", ["native", "python"])
def test_same_model_same_metadata_bytes_and_records(tmp_path, dataset,
                                                    monkeypatch, writer,
                                                    threshold):
    (_, tmaps, tvocabs), (_, jmaps, jvocabs) = dataset
    if writer == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert tnative.available()
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    tio.save_game_model(t_out, _torch_model(tmaps), tmaps, tvocabs,
                        sparsity_threshold=threshold)
    jio.save_game_model(j_out, _jax_model(jmaps), jmaps, jvocabs,
                        sparsity_threshold=threshold)
    meta = "model-metadata.json"
    with open(os.path.join(t_out, meta), "rb") as a, \
            open(os.path.join(j_out, meta), "rb") as b:
        assert a.read() == b.read()
    for kind, cid in (("fixed-effect", "global"),
                      ("random-effect", "perUser"),
                      ("random-effect", "perSong")):
        got = read_avro_file(_part(t_out, kind, cid))
        want = read_avro_file(_part(j_out, kind, cid))
        assert got == want and len(got) > 0


def test_re_writers_record_identical(tmp_path, dataset, monkeypatch):
    (_, tmaps, tvocabs), _ = dataset
    model = _torch_model(tmaps)
    native_dir, python_dir = str(tmp_path / "n"), str(tmp_path / "p")
    tio.save_game_model(native_dir, model, tmaps, tvocabs)
    monkeypatch.setattr(tnative, "available", lambda: False)
    tio.save_game_model(python_dir, model, tmaps, tvocabs)
    for cid in ("perUser", "perSong"):
        assert read_avro_file(_part(native_dir, "random-effect", cid)) == \
            read_avro_file(_part(python_dir, "random-effect", cid))


def test_lineage_fields(tmp_path, dataset):
    (_, tmaps, tvocabs), _ = dataset
    out = str(tmp_path / "m")
    lineage = {"parentModel": None, "trainedAt": "2026-01-01T00:00:00+00:00",
               "dataManifest": None}
    tio.save_game_model(out, _torch_model(tmaps), tmaps, tvocabs,
                        lineage=lineage)
    import json

    with open(os.path.join(out, "model-metadata.json")) as f:
        metadata = json.load(f)
    assert {k: metadata[k] for k in tio.LINEAGE_FIELDS} == lineage
    assert tio.LINEAGE_FIELDS == jio.LINEAGE_FIELDS


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_glm_files_both_ways(tmp_path, dataset, direction):
    (_, tmaps, _), (_, jmaps, _) = dataset
    rng = np.random.default_rng(3)
    d = len(tmaps["global"])
    means = rng.normal(size=d).astype(np.float32)
    var = rng.uniform(0.1, 1.0, size=d).astype(np.float32)
    path = str(tmp_path / "glm.avro")
    task = "POISSON_REGRESSION"
    if direction == "jax-to-port":
        jio.save_glm_model(path, JGLM(JCoefficients(
            jnp.asarray(means), jnp.asarray(var)), JTask(task)),
            jmaps["global"], sparsity_threshold=0.1)
        got = tio.load_glm_model(path, tmaps["global"], device="cpu")
        want = jio.load_glm_model(path, jmaps["global"])
        a = got.coefficients.means.numpy(), got.coefficients.variances.numpy()
        assert got.task.value == task
    else:
        tio.save_glm_model(path, TGLM(TCoefficients(
            torch.as_tensor(means), torch.as_tensor(var)), TTask(task)),
            tmaps["global"], sparsity_threshold=0.1)
        want = jio.load_glm_model(path, jmaps["global"])
        got = tio.load_glm_model(path, tmaps["global"], device="cpu")
        a = got.coefficients.means.numpy(), got.coefficients.variances.numpy()
        assert want.task.value == task
    np.testing.assert_array_equal(a[0], np.asarray(want.coefficients.means))
    np.testing.assert_array_equal(a[1],
                                  np.asarray(want.coefficients.variances))
    np.testing.assert_array_equal(a[0], np.where(np.abs(means) > 0.1,
                                                 means, 0))


def test_model_dir_lookups(tmp_path, dataset):
    (_, tmaps, tvocabs), _ = dataset
    run = tmp_path / "run"
    tio.save_game_model(str(run / "best"), _torch_model(tmaps), tmaps,
                        tvocabs)
    (run / "feature-indexes").mkdir()
    best = str(run / "best")
    assert tio.resolve_game_model_dir(str(run)) == \
        jio.resolve_game_model_dir(str(run)) == best
    assert tio.find_feature_index_dir(best) == \
        jio.find_feature_index_dir(best)
    with pytest.raises(FileNotFoundError):
        tio.resolve_game_model_dir(str(tmp_path))


def test_load_defaults_to_cuda(tmp_path, dataset, monkeypatch):
    (_, tmaps, tvocabs), _ = dataset
    out = str(tmp_path / "m")
    tio.save_game_model(out, _torch_model(tmaps), tmaps, tvocabs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.load_game_model(out, tmaps, tvocabs)
