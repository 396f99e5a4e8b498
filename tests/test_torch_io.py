"""The port's Avro codec, index maps and training-data reader against the
JAX package's: byte-identical container files under a pinned sync marker,
each package reading the other's files, and one training file read by both
packages on both decoder paths (the native C++ decoder and the pure-Python
codec) into equal arrays, index maps and vocabularies."""

import numpy as np
import pytest

import photon_ml_tpu.io.avro as javro
import photon_ml_tpu_torch.io.avro as tavro
from photon_ml_tpu import native as jnative
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.data_reader import FeatureShardConfig as JShard
from photon_ml_tpu.io.data_reader import write_training_examples as j_write
from photon_ml_tpu.io.index import IndexMap as JIndexMap
from photon_ml_tpu.io.index import build_index_map as j_build_index_map
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_AVRO as J_SCHEMA
from photon_ml_tpu_torch import native as tnative
from photon_ml_tpu_torch.io.data_reader import AvroDataReader as TReader
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfig as TShard
from photon_ml_tpu_torch.io.data_reader import parse_input_columns
from photon_ml_tpu_torch.io.data_reader import write_training_examples as t_write
from photon_ml_tpu_torch.io.index import IndexMap as TIndexMap
from photon_ml_tpu_torch.io.index import build_index_map as t_build_index_map
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO as T_SCHEMA
from photon_ml_tpu_torch.types import feature_key

SYNC = bytes(range(16))


def _records(n, seed=0):
    """TrainingExampleAvro records with offsets and weights present on some
    rows and null on others, a songId missing from every third record, and
    features of three bags (``fixed``, ``user`` and the bag-less ``bias``),
    some with terms."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feats = [{"name": f"fixed.x{j}", "term": "t" if j == 2 else "",
                  "value": float(rng.normal())}
                 for j in rng.choice(5, size=3, replace=False)]
        feats += [{"name": f"user.z{j}", "term": "",
                   "value": float(rng.normal())}
                  for j in rng.choice(3, size=2, replace=False)]
        if i % 4 == 0:
            feats.append({"name": "bias", "term": "", "value": 1.0})
        meta = {"userId": f"u{int(rng.integers(0, 6))}"}
        if i % 3:
            meta["songId"] = f"s{int(rng.integers(0, 4))}"
        out.append({
            "uid": str(i), "response": float(i % 2),
            "offset": None if i % 2 else float(rng.normal()),
            "weight": None if i % 5 == 0 else float(rng.uniform(0.5, 2.0)),
            "features": feats, "metadataMap": meta})
    return out


@pytest.mark.parametrize("codec", ["null", "deflate", "snappy"])
def test_container_bytes_identical_and_cross_read(tmp_path, codec):
    records = _records(40)
    assert T_SCHEMA == J_SCHEMA
    jp, tp = str(tmp_path / "j.avro"), str(tmp_path / "t.avro")
    kw = dict(codec=codec, block_records=16, sync=SYNC)
    assert javro.write_avro_file(jp, records, J_SCHEMA, **kw) == 40
    assert tavro.write_avro_file(tp, records, T_SCHEMA, **kw) == 40
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    assert tavro.read_avro_file(jp) == records
    assert javro.read_avro_file(tp) == records


def test_training_example_writers_identical(tmp_path):
    records = _records(10)
    jp, tp = str(tmp_path / "j.avro"), str(tmp_path / "t.avro")
    j_write(jp, records, sync=SYNC)
    t_write(tp, records, sync=SYNC)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()


def test_snappy_codec_functions_match():
    payload = b"photon " * 500 + bytes(range(256))
    assert tavro.snappy_compress(payload) == javro.snappy_compress(payload)
    assert tavro.snappy_decompress(javro.snappy_compress(payload)) == payload


def test_index_map_order_and_json_bytes(tmp_path):
    keys = [feature_key("b"), feature_key("a", "t"), feature_key("a"),
            feature_key("(INTERCEPT)")]
    for intercept in (True, False):
        t = t_build_index_map(keys, add_intercept=intercept)
        j = j_build_index_map(keys, add_intercept=intercept)
        assert dict(t.key_to_index) == dict(j.key_to_index)
        assert t.names() == j.names()
        t.save(str(tmp_path / "t.json"))
        j.save(str(tmp_path / "j.json"))
        assert (tmp_path / "t.json").read_bytes() == \
            (tmp_path / "j.json").read_bytes()
        assert TIndexMap.load(str(tmp_path / "j.json")).key_to_index == \
            dict(JIndexMap.load(str(tmp_path / "t.json")).key_to_index)
    with pytest.raises(ValueError):
        TIndexMap({"a": 0, "b": 2})


SHARDS = (("global", ("fixed", "bias"), True), ("user", ("user",), False),
          ("all", None, True))
IDS = ("userId", "songId")


def _read(pkg, path, native, index_maps=None, vocabs=None):
    shard, reader = (TShard, TReader) if pkg == "torch" else (JShard, JReader)
    r = reader(shard_configs=tuple(shard(s, b, i) for s, b, i in SHARDS),
               index_maps=index_maps, use_native=native)
    return r.read(path, id_columns=IDS, entity_vocabs=vocabs)


def _assert_reads_equal(a, b):
    (da, ma, va), (db, mb, vb) = a, b
    for name in ("labels", "offsets", "weights"):
        x, y = getattr(da, name), getattr(db, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert set(da.id_columns) == set(db.id_columns) == set(IDS)
    for c in IDS:
        np.testing.assert_array_equal(da.id_columns[c], db.id_columns[c])
        assert da.id_columns[c].dtype == db.id_columns[c].dtype
    assert set(da.shards) == set(db.shards)
    for s in da.shards:
        sa, sb = da.shards[s], db.shards[s]
        assert sa.dim == sb.dim
        for f in ("indptr", "cols", "vals"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
            assert getattr(sa, f).dtype == getattr(sb, f).dtype
        assert dict(ma[s].key_to_index) == dict(mb[s].key_to_index)
    assert {c: dict(v) for c, v in va.items()} == \
        {c: dict(v) for c, v in vb.items()}


@pytest.fixture(scope="module")
def train_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("reader")
    path = str(d / "train.avro")
    j_write(path, _records(60, seed=1))
    valid = str(d / "valid.avro")
    # validation: more users and songs than training has
    recs = _records(30, seed=2)
    for i, r in enumerate(recs):
        r["metadataMap"]["userId"] = f"u{i % 9}"
    j_write(valid, recs)
    return path, valid


def test_native_decoder_builds_in_both_packages():
    assert tnative.available() and jnative.available()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_training_read_matches_jax(train_file, native):
    path, _ = train_file
    _assert_reads_equal(_read("torch", path, native),
                        _read("jax", path, native))


def test_decoder_paths_agree(train_file):
    path, _ = train_file
    _assert_reads_equal(_read("torch", path, True), _read("torch", path, False))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_validation_read_reuses_vocabs_and_index_maps(train_file, native):
    path, valid = train_file
    _, tmaps, tvocabs = _read("torch", path, native)
    _, jmaps, jvocabs = _read("jax", path, native)
    got = _read("torch", valid, native, tmaps, tvocabs)
    want = _read("jax", valid, native, jmaps, jvocabs)
    _assert_reads_equal(got, want)
    # the training vocabularies and maps come back unchanged; users of the
    # validation file unseen in training get no id
    assert got[1] is tmaps and got[2] == tvocabs
    users = got[0].id_columns["userId"]
    assert (users == -1).any() and (users >= 0).any()


def test_multi_file_read_matches_jax(tmp_path):
    paths = []
    for k in range(3):
        p = str(tmp_path / f"part-{k}.avro")
        j_write(p, _records(15, seed=10 + k))
        paths.append(p)
    for native in (True, False):
        _assert_reads_equal(_read("torch", str(tmp_path), native),
                            _read("jax", str(tmp_path), native))


def test_remapped_input_columns_read_like_jax(tmp_path):
    from photon_ml_tpu.io.data_reader import (
        parse_input_columns as j_parse_input_columns,
    )

    schema = dict(J_SCHEMA)
    schema["fields"] = [dict(f, name="label") if f["name"] == "response"
                        else f for f in J_SCHEMA["fields"]]
    records = [dict(r) for r in _records(12, seed=3)]
    for r in records:
        r["label"] = r.pop("response")
    path = str(tmp_path / "remapped.avro")
    javro.write_avro_file(path, records, schema)
    shards = (TShard("global", ("fixed",)),)
    got = TReader(shard_configs=shards,
                  input_columns=parse_input_columns("response=label")).read(
        path, id_columns=("userId",))
    want = JReader(shard_configs=(JShard("global", ("fixed",)),),
                   input_columns=j_parse_input_columns(
                       "response=label")).read(path, id_columns=("userId",))
    np.testing.assert_array_equal(got[0].labels, want[0].labels)
    np.testing.assert_array_equal(got[0].shards["global"].vals,
                                  want[0].shards["global"].vals)
    with pytest.raises(SystemExit):
        parse_input_columns("bogus=x")


def test_reader_falls_back_without_the_native_library(train_file,
                                                      monkeypatch, tmp_path):
    """No sources and no library: ``available()`` is False, the decoder
    declines, and the reader takes the Python codec to the same result."""
    path, _ = train_file
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_failed", False)
    monkeypatch.setattr(tnative, "_SOURCES", (str(tmp_path / "none.cc"),))
    monkeypatch.setattr(tnative, "_LIB", str(tmp_path / "none.so"))
    assert not tnative.available()
    assert tnative.decode_training_file(path, IDS) is None
    _assert_reads_equal(_read("torch", path, True), _read("jax", path, False))
