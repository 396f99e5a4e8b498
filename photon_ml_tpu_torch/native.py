"""Build/load the native Avro library: decode training files, write
random-effect models and scoring results.

Counterpart of ``photon_ml_tpu/native.py``. It compiles the same unchanged
sources, ``native/avro_reader.cc``, ``avro_writer.cc`` and
``bucket_pack.cc``, with the same ``g++`` flags into a library of the
port's own, ``build/torch_native/libphoton_native.so`` at the root of the
checkout, on first use. The build writes a temporary file and renames it
into place, so processes building at once never load a half-written
library. Callers treat this as an optional fast path: :func:`available` is
False when no compiler or library is usable, ``AvroDataReader`` and the
model writer fall back to the pure-Python codec
(:mod:`photon_ml_tpu_torch.io.avro`), and the random-effect dataset build
to its numpy bucket packer.
"""

from __future__ import annotations

import ctypes
import dataclasses
import io
import json
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.io import avro as avro_mod

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = tuple(os.path.join(_REPO_ROOT, "native", name)
                 for name in ("avro_reader.cc", "avro_writer.cc",
                              "bucket_pack.cc"))
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
_LIB = os.path.join(_BUILD_DIR, "libphoton_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

#: canonical field order we emit; the file's order is matched against names
_FIELDS = ("uid", "response", "offset", "weight", "features", "metadataMap")


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"  # _lock serializes this process
    # -march=native first (the library is always compiled on the machine
    # that runs it), plain -O2 for toolchains that reject it
    for extra in (["-O3", "-march=native"], ["-O2"]):
        cmd = (["g++", "-std=c++17"] + extra
               + ["-shared", "-fPIC", "-o", tmp, *_SOURCES, "-lz"])
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if proc.returncode == 0 and os.path.exists(tmp):
            os.replace(tmp, _LIB)
            return True
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def _declare(lib: ctypes.CDLL) -> None:
    """Argument and result types of the entry points this module calls."""
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.photon_decode_blocks.restype = ctypes.c_void_p
    lib.photon_decode_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_char_p]
    lib.photon_result_error.restype = ctypes.c_char_p
    lib.photon_result_error.argtypes = [ctypes.c_void_p]
    for name, res in (("n_records", ctypes.c_int64),
                      ("nnz", ctypes.c_int64),
                      ("n_feature_keys", ctypes.c_int32),
                      ("feature_bytes_len", ctypes.c_int64)):
        fn = getattr(lib, f"photon_result_{name}")
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p]
    lib.photon_result_copy_core.argtypes = [
        ctypes.c_void_p, f64p, f64p, f64p, i64p, i32p, f64p]
    lib.photon_result_copy_feature_keys.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64p]
    lib.photon_result_id_vocab_size.restype = ctypes.c_int32
    lib.photon_result_id_vocab_size.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int32]
    lib.photon_result_id_vocab_bytes_len.restype = ctypes.c_int64
    lib.photon_result_id_vocab_bytes_len.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_int32]
    lib.photon_result_copy_id_col.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i32p, ctypes.c_char_p, i64p]
    lib.photon_result_free.argtypes = [ctypes.c_void_p]
    lib.photon_shard_split_count.restype = None
    lib.photon_shard_split_count.argtypes = [
        i64p, i32p, ctypes.c_int64, i32p, ctypes.c_int32, i64p]
    lib.photon_shard_split_fill.restype = None
    lib.photon_shard_split_fill.argtypes = [
        i64p, i32p, f64p, ctypes.c_int64, i32p, ctypes.c_int32, i64p, i32p,
        f32p]
    lib.photon_counting_sort.restype = None
    lib.photon_counting_sort.argtypes = [i64p, ctypes.c_int64, i64p, i64p]
    lib.photon_re_feature_counts.restype = None
    lib.photon_re_feature_counts.argtypes = [
        i64p, i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i64p, i64p, i64p]
    lib.photon_re_bucket_fill.restype = None
    lib.photon_re_bucket_fill.argtypes = [
        i64p, i32p, f32p, i64p, i64p, f32p, f32p, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i64p, i64p, i64p, i64p,
        f32p, f32p, f32p, i64p, i64p]
    lib.photon_re_bucket_indices.restype = None
    lib.photon_re_bucket_indices.argtypes = [
        i64p, i32p, i64p, i64p, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, i64p]
    lib.photon_write_re_models.restype = ctypes.c_int64
    lib.photon_write_re_models.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p, i64p,
        ctypes.c_char_p, ctypes.c_int64,
        i64p, i32p, f64p,
        ctypes.c_void_p,  # variances (f64*) or NULL
        ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
        ctypes.c_int64]
    lib.photon_write_scoring_results.restype = ctypes.c_int64
    lib.photon_write_scoring_results.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, f64p,
        ctypes.c_void_p,  # labels (f64*) or NULL
        ctypes.c_char_p,  # uid bytes or NULL
        ctypes.c_void_p,  # uid offsets (i64*) or NULL
        ctypes.c_int64, ctypes.c_int64]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            src_mtime = max(os.path.getmtime(s) for s in _SOURCES)
        except OSError:
            # sources absent (an installed wheel without the native tree):
            # unbuildable, so the Python fallback, never an error
            src_mtime = None
        if src_mtime is None and not os.path.exists(_LIB):
            _load_failed = True
            return None
        if not os.path.exists(_LIB) or (
                src_mtime is not None
                and os.path.getmtime(_LIB) < src_mtime):
            if not _build():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            _declare(lib)
        except (OSError, AttributeError):
            # unloadable, or a stale prebuilt library missing a symbol
            _load_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


@dataclasses.dataclass
class DecodedFile:
    """Columnar decode of one TrainingExampleAvro container file."""

    response: np.ndarray  # (n,) f64
    offset: np.ndarray  # (n,) f64, NaN = null
    weight: np.ndarray  # (n,) f64, NaN = null
    feat_indptr: np.ndarray  # (n+1,) i64
    feat_key_id: np.ndarray  # (nnz,) i32 -> feature_keys
    feat_val: np.ndarray  # (nnz,) f64
    feature_keys: list[str]  # interned "name\x01term" strings
    id_cols: dict[str, np.ndarray]  # (n,) i32, -1 missing
    id_vocabs: dict[str, list[str]]

    @property
    def n_records(self) -> int:
        return int(self.response.shape[0])


def _schema_layout(schema) -> Optional[tuple[list[int], bytes]]:
    """Match the file schema against TrainingExampleAvro; return
    (field_order, null_first) or None if incompatible."""
    if not isinstance(schema, dict) or schema.get("type") != "record":
        return None
    fields = schema.get("fields", [])
    if len(fields) != len(_FIELDS):
        return None
    order: list[int] = []
    null_first = bytearray(len(_FIELDS))
    for f in fields:
        name = f.get("name")
        if name not in _FIELDS:
            return None
        idx = _FIELDS.index(name)
        order.append(idx)
        t = f.get("type")
        if name in ("uid", "offset", "weight", "metadataMap"):
            if not (isinstance(t, list) and len(t) == 2 and "null" in t):
                return None
            null_first[idx] = 1 if t[0] == "null" else 0
            other = t[1] if t[0] == "null" else t[0]
            if name == "uid" and other != "string":
                return None
            if name in ("offset", "weight") and other != "double":
                return None
            if name == "metadataMap" and not (
                    isinstance(other, dict) and other.get("type") == "map"
                    and other.get("values") == "string"):
                return None
        elif name == "response":
            if t != "double":
                return None
        else:  # features
            if not (isinstance(t, dict) and t.get("type") == "array"):
                return None
            items = t.get("items")
            if not (isinstance(items, dict) and items.get("type") == "record"):
                return None
            fnames = [x.get("name") for x in items.get("fields", [])]
            ftypes = [x.get("type") for x in items.get("fields", [])]
            if fnames != ["name", "term", "value"] or \
                    ftypes != ["string", "string", "double"]:
                return None
    return order, bytes(null_first)


def _snappy_blocks_to_null(blocks: bytes, sync: bytes, path: str) -> bytes:
    """Rewrite a snappy-codec block stream as a null-codec stream (the
    native decoder reads null and deflate blocks). A CRC mismatch raises,
    as the pure-Python reader does: the file is corrupt."""
    src = io.BytesIO(blocks)
    out = io.BytesIO()
    total = len(blocks)
    while src.tell() < total:
        count = avro_mod.read_long(src)
        size = avro_mod.read_long(src)
        data = avro_mod.snappy_decode_block(src.read(size), context=path)
        block_sync = src.read(avro_mod.SYNC_SIZE)
        if block_sync != sync:
            raise ValueError(f"sync marker mismatch in {path!r}")
        avro_mod.write_long(out, count)
        avro_mod.write_long(out, len(data))
        out.write(data)
        out.write(sync)
    return out.getvalue()


def decode_training_file(path: str, id_keys: Sequence[str] = ()
                         ) -> Optional[DecodedFile]:
    """Decode via the native library; None if unavailable or the schema is
    not TrainingExampleAvro's (the caller falls back to the Python codec)."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        blob = f.read()
    buf = io.BytesIO(blob)
    if buf.read(4) != avro_mod.MAGIC:
        return None
    names: dict = {}
    meta = {}
    while True:
        count = avro_mod.read_long(buf)
        if count == 0:
            break
        if count < 0:
            count = -count
            avro_mod.read_long(buf)
        for _ in range(count):
            k = avro_mod.read_datum(buf, "string", names)
            size = avro_mod.read_long(buf)
            meta[k] = buf.read(size)
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate", "snappy"):
        return None
    layout = _schema_layout(json.loads(meta["avro.schema"].decode()))
    if layout is None:
        return None
    field_order, null_first = layout
    sync = buf.read(avro_mod.SYNC_SIZE)
    blocks = blob[buf.tell():]
    if codec == "snappy":
        blocks = _snappy_blocks_to_null(blocks, sync, path)
        codec = "null"
        del blob, buf  # free the compressed copy before the decode

    order_arr = (ctypes.c_int * len(field_order))(*field_order)
    rp = lib.photon_decode_blocks(
        blocks, len(blocks), sync, int(codec == "deflate"), order_arr,
        null_first, "\n".join(id_keys).encode())
    if not rp:
        return None
    try:
        err = lib.photon_result_error(rp)
        if err:
            raise ValueError(f"native avro decode failed for {path!r}: "
                             f"{err.decode()}")
        n = lib.photon_result_n_records(rp)
        nnz = lib.photon_result_nnz(rp)
        n_keys = lib.photon_result_n_feature_keys(rp)
        key_bytes_len = lib.photon_result_feature_bytes_len(rp)

        response = np.empty(n, np.float64)
        offset = np.empty(n, np.float64)
        weight = np.empty(n, np.float64)
        indptr = np.empty(n + 1, np.int64)
        key_id = np.empty(nnz, np.int32)
        val = np.empty(nnz, np.float64)
        lib.photon_result_copy_core(rp, response, offset, weight, indptr,
                                    key_id, val)

        kb = ctypes.create_string_buffer(max(int(key_bytes_len), 1))
        koff = np.empty(n_keys + 1, np.int64)
        lib.photon_result_copy_feature_keys(rp, kb, koff)
        kraw = kb.raw[:key_bytes_len]
        feature_keys = [kraw[koff[i]:koff[i + 1]].decode()
                        for i in range(n_keys)]

        id_cols = {}
        id_vocabs = {}
        for c, key in enumerate(id_keys):
            vsize = lib.photon_result_id_vocab_size(rp, c)
            vbytes = lib.photon_result_id_vocab_bytes_len(rp, c)
            ids = np.empty(n, np.int32)
            vb = ctypes.create_string_buffer(max(int(vbytes), 1))
            voff = np.empty(vsize + 1, np.int64)
            lib.photon_result_copy_id_col(rp, c, ids, vb, voff)
            vraw = vb.raw[:vbytes]
            id_cols[key] = ids
            id_vocabs[key] = [vraw[voff[i]:voff[i + 1]].decode()
                              for i in range(vsize)]
        return DecodedFile(
            response=response, offset=offset, weight=weight,
            feat_indptr=indptr, feat_key_id=key_id, feat_val=val,
            feature_keys=feature_keys, id_cols=id_cols, id_vocabs=id_vocabs)
    finally:
        lib.photon_result_free(rp)


class BucketPackScratch:
    """Dim-sized scratch shared by one dataset build's packer calls.

    ``native/bucket_pack.cc`` marks a feature as seen for an entity by
    writing the entity's dense id into a stamp array, so a stamp array is
    set to -1 once and then shared by every call of one pass of one build
    (dense ids never repeat across its calls). Pass A and pass B need
    distinct stamp arrays: pass A has stamped every entity, so pass B on
    pass A's array would see every feature as already seen. A deferred
    fill runs after the build's pass B and takes a scratch of its own."""

    def __init__(self, dim: int):
        self.stamp_a = np.full(dim, -1, np.int64)
        self.stamp_b = np.full(dim, -1, np.int64)
        self.kept_stamp = np.full(dim, -1, np.int64)
        self.support = np.empty(dim, np.int64)
        self.local = np.empty(dim, np.int64)


def _max_features(max_active_features: Optional[int]) -> int:
    return -1 if max_active_features is None else int(max_active_features)


def re_feature_counts(indptr: np.ndarray, cols: np.ndarray,
                      all_active: np.ndarray, ent_starts: np.ndarray,
                      dim: int, max_active_features: Optional[int],
                      scratch: BucketPackScratch) -> Optional[np.ndarray]:
    """Each active entity's count of kept features, after pruning to
    ``max_active_features`` by support (pass A of
    ``bucket_pack.cc::photon_re_feature_counts``), over the entity-grouped
    active rows ``all_active`` (entity ``e``'s rows are
    ``all_active[ent_starts[e]:ent_starts[e + 1]]``). None when the
    library is unavailable. The arrays' dtypes are the ndpointer
    argtypes'."""
    lib = _load()
    if lib is None:
        return None
    n_entities = len(ent_starts) - 1
    out = np.empty(n_entities, np.int64)
    lib.photon_re_feature_counts(
        indptr, cols, all_active, ent_starts, n_entities, int(dim),
        _max_features(max_active_features), scratch.stamp_a,
        scratch.support, out)
    return out


def re_bucket_fill(indptr, cols, vals, all_active, ent_starts, labels_all,
                   weights_all, sel, S: int, D: int, dim: int,
                   max_active_features: Optional[int],
                   scratch: BucketPackScratch):
    """One bucket's ``(E, S, D)`` tensors for the dense entity ids ``sel``
    (pass B, ``photon_re_bucket_fill``): ``(x, labels, weights,
    sample_idx, feature_index)``, equal to the numpy packer's, or None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    sel = np.ascontiguousarray(sel, np.int64)
    e = len(sel)
    x = np.zeros((e, S, D), np.float32)
    labels = np.zeros((e, S), np.float32)
    weights = np.zeros((e, S), np.float32)
    sample_idx = np.full((e, S), -1, np.int64)
    feature_index = np.full((e, D), -1, np.int64)
    lib.photon_re_bucket_fill(
        indptr, cols, vals, all_active, ent_starts, labels_all, weights_all,
        sel, e, int(S), int(D), int(dim), _max_features(max_active_features),
        scratch.stamp_b, scratch.support, scratch.kept_stamp, scratch.local,
        x, labels, weights, sample_idx, feature_index)
    return x, labels, weights, sample_idx, feature_index


def re_bucket_indices(indptr, cols, all_active, ent_starts, sel, S: int,
                      D: int, max_active_features: Optional[int],
                      scratch: BucketPackScratch):
    """One bucket's index maps only (``photon_re_bucket_indices``):
    ``(sample_idx, feature_index)``, equal to :func:`re_bucket_fill`'s,
    without the ``(E, S, D)`` fill, or None when the library is
    unavailable. The solver rebuilds the tensors on the device from
    them."""
    lib = _load()
    if lib is None:
        return None
    sel = np.ascontiguousarray(sel, np.int64)
    e = len(sel)
    sample_idx = np.full((e, S), -1, np.int64)
    feature_index = np.full((e, D), -1, np.int64)
    lib.photon_re_bucket_indices(
        indptr, cols, all_active, ent_starts, sel, e, int(S), int(D),
        _max_features(max_active_features), scratch.stamp_b,
        scratch.support, sample_idx, feature_index)
    return sample_idx, feature_index


def counting_sort(ids: np.ndarray) -> Optional[np.ndarray]:
    """The stable order of dense non-negative ids
    (``photon_counting_sort``, O(n)): the permutation of
    ``np.argsort(ids, kind="stable")``, or None when the library is
    unavailable. Its counters take O(max(ids)) memory, so sparse ids (a
    maximum above 4 x their count) take the comparison sort instead."""
    ids = np.ascontiguousarray(ids, np.int64)
    if ids.size == 0:
        return np.zeros(0, np.int64)
    if int(ids.max()) > 4 * ids.size:
        return np.argsort(ids, kind="stable")
    lib = _load()
    if lib is None:
        return None
    cnt = np.bincount(ids)
    cursors = np.zeros(len(cnt), np.int64)
    np.cumsum(cnt[:-1], out=cursors[1:])
    order = np.empty(ids.size, np.int64)
    lib.photon_counting_sort(ids, ids.size, cursors, order)
    return order


def _concat_strings(strings) -> tuple[bytes, np.ndarray]:
    """Concatenated utf-8 bytes + (n+1,) offsets for a string sequence."""
    encoded = [s.encode() for s in strings]
    offs = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(b) for b in encoded], out=offs[1:])
    return b"".join(encoded), offs


def write_re_models(path: str, model_ids, model_class: str,
                    rec_indptr: np.ndarray, name_ids: np.ndarray,
                    values: np.ndarray, variances: Optional[np.ndarray],
                    names, terms, block_records: int = 4096) -> bool:
    """Write per-entity ``BayesianLinearModelAvro`` records with the native
    writer (``native/avro_writer.cc::photon_write_re_models``).

    ``rec_indptr`` gives each record's [lo, hi) span in the flat
    ``name_ids``/``values``/``variances`` columns; ``name_ids`` index the
    ``names``/``terms`` tables. ``model_class`` is written as both
    modelClass and lossFunction. Returns False when the native library is
    unavailable; the caller falls back to
    :func:`photon_ml_tpu_torch.io.avro.write_avro_file`."""
    lib = _load()
    if lib is None:
        return False
    from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_AVRO

    schema = json.dumps(BAYESIAN_LINEAR_MODEL_AVRO).encode()
    id_bytes, id_offs = _concat_strings(model_ids)
    name_bytes, name_offs = _concat_strings(names)
    term_bytes, term_offs = _concat_strings(terms)
    rec_indptr = np.ascontiguousarray(rec_indptr, np.int64)
    name_ids = np.ascontiguousarray(name_ids, np.int32)
    values = np.ascontiguousarray(values, np.float64)
    n_models = len(rec_indptr) - 1
    var_ptr = None
    var_arr = None
    if variances is not None:
        var_arr = np.ascontiguousarray(variances, np.float64)
        var_ptr = var_arr.ctypes.data_as(ctypes.c_void_p)
    mc = model_class.encode()
    wrote = lib.photon_write_re_models(
        path.encode(), schema, len(schema), n_models, id_bytes, id_offs,
        mc, len(mc), rec_indptr, name_ids, values, var_ptr,
        name_bytes, name_offs, term_bytes, term_offs, block_records)
    return wrote == n_models


def write_scoring_results(path: str, scores: np.ndarray,
                          labels: Optional[np.ndarray] = None,
                          uids: Optional[Sequence[str]] = None,
                          block_records: int = 65536) -> bool:
    """Write a ``ScoringResultAvro`` container with the native writer
    (``native/avro_writer.cc::photon_write_scoring_results``): columns in,
    container out, null codec. ``uids=None`` writes decimal record indices
    (what ``score_game`` emits). Returns False when the native library is
    unavailable; the caller falls back to
    :func:`photon_ml_tpu_torch.io.avro.write_avro_file`."""
    lib = _load()
    if lib is None:
        return False
    from photon_ml_tpu_torch.io.schemas import SCORING_RESULT_AVRO

    schema = json.dumps(SCORING_RESULT_AVRO).encode()
    scores = np.ascontiguousarray(scores, np.float64)
    if scores.ndim != 1:
        raise ValueError(f"scores must be 1-D, got shape {scores.shape}")
    n = scores.shape[0]
    labels_ptr = labels_arr = None
    if labels is not None:
        labels_arr = np.ascontiguousarray(labels, np.float64)
        if labels_arr.shape != (n,):
            raise ValueError(
                f"labels must be shape ({n},), got {labels_arr.shape}")
        labels_ptr = labels_arr.ctypes.data_as(ctypes.c_void_p)
    uid_bytes = uid_off_ptr = uid_off = None
    if uids is not None:
        if len(uids) != n:
            raise ValueError("uids length mismatch")
        uid_bytes, uid_off = _concat_strings(uids)
        uid_off_ptr = uid_off.ctypes.data_as(ctypes.c_void_p)
    wrote = lib.photon_write_scoring_results(
        path.encode(), schema, len(schema), scores, labels_ptr,
        uid_bytes, uid_off_ptr, n, block_records)
    return wrote == n


def shard_split(feat_indptr, feat_key_id, feat_val, key_to_col,
                intercept_col: int):
    """CSR split of one decoded file's flat feature stream into one shard
    (``avro_reader.cc::photon_shard_split_{count,fill}``): record order
    kept, values cast to f32 in the pass, an intercept entry appended to
    each record when ``intercept_col`` >= 0. Returns ``(indptr, cols,
    vals)`` or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(feat_indptr) - 1
    counts = np.empty(n, np.int64)
    lib.photon_shard_split_count(feat_indptr, feat_key_id, n, key_to_col,
                                 intercept_col, counts)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1]) if n else 0
    cols = np.empty(nnz, np.int32)
    vals = np.empty(nnz, np.float32)
    lib.photon_shard_split_fill(feat_indptr, feat_key_id, feat_val, n,
                                key_to_col, intercept_col, indptr, cols,
                                vals)
    return indptr, cols, vals
