"""Minimal Avro object-container-file codec (pure Python + zlib).

A copy of ``photon_ml_tpu/io/avro.py``: both packages write and read the
same bytes.

The environment has no ``fastavro``/``avro`` package, and Avro is the
reference's interchange format (``photon-avro-schemas/src/main/avro/*.avsc``;
read/written by ``photon-client/.../data/avro/AvroUtils.scala``), so this
module implements the subset of the Avro 1.x spec those schemas need:

- primitives: null, boolean, int, long, float, double, bytes, string;
- complex: record, array, map, union, enum, fixed;
- binary encoding: zigzag-varint longs, length-prefixed bytes, block-encoded
  arrays/maps, union = long index + value;
- container files: ``Obj\\x01`` magic, metadata map (schema JSON + codec),
  16-byte sync marker, data blocks with ``null``, ``deflate``, or ``snappy``
  codec (snappy implemented here from the format spec — no wheel needed).

Schemas are plain Python dicts in the ``.avsc`` JSON form. Unknown/unneeded
spec corners (recursive types, aliases, logical types) raise cleanly.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterable, Iterator, Union

MAGIC = b"Obj\x01"
SYNC_SIZE = 16

Schema = Union[str, list, dict]


# ---------------------------------------------------------------------------
# binary encoding
# ---------------------------------------------------------------------------


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(out: BinaryIO, n: int) -> None:
    n = _zigzag_encode(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def read_long(buf: BinaryIO) -> int:
    shift = 0
    acc = 0
    while True:
        byte = buf.read(1)
        if not byte:
            raise EOFError("truncated varint")
        b = byte[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(acc)
        shift += 7


def _schema_type(schema: Schema) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


def _resolve_named(schema: Schema, names: dict) -> Schema:
    """Register/lookup named types so a schema can reference them by name."""
    if isinstance(schema, str) and schema in names:
        return names[schema]
    if isinstance(schema, dict) and schema.get("type") in ("record", "enum", "fixed"):
        name = schema.get("name")
        if name:
            names[name] = schema
            ns = schema.get("namespace")
            if ns:
                names[f"{ns}.{name}"] = schema
    return schema


def write_datum(out: BinaryIO, datum: Any, schema: Schema, names: dict) -> None:
    schema = _resolve_named(schema, names)
    t = _schema_type(schema)
    if t == "null":
        return
    if t == "boolean":
        out.write(b"\x01" if datum else b"\x00")
    elif t in ("int", "long"):
        write_long(out, int(datum))
    elif t == "float":
        out.write(struct.pack("<f", float(datum)))
    elif t == "double":
        out.write(struct.pack("<d", float(datum)))
    elif t == "bytes":
        write_long(out, len(datum))
        out.write(datum)
    elif t == "string":
        raw = datum.encode("utf-8")
        write_long(out, len(raw))
        out.write(raw)
    elif t == "union":
        idx = _union_branch(datum, schema, names)
        write_long(out, idx)
        write_datum(out, datum, schema[idx], names)
    elif t == "record":
        for field in schema["fields"]:
            name = field["name"]
            if name in datum:
                value = datum[name]
            elif "default" in field:
                value = field["default"]
            else:
                raise ValueError(f"record field {name!r} missing and has no default")
            write_datum(out, value, field["type"], names)
    elif t == "array":
        if datum:
            write_long(out, len(datum))
            for item in datum:
                write_datum(out, item, schema["items"], names)
        write_long(out, 0)
    elif t == "map":
        if datum:
            write_long(out, len(datum))
            for k, v in datum.items():
                write_datum(out, k, "string", names)
                write_datum(out, v, schema["values"], names)
        write_long(out, 0)
    elif t == "enum":
        out_idx = schema["symbols"].index(datum)
        write_long(out, out_idx)
    elif t == "fixed":
        if len(datum) != schema["size"]:
            raise ValueError("fixed size mismatch")
        out.write(datum)
    else:
        raise NotImplementedError(f"avro type {t!r}")


def _union_branch(datum: Any, union: list, names: dict) -> int:
    for i, branch in enumerate(union):
        bt = _schema_type(_resolve_named(branch, names))
        if datum is None and bt == "null":
            return i
        if datum is not None and bt != "null":
            # first non-null branch wins (our schemas use [null, X] only)
            return i
    raise ValueError(f"no union branch for {type(datum)} in {union}")


def read_datum(buf: BinaryIO, schema: Schema, names: dict) -> Any:
    schema = _resolve_named(schema, names)
    t = _schema_type(schema)
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return buf.read(read_long(buf))
    if t == "string":
        return buf.read(read_long(buf)).decode("utf-8")
    if t == "union":
        return read_datum(buf, schema[read_long(buf)], names)
    if t == "record":
        return {f["name"]: read_datum(buf, f["type"], names)
                for f in schema["fields"]}
    if t == "array":
        out = []
        while True:
            count = read_long(buf)
            if count == 0:
                return out
            if count < 0:  # block with byte size
                count = -count
                read_long(buf)
            for _ in range(count):
                out.append(read_datum(buf, schema["items"], names))
    if t == "map":
        out = {}
        while True:
            count = read_long(buf)
            if count == 0:
                return out
            if count < 0:
                count = -count
                read_long(buf)
            for _ in range(count):
                k = read_datum(buf, "string", names)
                out[k] = read_datum(buf, schema["values"], names)
    if t == "enum":
        return schema["symbols"][read_long(buf)]
    if t == "fixed":
        return buf.read(schema["size"])
    raise NotImplementedError(f"avro type {t!r}")


# ---------------------------------------------------------------------------
# container files
# ---------------------------------------------------------------------------


def write_avro_file(path: str, records: Iterable[dict], schema: Schema,
                    *, codec: str = "deflate", block_records: int = 4096,
                    sync: "bytes | None" = None) -> int:
    """Write an Avro object-container file; returns the record count.
    ``sync`` pins the container's 16-byte sync marker — writers that
    promise byte-identical output for identical records (the feedback
    joiner) pass a deterministic one; the default stays random per spec
    recommendation."""
    if codec not in ("null", "deflate", "snappy"):
        raise ValueError(f"unsupported codec {codec!r}")
    if sync is None:
        sync = os.urandom(SYNC_SIZE)
    elif len(sync) != SYNC_SIZE:
        raise ValueError(f"sync marker must be {SYNC_SIZE} bytes, "
                         f"got {len(sync)}")
    names: dict = {}
    n_total = 0
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = {"avro.schema": json.dumps(schema).encode(),
                "avro.codec": codec.encode()}
        write_long(f, len(meta))
        for k, v in meta.items():
            write_datum(f, k, "string", names)
            write_long(f, len(v))
            f.write(v)
        write_long(f, 0)
        f.write(sync)

        block: list[dict] = []

        def flush():
            nonlocal n_total
            if not block:
                return
            buf = io.BytesIO()
            for rec in block:
                write_datum(buf, rec, schema, names)
            payload = buf.getvalue()
            if codec == "deflate":
                payload = zlib.compress(payload)[2:-4]  # raw deflate per spec
            elif codec == "snappy":
                crc = (zlib.crc32(payload) & 0xFFFFFFFF).to_bytes(4, "big")
                payload = snappy_compress(payload) + crc
            write_long(f, len(block))
            write_long(f, len(payload))
            f.write(payload)
            f.write(sync)
            n_total += len(block)
            block.clear()

        for rec in records:
            block.append(rec)
            if len(block) >= block_records:
                flush()
        flush()
    return n_total


def iter_avro_file(path: str) -> Iterator[dict]:
    """Stream records from an Avro object-container file."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not an Avro container file")
        names: dict = {}
        meta = {}
        while True:
            count = read_long(f)
            if count == 0:
                break
            if count < 0:
                count = -count
                read_long(f)
            for _ in range(count):
                k = read_datum(f, "string", names)
                size = read_long(f)
                meta[k] = f.read(size)
        schema = json.loads(meta["avro.schema"].decode())
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate", "snappy"):
            raise ValueError(f"unsupported codec {codec!r} "
                             f"(supported: null, deflate, snappy)")
        sync = f.read(SYNC_SIZE)
        while True:
            try:
                n_records = read_long(f)
            except EOFError:
                return
            size = read_long(f)
            payload = f.read(size)
            if codec == "deflate":
                payload = zlib.decompress(payload, -15)
            elif codec == "snappy":
                payload = snappy_decode_block(payload, context=path)
            if f.read(SYNC_SIZE) != sync:
                raise ValueError(f"{path}: sync marker mismatch (corrupt block)")
            buf = io.BytesIO(payload)
            for _ in range(n_records):
                yield read_datum(buf, schema, names)


def read_avro_file(path: str) -> list[dict]:
    return list(iter_avro_file(path))


# ---------------------------------------------------------------------------
# Snappy block codec (pure Python)
# ---------------------------------------------------------------------------
# Hadoop-written Avro is very commonly snappy-compressed; there is no snappy
# wheel in this environment, so decompression is implemented directly from
# the format spec (https://github.com/google/snappy/blob/main/format_description.txt).
# Avro's snappy codec frames each block as snappy(payload) + 4-byte big-endian
# CRC32 of the UNCOMPRESSED payload.


def snappy_decode_block(payload: bytes, context: str = "") -> bytes:
    """Decode one Avro snappy block payload: decompress + verify the CRC.

    The single home of the Avro-snappy frame contract — both the pure-Python
    reader above and the native fast path (:mod:`photon_ml_tpu_torch.native`)
    call this."""
    if len(payload) < 4:
        raise ValueError(f"{context}: snappy block too short for CRC")
    body, crc = payload[:-4], payload[-4:]
    data = snappy_decompress(body)
    if zlib.crc32(data) & 0xFFFFFFFF != int.from_bytes(crc, "big"):
        raise ValueError(f"{context}: snappy block CRC mismatch")
    return data


def snappy_decompress(data: bytes) -> bytes:
    """Decompress one raw snappy block."""
    pos = 0
    # varint32 uncompressed length
    length = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("snappy: truncated preamble")
        b = data[pos]
        pos += 1
        length |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            elem = tag >> 2
            if elem < 60:
                lit_len = elem + 1
            else:
                n_bytes = elem - 59
                if pos + n_bytes > n:
                    raise ValueError("snappy: truncated literal length")
                lit_len = int.from_bytes(data[pos:pos + n_bytes], "little") + 1
                pos += n_bytes
            if pos + lit_len > n:
                raise ValueError("snappy: truncated literal")
            out += data[pos:pos + lit_len]
            pos += lit_len
            continue
        if kind == 1:  # copy, 1-byte offset
            if pos + 1 > n:
                raise ValueError("snappy: truncated copy")
            cp_len = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            if pos + 2 > n:
                raise ValueError("snappy: truncated copy")
            cp_len = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            if pos + 4 > n:
                raise ValueError("snappy: truncated copy")
            cp_len = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: invalid copy offset")
        start = len(out) - offset
        if offset >= cp_len:  # non-overlapping (the common case): one slice
            out += out[start:start + cp_len]
        else:  # overlapping copy: byte-at-a-time semantics
            for i in range(cp_len):
                out.append(out[start + i])
    if len(out) != length:
        raise ValueError(
            f"snappy: decompressed {len(out)} bytes, expected {length}")
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """Literal-only snappy encoding (valid, not size-optimal) — enough to
    WRITE snappy files other readers accept; real compression only matters
    for data we produce, which defaults to deflate."""
    out = bytearray()
    # varint32 length
    length = len(data)
    while True:
        b = length & 0x7F
        length >>= 7
        if length:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + 65536]
        lit_len = len(chunk) - 1
        if lit_len < 60:
            out.append(lit_len << 2)
        else:
            n_bytes = (lit_len.bit_length() + 7) // 8
            out.append((59 + n_bytes) << 2)
            out += lit_len.to_bytes(n_bytes, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)
