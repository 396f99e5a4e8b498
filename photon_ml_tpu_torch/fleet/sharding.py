"""Deterministic entity-id sharding: the port's one crc32 bucketing home.

Counterpart of ``photon_ml_tpu/fleet/sharding.py`` (a copy: the port
imports nothing of the JAX package). A serving fleet splits every
random-effect coordinate's coefficient rows across N hosts by hashing each
raw entity id, and every participant (the serving store's packing, the
router, ``refresh_game --fleet-shards``'s patch partitioner, offline joins
against the request log) must compute the same shard for the same id:

- the hash is ``crc32`` of the UTF-8 id string: stable across processes,
  Python versions and machines (unlike ``hash()``), and the same hash the
  request log samples by;
- ids map to one of :data:`N_BUCKETS` fixed virtual buckets
  (``crc32(id) % 4096``), and a bucket → shard table (:class:`ShardMap`)
  names the owner. The default table is ``bucket % n_shards``, which
  reproduces ``crc32(id) % n_shards`` whenever ``n_shards`` divides 4096;
  a reshard moves only the reassigned buckets' ids. No seed and no salt,
  so components that never exchange configuration agree.

A second crc32 call site could disagree (another encoding, a signedness
slip), so the port's other crc32 users (request-log sampling, the
rank-probe sample, fault-plan seeding) route through here; Avro container
checksums (``io/avro.py``) are data integrity, not identity, and stay put.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterable, Mapping, Optional, Sequence

#: the fixed virtual-bucket count every id hashes into — a power of two
#: large enough that per-bucket movement is fine-grained (a reshard moves
#: whole buckets) and divisible by every practical small fleet size, so
#: the DEFAULT bucket→shard table reproduces the historical
#: ``crc32(id) % n_shards`` placement bit-for-bit
N_BUCKETS = 4096


def stable_hash_u32(key: str) -> int:
    """The one identity hash: unsigned crc32 of the UTF-8 key. Every
    bucketing decision in the system (shard placement, request-log
    sampling, probe selection, fault-plan seeding) derives from this
    value, so they all join on the same id universe."""
    return zlib.crc32(str(key).encode("utf-8")) & 0xFFFFFFFF


def crc_bucket(key: str, mod: int) -> int:
    """``stable_hash_u32(key) % mod`` — the generic bucketing primitive
    (request-log sampling uses ``mod = 1 << 16``; sharding uses
    ``mod = n_shards`` via :func:`shard_of_id`)."""
    return stable_hash_u32(key) % int(mod)


def bucket_of_id(raw_id: str) -> int:
    """The id's fixed virtual bucket (``crc32 % N_BUCKETS``) — stable
    forever; only the bucket→shard TABLE ever moves."""
    return crc_bucket(str(raw_id), N_BUCKETS)


def shard_of_id(raw_id: str, n_shards: int) -> int:
    """The DEFAULT-map fleet placement function: which of ``n_shards``
    hosts owns this raw entity id's coefficient row, routed through the
    virtual-bucket layer (``bucket_of_id(id) % n_shards`` — identical to
    the historical ``crc32(id) % n_shards`` whenever ``n_shards``
    divides :data:`N_BUCKETS`). Deterministic and configuration-free —
    the serving store, the router and the refresh partitioner all call
    this and therefore always agree. A fleet running a NON-default
    :class:`ShardMap` routes through ``ShardMap.shard_of`` instead."""
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return bucket_of_id(raw_id) % n


def retry_jitter_s(request_id: str, base_s: float = 1.0,
                   spread_s: float = 2.0) -> float:
    """Deterministic per-request-id ``Retry-After`` jitter: ``base_s``
    plus a hash-derived fraction of ``spread_s``. Seeded from
    :func:`stable_hash_u32` (no wall clock, no global RNG) so the same
    refused request always gets the same hint while DIFFERENT requests
    spread over the window — synchronized clients stop retrying in
    lockstep without the router growing any mutable state."""
    frac = (stable_hash_u32(f"retry:{request_id}") % 1024) / 1024.0
    return float(base_s) + float(spread_s) * frac


def check_shard(shard: "tuple[int, int] | None") -> "tuple[int, int] | None":
    """Validate an ``(index, count)`` shard assignment (None = unsharded,
    the single-host identity). The one place the invariant
    ``0 <= index < count`` is spelled out."""
    if shard is None:
        return None
    index, count = int(shard[0]), int(shard[1])
    if count < 1:
        raise ValueError(f"shard count must be >= 1, got {count}")
    if not 0 <= index < count:
        raise ValueError(
            f"shard index must be in [0, {count}), got {index}")
    return (index, count)


def owns_id(raw_id: str, shard: "tuple[int, int] | None") -> bool:
    """Does the host holding ``shard`` own this raw id? ``None`` (an
    unsharded store) owns everything — the single-host degenerate."""
    if shard is None:
        return True
    index, count = shard
    return shard_of_id(raw_id, count) == index


def partition_by_shard(raw_ids: Iterable[str],
                       n_shards: int) -> "dict[int, list[str]]":
    """Split raw ids into per-shard lists (every shard present, possibly
    empty) — the ``refresh_game --fleet-shards`` patch partitioner and
    the router's batch splitter share this shape."""
    out: dict[int, list[str]] = {i: [] for i in range(int(n_shards))}
    for raw in raw_ids:
        out[shard_of_id(raw, n_shards)].append(raw)
    return out


def shard_vocab(entity_vocab: Mapping[str, int],
                shard: "tuple[int, int] | None") -> "dict[str, int]":
    """Restrict a raw→dense entity vocabulary to one shard's slice,
    preserving iteration order (the store packs rows in vocab order, so
    a shard's item axis stays a subsequence of the global one)."""
    if shard is None:
        return dict(entity_vocab)
    return {raw: dense for raw, dense in entity_vocab.items()
            if owns_id(raw, shard)}


def shard_counts(raw_ids: Sequence[str], n_shards: int) -> "list[int]":
    """Per-shard id counts — the balance diagnostic ``serve_fleet`` logs
    at startup (crc32 is uniform enough that a heavy skew means
    duplicated or constant ids, not bad luck)."""
    counts = [0] * int(n_shards)
    for raw in raw_ids:
        counts[shard_of_id(raw, n_shards)] += 1
    return counts


# ---------------------------------------------------------------------------
# the versioned bucket→shard table (live resharding's unit of movement)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """A versioned bucket→shard table: ``buckets[b]`` names the shard
    owning virtual bucket ``b``. The map — not the hash — is what a
    reshard changes, so growing the fleet moves only the reassigned
    buckets' ids. ``map_hash`` is a content fingerprint (buckets +
    n_shards + version, crc32 over the packed table — this module IS the
    crc32 home) that rides every fleet response next to ``lineage``; a
    router and a host disagreeing on it is refused like a mixed-lineage
    response."""

    buckets: "tuple[int, ...]"
    n_shards: int
    version: int = 1

    def __post_init__(self):
        object.__setattr__(self, "buckets", tuple(int(b)
                                                  for b in self.buckets))
        object.__setattr__(self, "n_shards", int(self.n_shards))
        object.__setattr__(self, "version", int(self.version))
        if self.n_shards < 1:
            raise ValueError(
                f"shard map needs n_shards >= 1, got {self.n_shards}")
        if len(self.buckets) != N_BUCKETS:
            raise ValueError(f"shard map needs exactly {N_BUCKETS} "
                             f"buckets, got {len(self.buckets)}")
        bad = [b for b, s in enumerate(self.buckets)
               if not 0 <= s < self.n_shards]
        if bad:
            raise ValueError(
                f"shard map assigns buckets {bad[:5]} outside "
                f"[0, {self.n_shards})")
        packed = b"".join(s.to_bytes(2, "big") for s in self.buckets)
        digest = zlib.crc32(
            packed + f"|{self.n_shards}|{self.version}".encode("utf-8"))
        object.__setattr__(
            self, "map_hash",
            f"sm{self.version}-{digest & 0xFFFFFFFF:08x}")

    @classmethod
    def default(cls, n_shards: int, version: int = 1) -> "ShardMap":
        """The round-robin table ``bucket % n_shards`` — reproduces
        :func:`shard_of_id` (and, when ``n_shards`` divides
        :data:`N_BUCKETS`, the historical ``crc32 % n_shards``) exactly,
        so a fresh fleet needs no configured map to agree with every
        incumbent component."""
        n = int(n_shards)
        if n < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        return cls(buckets=tuple(b % n for b in range(N_BUCKETS)),
                   n_shards=n, version=version)

    def shard_of(self, raw_id: str) -> int:
        """Map placement: the shard owning this id's bucket."""
        return self.buckets[bucket_of_id(raw_id)]

    def owns(self, raw_id: str, shard_index: int) -> bool:
        return self.shard_of(raw_id) == int(shard_index)

    def moved_buckets(self, other: "ShardMap") -> "list[int]":
        """Bucket indices assigned differently by ``other`` — the exact
        movement set of a reshard (every id outside these buckets stays
        put, the O(moved) contract)."""
        return [b for b in range(N_BUCKETS)
                if self.buckets[b] != other.buckets[b]]

    def with_moves(self, moves: "Mapping[int, int]") -> "ShardMap":
        """A successor map (version + 1) with the named buckets
        reassigned — the reshard's constructor."""
        buckets = list(self.buckets)
        for bucket, shard in moves.items():
            b = int(bucket)
            if not 0 <= b < N_BUCKETS:
                raise ValueError(f"bucket {bucket} outside "
                                 f"[0, {N_BUCKETS})")
            buckets[b] = int(shard)
        return ShardMap(buckets=tuple(buckets), n_shards=self.n_shards,
                        version=self.version + 1)

    def rebalanced(self, n_shards: int) -> "ShardMap":
        """A successor map resized to ``n_shards`` with MINIMAL bucket
        movement: buckets keep their owner where possible; only the
        excess above each shard's fair share moves (deterministically,
        highest bucket indices first) to under-full shards — growing N
        therefore moves ~1/N of buckets, never a full rehash."""
        n = int(n_shards)
        if n < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        per_shard: "dict[int, list[int]]" = {s: [] for s in range(n)}
        homeless: "list[int]" = []
        for b, s in enumerate(self.buckets):
            (per_shard[s] if s < n else homeless).append(b)
        base, extra = divmod(N_BUCKETS, n)
        targets = [base + (1 if s < extra else 0) for s in range(n)]
        for s in range(n):
            over = len(per_shard[s]) - targets[s]
            if over > 0:
                # shed the highest buckets first: deterministic, and a
                # later shrink tends to move the same buckets back
                homeless.extend(per_shard[s][-over:])
                del per_shard[s][-over:]
        homeless.sort()
        buckets = list(self.buckets)
        for s in range(n):
            need = targets[s] - len(per_shard[s])
            for b in homeless[:need]:
                buckets[b] = s
            homeless = homeless[need:]
        return ShardMap(buckets=tuple(buckets), n_shards=n,
                        version=self.version + 1)

    def as_dict(self) -> dict:
        return {"version": self.version, "nShards": self.n_shards,
                "mapHash": self.map_hash, "buckets": list(self.buckets)}

    @classmethod
    def from_dict(cls, data: Mapping) -> "ShardMap":
        sm = cls(buckets=tuple(data["buckets"]),
                 n_shards=int(data["nShards"]),
                 version=int(data.get("version", 1)))
        want = data.get("mapHash")
        if want is not None and want != sm.map_hash:
            raise ValueError(
                f"shard map content hash mismatch: payload says {want}, "
                f"content is {sm.map_hash} — refusing a tampered or "
                f"mis-versioned map")
        return sm


def map_shard_vocab(entity_vocab: Mapping[str, int],
                    shard_map: "Optional[ShardMap]",
                    shard: "tuple[int, int] | None") -> "dict[str, int]":
    """:func:`shard_vocab` under an explicit map: restrict a raw→dense
    vocabulary to the ids the map assigns to ``shard`` (falling back to
    the default-map hash when no map is given). Order-preserving, like
    the default path."""
    if shard is None:
        return dict(entity_vocab)
    if shard_map is None:
        return shard_vocab(entity_vocab, shard)
    index = int(shard[0])
    return {raw: dense for raw, dense in entity_vocab.items()
            if shard_map.owns(raw, index)}
