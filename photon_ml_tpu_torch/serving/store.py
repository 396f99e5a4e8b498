"""Entity coefficient store: per-entity models packed for O(1) online lookup.

Counterpart of ``photon_ml_tpu/serving/store.py``. The batch path joins
random-effect coefficients against a dataset with one ``searchsorted``
(:meth:`photon_ml_tpu_torch.game.model.RandomEffectModel.lookup`); a
serving request names one entity by its raw id and needs that entity's row
now. So each random-effect coordinate's sparse ``(entity·dim + feature) →
coeff`` table is repacked once at load into a dense ``(n_entities + 1,
dim)`` tensor on the store's device plus a host ``raw id → row`` dict:
request-time lookup is one dict probe and one device gather. The last row
is all zeros: the landing slot of entities the model never saw, which so
score exactly 0 from this coordinate (the cold-start contract, the same as
the batch path's not-found join).

Quantized tables (``table_dtype``): ``bfloat16`` halves the bytes with a
round-to-nearest-even cast; ``int8`` quarters them with per-row symmetric
quantization (``q = rint(row / scale)``, ``scale = max|row| / 127``, one
f32 scale per entity). The engine dequantizes in its scoring program
(:func:`gather_rows`), so the full-precision table never exists on the
device. ``float32`` stays bit-identical to the batch scorer; ``bfloat16``
holds ~1e-2 relative score error and ``int8`` ~5e-2. This module is the
one home of the table format: its constructor, its dequantization, and the
two writers of serving tables, :meth:`EntityCoefficientStore.build` and
:meth:`EntityCoefficientStore.apply_patch` (a coefficient patch's
functional, O(touched) derivation of the next version's table).

Fleet shard views (``shard=(index, count)``, optionally under an explicit
:class:`~photon_ml_tpu_torch.fleet.sharding.ShardMap`): the table packs
only the raw ids the shard owns (``fleet/sharding.py``), so a host of an
N-host fleet holds ~1/N of the rows on its device; every other id lands on
the fallback row exactly as an unseen one does, and a patch applies only
its owned slice.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.fleet import sharding as _sharding
from photon_ml_tpu_torch.game.model import RandomEffectModel

#: supported table storage formats, in decreasing precision
TABLE_DTYPES = ("float32", "bfloat16", "int8")


def quantize_rows(rows: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Per-row symmetric int8 quantization: ``(q int8 rows, f32 scales)``
    with ``row ≈ q * scale``. All-zero rows get scale 1.0, which makes the
    fallback row dequantize to exact zeros."""
    rows = np.asarray(rows, np.float32)
    amax = (np.max(np.abs(rows), axis=1) if rows.size
            else np.zeros((rows.shape[0],), np.float32))
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(rows / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales


def _pack_table(dense: np.ndarray, table_dtype: str, device: torch.device):
    """Host f32 dense rows → ``(table, scales | None)`` on ``device`` in the
    requested storage format."""
    if table_dtype == "float32":
        return torch.as_tensor(dense, dtype=torch.float32,
                               device=device), None
    if table_dtype == "bfloat16":
        return torch.as_tensor(dense, dtype=torch.float32).to(
            device=device, dtype=torch.bfloat16), None
    if table_dtype == "int8":
        q, scales = quantize_rows(dense)
        return (torch.as_tensor(q, device=device),
                torch.as_tensor(scales, device=device))
    raise ValueError(
        f"unknown table_dtype {table_dtype!r}; expected one of {TABLE_DTYPES}")


def gather_rows(params, rows: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Dequantizing row gather of the engine's scoring program: ``params``
    is :attr:`EntityCoefficientStore.device_params` ``(table, scales)``;
    returns ``(n, dim)`` rows in ``dtype``. With f32 tables this is the
    plain ``table[rows]`` widened, so f32 batch parity is untouched."""
    table, scales = params
    out = table.index_select(0, rows).to(dtype)
    if scales is not None:
        out = out * scales.index_select(0, rows)[:, None].to(dtype)
    return out


@dataclasses.dataclass(frozen=True)
class EntityCoefficientStore:
    """Dense per-entity coefficient table of one random-effect coordinate.

    ``table`` is ``(n_entities + 1, dim)`` on the store's device in
    ``table_dtype`` storage; row ``n_entities`` is the fallback row (zeros,
    which dequantize to exact zeros in every format). ``row_of_id`` maps a
    raw entity id to its row; ``scales`` is the ``(n_entities + 1,)`` f32
    scale vector of an int8 table, ``None`` otherwise. ``shard`` is the
    fleet shard ``(index, count)`` whose ids alone have rows (None:
    unsharded), ``shard_map`` the bucket → shard table governing ownership
    (None: the default map).
    """

    random_effect_type: str
    feature_shard_id: str
    dim: int
    table: torch.Tensor
    row_of_id: Mapping[str, int]
    table_dtype: str = "float32"
    scales: Optional[torch.Tensor] = None
    shard: Optional[tuple] = None
    shard_map: Optional[object] = None

    @property
    def n_entities(self) -> int:
        return len(self.row_of_id)

    @property
    def fallback_row(self) -> int:
        return int(self.table.shape[0]) - 1

    def shard_of(self, raw_id: str) -> Optional[int]:
        """The fleet shard owning this raw id (None on an unsharded
        store), by the store's map when it has one, else the default
        hash."""
        if self.shard is None:
            return None
        if self.shard_map is not None:
            return self.shard_map.shard_of(raw_id)
        return _sharding.shard_of_id(raw_id, self.shard[1])

    def owns(self, raw_id: str) -> bool:
        """Is this raw id in the store's shard slice? An unsharded store
        owns every id; a sharded one scores foreign ids on the fallback
        row and never packs rows for them."""
        if self.shard is not None and self.shard_map is not None:
            return self.shard_map.owns(raw_id, self.shard[0])
        return _sharding.owns_id(raw_id, self.shard)

    @property
    def device_params(self):
        """``(table, scales)``, consumed through :func:`gather_rows`."""
        return (self.table, self.scales)

    @property
    def table_bytes(self) -> int:
        """Resident device bytes of this coordinate's table (rows plus the
        int8 scale vector): the ``photon_serving_table_bytes`` gauge."""
        n = self.table.numel() * self.table.element_size()
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n

    def rows_for(self, raw_ids: Sequence[Optional[str]]) -> np.ndarray:
        """Table row per raw entity id; unseen or missing ids land on the
        zero fallback row."""
        fb = self.fallback_row
        n = len(raw_ids)
        if n == 1:
            r = raw_ids[0]
            return np.array([fb if r is None else self.row_of_id.get(r, fb)],
                            np.int32)
        get = self.row_of_id.get
        if all(r is None for r in raw_ids):
            return np.full(n, fb, np.int32)
        return np.fromiter(
            (fb if r is None else get(r, fb) for r in raw_ids),
            np.int32, count=n)

    def apply_patch(self, update: Optional[RandomEffectModel],
                    update_vocab: Mapping[str, int],
                    removed: Sequence[str] = (),
                    ) -> "EntityCoefficientStore":
        """The next version's store, derived by overwriting only the
        touched rows: O(touched) where :meth:`build` is O(all entities).

        ``update`` is the patch's partial model (the re-solved entities
        only) in its own dense-id space, ``update_vocab`` its raw → dense
        map; rows are matched by raw id. An entity of this store has its
        row overwritten, a new entity appends a row, and each raw id in
        ``removed`` has its row zeroed (it then scores as the cold-start
        fallback does); the fallback row stays last. The update is
        functional: this store's tensors are never written (in-flight
        requests and the previous version hold them), a new table is
        derived. Touched rows are packed alone through the format's one
        constructor (per-row int8 scales, so no other row's scale moves;
        bf16 a cast), untouched rows carry bit for bit."""
        if update is not None:
            if update.dim != self.dim:
                raise ValueError(
                    f"patch dim {update.dim} != store dim {self.dim}")
            if update.random_effect_type != self.random_effect_type:
                raise ValueError(
                    f"patch random-effect type "
                    f"{update.random_effect_type!r} != store "
                    f"{self.random_effect_type!r}")
        n_old = self.fallback_row
        updates: dict[int, np.ndarray] = {}
        new_raws: list[str] = []

        def target_row(raw: str) -> int:
            r = self.row_of_id.get(raw)
            if r is None or r == n_old:
                # an unseen raw id, or a vocabulary entry parked on the
                # fallback row (never writable): append a row
                new_raws.append(raw)
                return n_old + len(new_raws) - 1
            return r

        # removals first, so an id both removed and re-solved takes the
        # update's row
        for raw in removed:
            r = self.row_of_id.get(raw)
            if r is not None and r != n_old:
                updates[r] = np.zeros(self.dim, np.float32)
        if update is not None and len(update.keys):
            ent = np.unique(np.asarray(update.keys) // update.dim)
            reverse = {int(d): raw for raw, d in update_vocab.items()}
            block = update.entity_rows(ent)
            for i, e in enumerate(ent):
                raw = reverse.get(int(e))
                if raw is None:
                    raise ValueError(
                        f"patch entity {int(e)} has no vocabulary entry")
                if not self.owns(raw):
                    # a foreign entity belongs to (and is patched on)
                    # another host of the fleet
                    continue
                updates[target_row(raw)] = block[i]
        if not updates:
            return self
        device = self.table.device
        n_rows = n_old + len(new_raws) + 1
        # torch.cat allocates: the parent's table is only read
        table = torch.cat([
            self.table[:n_old],
            torch.zeros((n_rows - n_old, self.dim), dtype=self.table.dtype,
                        device=device)])
        scales = None if self.scales is None else torch.cat([
            self.scales[:n_old],
            torch.ones(n_rows - n_old, dtype=self.scales.dtype,
                       device=device)])
        if updates:
            rows = torch.as_tensor(
                np.fromiter(updates.keys(), np.int64, len(updates)),
                device=device)
            packed, packed_scales = _pack_table(
                np.stack(list(updates.values())), self.table_dtype, device)
            table[rows] = packed
            if scales is not None:
                scales[rows] = packed_scales
        fallback = n_rows - 1
        row_of_id = {raw: (fallback if r == n_old else r)
                     for raw, r in self.row_of_id.items()}
        for i, raw in enumerate(new_raws):
            row_of_id[raw] = n_old + i
        return EntityCoefficientStore(
            random_effect_type=self.random_effect_type,
            feature_shard_id=self.feature_shard_id, dim=self.dim,
            table=table, row_of_id=row_of_id,
            table_dtype=self.table_dtype, scales=scales,
            shard=self.shard, shard_map=self.shard_map)

    @staticmethod
    def build(model: RandomEffectModel,
              entity_vocab: Mapping[str, int],
              table_dtype: str = "float32",
              shard: Optional[tuple] = None,
              shard_map=None,
              device=None) -> "EntityCoefficientStore":
        """Pack a loaded :class:`RandomEffectModel`'s sparse table densely
        in ``table_dtype`` storage on ``device`` (``cuda`` unless the
        caller passes ``device="cpu"``). ``entity_vocab`` is the
        model-derived raw → dense id map
        (:func:`photon_ml_tpu_torch.io.model_io.game_model_entity_vocabs`).

        ``shard=(index, count)`` builds the fleet shard view: only the raw
        ids the shard owns get rows (the device table shrinks to ~1/count),
        every other id resolves to the fallback row. ``shard_map`` (a
        :class:`~photon_ml_tpu_torch.fleet.sharding.ShardMap`) replaces the
        default placement with an explicit bucket table, the live
        reshard's repack.
        """
        if table_dtype not in TABLE_DTYPES:
            raise ValueError(f"unknown table_dtype {table_dtype!r}; "
                             f"expected one of {TABLE_DTYPES}")
        device = resolve_device(device)
        shard = _sharding.check_shard(shard)
        entity_vocab = _sharding.map_shard_vocab(entity_vocab, shard_map,
                                                 shard)
        keys = np.asarray(model.keys, np.int64)
        ent = keys // model.dim
        feat = keys % model.dim
        coeffs = np.asarray(model.coeffs)
        if shard is not None and len(keys):
            # only the shard's entities' coefficients: the device table is
            # what sharding shrinks
            kept = np.fromiter((int(d) for d in entity_vocab.values()),
                               np.int64, count=len(entity_vocab))
            mask = np.isin(ent, kept)
            ent, feat, coeffs = ent[mask], feat[mask], coeffs[mask]
        uniq = np.unique(ent)
        dense = np.zeros((len(uniq) + 1, model.dim), np.float32)
        if len(ent):
            dense[np.searchsorted(uniq, ent), feat] = coeffs
        # dense entity id -> packed row, then raw id -> packed row; vocab
        # entries without coefficients (coordinates sharing an entity type
        # merge their vocabularies) map to the fallback zeros row
        row_of_dense = {int(e): i for i, e in enumerate(uniq)}
        fallback = len(uniq)
        row_of_id = {raw: row_of_dense.get(d, fallback)
                     for raw, d in entity_vocab.items()}
        table, scales = _pack_table(dense, table_dtype, device)
        return EntityCoefficientStore(
            random_effect_type=model.random_effect_type,
            feature_shard_id=model.feature_shard_id,
            dim=model.dim, table=table, row_of_id=row_of_id,
            table_dtype=table_dtype, scales=scales, shard=shard,
            shard_map=shard_map)
