"""Item-major retrieval index over one random-effect coordinate's store.

Counterpart of ``photon_ml_tpu/retrieval/index.py``. The serving
:class:`~photon_ml_tpu_torch.serving.store.EntityCoefficientStore` is
request-major: a request names an entity and the engine gathers its row.
Ranking touches every item's row, so the index re-packs the store
item-major once per model version:

- ``matrix`` is a ``(bucket, dim)`` tensor of per-item coefficient rows
  in the store's storage dtype (float32, bfloat16, or int8 with the
  matching per-row ``scales``), on the store's device. The ranking program
  dequantizes through the store's one numeric home
  (:func:`~photon_ml_tpu_torch.serving.store.gather_rows`), so the
  full-precision matrix never exists on the device.
- The item axis is padded to ``bucket``, a power of two (rounded up to
  the mesh axis size when sharded), so a patch that grows the vocabulary
  inside the padding changes no shape. Padding rows alias the store's zero
  fallback row and are masked to ``-inf`` before the sort.
- ``static`` is a per-item f32 vector of request-independent margin terms
  (the fixed effect on per-item feature records, an item-side offset;
  :meth:`ItemIndex.static_margins_from_records`), all zeros when no item
  feature source is configured.
- With a ``mesh`` the item axis is spread over the slots of its entity
  axis (else its first axis): ``parts[j]`` holds items ``[j·b/k,
  (j+1)·b/k)`` on slot ``j``, and the ranking program computes each
  part's margins on its slot. Unsharded, ``parts`` is one part on the
  store's device.
- :meth:`apply_patch` derives the next version's index from a patched
  store by re-gathering only the touched items' rows; new items append
  inside the padding, and overflowing it rebuilds at the next bucket.

``item_ids`` fixes the item axis order and so the tie-break order of the
ranking (lower item position first).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.serving.store import EntityCoefficientStore


def item_bucket(n: int, multiple: int = 1) -> int:
    """Padded item-axis length: smallest power of two >= max(n, 1),
    rounded up to ``multiple``."""
    b = 1 << max(int(n) - 1, 0).bit_length()
    if multiple > 1:
        b += (-b) % int(multiple)
    return b


@dataclasses.dataclass(frozen=True)
class ItemIndex:
    """Immutable per-version retrieval index (one per rank coordinate).

    ``parts`` mirror the store's storage format, one ``(matrix, scales)``
    pair a slot in item order (each feeds ``gather_rows`` as a store's
    table does); ``static`` is the f32 request-independent margin vector
    on the first slot, ``static_host`` its host copy; ``item_ids[i]`` is
    the raw id at item-axis position ``i`` and ``pos_of`` its inverse.
    """

    coordinate_id: str
    random_effect_type: str
    dim: int
    table_dtype: str
    item_ids: tuple
    bucket: int
    #: ((bucket / len(parts), dim) matrix in table_dtype storage, its
    #: (bucket / len(parts),) f32 scales for int8 else None), a slot each
    parts: tuple
    static: torch.Tensor  # (bucket,) f32
    static_host: np.ndarray = dataclasses.field(repr=False, compare=False,
                                                default=None)
    pos_of: Mapping[str, int] = dataclasses.field(repr=False, compare=False,
                                                  default_factory=dict)
    #: the mesh the item axis is spread over, None when unsharded
    mesh: object = dataclasses.field(repr=False, compare=False, default=None)

    @property
    def n_items(self) -> int:
        return len(self.item_ids)

    @property
    def device(self) -> torch.device:
        """The first slot's device (where the ranking sums and sorts)."""
        return self.parts[0][0].device

    @property
    def slots(self) -> tuple:
        """The device of each part, in item order."""
        return tuple(m.device for m, _ in self.parts)

    @property
    def matrix(self) -> torch.Tensor:
        """The whole ``(bucket, dim)`` item matrix on the first slot."""
        if len(self.parts) == 1:
            return self.parts[0][0]
        return torch.cat([m.to(self.device) for m, _ in self.parts])

    @property
    def scales(self) -> Optional[torch.Tensor]:
        """The whole ``(bucket,)`` int8 scale vector, or None."""
        if self.parts[0][1] is None:
            return None
        if len(self.parts) == 1:
            return self.parts[0][1]
        return torch.cat([s.to(self.device) for _, s in self.parts])

    @property
    def matrix_bytes(self) -> int:
        """Resident device bytes of the item matrix, its scales and the
        static vector."""
        n = 0
        for m, sc in self.parts:
            n += m.numel() * m.element_size()
            if sc is not None:
                n += sc.numel() * 4
        return n + self.bucket * 4

    # --- construction -----------------------------------------------------
    @staticmethod
    def build(store: EntityCoefficientStore, coordinate_id: str, *,
              static_margins: Optional[Mapping[str, float]] = None,
              mesh=None, bucket: Optional[int] = None) -> "ItemIndex":
        """Pack ``store`` item-major on its device. ``static_margins`` maps
        raw item id to its precomputed request-independent margin (absent
        ids take 0.0); ``mesh`` spreads the item axis over the slots of its
        :data:`~photon_ml_tpu_torch.parallel.mesh.ENTITY_AXIS` (else its
        first axis), for vocabularies one device cannot hold."""
        item_ids = tuple(store.row_of_id)
        n = len(item_ids)
        device = store.table.device
        slots = (device,)
        if mesh is not None:
            from photon_ml_tpu_torch.parallel.mesh import ENTITY_AXIS

            axis = (ENTITY_AXIS if ENTITY_AXIS in mesh.shape
                    else next(iter(mesh.shape)))
            slots = mesh.axis_devices(axis)
        b = (item_bucket(n, len(slots)) if bucket is None else int(bucket))
        if b < max(n, 1):
            raise ValueError(f"bucket {b} < {n} items")
        if b % len(slots):
            raise ValueError(f"bucket {b} does not split over "
                             f"{len(slots)} slots")
        rows = np.full(b, store.fallback_row, np.int64)
        if n:
            rows[:n] = store.rows_for(list(item_ids))
        # one gather in storage dtype a slot; padding rows alias the
        # fallback row
        per = b // len(slots)
        parts = []
        for j, dev in enumerate(slots):
            rows_d = torch.as_tensor(rows[j * per:(j + 1) * per],
                                     device=device)
            parts.append((
                store.table.index_select(0, rows_d).to(dev),
                None if store.scales is None
                else store.scales.index_select(0, rows_d).to(dev)))
        static_host = np.zeros(b, np.float32)
        pos_of = {raw: i for i, raw in enumerate(item_ids)}
        for raw, v in (static_margins or {}).items():
            i = pos_of.get(raw)
            if i is not None:
                static_host[i] = np.float32(v)
        return ItemIndex(
            coordinate_id=coordinate_id,
            random_effect_type=store.random_effect_type, dim=store.dim,
            table_dtype=store.table_dtype, item_ids=item_ids, bucket=b,
            parts=tuple(parts),
            static=torch.as_tensor(static_host, device=slots[0]),
            static_host=static_host, pos_of=pos_of, mesh=mesh)

    def apply_patch(self, store: EntityCoefficientStore,
                    touched: Sequence[str], *,
                    static_margins: Optional[Mapping[str, float]] = None,
                    ) -> "ItemIndex":
        """The next version's index from the patched ``store``, re-gathering
        only the ``touched`` raw ids' rows (updated, removed — their store
        rows are already zeroed — and new items, which append inside the
        padding). Touched items keep their static margin unless
        ``static_margins`` gives a fresh one. Functional: this index's
        tensors are never written. Overflowing the bucket rebuilds at the
        next power of two."""
        if store.random_effect_type != self.random_effect_type:
            raise ValueError(
                f"patch store random-effect type "
                f"{store.random_effect_type!r} != index "
                f"{self.random_effect_type!r}")
        if store.dim != self.dim or store.table_dtype != self.table_dtype:
            raise ValueError(
                f"patch store (dim={store.dim}, dtype="
                f"{store.table_dtype!r}) does not match index (dim="
                f"{self.dim}, dtype={self.table_dtype!r})")
        touched = list(dict.fromkeys(str(t) for t in touched))
        if not touched:
            return self
        new = [raw for raw in touched if raw not in self.pos_of]
        if self.n_items + len(new) > self.bucket:
            carried = dict(zip(self.item_ids,
                               self.static_host[:self.n_items].tolist()))
            carried.update(static_margins or {})
            return ItemIndex.build(store, self.coordinate_id,
                                   static_margins=carried, mesh=self.mesh)
        if self.parts[0][1] is None and store.scales is not None:
            raise ValueError("patch store carries scales but the index has "
                             "none (dtype drift)")
        item_ids = self.item_ids + tuple(new)
        pos_of = dict(self.pos_of)
        for raw in new:
            pos_of[raw] = len(pos_of)
        pos = np.fromiter((pos_of[raw] for raw in touched), np.int64,
                          count=len(touched))
        rows = store.rows_for(touched).astype(np.int64)
        per = self.bucket // len(self.parts)
        parts = []
        for j, (matrix, scales) in enumerate(self.parts):
            sel = (pos >= j * per) & (pos < (j + 1) * per)
            if not sel.any():
                parts.append((matrix, scales))
                continue
            dev = matrix.device
            local = torch.as_tensor(pos[sel] - j * per, device=dev)
            rows_d = torch.as_tensor(rows[sel], device=store.table.device)
            matrix = matrix.clone()
            matrix[local] = store.table.index_select(0, rows_d).to(dev)
            if store.scales is not None:
                scales = scales.clone()
                scales[local] = store.scales.index_select(0, rows_d).to(dev)
            parts.append((matrix, scales))
        static_host = self.static_host.copy()
        for raw, v in (static_margins or {}).items():
            i = pos_of.get(raw)
            if i is not None:
                static_host[i] = np.float32(v)
        return dataclasses.replace(
            self, item_ids=item_ids, parts=tuple(parts),
            static=torch.as_tensor(static_host, device=self.device),
            static_host=static_host, pos_of=pos_of)

    # --- static margins ---------------------------------------------------
    @staticmethod
    def static_margins_from_records(engine, records_by_id: Mapping[str, dict],
                                    ) -> dict:
        """Each item's request-independent margin from a per-item feature
        record: the FIXED-effect contribution on the item's own features
        plus the record's offset, the GLMix terms a user-side request
        vector cannot produce. On the CPU over the engine's own packing,
        with the scoring program's arithmetic (an f64 ``torch.mv`` a fixed
        effect, each margin rounded to f32, summed in f64); returns ``{raw
        item id: float}`` for :meth:`build`."""
        from photon_ml_tpu_torch.game.model import FixedEffectModel

        if not records_by_id:
            return {}
        raws = list(records_by_id)
        batch = engine.pack([records_by_id[r] for r in raws])
        shard_x = {cfg.shard_id: x
                   for cfg, x in zip(engine.shard_configs, batch.xs)}
        total = torch.as_tensor(batch.offsets).to(torch.float64)
        for cm in engine.model.coordinates.values():
            if not isinstance(cm, FixedEffectModel):
                continue
            w = torch.as_tensor(cm.model.coefficients.means).detach().cpu()
            m = torch.mv(torch.as_tensor(shard_x[cm.feature_shard_id])
                         .to(torch.float64), w.to(torch.float64))
            total = total + m.to(torch.float32).to(torch.float64)
        return {raw: float(v) for raw, v in
                zip(raws, total.to(torch.float32).tolist())}
