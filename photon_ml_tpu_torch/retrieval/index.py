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
- The item axis is padded to ``bucket``, a power of two, so a patch that
  grows the vocabulary inside the padding changes no shape. Padding rows
  alias the store's zero fallback row and are masked to ``-inf`` before
  the sort.
- :meth:`apply_patch` derives the next version's index from a patched
  store by re-gathering only the touched items' rows; new items append
  inside the padding, and overflowing it rebuilds at the next bucket.

``item_ids`` fixes the item axis order and so the tie-break order of the
ranking (lower item position first). Not ported: the JAX index's
request-independent per-item margins (``static_margins``, which no caller
sets) and its sharding over a mesh.
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

    ``matrix``/``scales`` mirror the store's storage format
    (:attr:`device_params` feeds ``gather_rows`` as a store's table does);
    ``item_ids[i]`` is the raw id at item-axis position ``i`` and
    ``pos_of`` its inverse.
    """

    coordinate_id: str
    random_effect_type: str
    dim: int
    table_dtype: str
    item_ids: tuple
    bucket: int
    matrix: torch.Tensor  # (bucket, dim) in table_dtype storage
    scales: Optional[torch.Tensor]  # (bucket,) f32, int8 only
    pos_of: Mapping[str, int] = dataclasses.field(repr=False, compare=False,
                                                  default_factory=dict)

    @property
    def n_items(self) -> int:
        return len(self.item_ids)

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    @property
    def device_params(self):
        """``(matrix, scales)``, consumed through ``store.gather_rows``."""
        return (self.matrix, self.scales)

    @property
    def matrix_bytes(self) -> int:
        """Resident device bytes of the item matrix and its scales."""
        n = self.matrix.numel() * self.matrix.element_size()
        if self.scales is not None:
            n += self.scales.numel() * 4
        return n

    # --- construction -----------------------------------------------------
    @staticmethod
    def build(store: EntityCoefficientStore, coordinate_id: str, *,
              bucket: Optional[int] = None) -> "ItemIndex":
        """Pack ``store`` item-major on its device."""
        item_ids = tuple(store.row_of_id)
        n = len(item_ids)
        b = item_bucket(n) if bucket is None else int(bucket)
        if b < max(n, 1):
            raise ValueError(f"bucket {b} < {n} items")
        rows = np.full(b, store.fallback_row, np.int64)
        if n:
            rows[:n] = store.rows_for(list(item_ids))
        device = store.table.device
        # one gather in storage dtype; padding rows alias the fallback row
        rows_d = torch.as_tensor(rows, device=device)
        matrix = store.table.index_select(0, rows_d)
        scales = (None if store.scales is None
                  else store.scales.index_select(0, rows_d))
        return ItemIndex(
            coordinate_id=coordinate_id,
            random_effect_type=store.random_effect_type, dim=store.dim,
            table_dtype=store.table_dtype, item_ids=item_ids, bucket=b,
            matrix=matrix, scales=scales,
            pos_of={raw: i for i, raw in enumerate(item_ids)})

    def apply_patch(self, store: EntityCoefficientStore,
                    touched: Sequence[str]) -> "ItemIndex":
        """The next version's index from the patched ``store``, re-gathering
        only the ``touched`` raw ids' rows (updated, removed — their store
        rows are already zeroed — and new items, which append inside the
        padding). Functional: this index's tensors are never written.
        Overflowing the bucket rebuilds at the next power of two."""
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
            return ItemIndex.build(store, self.coordinate_id)
        item_ids = self.item_ids + tuple(new)
        pos_of = dict(self.pos_of)
        for raw in new:
            pos_of[raw] = len(pos_of)
        device = self.matrix.device
        pos = torch.as_tensor(
            np.fromiter((pos_of[raw] for raw in touched), np.int64,
                        count=len(touched)), device=device)
        rows = torch.as_tensor(store.rows_for(touched).astype(np.int64),
                               device=device)
        matrix = self.matrix.clone()
        matrix[pos] = store.table.index_select(0, rows)
        scales = self.scales
        if store.scales is not None:
            if scales is None:
                raise ValueError("patch store carries scales but the "
                                 "index has none (dtype drift)")
            scales = scales.clone()
            scales[pos] = store.scales.index_select(0, rows)
        return dataclasses.replace(
            self, item_ids=item_ids, matrix=matrix, scales=scales,
            pos_of=pos_of)
