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
one home of the table format: its constructor and its dequantization.

Not ported: fleet shard views (``shard=``, ``shard_map=``) and coefficient
patches (:meth:`EntityCoefficientStore.apply_patch`); they raise
:class:`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
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
    scale vector of an int8 table, ``None`` otherwise.
    """

    random_effect_type: str
    feature_shard_id: str
    dim: int
    table: torch.Tensor
    row_of_id: Mapping[str, int]
    table_dtype: str = "float32"
    scales: Optional[torch.Tensor] = None

    @property
    def n_entities(self) -> int:
        return len(self.row_of_id)

    @property
    def fallback_row(self) -> int:
        return int(self.table.shape[0]) - 1

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

    def apply_patch(self, update, update_vocab, removed=()):
        raise NotImplementedError(
            "EntityCoefficientStore.apply_patch: coefficient patches are "
            "not ported")

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
        """
        if table_dtype not in TABLE_DTYPES:
            raise ValueError(f"unknown table_dtype {table_dtype!r}; "
                             f"expected one of {TABLE_DTYPES}")
        if shard is not None or shard_map is not None:
            raise NotImplementedError(
                "EntityCoefficientStore.build: fleet shard views (shard=, "
                "shard_map=) are not ported")
        device = resolve_device(device)
        keys = np.asarray(model.keys, np.int64)
        ent = keys // model.dim
        feat = keys % model.dim
        uniq = np.unique(ent)
        dense = np.zeros((len(uniq) + 1, model.dim), np.float32)
        if len(keys):
            dense[np.searchsorted(uniq, ent), feat] = model.coeffs
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
            table_dtype=table_dtype, scales=scales)
