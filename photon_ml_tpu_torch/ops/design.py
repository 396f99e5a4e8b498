"""Design matrices (counterpart of ``photon_ml_tpu/ops/design.py``): dense
``(..., n, d)`` tensors, the padded-COO :class:`CsrDesign` and the dual
chunked-COO :class:`ChunkedSparseDesign` that wide sparse data trains on.

The JAX package computes the sparse contractions in XLA, outside any Pallas
kernel, so here they are plain PyTorch: gather, multiply, a row-sum over
each fixed-width chunk, then a segment sum of the chunk partials over their
sorted keys. That last sum is ``torch.segment_reduce`` over precomputed
segment lengths, not ``index_add_``: on the card ``index_add_`` adds with
atomics, whose order (and so the f32 result's last bit) changes from run
to run unless ``torch.use_deterministic_algorithms(True)`` is on for the
whole process; a per-segment reduction over the already-sorted chunk keys
(``rrow`` and ``ccol`` are non-decreasing) adds each segment in a fixed
order, so a rerun is bit-identical, as the fused kernels' are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

Tensor = torch.Tensor


def accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least f32: bf16 and f32 storage accumulate in f32, f64 keeps f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


@dataclasses.dataclass(frozen=True)
class DenseDesign:
    """Dense ``(..., n, d)`` design matrix; leading dims batch (a
    random-effect bucket is ``(E, S, D)``)."""

    x: torch.Tensor

    @property
    def n_samples(self) -> int:
        return self.x.shape[-2]

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        """Margins ``X @ w``, accumulated in at least f32 (a bf16 design is
        upcast explicitly: a bf16 matmul would return rounded bf16 margins)."""
        acc = accumulation_dtype(self.x.dtype)
        return torch.einsum("...nd,...d->...n", self.x.to(acc), w.to(acc))

    def rmatvec(self, g: torch.Tensor) -> torch.Tensor:
        acc = accumulation_dtype(self.x.dtype)
        return torch.einsum("...nd,...n->...d", self.x.to(acc), g.to(acc))


def _acc(values: Tensor, other: Tensor) -> torch.dtype:
    """The contraction's dtype: at least f32, f64 if either side is."""
    return accumulation_dtype(torch.promote_types(values.dtype, other.dtype))


@dataclasses.dataclass(frozen=True)
class CsrDesign:
    """Padded COO triplets ``rows``, ``cols`` (int64) and ``values``; a
    padding entry has value 0. The COO container of a sparse shard. Its
    contractions add with ``index_add_`` (atomics on the card, so the last
    bit may differ between runs); training builds a
    :class:`ChunkedSparseDesign` from it instead."""

    rows: Tensor
    cols: Tensor
    values: Tensor
    n_rows: int
    n_cols: int

    @property
    def n_samples(self) -> int:
        return self.n_rows

    @property
    def dim(self) -> int:
        return self.n_cols

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def matvec(self, w: Tensor) -> Tensor:
        acc = _acc(self.values, w)
        contrib = (self.values * w[self.cols]).to(acc)
        return torch.zeros(self.n_rows, dtype=acc, device=w.device) \
            .index_add_(0, self.rows, contrib)

    def rmatvec(self, g: Tensor) -> Tensor:
        acc = _acc(self.values, g)
        contrib = (self.values * g[self.rows]).to(acc)
        return torch.zeros(self.n_cols, dtype=acc, device=g.device) \
            .index_add_(0, self.cols, contrib)

    @staticmethod
    def from_coo(rows, cols, vals, n_rows: int, n_cols: int,
                 device=None) -> "CsrDesign":
        """From host COO triplets, on ``device`` (``cuda`` unless the caller
        passes ``device="cpu"``)."""
        from photon_ml_tpu_torch.device import resolve_device

        device = resolve_device(device)
        return CsrDesign(
            rows=torch.as_tensor(np.asarray(rows, np.int64), device=device),
            cols=torch.as_tensor(np.asarray(cols, np.int64), device=device),
            values=torch.as_tensor(np.asarray(vals, np.float32),
                                   device=device),
            n_rows=int(n_rows), n_cols=int(n_cols))


def _chunk_sorted(keys: np.ndarray, payload_idx: np.ndarray, n_keys: int,
                  chunk: int) -> tuple[np.ndarray, np.ndarray]:
    """Chunk entries sorted by ``keys`` into fixed-width groups per key.

    Returns ``(gather, chunk_key)``: ``gather`` is an ``(M, chunk)`` int64
    index into the payload (−1 = padding slot), ``chunk_key`` ``(M,)`` the
    key of each chunk. A key with k entries occupies ceil(k/chunk) chunks.
    """
    counts = np.bincount(keys, minlength=n_keys)
    present = np.flatnonzero(counts)
    n_chunks_per = -(-counts[present] // chunk)
    total = int(n_chunks_per.sum())
    chunk_key = np.repeat(present, n_chunks_per).astype(np.int32)
    # entry positions: within-key offset → (chunk row, slot)
    starts = np.zeros(len(present) + 1, np.int64)
    np.cumsum(counts[present], out=starts[1:])
    chunk_starts = np.zeros(len(present) + 1, np.int64)
    np.cumsum(n_chunks_per, out=chunk_starts[1:])
    within = np.arange(len(keys)) - np.repeat(starts[:-1], counts[present])
    chunk_row = np.repeat(chunk_starts[:-1], counts[present]) + within // chunk
    slot = within % chunk
    gather = np.full((total, chunk), -1, np.int64)
    gather[chunk_row, slot] = payload_idx
    return gather, chunk_key


def _segment_sum(part: Tensor, lengths: Tensor) -> Tensor:
    """Sum consecutive runs of ``part``'s last axis, run k of ``lengths[k]``
    entries (0 gives 0), in a fixed order."""
    if part.dim() == 1:
        return torch.segment_reduce(part, "sum", lengths=lengths,
                                    unsafe=True)
    lead = part.shape[:-1]
    flat = part.reshape(-1, part.shape[-1]).t()
    out = torch.segment_reduce(flat, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    return out.t().reshape(*lead, lengths.shape[0])


@dataclasses.dataclass(frozen=True)
class ChunkedSparseDesign:
    """Dual chunked-COO sparse design: the entries stored twice, sorted on
    the host at build time —

    - row-major: ``(Mr, C)`` values and column ids with one row id per
      chunk (``rrow``): margins are per-chunk ``Σ v·w[col]``, then a
      segment sum of the ``Mr ≈ nnz/C + n`` partials into n rows;
    - column-major: ``(Mc, C)`` values and row ids with one column id per
      chunk (``ccol``): the gradient's transpose the same way into d bins.

    Chunk padding has value 0 and adds nothing. The chunk width defaults to
    each layout's median entries per key rounded up to a multiple of 8 in
    [8, 128]. Values are f32. Leading dims of ``w`` (``g``) batch: ``(M,
    d)`` coefficient rows share one gather of the indices.
    ``row_lengths``/``col_lengths`` hold each row's (column's) number of
    chunks, the segment lengths of the two sums.
    """

    rvals: Tensor  # (Mr, C) f32
    rcols: Tensor  # (Mr, C) int32
    rrow: Tensor  # (Mr,) int32, non-decreasing
    cvals: Tensor  # (Mc, C) f32
    crows: Tensor  # (Mc, C) int32
    ccol: Tensor  # (Mc,) int32, non-decreasing
    row_lengths: Tensor  # (n_rows,) int64
    col_lengths: Tensor  # (n_cols,) int64
    n_rows: int
    n_cols: int

    @property
    def n_samples(self) -> int:
        return self.n_rows

    @property
    def dim(self) -> int:
        return self.n_cols

    @property
    def dtype(self) -> torch.dtype:
        return self.rvals.dtype

    @property
    def device(self) -> torch.device:
        return self.rvals.device

    @staticmethod
    def _contract(vals: Tensor, idx: Tensor, v: Tensor,
                  lengths: Tensor) -> Tensor:
        acc = _acc(vals, v)
        part = (vals * v[..., idx]).to(acc).sum(-1)
        return _segment_sum(part, lengths)

    def matvec(self, w: Tensor) -> Tensor:
        """Margins ``X @ w`` ``(..., n)``."""
        return self._contract(self.rvals, self.rcols, w, self.row_lengths)

    def rmatvec(self, g: Tensor) -> Tensor:
        """``Xᵀ g`` ``(..., d)``."""
        return self._contract(self.cvals, self.crows, g, self.col_lengths)

    def rmatvec_squared(self, g: Tensor) -> Tensor:
        """``(X²)ᵀ g`` — the Hessian-diagonal contraction (values squared)."""
        return self._contract(self.cvals * self.cvals, self.crows, g,
                              self.col_lengths)

    @staticmethod
    def default_chunk(counts: np.ndarray) -> int:
        """Median nnz of the non-empty keys, rounded to 8 in [8, 128]."""
        nz = counts[counts > 0]
        if not len(nz):
            return 8
        med = int(np.median(nz))
        return int(np.clip(-(-med // 8) * 8, 8, 128))

    @staticmethod
    def layout_numpy(rows, cols, vals, *, row_chunk: Optional[int] = None,
                     col_chunk: Optional[int] = None) -> dict:
        """The two chunk layouts as host numpy arrays. Explicit zeros are
        dropped; duplicate (row, col) entries keep a slot each."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        live = vals != 0
        rows, cols, vals = rows[live], cols[live], vals[live]
        if row_chunk is None:
            row_chunk = ChunkedSparseDesign.default_chunk(
                np.bincount(rows) if len(rows) else np.zeros(1, np.int64))
        if col_chunk is None:
            col_chunk = ChunkedSparseDesign.default_chunk(
                np.bincount(cols) if len(cols) else np.zeros(1, np.int64))

        def layout(keys, chunk):
            order = np.argsort(keys, kind="stable")
            gather, chunk_key = _chunk_sorted(
                keys[order], order,
                max(int(keys.max()) + 1 if len(keys) else 1, 1), chunk)
            pad = gather < 0
            safe = np.where(pad, 0, gather)
            v = np.where(pad, 0.0, vals[safe] if len(vals) else 0.0
                         ).astype(np.float32)
            return v, safe, chunk_key

        rvals, r_src, rrow = layout(rows, row_chunk)
        cvals, c_src, ccol = layout(cols, col_chunk)
        safe_cols = cols[r_src] if len(cols) else np.zeros_like(r_src)
        safe_rows = rows[c_src] if len(rows) else np.zeros_like(c_src)
        return dict(
            rvals=rvals, rcols=safe_cols.astype(np.int32), rrow=rrow,
            cvals=cvals, crows=safe_rows.astype(np.int32), ccol=ccol,
            row_chunk=row_chunk, col_chunk=col_chunk)

    @staticmethod
    def from_coo(rows, cols, vals, n_rows: int, n_cols: int,
                 row_chunk: Optional[int] = None,
                 col_chunk: Optional[int] = None,
                 device=None) -> "ChunkedSparseDesign":
        """Both layouts from host COO triplets, on ``device`` (``cuda``
        unless the caller passes ``device="cpu"``). Duplicate (row, col)
        entries accumulate in every contraction."""
        from photon_ml_tpu_torch.device import resolve_device

        device = resolve_device(device)
        lay = ChunkedSparseDesign.layout_numpy(
            rows, cols, vals, row_chunk=row_chunk, col_chunk=col_chunk)

        def put(a):
            return torch.as_tensor(a, device=device)

        return ChunkedSparseDesign(
            rvals=put(lay["rvals"]), rcols=put(lay["rcols"]),
            rrow=put(lay["rrow"]),
            cvals=put(lay["cvals"]), crows=put(lay["crows"]),
            ccol=put(lay["ccol"]),
            row_lengths=put(np.bincount(lay["rrow"], minlength=n_rows)
                            .astype(np.int64)),
            col_lengths=put(np.bincount(lay["ccol"], minlength=n_cols)
                            .astype(np.int64)),
            n_rows=int(n_rows), n_cols=int(n_cols))


Design = Union[DenseDesign, CsrDesign, ChunkedSparseDesign]
