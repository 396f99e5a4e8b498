"""The data-parallel GLM objective: each rank's kernel call on its own rows,
then one ``all_reduce`` (counterpart of ``photon_ml_tpu/parallel/distributed.py``).

Where the JAX package runs ``shard_map`` + ``psum`` over a ``data`` mesh
axis, here every rank evaluates the SAME objective on its own block of rows
— kernel 1 for (value, gradient) and kernel 3 for each Hessian-vector
product on a dense design — and one ``torch.distributed.all_reduce`` of the
packed result on the device sums the blocks (the reference's per-iteration
``treeAggregate``). The L2 term is added once, outside the reduction.

Layout: :func:`shard_glm_data` splits host rows into equal blocks, padding
the tail with weight-0 rows (which contribute exactly nothing: kernel 1
skips rows of weight 0, kernel 3 rows whose curvature weight is 0) and, for
a sparse design, padding every block's chunk lists to common counts. Its
result stacks the blocks on a leading axis, the JAX package's layout leaf
for leaf; :func:`local_block` takes one block to a device. In a multi-
process job each rank holds one block
(:func:`~photon_ml_tpu_torch.parallel.multihost.global_glm_data_multihost`).

The feature-sharded objective of ``--mesh feature=N`` (one process over
several cards) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.ops.design import (
    ChunkedSparseDesign,
    CsrDesign,
    DenseDesign,
)
from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective, _per_lane

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ShardBudget:
    """The shape budget every rank builds its block to: rows per block and,
    for a sparse design, the chunk widths and padded chunk counts (0 for
    dense designs). Field-wise max-reduced across ranks by
    :func:`~photon_ml_tpu_torch.parallel.multihost.allreduce_shard_budget`."""

    rows_per_shard: int
    row_chunk: int = 0
    col_chunk: int = 0
    row_chunks: int = 0
    col_chunks: int = 0

    def to_array(self) -> np.ndarray:
        return np.array([self.rows_per_shard, self.row_chunk, self.col_chunk,
                         self.row_chunks, self.col_chunks], np.int64)

    @staticmethod
    def from_array(a) -> "ShardBudget":
        return ShardBudget(*(int(v) for v in np.asarray(a, np.int64)))


def shard_budget(sharded: GLMData) -> ShardBudget:
    """The budget a stacked layout was built with."""
    per = int(sharded.labels.shape[1])
    design = sharded.design
    if isinstance(design, ChunkedSparseDesign):
        return ShardBudget(
            rows_per_shard=per,
            row_chunk=int(design.rvals.shape[2]),
            col_chunk=int(design.cvals.shape[2]),
            row_chunks=int(design.rvals.shape[1]),
            col_chunks=int(design.cvals.shape[1]))
    return ShardBudget(rows_per_shard=per)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, Tensor) \
        else np.asarray(a)


def _pad_rows(a, n_pad: int) -> Tensor:
    """``a`` (rows first, numpy or tensor, any dtype torch holds — bf16
    included) zero-padded to ``n_pad`` rows, on the CPU."""
    t = torch.as_tensor(a).cpu() if not isinstance(a, Tensor) \
        else a.detach().cpu()
    out = torch.zeros((n_pad,) + tuple(t.shape[1:]), dtype=t.dtype)
    out[:t.shape[0]] = t
    return out


def shard_glm_data(data: GLMData, n_shards: int, *,
                   budget: Optional[ShardBudget] = None) -> GLMData:
    """Split host rows into ``n_shards`` equal blocks stacked on a leading
    axis (CPU tensors; :func:`local_block` moves one to a device).

    Rows are padded up to a multiple of ``n_shards`` with weight-0 rows. A
    dense (or factored) design keeps its dtype; a :class:`CsrDesign`
    becomes per-block chunked layouts with common chunk widths (each
    layout's median entries per key, counted per block) and chunk counts
    padded to the largest block's with value-0 chunks. ``budget`` (agreed
    across ranks) fixes the rows per block and, when set, the chunk widths
    and counts."""
    n = data.n_samples
    per = math.ceil(n / n_shards)
    if budget is not None:
        if budget.rows_per_shard < per:
            raise ValueError(
                f"budget.rows_per_shard={budget.rows_per_shard} cannot hold "
                f"{n} rows over {n_shards} shards (need ≥ {per})")
        per = budget.rows_per_shard
    n_pad = per * n_shards

    def stack(a):
        padded = _pad_rows(a, n_pad)
        return padded.reshape((n_shards, per) + tuple(padded.shape[1:]))

    design = data.design
    from photon_ml_tpu_torch.game.factored import FactoredDesign

    if isinstance(design, DenseDesign):
        sharded_design = DenseDesign(x=stack(design.x))
    elif isinstance(design, FactoredDesign):
        sharded_design = FactoredDesign(x=stack(design.x), v=stack(design.v),
                                        latent_dim=design.latent_dim)
    elif isinstance(design, CsrDesign):
        sharded_design = _shard_sparse(design, n, n_shards, per, budget)
    elif isinstance(design, ChunkedSparseDesign):
        raise TypeError(
            "shard_glm_data splits by row from COO; pass the host "
            "CsrDesign and the sharded layout is built chunked per block")
    else:
        raise TypeError(type(design))
    return GLMData(design=sharded_design, labels=stack(data.labels),
                   offsets=stack(data.offsets), weights=stack(data.weights))


def _shard_sparse(design: CsrDesign, n: int, n_shards: int, per: int,
                  budget: Optional[ShardBudget]) -> ChunkedSparseDesign:
    rows = _host(design.rows).astype(np.int64)
    cols = _host(design.cols).astype(np.int64)
    vals = _host(design.values)
    block_of = rows // per
    local_row = rows % per
    live = vals != 0
    if budget is not None and budget.row_chunk and budget.col_chunk:
        row_chunk, col_chunk = budget.row_chunk, budget.col_chunk
    else:
        row_chunk = ChunkedSparseDesign.default_chunk(
            np.bincount(rows[live], minlength=n))
        # per-block column counts: columns recur in every block, so merged
        # counts would inflate the median (and the padding) ~n_shards x
        _, blockcol_counts = np.unique(
            block_of[live] * np.int64(design.n_cols) + cols[live],
            return_counts=True)
        col_chunk = ChunkedSparseDesign.default_chunk(blockcol_counts)
    lays = []
    for b in range(n_shards):
        sel = block_of == b
        lays.append(ChunkedSparseDesign.layout_numpy(
            local_row[sel], cols[sel], vals[sel],
            row_chunk=row_chunk, col_chunk=col_chunk))
    mr = max(lay["rrow"].shape[0] for lay in lays)
    mc = max(lay["ccol"].shape[0] for lay in lays)
    if budget is not None and budget.row_chunks and budget.col_chunks:
        if budget.row_chunks < mr or budget.col_chunks < mc:
            raise ValueError(
                f"budget chunk counts (mr={budget.row_chunks}, "
                f"mc={budget.col_chunks}) below this host's layout "
                f"(mr={mr}, mc={mc}) — compute the budget from the same "
                f"data")
        mr, mc = budget.row_chunks, budget.col_chunks

    def pad_stack(key, m, fill):
        outs = []
        for lay in lays:
            a = lay[key]
            if m > a.shape[0]:
                a = np.concatenate(
                    [a, np.full((m - a.shape[0],) + a.shape[1:], fill,
                                a.dtype)])
            outs.append(a)
        return np.stack(outs)

    # padded segment ids take the LAST id, so the keys stay sorted; their
    # chunks hold value 0 and add nothing
    rrow = pad_stack("rrow", mr, max(per - 1, 0))
    ccol = pad_stack("ccol", mc, max(design.n_cols - 1, 0))
    return ChunkedSparseDesign(
        rvals=torch.as_tensor(pad_stack("rvals", mr, 0.0)),
        rcols=torch.as_tensor(pad_stack("rcols", mr, 0)),
        rrow=torch.as_tensor(rrow),
        cvals=torch.as_tensor(pad_stack("cvals", mc, 0.0)),
        crows=torch.as_tensor(pad_stack("crows", mc, 0)),
        ccol=torch.as_tensor(ccol),
        row_lengths=torch.as_tensor(np.stack(
            [np.bincount(r, minlength=per) for r in rrow]).astype(np.int64)),
        col_lengths=torch.as_tensor(np.stack(
            [np.bincount(c, minlength=design.n_cols) for c in ccol])
            .astype(np.int64)),
        n_rows=per, n_cols=design.n_cols)


def local_block(sharded: GLMData, i: int, device) -> GLMData:
    """Block ``i`` of a stacked layout as a :class:`GLMData` on
    ``device``."""
    from photon_ml_tpu_torch.game.factored import FactoredDesign

    def put(t):
        return t[i].to(device)

    d = sharded.design
    if isinstance(d, DenseDesign):
        design = DenseDesign(x=put(d.x))
    elif isinstance(d, FactoredDesign):
        design = FactoredDesign(x=put(d.x), v=put(d.v),
                                latent_dim=d.latent_dim)
    else:
        design = ChunkedSparseDesign(
            rvals=put(d.rvals), rcols=put(d.rcols), rrow=put(d.rrow),
            cvals=put(d.cvals), crows=put(d.crows), ccol=put(d.ccol),
            row_lengths=put(d.row_lengths), col_lengths=put(d.col_lengths),
            n_rows=d.n_rows, n_cols=d.n_cols)
    return GLMData(design=design, labels=put(sharded.labels),
                   offsets=put(sharded.offsets),
                   weights=put(sharded.weights))


def _all_reduce(t: Tensor) -> Tensor:
    from photon_ml_tpu_torch.parallel.multihost import device_all_reduce

    return device_all_reduce(t)


@dataclasses.dataclass(frozen=True)
class DistributedGLMObjective:
    """The fixed-effect objective over the rows of every rank: a drop-in for
    :class:`~photon_ml_tpu_torch.ops.objective.GLMObjective` (the same
    methods) whose ``data`` is this rank's block. Each evaluation is the
    wrapped objective on the block (its fused kernels on a dense design)
    and one ``all_reduce`` on the device; the L2 term is added after it, so
    it counts once. Every rank gets the same reduced bits, so optimizers
    that branch on them on the host stay in lockstep."""

    objective: GLMObjective

    def _l2_grad(self, w: Tensor, l2) -> Tensor:
        return _per_lane(l2) * self.objective._reg_w(w)

    def value_and_grad(self, w: Tensor, data: GLMData, l2=0.0):
        v, g = self.objective.value_and_grad(w, data, 0.0)
        g = g.to(w.dtype)
        dt = torch.promote_types(v.dtype, g.dtype)
        packed = _all_reduce(torch.cat([v.reshape(-1).to(dt),
                                        g.reshape(-1).to(dt)]))
        nv = v.numel()
        value = packed[:nv].reshape(v.shape).to(v.dtype)
        grad = packed[nv:].reshape(g.shape).to(g.dtype)
        return (value + self.objective._l2_term(w, l2),
                grad + self._l2_grad(w, l2))

    def value(self, w: Tensor, data: GLMData, l2=0.0) -> Tensor:
        local = self.objective.value(w, data, 0.0)
        return _all_reduce(local) + self.objective._l2_term(w, l2)

    def grad(self, w: Tensor, data: GLMData, l2=0.0) -> Tensor:
        return self.value_and_grad(w, data, l2)[1]

    def hvp_operator(self, w: Tensor, data: GLMData, l2=0.0):
        """``v ↦ Hv``: the rank's product (kernel 3 on a dense block, its
        curvature weights computed once here) summed over ranks, then the
        L2 curvature."""
        local = self.objective.hvp_operator(w, data, 0.0)
        reg = self.objective.reg_curvature(l2)

        def apply(v: Tensor) -> Tensor:
            return _all_reduce(local(v)) + reg * v

        return apply

    def hvp(self, w: Tensor, v: Tensor, data: GLMData, l2=0.0) -> Tensor:
        return self.hvp_operator(w, data, l2)(v)

    def margins(self, w: Tensor, data: GLMData) -> Tensor:
        """The margins of this rank's rows."""
        return self.objective.margins(w, data)

    def hessian_diagonal(self, w: Tensor, data: GLMData, l2=0.0) -> Tensor:
        """Variance type SIMPLE over every rank's rows."""
        diag = _all_reduce(self.objective.hessian_diagonal(w, data, 0.0))
        return diag + self.objective.reg_curvature(l2)

    def hessian_matrix(self, w: Tensor, data: GLMData, l2=0.0) -> Tensor:
        """Variance type FULL over every rank's rows."""
        h = _all_reduce(self.objective.hessian_matrix(w, data, 0.0))
        reg = torch.broadcast_to(torch.as_tensor(
            self.objective.reg_curvature(l2), dtype=h.dtype,
            device=h.device), h.shape[:-1])
        return h + torch.diag_embed(reg)
