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

Inside one process, a :class:`~photon_ml_tpu_torch.parallel.mesh.Mesh`
takes the place of the process group: ``shard_glm_data(...,
device_put_mesh=mesh)`` puts block ``i`` on the slot of data index ``i``
(a :class:`MeshGLMData`), and ``DistributedGLMObjective(objective,
mesh=mesh)`` evaluates the wrapped objective on each block on its slot
(kernel 1, and kernel 3 for each Hvp, on a dense block) and sums the
partials in slot order on the first slot, the L2 term added once after the
sum.

The feature axis (``--mesh feature=N``): :func:`shard_glm_data_features`
splits the coefficient dimension into column blocks, one a slot, and
:class:`FeatureShardedGLMObjective` computes the closed forms over them —
one sum of the partial margins, one assembly of the block-disjoint
gradient — as the JAX package does outside its Pallas kernels (the fused
kernels need whole margins).
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
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    Mesh,
    on_slot,
)

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
                   device_put_mesh: Optional[Mesh] = None,
                   axis: str = DATA_AXIS,
                   budget: Optional[ShardBudget] = None):
    """Split host rows into ``n_shards`` equal blocks stacked on a leading
    axis (CPU tensors; :func:`local_block` moves one to a device).

    Rows are padded up to a multiple of ``n_shards`` with weight-0 rows. A
    dense (or factored) design keeps its dtype; a :class:`CsrDesign`
    becomes per-block chunked layouts with common chunk widths (each
    layout's median entries per key, counted per block) and chunk counts
    padded to the largest block's with value-0 chunks. ``budget`` (agreed
    across ranks) fixes the rows per block and, when set, the chunk widths
    and counts. With ``device_put_mesh`` the result is a
    :class:`MeshGLMData`: block ``i`` on the slot of ``axis`` index ``i``
    (the stacked layout never goes to one device whole)."""
    stacked = _shard_stacked(data, n_shards, budget)
    if device_put_mesh is None:
        return stacked
    slots = device_put_mesh.axis_devices(axis)
    if len(slots) != n_shards:
        raise ValueError(f"{n_shards} blocks for a {axis!r} axis of "
                         f"{len(slots)} slots")
    return MeshGLMData(blocks=tuple(local_block(stacked, i, dev)
                                   for i, dev in enumerate(slots)))


def _shard_stacked(data: GLMData, n_shards: int,
                   budget: Optional[ShardBudget]) -> GLMData:
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


@dataclasses.dataclass(frozen=True)
class MeshGLMData:
    """A stacked layout placed on a mesh axis: ``blocks[i]``, a
    :class:`GLMData` of ``rows_per_shard`` rows, lives on slot ``i``; the
    first block's slot holds the sums."""

    blocks: tuple

    @property
    def n_shards(self) -> int:
        return len(self.blocks)

    @property
    def rows_per_shard(self) -> int:
        return self.blocks[0].n_samples

    @property
    def n_samples(self) -> int:
        """Rows of every block, the padding included."""
        return self.n_shards * self.rows_per_shard

    @property
    def device(self) -> torch.device:
        return self.blocks[0].labels.device

    def gather(self, field: str) -> Tensor:
        """``field`` (``labels``, ``offsets`` or ``weights``) of every
        block, ``(n_shards * rows_per_shard,)`` on the first slot."""
        return torch.cat([getattr(b, field).to(self.device)
                          for b in self.blocks])

    def replace_rows(self, **fields) -> "MeshGLMData":
        """Every block with ``fields`` replaced: each a vector over the
        padded rows (any device), cut into blocks and put on their slots;
        one shorter than the padded rows is padded with zeros."""
        per, n_pad = self.rows_per_shard, self.n_samples
        cut = {}
        for name, v in fields.items():
            v = torch.as_tensor(v)
            if v.shape[0] < n_pad:
                v = torch.cat([v, torch.zeros(n_pad - v.shape[0],
                                              dtype=v.dtype,
                                              device=v.device)])
            cut[name] = v
        return MeshGLMData(blocks=tuple(
            dataclasses.replace(b, **{
                name: v[i * per:(i + 1) * per].to(b.labels.device)
                for name, v in cut.items()})
            for i, b in enumerate(self.blocks)))


def _slot(block: GLMData) -> torch.device:
    return block.labels.device


def _sum_in_slot_order(parts) -> Tensor:
    """The parts added in slot order on the first part's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def _all_reduce(t: Tensor) -> Tensor:
    from photon_ml_tpu_torch.parallel.multihost import device_all_reduce

    return device_all_reduce(t)


@dataclasses.dataclass(frozen=True)
class DistributedGLMObjective:
    """The fixed-effect objective over every block of rows: a drop-in for
    :class:`~photon_ml_tpu_torch.ops.objective.GLMObjective` (the same
    methods). Each evaluation is the wrapped objective on each block (its
    fused kernels on a dense design) and one sum; the L2 term is added
    after it, so it counts once.

    Without ``mesh``, ``data`` is this rank's block and the sum is one
    ``all_reduce`` on the device: every rank gets the same reduced bits, so
    optimizers that branch on them on the host stay in lockstep. With
    ``mesh``, ``data`` is a :class:`MeshGLMData` of this process: each
    block is evaluated on its slot and the partials are added in slot order
    on the first slot, where the result stays."""

    objective: GLMObjective
    mesh: Optional[Mesh] = None
    axis: str = DATA_AXIS

    def _l2_grad(self, w: Tensor, l2) -> Tensor:
        return _per_lane(l2) * self.objective._reg_w(w)

    def _sum(self, fn, w: Tensor, data) -> Tensor:
        """``fn(w, block)`` summed over the blocks: the rank's all_reduce,
        or on the mesh each block on its slot (``w`` copied there), added
        in slot order and brought to ``w``'s device."""
        if self.mesh is None:
            return _all_reduce(fn(w, data))
        parts = []
        for blk in data.blocks:
            with on_slot(_slot(blk)):
                parts.append(fn(w.to(_slot(blk)), blk))
        return _sum_in_slot_order(parts).to(w.device)

    def value_and_grad(self, w: Tensor, data, l2=0.0):
        shapes = {}

        def packed(wv, blk):
            v, g = self.objective.value_and_grad(wv, blk, 0.0)
            g = g.to(wv.dtype)
            shapes.update(v=(v.shape, v.dtype), g=(g.shape, g.dtype))
            dt = torch.promote_types(v.dtype, g.dtype)
            return torch.cat([v.reshape(-1).to(dt), g.reshape(-1).to(dt)])

        total = self._sum(packed, w, data)
        (v_shape, v_dtype), (g_shape, g_dtype) = shapes["v"], shapes["g"]
        nv = math.prod(v_shape)
        value = total[:nv].reshape(v_shape).to(v_dtype)
        grad = total[nv:].reshape(g_shape).to(g_dtype)
        return (value + self.objective._l2_term(w, l2),
                grad + self._l2_grad(w, l2))

    def value(self, w: Tensor, data, l2=0.0) -> Tensor:
        local = self._sum(
            lambda wv, blk: self.objective.value(wv, blk, 0.0), w, data)
        return local + self.objective._l2_term(w, l2)

    def grad(self, w: Tensor, data, l2=0.0) -> Tensor:
        return self.value_and_grad(w, data, l2)[1]

    def hvp_operator(self, w: Tensor, data, l2=0.0):
        """``v ↦ Hv``: each block's product (kernel 3 on a dense block, its
        curvature weights computed once here) summed over the blocks, then
        the L2 curvature."""
        reg = self.objective.reg_curvature(l2)
        if self.mesh is None:
            local = self.objective.hvp_operator(w, data, 0.0)

            def apply(v: Tensor) -> Tensor:
                return _all_reduce(local(v)) + reg * v

            return apply
        ops = []
        for blk in data.blocks:
            with on_slot(_slot(blk)):
                ops.append(self.objective.hvp_operator(
                    w.to(_slot(blk)), blk, 0.0))

        def apply_mesh(v: Tensor) -> Tensor:
            parts = []
            for op, blk in zip(ops, data.blocks):
                with on_slot(_slot(blk)):
                    parts.append(op(v.to(_slot(blk))))
            return _sum_in_slot_order(parts).to(v.device) + reg * v

        return apply_mesh

    def hvp(self, w: Tensor, v: Tensor, data, l2=0.0) -> Tensor:
        return self.hvp_operator(w, data, l2)(v)

    def margins(self, w: Tensor, data) -> Tensor:
        """The margins of this rank's rows; on the mesh, every block's in
        the stacked ``(n_shards, rows_per_shard)`` layout on the first
        slot."""
        if self.mesh is None:
            return self.objective.margins(w, data)
        out = []
        for blk in data.blocks:
            with on_slot(_slot(blk)):
                out.append(self.objective.margins(w.to(_slot(blk)), blk)
                           .to(data.device))
        return torch.stack(out)

    def hessian_diagonal(self, w: Tensor, data, l2=0.0) -> Tensor:
        """Variance type SIMPLE over every block's rows."""
        diag = self._sum(lambda wv, blk: self.objective.hessian_diagonal(
            wv, blk, 0.0), w, data)
        return diag + self.objective.reg_curvature(l2)

    def hessian_matrix(self, w: Tensor, data, l2=0.0) -> Tensor:
        """Variance type FULL over every block's rows."""
        h = self._sum(lambda wv, blk: self.objective.hessian_matrix(
            wv, blk, 0.0), w, data)
        reg = torch.broadcast_to(torch.as_tensor(
            self.objective.reg_curvature(l2), dtype=h.dtype,
            device=h.device), h.shape[:-1])
        return h + torch.diag_embed(reg)


# ---------------------------------------------------------------------------
# The feature axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColumnBlocks:
    """A design cut by columns: ``blocks[j]`` (a dense or COO design of
    ``cols_per_block`` columns) lives on slot ``j``. ``matvec`` adds the
    blocks' partial margins in slot order on the first slot; ``rmatvec``
    computes each block's part of the gradient on its slot and concatenates
    the parts there."""

    blocks: tuple

    @property
    def cols_per_block(self) -> int:
        return self.blocks[0].dim

    @property
    def n_samples(self) -> int:
        return self.blocks[0].n_samples

    @property
    def dim(self) -> int:
        return len(self.blocks) * self.cols_per_block

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    def matvec(self, w: Tensor) -> Tensor:
        per = self.cols_per_block
        parts = []
        for j, blk in enumerate(self.blocks):
            with on_slot(blk.device):
                parts.append(blk.matvec(
                    w[..., j * per:(j + 1) * per].to(blk.device)))
        return _sum_in_slot_order(parts)

    def rmatvec(self, g: Tensor) -> Tensor:
        parts = []
        for blk in self.blocks:
            with on_slot(blk.device):
                parts.append(blk.rmatvec(g.to(blk.device)).to(self.device))
        return torch.cat(parts, dim=-1)


def shard_glm_data_features(data: GLMData, n_shards: int, *,
                            device_put_mesh: Optional[Mesh] = None,
                            axis: str = FEATURE_AXIS
                            ) -> tuple[GLMData, int]:
    """Split a :class:`GLMData`'s FEATURE dimension into ``n_shards``
    column blocks. Returns ``(sharded, d_pad)``: ``d_pad`` is the feature
    dimension padded to a multiple of ``n_shards``; solve in the padded
    dimension (padded columns are all-zero, so their coefficients stay 0
    from a zero start) and cut the model back to ``data.dim``.

    The design becomes a :class:`ColumnBlocks`: a dense design's columns
    ``[j·per, (j+1)·per)``, or a COO design's entries of those columns with
    block-local column ids, padded with value-0 entries to the largest
    block's count (the JAX package's stacked ``(n_shards, budget)``
    layout). With ``device_put_mesh`` block ``j`` goes to the slot of
    ``axis`` index ``j`` and the labels, offsets and weights to the first
    slot; without it everything stays on the CPU."""
    d = data.dim
    per = math.ceil(d / n_shards)
    d_pad = per * n_shards
    slots = ((torch.device("cpu"),) * n_shards if device_put_mesh is None
             else device_put_mesh.axis_devices(axis))
    if len(slots) != n_shards:
        raise ValueError(f"{n_shards} column blocks for a {axis!r} axis of "
                         f"{len(slots)} slots")
    design = data.design
    if isinstance(design, DenseDesign):
        x = design.x.detach().cpu()
        xp = torch.zeros((x.shape[0], d_pad), dtype=x.dtype)
        xp[:, :d] = x
        blocks = tuple(
            DenseDesign(x=xp[:, j * per:(j + 1) * per].contiguous().to(dev))
            for j, dev in enumerate(slots))
    elif isinstance(design, CsrDesign):
        rows = _host(design.rows).astype(np.int64)
        cols = _host(design.cols).astype(np.int64)
        vals = _host(design.values)
        block_of = cols // per
        counts = np.bincount(block_of, minlength=n_shards)
        budget = int(counts.max()) if counts.size else 0
        out = []
        for j, dev in enumerate(slots):
            sel = block_of == j
            k = int(counts[j])
            r = np.zeros(budget, np.int64)
            c = np.zeros(budget, np.int64)
            v = np.zeros(budget, vals.dtype)
            r[:k], c[:k], v[:k] = rows[sel], cols[sel] % per, vals[sel]
            out.append(CsrDesign(
                rows=torch.as_tensor(r, device=dev),
                cols=torch.as_tensor(c, device=dev),
                values=torch.as_tensor(v, device=dev),
                n_rows=design.n_rows, n_cols=per))
        blocks = tuple(out)
    else:
        raise TypeError(type(design))
    first = slots[0]
    return GLMData(
        design=ColumnBlocks(blocks=blocks),
        labels=torch.as_tensor(data.labels).to(first),
        offsets=torch.as_tensor(data.offsets).to(first),
        weights=torch.as_tensor(data.weights).to(first)), d_pad


@dataclasses.dataclass(frozen=True)
class FeatureShardedGLMObjective:
    """The fixed-effect objective with the COEFFICIENT dimension sharded:
    a drop-in for :class:`~photon_ml_tpu_torch.ops.objective.GLMObjective`
    over data from :func:`shard_glm_data_features`. ``w`` is whole on the
    first slot, so L-BFGS, OWL-QN and TRON run unchanged; each slot touches
    only its column block. The derivatives are the closed forms ``g =
    Xᵀ(weight·l')`` and ``Hv = Xᵀ(weight·l''·Xv)`` over the column blocks:
    one sum of partial margins forward, one assembly of the gradient back.
    Identity normalization only (the normalization is a per-feature
    transform: fold it into the data before sharding)."""

    objective: GLMObjective
    mesh: Mesh
    axis: str = FEATURE_AXIS

    def __post_init__(self):
        if not self.objective.normalization.is_identity:
            raise ValueError(
                "feature-sharded objective requires identity normalization; "
                "pre-transform the design instead")

    def _padded(self, w: Tensor) -> GLMObjective:
        """The wrapped objective with its 0/1 mask padded to the padded
        dimension (padded coefficients are regularized like none)."""
        mask = self.objective.reg_mask
        if mask is not None and mask.shape[-1] < w.shape[-1]:
            mask = torch.cat([mask.to(w.device), torch.zeros(
                w.shape[-1] - mask.shape[-1], dtype=mask.dtype,
                device=w.device)])
            return dataclasses.replace(self.objective, reg_mask=mask)
        return self.objective

    def value_and_grad(self, w: Tensor, data: GLMData, l2=0.0):
        return self._padded(w)._closed_value_and_grad(w, data, l2)

    def value(self, w: Tensor, data: GLMData, l2=0.0) -> Tensor:
        return self._padded(w).value(w, data, l2)

    def grad(self, w: Tensor, data: GLMData, l2=0.0) -> Tensor:
        return self.value_and_grad(w, data, l2)[1]

    def hvp_operator(self, w: Tensor, data: GLMData, l2=0.0):
        return self._padded(w).hvp_operator(w, data, l2)

    def hvp(self, w: Tensor, v: Tensor, data: GLMData, l2=0.0) -> Tensor:
        return self.hvp_operator(w, data, l2)(v)

    def margins(self, w: Tensor, data: GLMData) -> Tensor:
        return self.objective.margins(w, data)
