"""Entity-batched GLM value + gradient in one pass over a random-effect
bucket: the CUDA kernel (``csrc/fused_re.cu``) and its plain PyTorch version.

Counterpart of ``photon_ml_tpu/ops/pallas_re.py::fused_entity_value_and_grad``
(reached there through the ``custom_vmap`` rule of the bucket solve; here
the batched L-BFGS calls it directly with the entity lanes as the leading
dimension). The kernel takes any ``(E, S, D)`` shape up to
:data:`cuda_build.MAX_ROW_WIDTH` columns; its own block plan,
:func:`entity_plan`, splits each entity's rows into chunks, so the TPU's
VMEM block plan and its entity padding have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from photon_ml_tpu_torch.ops import cuda_build, fused_glm
from photon_ml_tpu_torch.ops.design import accumulation_dtype
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

_P = cuda_build.PTR
_I = ctypes.c_int
_SIGNATURE = {"photon_fused_entity_value_and_grad": (
    _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P)}

#: threads of a kernel-2 block (csrc/fused_re.cu ``kThreads``)
BLOCK_THREADS = 256
#: widest row of kernel 2's one-thread-per-row body (``kMaxNarrow``);
#: wider rows take the row-group body, one block per unit
NARROW_MAX_D = 16
#: blocks a bucket is spread over where its rows allow: two for each of an
#: H100's 132 SMs
TARGET_BLOCKS = 264
#: rows a chunk of a split entity holds, at least
MIN_CHUNK_ROWS = 256


class EntityPlan(NamedTuple):
    """How kernel 2 cuts an (E, S, D) bucket: each entity's S rows into
    ``chunks`` chunks of ``chunk_rows`` rows (the last one shorter); one
    (entity, chunk) unit is served by ``unit_threads`` threads, so a block
    serves ``BLOCK_THREADS // unit_threads`` units; ``blocks`` blocks."""

    chunks: int
    chunk_rows: int
    unit_threads: int
    blocks: int


def entity_plan(e: int, s: int, d: int,
                plan_lanes: Optional[int] = None) -> EntityPlan:
    """Kernel 2's chunk plan for an (E, S, D) bucket, a function of the
    shape alone (so the fold order, and every bit of the result, is too).
    Entities are split into chunks of at least MIN_CHUNK_ROWS rows until
    the bucket has about TARGET_BLOCKS units: a head bucket of a few
    entities with ~10^5 rows each covers the card. Narrow rows (D <=
    NARROW_MAX_D) get one thread per row, the smallest power of two of
    threads covering a chunk, so many small entities share a block; wider
    rows get a block per unit. ``plan_lanes`` (default ``e``) is the lane
    count the rows are chunked for: a slice of a bucket passes the whole
    bucket's, so each entity's rows fold as they do in the whole bucket
    (the slice's blocks still cover its own ``e`` lanes)."""
    lanes = e if plan_lanes is None else plan_lanes
    chunks = max(1, min(-(-TARGET_BLOCKS // max(lanes, 1)),
                        -(-s // MIN_CHUNK_ROWS)))
    chunk_rows = max(1, -(-s // chunks))
    chunks = max(1, -(-s // chunk_rows))
    unit_threads = BLOCK_THREADS
    if d <= NARROW_MAX_D:
        unit_threads = 1
        while unit_threads < min(chunk_rows, BLOCK_THREADS):
            unit_threads <<= 1
    units = e * chunks
    return EntityPlan(chunks, chunk_rows, unit_threads,
                      -(-units // (BLOCK_THREADS // unit_threads)))


def work(n_live: int, e: int, s: int, d: int, itemsize: int):
    """One evaluation of kernel 2 over an (E, S, D) bucket with ``n_live``
    live rows in all: kernel 1's count (``fused_glm.work``) over the
    bucket's E·S rows with E coefficient rows and outputs."""
    return fused_glm.work(n_live, e * s, d, itemsize, e)


def fused_entity_value_and_grad_plain(loss: PointwiseLoss, x, ws, labels,
                                      offsets, weights):
    """``(values (E,), grads (E, D))`` of the per-entity objectives
    ``Σ_s weights[e,s]·loss(x[e,s]·ws[e] + offsets[e,s], labels[e,s])`` with
    the kernel's arithmetic: the design is upcast after the load and all
    maths is in at least f32; weight-0 rows are evaluated at margin 0 and
    zeroed."""
    acc = accumulation_dtype(x.dtype)
    xf = x.to(acc)
    m = torch.einsum("esd,ed->es", xf, ws.to(acc)) + offsets.to(acc)
    live = weights > 0
    zero = torch.zeros_like(m)
    m_safe = torch.where(live, m, zero)
    values = torch.where(live, weights * loss.loss(m_safe, labels),
                         zero).sum(dim=1)
    dvec = torch.where(live, loss.d1(m_safe, labels) * weights, zero)
    grads = torch.einsum("es,esd->ed", dvec, xf)
    return values, grads


def fused_entity_value_and_grad(loss: PointwiseLoss, x, ws, labels, offsets,
                                weights, plan_lanes: Optional[int] = None):
    """``(values (E,), grads (E, D))`` — the kernel on a CUDA device, the
    plain version on the CPU. ``x`` is ``(E, S, D)`` f32 or bf16; ``ws``
    ``(E, D)`` and the ``(E, S)`` arrays f32, all contiguous on one device.
    ``plan_lanes``: see :func:`entity_plan`."""
    if x.device.type == "cpu":
        return fused_entity_value_and_grad_plain(loss, x, ws, labels,
                                                 offsets, weights)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_entity_value_and_grad: unsupported device {x.device}")
    e, s, d = cuda_build.check_args(
        "fused_entity_value_and_grad", x, "esd", ws=(ws, "ed"),
        labels=(labels, "es"), offsets=(offsets, "es"),
        weights=(weights, "es"))
    values = torch.empty(e, dtype=torch.float32, device=x.device)
    grads = torch.empty((e, d), dtype=torch.float32, device=x.device)
    if e == 0 or s == 0 or d == 0:
        return values.zero_(), grads.zero_()
    plan = entity_plan(e, s, d, plan_lanes)
    partials = torch.empty(
        (e, plan.chunks, d + 1) if plan.chunks > 1 else (0,),
        dtype=torch.float32, device=x.device)
    lib = cuda_build.load("fused_re", _SIGNATURE)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.photon_fused_entity_value_and_grad(
        loss.kernel_id, cuda_build.DTYPE_IDS[x.dtype], x.data_ptr(), ws.data_ptr(),
        labels.data_ptr(), offsets.data_ptr(), weights.data_ptr(), e, s, d,
        *plan, partials.data_ptr(), values.data_ptr(), grads.data_ptr(),
        stream)
    cuda_build.check("fused_re", code)
    fused_entity_value_and_grad.launches += 1
    return values, grads


#: kernel launches made by :func:`fused_entity_value_and_grad` in this process
fused_entity_value_and_grad.launches = 0

