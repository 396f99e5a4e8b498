"""Fused GLM value + gradient in one pass over a dense design: the CUDA
kernels (``csrc/fused_glm.cu`` for one coefficient vector,
``csrc/fused_glm_multi.cu`` for M of them) and their plain PyTorch version.

Counterparts of ``photon_ml_tpu/ops/pallas_glm.py::fused_value_and_grad``
and ``::fused_value_and_grad_multi`` (the batched lambda sweep's kernel,
which the JAX package reaches through the ``custom_vmap`` rule of
``vmappable_value_and_grad``; here ``GLMObjective`` calls it for ``w``
``(M, d)`` against an ``(n, d)`` design). Each wrapper launches its kernel
for tensors on a CUDA device and runs :func:`fused_value_and_grad_plain`
for tensors on the CPU; there is no fallback from one to the other. The
kernels take any ``(n, d)`` shape (they mask their own ragged edges), so
there is no block-size gate.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from photon_ml_tpu_torch.ops import cuda_build
from photon_ml_tpu_torch.ops.design import accumulation_dtype
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

#: the plan of kernels 1 and 3 (csrc/fused_glm.cu, csrc/fused_hvp.cu),
#: which share two bodies: blocks of 256 threads (8 warps),
#: two for each of an H100's 132 SMs once n is large. Rows of at most
#: GLM_NARROW_MAX_D columns take the narrow body (a thread a row, tiles of
#: 256 rows staged in a ring of 2-4 slots; a block gets one tile at least);
#: wider ones the wide body (a warp a row, the row held in registers up to
#: 1024 columns; a warp gets GLM_WIDE_WARP_ROWS rows at least)
GLM_THREADS = 256
GLM_MAX_BLOCKS = 264
GLM_NARROW_MAX_D = 64
GLM_TILE_ROWS = GLM_THREADS
GLM_MAX_STAGES = 4
GLM_WIDE_WARP_ROWS = 4
#: shared memory of a block such that two fit an SM (228 KiB an SM, 1 KiB
#: of it reserved per block): ``kTwoBlockSmemBytes`` of csrc/cp_async.cuh
TWO_BLOCK_SMEM_BYTES = 233_472 // 2 - 1024
#: kernel 4's blocks, at most
MULTI_MAX_BLOCKS = 264
#: rows per block below which fewer blocks are used
MIN_ROWS_PER_BLOCK = 256
_P = cuda_build.PTR
_SIGNATURE = {"photon_fused_glm_value_and_grad": (
    ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, _P, _P, _P)}
_MULTI_SIGNATURE = {"photon_fused_glm_value_and_grad_multi": (
    ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P)}


class Work(NamedTuple):
    """A kernel launch's analytic work: the f32 operations it does and the
    bytes it must move (each input read once, each output written once).
    ``chip_smoke.py`` divides them by the card's rates for the launch's
    least time; the telemetry plane sums them per profiled call
    (``photon_flops_total`` / ``photon_bytes_accessed_total``)."""

    ops: float
    nbytes: float


def work(n_live: int, n_rows: int, d: int, itemsize: int, n_out: int,
         lanes: int = 1) -> Work:
    """One evaluation of kernel 1 (``n_out`` = ``lanes`` = 1), kernel 4
    (``n_out`` = ``lanes`` = M coefficient rows sharing X) or kernel 2
    (``n_out`` = E entities, through ``fused_re.work``): X's ``n_live``
    live rows (weight > 0) and their label and offset read once, every
    row's weight read once, the ``n_out`` coefficient rows read and the
    outputs (a gradient row and a value each) written once; ~4 f32
    operations per element of the live rows plus ~10 per live row for the
    loss, for each of the ``lanes`` coefficient rows."""
    nbytes = (n_live * d * itemsize + n_live * 8 + n_rows * 4
              + n_out * d * 4 + n_out * (d + 1) * 4)
    return Work(float(lanes * (4.0 * n_live * d + 10.0 * n_live)),
                float(nbytes))


def fused_value_and_grad_plain(loss: PointwiseLoss, x, w, labels, offsets,
                               weights):
    """``(value, grad)`` of ``Σ_i weights_i·loss(x_i·w + offsets_i, y_i)``
    with the kernels' arithmetic in PyTorch: ``w`` and ``weights·d1`` are
    rounded to the design's dtype before their products (a no-op for f32,
    the bf16 rounding of the TPU kernels for bf16), products accumulate in
    at least f32, and weight-0 rows are evaluated at margin 0 and zeroed.
    ``w`` ``(d,)`` gives kernel 1's ``(value (), grad (d,))``; ``w``
    ``(M, d)`` kernel 4's ``(values (M,), grads (M, d))``."""
    acc = accumulation_dtype(x.dtype)
    xf = x.to(acc)
    wq = w.to(x.dtype).to(acc)
    m = (xf @ wq if w.dim() == 1 else wq @ xf.T) + offsets.to(acc)
    live = weights > 0
    m_safe = torch.where(live, m, torch.zeros_like(m))
    zero = torch.zeros_like(m)
    value = torch.where(live, weights * loss.loss(m_safe, labels),
                        zero).sum(-1)
    dvec = torch.where(live, loss.d1(m_safe, labels) * weights, zero)
    grad = dvec.to(x.dtype).to(acc) @ xf
    return value, grad


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def tile_slot_bytes(d: int, itemsize: int) -> int:
    """Bytes of a narrow-body ring slot's design tile (``slot_x_bytes`` of
    csrc/fused_glm.cu and csrc/fused_hvp.cu): a 256-row tile's span as
    16-byte granules, and 16 bytes of lead room."""
    return _round_up(GLM_TILE_ROWS * d * itemsize, 16) + 16


def narrow_smem_bytes(d: int, itemsize: int, stages: int) -> int:
    """Dynamic shared memory of a narrow-body block of kernel 1
    (``narrow_smem_bytes`` of csrc/fused_glm.cu): ``stages`` ring slots of
    a 256-row tile with its y, off, wt; then w, the tile's dv, the value
    reduction and the row groups' gradient sums, all f32."""
    return stages * (tile_slot_bytes(d, itemsize) + 3 * GLM_TILE_ROWS * 4) \
        + 4 * (_round_up(d, 4) + GLM_TILE_ROWS + 2 * GLM_THREADS)


def wide_smem_bytes(d: int, warps: int) -> int:
    """Dynamic shared memory of a wide-body block of kernel 1
    (``wide_smem_bytes`` of csrc/fused_glm.cu): w, a gradient partial and
    a value per warp, all f32."""
    return 4 * (d + warps * d + warps)


class GlmPlan(NamedTuple):
    """How kernel 1 (:func:`glm_plan`) or kernel 3
    (``fused_hvp.hvp_plan``) covers an ``(n, d)`` design."""

    body: str  # "narrow" (a thread a row) or "wide" (a warp a row)
    blocks: int  # blocks, each owning a contiguous range of rows
    warps: int  # warps a block
    stages: int  # ring slots (narrow body; 0 for the wide one)
    smem_bytes: int  # dynamic shared memory a block


def body_plan(n: int, d: int, itemsize: int, narrow_smem,
              wide_smem) -> GlmPlan:
    """The plan of the two bodies kernels 1 and 3 share, given a body's
    shared memory (``narrow_smem(d, itemsize, stages)``,
    ``wide_smem(d, warps)``). The block count depends on the shape (n, d)
    alone, never on the dtype, so the fold order, and every bit of the
    result, does too; the body depends on d alone. ``warps`` 0 means the
    row is too wide for a block's shared memory."""
    if d <= GLM_NARROW_MAX_D:
        stages = next((st for limit in (TWO_BLOCK_SMEM_BYTES,
                                        cuda_build.MAX_BLOCK_SMEM_BYTES)
                       for st in range(GLM_MAX_STAGES, 1, -1)
                       if narrow_smem(d, itemsize, st) <= limit), 0)
        return GlmPlan("narrow", min(GLM_MAX_BLOCKS, -(-n // GLM_TILE_ROWS)),
                       GLM_THREADS // 32, stages,
                       narrow_smem(d, itemsize, stages))
    warps = next((k for k in range(GLM_THREADS // 32, 0, -1)
                  if wide_smem(d, k) <= cuda_build.MAX_BLOCK_SMEM_BYTES), 0)
    blocks = min(GLM_MAX_BLOCKS,
                 -(-n // (GLM_WIDE_WARP_ROWS * max(warps, 1))))
    return GlmPlan("wide", blocks, warps, 0, wide_smem(d, warps))


def glm_plan(n: int, d: int, itemsize: int) -> GlmPlan:
    """Kernel 1's plan, as csrc/fused_glm.cu computes it
    (:func:`body_plan`)."""
    return body_plan(n, d, itemsize, narrow_smem_bytes, wide_smem_bytes)


def multi_blocks(n: int) -> int:
    """Blocks of kernel 4: two 8-warp blocks for each of an H100's 132
    SMs once n is large, fewer for small n. A function of n alone, so the
    fold order, and every bit of the result, is too."""
    return min(MULTI_MAX_BLOCKS, -(-n // MIN_ROWS_PER_BLOCK))


def fused_value_and_grad(loss: PointwiseLoss, x, w, labels, offsets, weights):
    """``(value (), grad (d,))`` — the kernel on a CUDA device, the plain
    version on the CPU. ``x`` is ``(n, d)`` f32 or bf16; ``w`` ``(d,)`` and
    the ``(n,)`` vectors f32, all contiguous on one device."""
    if x.device.type == "cpu":
        return fused_value_and_grad_plain(loss, x, w, labels, offsets,
                                          weights)
    if x.device.type != "cuda":
        raise ValueError(f"fused_value_and_grad: unsupported device {x.device}")
    n, d = cuda_build.check_args(
        "fused_value_and_grad", x, "nd", w=(w, "d"), labels=(labels, "n"),
        offsets=(offsets, "n"), weights=(weights, "n"))
    out = torch.empty(d + 1, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        out.zero_()
        return out[d], out[:d]
    n_blocks = glm_plan(n, d, x.element_size()).blocks
    scratch = torch.empty((n_blocks, d + 1), dtype=torch.float32,
                          device=x.device)
    lib = cuda_build.load("fused_glm", _SIGNATURE)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.photon_fused_glm_value_and_grad(
        loss.kernel_id, cuda_build.DTYPE_IDS[x.dtype], x.data_ptr(), w.data_ptr(),
        labels.data_ptr(), offsets.data_ptr(), weights.data_ptr(), n, d,
        n_blocks, scratch.data_ptr(), out.data_ptr(), stream)
    cuda_build.check("fused_glm", code)
    fused_value_and_grad.launches += 1
    return out[d], out[:d]


#: kernel launches made by :func:`fused_value_and_grad` in this process
fused_value_and_grad.launches = 0


def fused_value_and_grad_multi(loss: PointwiseLoss, x, ws, labels, offsets,
                               weights):
    """``(values (M,), grads (M, d))`` for M coefficient rows ``ws``
    ``(M, d)`` over one pass of ``x`` — kernel 4 on a CUDA device, the
    plain version on the CPU. ``x`` is ``(n, d)`` f32 or bf16, the ``(n,)``
    vectors f32, all contiguous on one device; ``d`` at most
    :func:`cuda_build.max_row_width` of ``M`` on the card."""
    if ws.dim() != 2 or ws.shape[0] == 0:
        raise ValueError("fused_value_and_grad_multi: ws must be (M, d) with "
                         f"M >= 1, got {tuple(ws.shape)}")
    if x.device.type == "cpu":
        return fused_value_and_grad_plain(loss, x, ws, labels, offsets,
                                          weights)
    if x.device.type != "cuda":
        raise ValueError(
            f"fused_value_and_grad_multi: unsupported device {x.device}")
    lanes = ws.shape[0]
    n, d = cuda_build.check_args(
        "fused_value_and_grad_multi", x, "nd", lanes=lanes,
        ws=(ws, "md"), labels=(labels, "n"), offsets=(offsets, "n"),
        weights=(weights, "n"))
    out = torch.empty(lanes * (d + 1), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        out.zero_()
        return out[lanes * d:], out[:lanes * d].view(lanes, d)
    n_blocks = multi_blocks(n)
    scratch = torch.empty((n_blocks, lanes * (d + 1)), dtype=torch.float32,
                          device=x.device)
    lib = cuda_build.load("fused_glm_multi", _MULTI_SIGNATURE)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.photon_fused_glm_value_and_grad_multi(
        loss.kernel_id, cuda_build.DTYPE_IDS[x.dtype], x.data_ptr(),
        ws.data_ptr(), labels.data_ptr(), offsets.data_ptr(),
        weights.data_ptr(), n, d, lanes, n_blocks, scratch.data_ptr(),
        out.data_ptr(), stream)
    cuda_build.check("fused_glm_multi", code)
    fused_value_and_grad_multi.launches += 1
    return out[lanes * d:], out[:lanes * d].view(lanes, d)


#: kernel launches made by :func:`fused_value_and_grad_multi` in this process
fused_value_and_grad_multi.launches = 0
