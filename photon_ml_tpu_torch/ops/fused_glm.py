"""Fused GLM value + gradient in one pass over a dense design: the CUDA
kernel (``csrc/fused_glm.cu``) and its plain PyTorch version.

Counterpart of ``photon_ml_tpu/ops/pallas_glm.py::fused_value_and_grad``.
:func:`fused_value_and_grad` launches the kernel for tensors on a CUDA
device and runs :func:`fused_value_and_grad_plain` for tensors on the CPU;
there is no fallback from one to the other. The kernel takes any ``(n, d)``
shape (it masks its own ragged edges), so there is no block-size gate.
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_tpu_torch.ops import cuda_build
from photon_ml_tpu_torch.ops.design import accumulation_dtype
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

#: blocks of the partials pass, at most: the cross-block fold order — and so
#: every bit of the result — depends on n only, never on the card
MAX_BLOCKS = 1056
#: rows per block below which fewer blocks are used
MIN_ROWS_PER_BLOCK = 256
_P = cuda_build.PTR
_SIGNATURE = {"photon_fused_glm_value_and_grad": (
    ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, _P, _P, _P)}


def fused_value_and_grad_plain(loss: PointwiseLoss, x, w, labels, offsets,
                               weights):
    """``(value, grad)`` of ``Σ_i weights_i·loss(x_i·w + offsets_i, y_i)``
    with the kernel's arithmetic in PyTorch: ``w`` and ``weights·d1`` are
    rounded to the design's dtype before their products (a no-op for f32,
    the bf16 rounding of the TPU kernel for bf16), products accumulate in at
    least f32, and weight-0 rows are evaluated at margin 0 and zeroed."""
    acc = accumulation_dtype(x.dtype)
    xf = x.to(acc)
    m = xf @ w.to(x.dtype).to(acc) + offsets.to(acc)
    live = weights > 0
    m_safe = torch.where(live, m, torch.zeros_like(m))
    zero = torch.zeros_like(m)
    value = torch.where(live, weights * loss.loss(m_safe, labels), zero).sum()
    dvec = torch.where(live, loss.d1(m_safe, labels) * weights, zero)
    grad = dvec.to(x.dtype).to(acc) @ xf
    return value, grad


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
    n_blocks = min(MAX_BLOCKS, -(-n // MIN_ROWS_PER_BLOCK))
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

