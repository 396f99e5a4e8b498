"""Entity-batched GLM value + gradient in one pass over a random-effect
bucket: the CUDA kernel (``csrc/fused_re.cu``) and its plain PyTorch version.

Counterpart of ``photon_ml_tpu/ops/pallas_re.py::fused_entity_value_and_grad``
(reached there through the ``custom_vmap`` rule of the bucket solve; here
the batched L-BFGS calls it directly with the entity lanes as the leading
dimension). The kernel takes any ``(E, S, D)`` shape, so the TPU's VMEM
block plan and its entity padding have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_tpu_torch.ops import cuda_build
from photon_ml_tpu_torch.ops.design import accumulation_dtype
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

_P = cuda_build.PTR
_SIGNATURE = {"photon_fused_entity_value_and_grad": (
    ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, _P, _P, _P)}


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
                                weights):
    """``(values (E,), grads (E, D))`` — the kernel on a CUDA device, the
    plain version on the CPU. ``x`` is ``(E, S, D)`` f32 or bf16; ``ws``
    ``(E, D)`` and the ``(E, S)`` arrays f32, all contiguous on one device."""
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
    lib = cuda_build.load("fused_re", _SIGNATURE)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.photon_fused_entity_value_and_grad(
        loss.kernel_id, cuda_build.DTYPE_IDS[x.dtype], x.data_ptr(), ws.data_ptr(),
        labels.data_ptr(), offsets.data_ptr(), weights.data_ptr(), e, s, d,
        values.data_ptr(), grads.data_ptr(), stream)
    cuda_build.check("fused_re", code)
    fused_entity_value_and_grad.launches += 1
    return values, grads


#: kernel launches made by :func:`fused_entity_value_and_grad` in this process
fused_entity_value_and_grad.launches = 0

