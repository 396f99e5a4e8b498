"""GLM Hessian-vector product in one pass over a dense design: the CUDA
kernel (``csrc/fused_hvp.cu``) and its plain PyTorch version.

Counterpart of ``photon_ml_tpu/ops/pallas_glm.py::fused_hvp``: TRON's inner
conjugate-gradient solve asks for ``Xᵀ(d2w ∘ (X v))`` many times at one
``d2w`` (the per-row weight·loss'' at the current coefficients, computed
once per Newton step by ``GLMObjective.hvp_operator``, which also adds the
L2 curvature). :func:`fused_hvp` launches the kernel for tensors on a CUDA
device and runs :func:`fused_hvp_plain` for tensors on the CPU; there is no
fallback from one to the other. The kernel takes kernel 1's two bodies
(``csrc/fused_glm.cu``) and their plan, :func:`hvp_plan`.
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_tpu_torch.ops import cuda_build
from photon_ml_tpu_torch.ops.design import accumulation_dtype
from photon_ml_tpu_torch.ops.fused_glm import (
    GLM_THREADS,
    GLM_TILE_ROWS,
    GlmPlan,
    Work,
    body_plan,
    tile_slot_bytes,
)

_P = cuda_build.PTR
_SIGNATURE = {"photon_fused_hvp": (
    ctypes.c_int, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P,
    _P, _P)}


def work(n_live: int, n_rows: int, d: int, itemsize: int) -> Work:
    """One product of kernel 3: the ``n_live`` rows it reads (those of
    nonzero curvature; rows of d2w = 0 are skipped) read once, every row's
    d2w read once, v read and the output written once; 4 f32 operations
    per element of those rows."""
    return Work(4.0 * n_live * d,
                float(n_live * d * itemsize + n_rows * 4 + 2 * d * 4))


def fused_hvp_plain(x, v, d2w):
    """``Xᵀ(d2w ∘ (X v))`` with the kernel's arithmetic in PyTorch: ``v``
    and ``d2w·(X v)`` are rounded to the design's dtype before their
    products (a no-op for f32, the TPU kernel's bf16 rounding for bf16),
    products accumulate in at least f32, and a row whose ``d2w`` is 0
    contributes exactly 0 whatever its x."""
    acc = accumulation_dtype(x.dtype)
    xf = x.to(acc)
    t = xf @ v.to(x.dtype).to(acc)
    c = torch.where(d2w != 0, d2w.to(acc) * t, torch.zeros_like(t))
    return c.to(x.dtype).to(acc) @ xf


def narrow_smem_bytes(d: int, itemsize: int, stages: int) -> int:
    """Dynamic shared memory of a narrow-body block of kernel 3
    (``narrow_smem_bytes`` of csrc/fused_hvp.cu): ``stages`` ring slots of
    a 256-row tile with its d2w; then v, the tile's c and the row groups'
    output sums, all f32."""
    return stages * (tile_slot_bytes(d, itemsize) + GLM_TILE_ROWS * 4) \
        + 4 * (-(-d // 4) * 4 + GLM_TILE_ROWS + GLM_THREADS)


def wide_smem_bytes(d: int, warps: int) -> int:
    """Dynamic shared memory of a wide-body block of kernel 3
    (``wide_smem_bytes`` of csrc/fused_hvp.cu): v and an output partial per
    warp, all f32."""
    return 4 * (d + warps * d)


def hvp_plan(n: int, d: int, itemsize: int) -> GlmPlan:
    """Kernel 3's plan, as csrc/fused_hvp.cu computes it: kernel 1's
    (``fused_glm.body_plan``) with kernel 3's shared memory. The block
    count depends on (n, d) alone, so TRON's CG products are bit-identical
    from run to run."""
    return body_plan(n, d, itemsize, narrow_smem_bytes, wide_smem_bytes)


def fused_hvp(x, v, d2w):
    """``(d,)`` ``Xᵀ(d2w ∘ (X v))`` — the kernel on a CUDA device, the plain
    version on the CPU. ``x`` is ``(n, d)`` f32 or bf16; ``v`` ``(d,)`` and
    ``d2w`` ``(n,)`` f32, all contiguous on one device."""
    if x.device.type == "cpu":
        return fused_hvp_plain(x, v, d2w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_hvp: unsupported device {x.device}")
    n, d = cuda_build.check_args("fused_hvp", x, "nd", v=(v, "d"),
                                 d2w=(d2w, "n"))
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out.zero_()
    n_blocks = hvp_plan(n, d, x.element_size()).blocks
    scratch = torch.empty((n_blocks, d), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("fused_hvp", _SIGNATURE)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.photon_fused_hvp(
        cuda_build.DTYPE_IDS[x.dtype], x.data_ptr(), v.data_ptr(),
        d2w.data_ptr(), n, d, n_blocks, scratch.data_ptr(), out.data_ptr(),
        stream)
    cuda_build.check("fused_hvp", code)
    fused_hvp.launches += 1
    return out


#: kernel launches made by :func:`fused_hvp` in this process
fused_hvp.launches = 0
