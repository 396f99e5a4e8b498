"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W) and the
roofline arithmetic over them.

The GLM kernels run f32 arithmetic outside the tensor cores and are bound
by HBM bandwidth, so a share of the peak is taken against the roofline of
HBM bytes/s and f32 FLOP/s, not against the bf16 tensor-core rate. A card
set below 700 W runs below these peaks; each run records its
``power.limit`` beside them.
"""

from __future__ import annotations

#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: f32 FLOP/s outside the tensor cores
F32_OPS_PER_S = 67e12
#: the power limit the peaks assume, W
PEAK_POWER_W = 700.0


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, what binds): bytes over the HBM rate or f32
    operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
