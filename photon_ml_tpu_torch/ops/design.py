"""Dense design matrix (counterpart of ``photon_ml_tpu/ops/design.py``'s
``DenseDesign``; the sparse designs are not ported yet)."""

from __future__ import annotations

import dataclasses

import torch


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

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        """Margins ``X @ w``, accumulated in at least f32 (a bf16 design is
        upcast explicitly: a bf16 matmul would return rounded bf16 margins)."""
        acc = accumulation_dtype(self.x.dtype)
        return torch.einsum("...nd,...d->...n", self.x.to(acc), w.to(acc))

    def rmatvec(self, g: torch.Tensor) -> torch.Tensor:
        acc = accumulation_dtype(self.x.dtype)
        return torch.einsum("...nd,...n->...d", self.x.to(acc), g.to(acc))
