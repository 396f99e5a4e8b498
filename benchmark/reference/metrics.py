"""Plain validation metrics of the references, in float64 PyTorch."""

from __future__ import annotations

import torch

F64 = torch.float64


def auc(scores: torch.Tensor, labels: torch.Tensor) -> float:
    """Area under the ROC curve of ``scores`` against 0/1 ``labels``, a tie
    between a positive and a negative counting half: the Mann-Whitney
    statistic over average ranks."""
    s = scores.to(F64)
    order = torch.argsort(s)
    s, y = s[order], labels.to(F64)[order]
    _, group, counts = torch.unique_consecutive(s, return_inverse=True,
                                                return_counts=True)
    ends = torch.cumsum(counts, 0).to(F64)
    ranks = (ends - (counts.to(F64) - 1.0) / 2.0)[group]
    n_pos = y.sum()
    n_neg = y.numel() - n_pos
    return float(((ranks * y).sum() - n_pos * (n_pos + 1.0) / 2.0)
                 / (n_pos * n_neg))
