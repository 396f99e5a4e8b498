"""Single-metric implementations: AUC, RMSE, average pointwise loss.

Counterpart of ``photon_ml_tpu/evaluation/metrics.py``. AUC is the
weighted Mann-Whitney statistic with ties counted half, by one sort and two
``searchsorted`` passes. Scores are host arrays or tensors; the metrics
compute in float64 on the CPU.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(a).detach().to("cpu", torch.float64)


def _weights(weights, like: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(like) if weights is None else _f64(weights)


def area_under_roc_curve(scores, labels, weights=None) -> float:
    """Weighted AUC with average-rank tie handling; ``labels`` in {0, 1}.
    NaN when either class has zero total weight."""
    s, y = _f64(scores), _f64(labels)
    w = _weights(weights, s)
    pos_w, neg_w = w * y, w * (1.0 - y)
    order = torch.argsort(s, stable=True)
    s, pw, nw = s[order], pos_w[order], neg_w[order]
    cum = torch.cat([torch.zeros(1, dtype=nw.dtype), torch.cumsum(nw, 0)])
    lo = torch.searchsorted(s, s, side="left")
    hi = torch.searchsorted(s, s, side="right")
    strictly_lower = cum[lo]
    tied = cum[hi] - cum[lo]
    total = (pw * (strictly_lower + 0.5 * tied)).sum()
    return float(total / (pos_w.sum() * neg_w.sum()))


def root_mean_squared_error(scores, labels, weights=None) -> float:
    """Weighted RMSE of raw scores vs labels."""
    s, y = _f64(scores), _f64(labels)
    w = _weights(weights, s)
    return float(torch.sqrt((w * torch.square(s - y)).sum() / w.sum()))


def mean_pointwise_loss(loss: PointwiseLoss, scores, labels,
                        weights=None) -> float:
    """Weighted average of a pointwise loss over scored data."""
    s, y = _f64(scores), _f64(labels)
    w = _weights(weights, s)
    return float((w * loss.loss(s, y)).sum() / w.sum())
