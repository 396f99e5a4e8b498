"""Grouped ("sharded") metrics: per-entity AUC and Precision@K averaged over groups.

A copy of ``photon_ml_tpu/evaluation/grouped.py`` (host numpy) on the
port's own ``util.group_starts``.

Re-design of the reference's multi-evaluators
(``photon-api/.../evaluation/{MultiEvaluator, AreaUnderROCCurveMultiEvaluator,
PrecisionAtKMultiEvaluator}.scala``): scores are joined with an id tag (e.g.
``queryId``, ``documentId``), the metric is computed per group, and the result
is the unweighted mean over groups where the metric is defined.

The reference does this with an RDD groupBy; here the whole computation is a
handful of vectorized sorts/segment reductions on host numpy — group counts
can reach hundreds of millions but the arithmetic is a few passes over flat
arrays, far from the training hot loop, so the host is the right place (device
arrays would pay a gather-heavy irregular reduction for no win).
"""

from __future__ import annotations

import numpy as np

from photon_ml_tpu_torch.util import group_starts as _group_starts


def grouped_auc(scores, labels, groups, weights=None) -> float:
    """Mean per-group weighted AUC over groups with both classes present.

    ``groups`` is an integer (or any sortable) id per sample. Matches
    ``AreaUnderROCCurveMultiEvaluator``: groups with only one class are
    skipped; the average over groups is unweighted.
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    groups = np.asarray(groups)
    weights = np.ones_like(scores) if weights is None else np.asarray(weights, np.float64)

    order = np.lexsort((scores, groups))
    g = groups[order]
    s = scores[order]
    y = labels[order]
    w = weights[order]
    nw = w * (1.0 - y)
    pw = w * y

    starts = _group_starts(g)
    n = g.shape[0]
    if n == 0:
        return float("nan")
    # Per-element index of its group's start.
    group_start = np.zeros(n, dtype=np.int64)
    group_start[starts] = starts
    np.maximum.accumulate(group_start, out=group_start)

    # Tie blocks: same (group, score). Block start index per element.
    new_block = np.empty(n, dtype=bool)
    new_block[0] = True
    new_block[1:] = (g[1:] != g[:-1]) | (s[1:] != s[:-1])
    block_ids = np.cumsum(new_block) - 1
    block_starts = np.flatnonzero(new_block)
    block_start = block_starts[block_ids]
    # Block end (exclusive): start of next block, or n.
    block_end = np.empty(n, dtype=np.int64)
    block_end[:] = np.append(block_starts[1:], n)[block_ids]

    cum = np.concatenate([[0.0], np.cumsum(nw)])
    cum_at_group_start = cum[group_start]
    strictly_lower = cum[block_start] - cum_at_group_start
    tied = cum[block_end] - cum[block_start]

    contrib = pw * (strictly_lower + 0.5 * tied)
    # Per-group reductions.
    contrib_g = np.add.reduceat(contrib, starts)
    pos_g = np.add.reduceat(pw, starts)
    neg_g = np.add.reduceat(nw, starts)

    valid = (pos_g > 0) & (neg_g > 0)
    if not np.any(valid):
        return float("nan")
    auc_g = contrib_g[valid] / (pos_g[valid] * neg_g[valid])
    return float(np.mean(auc_g))


def grouped_precision_at_k(scores, labels, groups, k: int) -> float:
    """Mean per-group Precision@K (reference ``PrecisionAtKMultiEvaluator``).

    Per group: sort by score descending, precision = (# positive labels among
    the top ``k``) / ``k``. Groups smaller than ``k`` still divide by ``k``
    (missing items count as misses), matching the reference's fixed-k
    denominator. Unweighted average over all groups.
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    groups = np.asarray(groups)
    if scores.shape[0] == 0:
        return float("nan")

    order = np.lexsort((-scores, groups))
    g = groups[order]
    y = labels[order]

    starts = _group_starts(g)
    n = g.shape[0]
    group_start = np.zeros(n, dtype=np.int64)
    group_start[starts] = starts
    np.maximum.accumulate(group_start, out=group_start)
    rank = np.arange(n, dtype=np.int64) - group_start

    hits = np.where(rank < k, (y > 0).astype(np.float64), 0.0)
    hits_g = np.add.reduceat(hits, starts)
    return float(np.mean(hits_g / float(k)))
