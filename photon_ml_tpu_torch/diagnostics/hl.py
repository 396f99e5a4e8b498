"""Hosmer–Lemeshow goodness-of-fit (calibration) test for logistic models.

Counterpart of ``photon_ml_tpu/diagnostics/hl.py`` (the reference's
``HosmerLemeshowDiagnostic``): bin the samples into G equal-count bins by
predicted probability, compare observed with expected positives per bin,
and report the chi-squared statistic on ``G - 2`` degrees of freedom.

The binning and the per-bin sums run in torch where the probabilities lie
(on the card for the ``train_glm`` diagnostics), in the probabilities'
dtype; the cut positions are computed in float64, as the JAX package
computes them under x64. The per-bin sums are ``index_add_``: in row order
on the CPU, as the JAX package's segment sums add them, and by atomics on
the card, whose f32 sums of the same values can differ in the last bits.
The p-value is the chi-square tail (``scipy.special.chdtrc``, what
``scipy.stats.chi2.sf`` evaluates, without ``scipy.stats``'s import
time).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HosmerLemeshowReport:
    """Per-bin calibration table plus the aggregate test."""

    bin_counts: np.ndarray          # (G,) weighted sample count per bin
    observed_positives: np.ndarray  # (G,) weighted positive count
    expected_positives: np.ndarray  # (G,) sum of predicted probabilities
    mean_predicted: np.ndarray      # (G,) mean predicted prob per bin
    chi_square: float
    degrees_of_freedom: int
    p_value: float

    @property
    def n_bins(self) -> int:
        return int(self.bin_counts.shape[0])

    def well_calibrated(self, significance: float = 0.05) -> bool:
        """True when the test fails to reject calibration at
        ``significance``."""
        return self.p_value > significance


def _hl_core(probs: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor, n_bins: int):
    """``(counts, observed, expected, mean_p, chi2)`` as tensors on the
    probabilities' device."""
    live = weights > 0
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    w = torch.where(live, weights, zero)
    p = probs.clamp(1e-7, 1.0 - 1e-7)
    # equal-count cut points from the live samples' quantiles; dead rows
    # sort to the top as +inf and carry weight 0 in every sum
    qs = torch.linspace(0.0, 1.0, n_bins + 1, dtype=torch.float64)[1:-1]
    p_sorted = torch.sort(torch.where(live, p, torch.full_like(p, np.inf)))
    p_sorted = p_sorted.values
    n_live = int(live.sum())
    pos = (qs * (n_live - 1)).to(torch.int32).clamp(0, max(n_live - 1, 0))
    cuts = p_sorted[pos.to(torch.int64).to(p.device)]
    bins = torch.searchsorted(cuts, p, right=True)
    def seg(v):
        return torch.zeros(n_bins, dtype=v.dtype,
                           device=v.device).index_add_(0, bins, v)

    counts = seg(w)
    obs = seg(w * labels)
    exp = seg(w * p)
    mean_p = torch.where(counts > 0,
                         exp / torch.clamp(counts, min=1e-30), zero)
    # chi^2 over both outcome cells; empty bins contribute 0
    exp_neg = counts - exp
    safe = counts > 0
    t1 = torch.where(safe, (obs - exp) ** 2 / torch.clamp(exp, min=1e-10),
                     zero)
    t0 = torch.where(safe, ((counts - obs) - exp_neg) ** 2
                     / torch.clamp(exp_neg, min=1e-10), zero)
    chi2 = (t1 + t0).sum()
    return counts, obs, exp, mean_p, chi2


def hosmer_lemeshow(probs, labels, weights=None, n_bins: int = 10
                    ) -> HosmerLemeshowReport:
    """Run the HL test on predicted probabilities vs binary labels. Tensors
    stay on their device; numpy arrays run on the CPU."""
    import scipy.special

    probs = torch.as_tensor(probs)
    labels = torch.as_tensor(labels).to(dtype=probs.dtype,
                                        device=probs.device)
    weights = (torch.ones_like(probs) if weights is None
               else torch.as_tensor(weights).to(dtype=probs.dtype,
                                                device=probs.device))
    counts, obs, exp, mean_p, chi2 = _hl_core(probs, labels, weights, n_bins)
    dof = max(n_bins - 2, 1)
    chi2 = float(chi2)

    def host(t):
        return t.detach().cpu().numpy()

    return HosmerLemeshowReport(
        bin_counts=host(counts),
        observed_positives=host(obs),
        expected_positives=host(exp),
        mean_predicted=host(mean_p),
        chi_square=chi2,
        degrees_of_freedom=dof,
        p_value=float(scipy.special.chdtrc(dof, chi2)),
    )
