"""L1 / L2 / elastic-net regularization contexts.

Counterpart of ``photon_ml_tpu/ops/regularization.py``: one scalar lambda
split into a smooth L2 part folded into the objective and an L1 part that
an orthant-wise optimizer would handle (OWL-QN is not ported yet).
"""

from __future__ import annotations

import dataclasses

from photon_ml_tpu_torch.types import RegularizationType


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """How a single lambda is split between L1 and L2 penalties.

    ``alpha`` follows the reference/glmnet convention: the fraction of the
    penalty that is L1. ``alpha=1`` is pure L1 (lasso), ``alpha=0`` pure L2
    (ridge). For ``RegularizationType.L1``/``L2`` alpha is forced to 1/0.
    """

    reg_type: RegularizationType = RegularizationType.NONE
    alpha: float = 0.0

    def __post_init__(self) -> None:
        if self.reg_type == RegularizationType.ELASTIC_NET:
            if not 0.0 <= self.alpha <= 1.0:
                raise ValueError(f"elastic-net alpha must be in [0,1], got {self.alpha}")
        elif self.reg_type == RegularizationType.L1:
            object.__setattr__(self, "alpha", 1.0)
        else:
            object.__setattr__(self, "alpha", 0.0)

    def l2_weight(self, regularization_weight):
        """The smooth L2 coefficient folded into the objective
        (``(1 - alpha) * lambda``; 0 for ``NONE`` regardless of lambda).
        ``regularization_weight`` is a number or a tensor of lambdas, one
        per lane of a batched solve."""
        if self.reg_type == RegularizationType.NONE:
            return 0.0
        return (1.0 - self.alpha) * regularization_weight

    def check_weight(self, regularization_weight: float) -> None:
        """Reject a nonzero lambda paired with a NONE context — the weight
        would be silently ignored (every l1/l2 split maps it to 0), which
        turns a regularization sweep or hyperparameter search into identical
        unregularized fits. Call with *concrete* weights only (host side)."""
        if (self.reg_type == RegularizationType.NONE
                and float(regularization_weight) != 0.0):
            raise ValueError(
                f"regularization_weight={regularization_weight} has no effect "
                "under RegularizationType.NONE; configure an L1/L2/elastic-net "
                "RegularizationContext")

    @property
    def has_l1(self) -> bool:
        return self.reg_type in (RegularizationType.L1, RegularizationType.ELASTIC_NET) and self.alpha > 0.0


NoRegularization = RegularizationContext(RegularizationType.NONE)
L1Regularization = RegularizationContext(RegularizationType.L1, alpha=1.0)
L2Regularization = RegularizationContext(RegularizationType.L2, alpha=0.0)


def elastic_net(alpha: float) -> RegularizationContext:
    return RegularizationContext(RegularizationType.ELASTIC_NET, alpha=alpha)
