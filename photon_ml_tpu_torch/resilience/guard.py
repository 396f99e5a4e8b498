"""Divergence guard: NaN/Inf detection + rollback/freeze bookkeeping.

After every coordinate step the training drivers can ask the guard whether
the step's outputs (new scores, new model coefficients) are healthy. The
checks are **pure reads** — one ``torch.isfinite(...).all()`` per array,
on the device the array lives on — so a guarded healthy run produces
bit-identical models to an unguarded one. (A copy of
``photon_ml_tpu/resilience/guard.py``, whose reads go through host numpy.)

On divergence the guard decides, per its policy:

- ``"fail"`` — post ``divergence_detected`` and raise
  :class:`DivergenceError` (fail fast with an actionable message instead of
  silently writing a NaN model);
- ``"rollback"`` — roll the coordinate back to its last good state, bump
  the coordinate's regularization by ``reg_backoff`` (stronger curvature is
  the standard fix for a diverged GLM solve), and retry, up to
  ``max_retries`` times — then freeze;
- ``"freeze"`` — immediately lock the coordinate at its last good model
  (the existing ``locked`` mechanism) and continue the run degraded.

The guard only *decides*; the drivers own the state restore (in-process
rollback at the coordinate boundary, which at that granularity coincides
with the last ``CheckpointManager`` step — see RESILIENCE.md "Rollback
semantics"). In the multi-process driver the verdict is allreduce-maxed so
every process rolls back in lockstep; the guard's own bookkeeping is
deterministic, so per-process counters never diverge. The port runs one
process.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_MODES = ("fail", "rollback", "freeze")


class DivergenceError(RuntimeError):
    """Raised under ``mode="fail"`` (and when a coordinate diverges before
    ever producing a good model, leaving nothing to freeze to)."""


@dataclasses.dataclass(frozen=True)
class DivergencePolicy:
    """What to do when a coordinate step produces NaN/Inf (or throws).

    ``reg_backoff`` multiplies the coordinate's regularization weight on
    every rollback-retry (a backoff schedule in curvature space);
    ``max_retries`` bounds rollback-retries per coordinate before freezing.
    """

    mode: str = "fail"
    max_retries: int = 2
    reg_backoff: float = 10.0

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"divergence mode must be one of {_MODES}, got {self.mode!r}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")


def arrays_finite(arrays: Iterable) -> bool:
    """True when every non-None array is fully finite (pure read). A tensor
    is read where it lies, with one ``torch.isfinite(...).all()``, and the
    flags of all tensors reach the host together (one device sync); host
    numpy arrays are read in numpy."""
    flags = []
    for a in arrays:
        if a is None:
            continue
        if isinstance(a, torch.Tensor):
            flags.append(torch.isfinite(a).all())
        elif not np.isfinite(np.asarray(a, np.float32)).all():
            return False
    if not flags:
        return True
    device = flags[0].device
    return bool(torch.stack([f.to(device) for f in flags]).all())


def model_arrays(model) -> list:
    """Coefficient leaves of a coordinate model (fixed or random effect),
    duck-typed so the guard needs no import of the game layer."""
    out = []
    glm = getattr(model, "model", None)
    if glm is not None and hasattr(glm, "coefficients"):  # FixedEffectModel
        out.append(glm.coefficients.means)
    coeffs = getattr(model, "coeffs", None)  # RandomEffectModel
    if coeffs is not None:
        out.append(coeffs)
    return out


class DivergenceGuard:
    """Per-run divergence bookkeeping (one instance per training run)."""

    def __init__(self, policy: DivergencePolicy = DivergencePolicy(),
                 bus=None):
        self.policy = policy
        self.bus = bus
        self.failures: dict[str, int] = {}
        self.frozen: set[str] = set()

    def _post(self, name: str, **payload) -> None:
        bus = self.bus
        if bus is None:
            from photon_ml_tpu_torch.events import GLOBAL_BUS as bus
        bus.post(name, **payload)

    # --- detection (pure reads) ------------------------------------------
    def healthy(self, model, scores) -> bool:
        """True when the step's outputs carry no NaN/Inf."""
        checks = [] if scores is None else [scores]
        if model is not None:
            checks.extend(model_arrays(model))
        return arrays_finite(checks)

    def next_lam(self, lam: float) -> float:
        """The rollback-retry's bumped regularization weight. An
        unregularized coordinate (lam=0) seeds at ``reg_backoff`` itself —
        multiplying zero would retry the identical diverging solve."""
        return (lam * self.policy.reg_backoff if lam > 0
                else self.policy.reg_backoff)

    # --- decision ---------------------------------------------------------
    def on_divergence(self, coordinate_id: str, *, sweep: int,
                      has_good_model: bool,
                      error: Optional[BaseException] = None) -> str:
        """Record a failure and return the action: ``"retry"`` (roll back,
        bump regularization, try again) or ``"freeze"`` (lock the
        coordinate). Raises :class:`DivergenceError` under ``mode="fail"``
        or when freezing is impossible (no good model yet)."""
        n = self.failures.get(coordinate_id, 0) + 1
        self.failures[coordinate_id] = n
        detail = (f": {error!r}" if error is not None
                  else " (non-finite update)")
        self._post("divergence_detected", coordinate=coordinate_id,
                   sweep=sweep, failures=n,
                   error=None if error is None else repr(error))
        if self.policy.mode == "fail":
            raise DivergenceError(
                f"coordinate {coordinate_id!r} diverged at sweep {sweep}"
                f"{detail}; re-run with --on-divergence=rollback to "
                f"recover automatically, or raise its regularization"
            ) from error
        retry_ok = (self.policy.mode == "rollback"
                    and n <= self.policy.max_retries)
        if retry_ok:
            self._post("coordinate_rollback", coordinate=coordinate_id,
                       sweep=sweep, attempt=n,
                       reg_backoff=self.policy.reg_backoff)
            logger.warning(
                "coordinate %s diverged at sweep %d (failure %d/%d): "
                "rolling back and retrying with regularization x%g",
                coordinate_id, sweep, n, self.policy.max_retries,
                self.policy.reg_backoff)
            return "retry"
        if not has_good_model:
            raise DivergenceError(
                f"coordinate {coordinate_id!r} diverged at sweep {sweep}"
                f"{detail} before producing any model — nothing to freeze "
                f"to; fix its optimization configuration") from error
        self.frozen.add(coordinate_id)
        self._post("coordinate_frozen", coordinate=coordinate_id,
                   sweep=sweep, failures=n)
        logger.warning(
            "coordinate %s diverged at sweep %d (failure %d): freezing at "
            "its last good model and continuing degraded",
            coordinate_id, sweep, n)
        return "freeze"
