"""Resilience: deterministic fault injection, retry/backoff, and the
divergence guard of GAME training (counterpart of
``photon_ml_tpu/resilience``).

- :mod:`~photon_ml_tpu_torch.resilience.faults` — a seedable
  :class:`FaultPlan` with named injection sites threaded as no-op hooks
  (``ckpt.save``, ``io.delta_publish``, ``optimizer.step`` in the port),
  activated explicitly or by the ``PHOTON_FAULT_PLAN`` environment
  variable.
- :mod:`~photon_ml_tpu_torch.resilience.retry` — the one ``retry(fn,
  policy)`` primitive around checkpoint save/restore and patch publish.
- :mod:`~photon_ml_tpu_torch.resilience.guard` — NaN/Inf detection at
  coordinate boundaries with rollback / regularization backoff / freeze.

Not ported yet: the fleet supervisor and its heartbeat files
(``resilience/supervisor.py``).
"""

from photon_ml_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    active_plan,
    fault_point,
    fault_value,
    injected,
)
from photon_ml_tpu_torch.resilience.guard import (
    DivergenceError,
    DivergenceGuard,
    DivergencePolicy,
)
from photon_ml_tpu_torch.resilience.retry import (
    RetryPolicy,
    get_default_policy,
    retry,
    set_default_policy,
)

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "active_plan",
    "fault_point",
    "fault_value",
    "injected",
    "DivergenceError",
    "DivergenceGuard",
    "DivergencePolicy",
    "RetryPolicy",
    "get_default_policy",
    "retry",
    "set_default_policy",
]
