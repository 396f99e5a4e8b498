"""Resilience: deterministic fault injection, retry/backoff, and the
divergence guard of GAME training (counterpart of
``photon_ml_tpu/resilience``).

- :mod:`~photon_ml_tpu_torch.resilience.faults` — a seedable
  :class:`FaultPlan` with named injection sites threaded as no-op hooks
  (``io.read``, ``ckpt.save``, ``io.delta_publish``, ``optimizer.step``,
  ``serving.reload``, ``serving.watch_tick`` and ``io.save.reqlog`` in the
  port), activated explicitly or by the ``PHOTON_FAULT_PLAN`` environment
  variable.
- :mod:`~photon_ml_tpu_torch.resilience.retry` — the one ``retry(fn,
  policy)`` primitive around Avro reads, checkpoint save/restore, the
  patch publish and serving's model loads.
- :mod:`~photon_ml_tpu_torch.resilience.heartbeat` — the supervisor's
  liveness file, touched at reads, sweeps, lambdas and collectives.
- :mod:`~photon_ml_tpu_torch.resilience.guard` — NaN/Inf detection at
  coordinate boundaries with rollback / regularization backoff / freeze.
- :mod:`~photon_ml_tpu_torch.resilience.supervisor` — the fleet supervisor
  behind ``--supervise N``: it launches N processes, watches their exits
  and heartbeat files, and restarts the whole fleet from its checkpoint.
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
from photon_ml_tpu_torch.resilience.heartbeat import heartbeat
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
    "heartbeat",
    "RetryPolicy",
    "get_default_policy",
    "retry",
    "set_default_policy",
]
