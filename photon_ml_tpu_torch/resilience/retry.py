"""``retry(fn, policy)`` — the single retry/backoff primitive.

A copy of ``photon_ml_tpu/resilience/retry.py``. In the port it wraps
checkpoint save/restore and the coefficient patch publish.

Every transient-fault recovery in the framework goes through this one
function: Avro file reads, checkpoint save/restore, and multihost
initialization all wrap their attempt bodies in :func:`retry` so backoff
behavior, deadline enforcement, and event emission cannot drift apart
between call sites.

Semantics:

- attempts run up to ``policy.max_attempts`` times, sleeping a
  deterministic exponentially-backed-off, jittered delay between attempts
  (the jitter sequence is a pure function of ``policy.seed`` — a retry
  schedule is reproducible, like everything else in a training run);
- ``policy.deadline_s`` bounds the *total* elapsed time including the next
  planned sleep: the primitive never sleeps into a deadline it would then
  blow — it gives up immediately instead (a hung coordinator resolves in
  ``deadline_s``, not ``deadline_s + max_delay``);
- on exhaustion the **original** exception is re-raised, so a wrapped call
  site's error contract is unchanged — with no faults and default
  policies, wrapped paths behave bit-identically to unwrapped ones;
- every attempt failure posts ``retry_attempt``; exhaustion posts
  ``retry_exhausted``; success after at least one failure posts
  ``retry_succeeded`` — all through :mod:`photon_ml_tpu.events`, so runs
  are auditable.

This module owns the ONE sanctioned ``time.sleep`` in the package
(``tools/check_resilience_hygiene.py`` enforces it): stalls anywhere else
would be invisible to the retry/deadline accounting.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional, TypeVar

import numpy as np

T = TypeVar("T")

#: the package's only sleep — fault stalls and backoff waits both route
#: here so a chaos run's entire wait budget is one greppable chokepoint
_sleep = time.sleep


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule + attempt/deadline budget.

    ``delay_k = min(base_delay_s * multiplier**k, max_delay_s)`` scaled by
    ``1 + jitter * u_k`` with ``u_k ~ Uniform[-1, 1)`` drawn from a
    generator seeded with ``seed`` — deterministic per policy instance.
    ``retry_on`` filters which exception types are retried at all; anything
    else propagates immediately.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.1
    deadline_s: Optional[float] = None
    seed: int = 0
    retry_on: tuple = (Exception,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")

    def delays(self) -> Iterator[float]:
        """The deterministic inter-attempt delay sequence (unbounded)."""
        rng = np.random.default_rng(self.seed)
        k = 0
        while True:
            base = min(self.base_delay_s * self.multiplier ** k,
                       self.max_delay_s)
            u = 2.0 * float(rng.random()) - 1.0
            yield max(0.0, base * (1.0 + self.jitter * u))
            k += 1


#: no-retry policy — for call sites that want the fault hooks and events
#: without any recovery (e.g. collectives, which must never retry
#: unilaterally: a second attempt on one process desyncs every other)
NO_RETRY = RetryPolicy(max_attempts=1)

DEFAULT_POLICY = RetryPolicy()

_default_policy = DEFAULT_POLICY


def set_default_policy(policy: RetryPolicy) -> RetryPolicy:
    """Install the process-wide default (the CLI's --max-retries /
    --retry-deadline-s flags land here). Returns the previous default."""
    global _default_policy
    prev = _default_policy
    _default_policy = policy
    return prev


def get_default_policy() -> RetryPolicy:
    return _default_policy


def retry(fn: Callable[[], T], policy: Optional[RetryPolicy] = None, *,
          name: Optional[str] = None, bus=None,
          sleep: Optional[Callable[[float], None]] = None,
          clock: Callable[[], float] = time.monotonic) -> T:
    """Call ``fn()`` under ``policy``; see the module docstring for the
    full semantics. ``sleep``/``clock`` are injectable for tests."""
    if policy is None:
        policy = _default_policy
    if bus is None:
        from photon_ml_tpu_torch.events import GLOBAL_BUS as bus
    if sleep is None:
        sleep = _sleep
    if name is None:
        name = getattr(fn, "__name__", "op")
    start = clock()
    delays = policy.delays()
    for attempt in range(1, policy.max_attempts + 1):
        try:
            result = fn()
        except policy.retry_on as e:
            elapsed = clock() - start
            delay = next(delays)
            over_deadline = (policy.deadline_s is not None
                             and elapsed + delay >= policy.deadline_s)
            if attempt >= policy.max_attempts or over_deadline:
                bus.post("retry_exhausted", op=name, attempts=attempt,
                         elapsed_s=elapsed, deadline_hit=over_deadline,
                         error=repr(e))
                raise
            bus.post("retry_attempt", op=name, attempt=attempt,
                     delay_s=delay, elapsed_s=elapsed, error=repr(e))
            sleep(delay)
        else:
            if attempt > 1:
                bus.post("retry_succeeded", op=name, attempt=attempt,
                         elapsed_s=clock() - start)
            return result
    raise AssertionError("unreachable")  # pragma: no cover
