"""Canary-gated activation: shadow-score a candidate before it serves.

Counterpart of ``photon_ml_tpu/quality/canary.py`` (host-side; the same
metrics and the ``quality.canary`` span). In the port the registry runs
the canary after the candidate's warmup, so the shadow scores replay the
candidate's already-captured bucket graphs and capture nothing.

Validation at load time proves a candidate is STRUCTURALLY sound
(metadata, part files, store packing — ``serving/registry.py``); it says
nothing about what the candidate *predicts*. With the continuous loop
auto-publishing versions into a watched directory, a refresh gone wrong —
a corrupted coefficient table, a solver fed garbage data — passes every
structural check and then serves garbage scores. The canary closes that
hole:

- the registry keeps a :class:`RequestReservoir` of recent live request
  records (uniform reservoir sampling, so the sample tracks real traffic
  without unbounded memory);
- at activation time (``/reload`` or a watch-dir pickup) the validated
  candidate **shadow-scores the reservoir against the incumbent**
  (:func:`run_canary`); the relative score divergence is annotated onto
  the activation (event + ``photon_quality_canary_divergence`` gauge +
  a ``quality.canary`` span for the report's history), and — under
  ``serve_game --canary-gate`` — a divergence past the bound REFUSES the
  activation exactly like a validation failure: :class:`CanaryRejected`
  propagates through the registry's reject path, the incumbent keeps
  serving bit-identically, and ``photon_model_reload_rejects_total``
  moves.

Default bounds are the quantized-table score tolerances SERVING.md
already documents as acceptable score error (bf16 ≤ 1e-2 relative, int8
≤ 5e-2); float32 stores default to the loosest of those (5e-2) — a
genuine model refresh may legitimately move scores more, in which case
the operator widens ``--canary-bound`` (the gate is for catching
corruption, not for freezing the model).
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.telemetry import metrics as _metrics
from photon_ml_tpu_torch.telemetry import tracing

#: default divergence bound per serving table dtype — the documented
#: quantized-table score-parity tolerances (SERVING.md); float32 takes
#: the loosest documented tolerance
DEFAULT_BOUNDS = {"float32": 5e-2, "bfloat16": 1e-2, "int8": 5e-2}

_CANARY_SECONDS = _metrics.histogram(
    "photon_quality_canary_seconds",
    "Wall seconds of one canary shadow-scoring evaluation (incumbent + "
    "candidate over the request reservoir, at activation time — never "
    "on the score hot path)")
_CANARY_DIVERGENCE = _metrics.gauge(
    "photon_quality_canary_divergence",
    "Max relative score divergence of the last canary-evaluated "
    "candidate vs the incumbent over the request reservoir")
_metrics.mark_host_owned("photon_quality_canary_divergence")
_CANARY_REJECTS = _metrics.counter(
    "photon_quality_canary_rejects_total",
    "Candidate activations refused by the canary gate (divergence past "
    "the bound; the incumbent kept serving)")


class CanaryRejected(RuntimeError):
    """A candidate's shadow scores diverged past the gate's bound — the
    activation is refused like any validation failure."""


@dataclasses.dataclass(frozen=True)
class CanaryConfig:
    """Registry-level canary policy.

    ``gate=False`` (the default) only ANNOTATES activations with the
    measured divergence; ``gate=True`` (``serve_game --canary-gate``)
    refuses past the bound. ``bound=None`` resolves per table dtype from
    :data:`DEFAULT_BOUNDS`. Evaluations below ``min_records`` reservoir
    entries are skipped — a divergence measured on two requests says
    nothing."""

    gate: bool = False
    bound: Optional[float] = None
    min_records: int = 8

    def bound_for(self, table_dtype: str) -> float:
        if self.bound is not None:
            return float(self.bound)
        return DEFAULT_BOUNDS.get(table_dtype, DEFAULT_BOUNDS["float32"])


class RequestReservoir:
    """Bounded uniform sample of recent request records (Algorithm R).

    Thread-safe; ``add`` is O(records) dict-free bookkeeping per call —
    cheap enough to sit on the request path unconditionally."""

    def __init__(self, capacity: int = 256, seed: int = 0):
        self.capacity = int(capacity)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._records: list = []
        self._seen = 0

    def add(self, records: Sequence[dict]) -> None:
        with self._lock:
            for rec in records:
                self._seen += 1
                if len(self._records) < self.capacity:
                    self._records.append(rec)
                else:
                    j = self._rng.randrange(self._seen)
                    if j < self.capacity:
                        self._records[j] = rec

    def sample(self) -> list:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


def score_divergence(incumbent_scores, candidate_scores) -> float:
    """Max relative divergence, ``max |cand - inc| / max(|inc|, 1)`` —
    the same normalization the quantized-table score-parity gates use,
    so the default bounds mean the same thing they mean there."""
    a = np.asarray(incumbent_scores, np.float64)
    b = np.asarray(candidate_scores, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"score shapes differ: {a.shape} vs {b.shape}")
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(b - a) / np.maximum(np.abs(a), 1.0)))


def run_canary(incumbent_score: Callable, candidate_score: Callable,
               records: Sequence[dict], *, bound: float, gate: bool,
               candidate_dir: str, bus=None) -> dict:
    """Shadow-score ``records`` through both engines and judge the
    candidate. Returns the annotation dict (divergence, bound, verdict,
    wall seconds); raises :class:`CanaryRejected` past the bound under
    ``gate``. The evaluation is timed into
    ``photon_quality_canary_seconds`` and spanned as ``quality.canary``
    (the quality report renders the span history)."""
    records = list(records)
    with _CANARY_SECONDS.time() as timer, \
            tracing.span("quality.canary", candidate=candidate_dir) as sp:
        base = incumbent_score(records)
        cand = candidate_score(records)
        divergence = score_divergence(base, cand)
        verdict = ("pass" if divergence <= bound
                   else ("rejected" if gate else "divergent"))
        sp.set(divergence=round(divergence, 6), bound=bound,
               n=len(records), verdict=verdict)
    _CANARY_DIVERGENCE.set(divergence)
    result = {"divergence": divergence, "bound": bound,
              "n": len(records), "verdict": verdict,
              "seconds": timer.seconds}
    if bus is not None:
        bus.post("canary_evaluated", candidate=candidate_dir, **result)
    if verdict == "rejected":
        _CANARY_REJECTS.inc()
        raise CanaryRejected(
            f"canary: candidate {candidate_dir!r} diverges "
            f"{divergence:.4g} (> bound {bound:.4g}) from the incumbent "
            f"over {len(records)} reservoir records — activation refused; "
            f"widen --canary-bound if this is an intended model change")
    return result
