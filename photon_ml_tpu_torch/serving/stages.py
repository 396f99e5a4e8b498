"""Per-request stage-seconds side channel.

A copy of ``photon_ml_tpu/serving/stages.py`` (stdlib only).

The five-stage critical-path histogram (``photon_serving_stage_seconds``)
aggregates across requests; the fleet router needs the SAME numbers per
request so each fan-out leg can report a compact stage summary back for
cross-host trace stitching.
This module is that side channel: a ContextVar-scoped sink dict that
stage owners write into when — and only when — a collector is active.

Two hand-off patterns compose here:

- same-thread stages (parse/respond in http.py, assemble/execute on the
  direct scoring path) run inside :func:`collect`, so :func:`record`
  finds the sink through the ContextVar;
- batched stages cross the batcher's worker thread, where ContextVars do
  NOT propagate — the batcher carries an explicit per-entry ``stage_out``
  dict and re-enters :func:`collect` around the batch execution, then
  copies the batch-level stages to every rider (each request in a
  micro-batch honestly paid the whole batch's assemble+execute wall).

Keys are stage names from the critical-path histogram; values are
seconds (float). One key is not a stage: :data:`SERVED_BY`, the
``(version, lineage)`` of the model version that scored the request
(:func:`note_served_by`), so a reply and its request-log record name the
version that answered even when a hot swap lands between the request's
arrival and its batch. When no collector is active every call is a cheap
no-op, so steady-state single-host serving pays nothing.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Dict, Iterator, Optional

#: sink key of the ``(version, lineage)`` that scored the request
SERVED_BY = "served_by"

_SINK: ContextVar[Optional[Dict[str, float]]] = ContextVar(
    "photon_stage_sink", default=None)


@contextlib.contextmanager
def collect(sink: Dict[str, float]) -> Iterator[Dict[str, float]]:
    """Route :func:`record` calls in this context into ``sink``."""
    token = _SINK.set(sink)
    try:
        yield sink
    finally:
        _SINK.reset(token)


def record(stage: str, seconds: float) -> None:
    """Add ``seconds`` to ``stage`` in the active sink (no-op if none).

    Accumulates rather than overwrites: a chunked execute (or a retried
    assemble) reports its total, matching what the histogram observed.
    """
    sink = _SINK.get()
    if sink is not None:
        sink[stage] = sink.get(stage, 0.0) + float(seconds)


def note_served_by(version: int, lineage: Optional[str]) -> None:
    """Set :data:`SERVED_BY` in the active sink (no-op if none)."""
    sink = _SINK.get()
    if sink is not None:
        sink[SERVED_BY] = (version, lineage)
