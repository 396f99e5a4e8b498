"""Feedback joiner: logged score records + labels → incremental training
data (counterpart of ``photon_ml_tpu/feedback/joiner.py``; host work).

The request log (``serving/reqlog.py``) records WHAT was served — request
id, features, entity ids (``metadataMap``), offset, score — but a refresh
needs outcomes. This module is the deterministic join between the two
label channels and the log:

- **inline labels**: the schema's nullable ``label`` field
  (``RequestLogScoredRecordAvro``), stamped at request time by
  backfill/replay clients that already know the outcome;
- **external labels**: an Avro (``FeedbackLabelAvro``) or CSV source
  keyed by ``(request id, record index)`` — the production shape, where
  outcomes (clicks, conversions) arrive minutes after the request.

Join semantics (all deterministic: directories and segments scan in
sorted order, ties resolve first-wins):

- a logged score record with a label (inline wins over external) emits
  one ``TrainingExampleAvro`` row — ``uid=<requestId>#<index>``,
  ``response=label``, features/offset/``metadataMap`` copied verbatim,
  so the entity ids ride into :class:`~photon_ml_tpu_torch.io.data_reader.
  AvroDataReader` exactly as training data does;
- a logged record with NO label counts as **unjoined** (it emits
  nothing — unlabeled traffic is not training data);
- a label whose ``(request id, index)`` never appears in the log counts
  as **late** (the segment rotated out, the request was sampled out, or
  the label outlived retention);
- a second label for an already-joined key, and a re-logged record (a
  replica double-logging a request), count as **duplicates** and do not
  emit a second row.

Nothing is dropped silently: every disposition lands in the
``photon_feedback_{joined,unjoined,late}_total`` counters (late carries
a ``reason`` label separating late labels from duplicates) and in the
returned :class:`JoinResult`. The joined Avro is byte-identical to the
JAX package's for the same log and labels.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterable, Mapping, Optional, Sequence, Union

from photon_ml_tpu_torch.resilience.faults import fault_point
from photon_ml_tpu_torch.serving.reqlog import iter_reqlog
from photon_ml_tpu_torch.telemetry import metrics as _metrics

_JOINED = _metrics.counter(
    "photon_feedback_joined_total",
    "Logged score records successfully joined to a label and emitted as "
    "incremental training examples (feedback/joiner.py)")
_UNJOINED = _metrics.counter(
    "photon_feedback_unjoined_total",
    "Logged score records that had no label from any source — counted, "
    "not silently dropped (unlabeled traffic is not training data)")
_LATE = _metrics.counter(
    "photon_feedback_late_total",
    "Labels that could not join: reason=unknown_request (the request was "
    "sampled out, rotated out, or the label arrived after retention), "
    "reason=duplicate (a second label for a joined key, or a replica's "
    "re-logged record)", labels=("reason",))


@dataclasses.dataclass
class JoinResult:
    """One join pass's full accounting (mirrors the counters)."""

    output_path: str
    joined: int = 0
    unjoined: int = 0
    late: int = 0
    duplicates: int = 0
    requests: int = 0
    #: wall timestamp of the newest JOINED request — the freshness-lag
    #: anchor (photon_freshness_lag_seconds measures from here)
    last_ts: Optional[float] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_labels(path: str) -> dict[tuple[str, int], float]:
    """``(request id, record index) → label`` from an external source.

    ``.avro`` reads ``FeedbackLabelAvro`` records; anything else parses
    as CSV — ``request_id,label`` or ``request_id,record_index,label``,
    with an optional header row (sniffed: a non-numeric last cell).
    First label wins per key; later ones count as duplicates at join
    time.
    """
    labels: dict[tuple[str, int], float] = {}
    dupes = 0
    if path.endswith(".avro"):
        from photon_ml_tpu_torch.io.avro import iter_avro_file

        for rec in iter_avro_file(path):
            key = (str(rec["requestId"]), int(rec.get("recordIndex", 0)))
            if key in labels:
                dupes += 1
                continue
            labels[key] = float(rec["label"])
    else:
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                try:
                    value = float(row[-1])
                except ValueError:
                    continue  # header row
                rid = row[0].strip()
                idx = int(row[1]) if len(row) >= 3 else 0
                if (rid, idx) in labels:
                    dupes += 1
                    continue
                labels[(rid, idx)] = value
    if dupes:
        _LATE.labels(reason="duplicate").inc(dupes)
    return labels


def join_feedback(reqlog_dirs: "str | Sequence[str]",
                  labels: Union[str, Mapping[tuple[str, int], float], None],
                  output_path: str, *,
                  codec: str = "null") -> JoinResult:
    """Join ``labels`` to the logged score records under ``reqlog_dirs``
    and write the joined rows as ``TrainingExampleAvro`` at
    ``output_path`` (written even when empty — a valid, zero-row file,
    so downstream readers fail loudly on min-rows policy, not on a
    missing path). Returns the full :class:`JoinResult` accounting.

    ``labels`` is a path (CSV/Avro, :func:`load_labels`), an in-memory
    mapping, or None (inline labels only). Deterministic: same log +
    same labels → byte-identical output.
    """
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    dirs = [reqlog_dirs] if isinstance(reqlog_dirs, str) else list(reqlog_dirs)
    # chaos site: a faulted join aborts THIS pass cleanly — the log and
    # serving are untouched, and the next drift event retries the join
    fault_point("feedback.join", dirs=",".join(dirs))
    label_map: Mapping[tuple[str, int], float]
    if labels is None:
        label_map = {}
    elif isinstance(labels, str):
        label_map = load_labels(labels)
    else:
        label_map = labels
    result = JoinResult(output_path=output_path)
    emitted: set[tuple[str, int]] = set()
    matched_labels: set[tuple[str, int]] = set()

    def examples() -> Iterable[dict]:
        for log_dir in sorted(dirs):
            for entry in iter_reqlog(log_dir):
                if entry.get("kind", "score") != "score":
                    continue  # ranked requests carry no per-record truth
                rid = str(entry["requestId"])
                result.requests += 1
                for i, rec in enumerate(entry.get("records") or ()):
                    key = (rid, i)
                    label = rec.get("label")
                    if label is None:
                        label = label_map.get(key)
                        if label is not None:
                            matched_labels.add(key)
                    if label is None:
                        result.unjoined += 1
                        continue
                    if key in emitted:
                        # a replica double-logged the request — one row
                        # per observation, the rest are counted
                        result.duplicates += 1
                        continue
                    emitted.add(key)
                    result.joined += 1
                    ts = float(entry.get("ts") or 0.0)
                    if result.last_ts is None or ts > result.last_ts:
                        result.last_ts = ts
                    yield {
                        "uid": f"{rid}#{i}",
                        "response": float(label),
                        "offset": rec.get("offset"),
                        "weight": None,
                        "features": [
                            {"name": f.get("name", ""),
                             "term": f.get("term") or "",
                             "value": float(f.get("value", 0.0))}
                            for f in (rec.get("features") or ())],
                        "metadataMap": rec.get("metadataMap"),
                    }

    os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                exist_ok=True)
    # a pinned sync marker makes the byte-identical promise above hold —
    # the container is otherwise identical but Avro's marker is random
    import hashlib

    sync = hashlib.blake2s(b"photon-feedback-join",
                           digest_size=16).digest()
    write_training_examples(output_path, examples(), codec=codec,
                            sync=sync)
    result.late = len(set(label_map) - matched_labels)
    if result.joined:
        _JOINED.inc(result.joined)
    if result.unjoined:
        _UNJOINED.inc(result.unjoined)
    if result.late:
        _LATE.labels(reason="unknown_request").inc(result.late)
    if result.duplicates:
        _LATE.labels(reason="duplicate").inc(result.duplicates)
    return result
