"""Metric aggregation: fold N registry snapshots into one.

Counterpart of the fold half of ``photon_ml_tpu/telemetry/aggregate.py``,
on the :mod:`~photon_ml_tpu_torch.telemetry.prometheus` render/parse round
trip, so every transport shares one merge:

- :func:`merge_parsed` / :func:`aggregate_text`: counters and histogram
  ``_bucket`` / ``_sum`` / ``_count`` series sum per label set; gauges
  resolve by owner: the first snapshot holding a label set wins (snapshots
  come chief first, so replicated gauges read as the chief's), while
  host-owned gauges, tagged per host (``metrics.mark_host_owned``), carry
  distinct label sets and fan out. The fleet router's ``GET /metrics``
  (:mod:`photon_ml_tpu_torch.fleet.observe`) folds its hosts through it.
- :func:`process_tag` / :func:`is_chief`: this process's identity in a
  multi-process job, read from
  :mod:`photon_ml_tpu_torch.parallel.multihost`.

Not ported: the in-training collective aggregator, the chief's
``--metrics-port`` server and the trace-file merge (the telemetry flags
stay refused).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from photon_ml_tpu_torch.telemetry.prometheus import (
    ParsedSnapshot,
    histogram_series_names,
    parse_text,
    render,
)


# ---------------------------------------------------------------------------
# the pure fold
# ---------------------------------------------------------------------------


def _label_key(labels) -> tuple:
    return tuple(sorted(labels.items()))


def _merge_series(out: ParsedSnapshot, snapshots: Sequence[ParsedSnapshot],
                  series: str, sum_values: bool) -> None:
    index: dict[tuple, int] = {}
    samples: list = []
    for snap in snapshots:
        for labels, value in snap.get(series, ()):
            key = _label_key(labels)
            pos = index.get(key)
            if pos is None:
                index[key] = len(samples)
                samples.append((labels, value))
            elif sum_values:
                kept, total = samples[pos]
                samples[pos] = (kept, total + value)
            # else: owner semantics — the first (chief-most) snapshot
            # holding this label set keeps its value
    if samples:
        out[series] = samples


def merge_parsed(snapshots: Sequence[ParsedSnapshot]) -> ParsedSnapshot:
    """Fold parsed snapshots (chief first, then workers in process order).

    Family order and headers follow first appearance; a family declared
    with conflicting types across snapshots (a version-skewed fleet
    redefining a name) raises rather than summing apples into oranges.
    Merging a single snapshot is the identity — ``render`` of the result
    is byte-identical to the input text.
    """
    out = ParsedSnapshot()
    for snap in snapshots:
        for name, fam in snap.families.items():
            have = out.families.get(name)
            if have is None:
                out.families[name] = dict(fam)
            elif have["type"] != fam["type"]:
                raise ValueError(
                    f"metric family {name!r} has conflicting types across "
                    f"processes ({have['type']} vs {fam['type']}) — a "
                    f"mixed-version fleet is redefining the metric; check "
                    f"photon_build_info in the per-process snapshots")
            elif not have.get("help") and fam.get("help"):
                have["help"] = fam["help"]
    claimed: set[str] = set()
    for name, fam in out.families.items():
        if fam["type"] == "histogram":
            for series in histogram_series_names(name):
                claimed.add(series)
                _merge_series(out, snapshots, series, sum_values=True)
        else:
            claimed.add(name)
            _merge_series(out, snapshots, name,
                          sum_values=fam["type"] == "counter")
    for snap in snapshots:  # headerless series: first snapshot wins
        for series in snap:
            if series not in claimed and series not in out:
                out[series] = list(snap[series])
    return out


def aggregate_text(texts: Sequence[str]) -> str:
    """N exposition texts (chief first) → one aggregate exposition text."""
    return render(merge_parsed([parse_text(t) for t in texts]))


# ---------------------------------------------------------------------------
# process identity (safe before or without a process group)
# ---------------------------------------------------------------------------


def _multihost():
    """The multi-process module when something imported it (a process
    group can only exist then), else None."""
    return sys.modules.get("photon_ml_tpu_torch.parallel.multihost")


def process_tag() -> Optional[str]:
    """This process's index as a label value when the job spans processes,
    else None (single-process renders stay untagged)."""
    mh = _multihost()
    if mh is None or mh.process_count() <= 1:
        return None
    return str(mh.process_index())


def is_chief() -> bool:
    mh = _multihost()
    return True if mh is None else mh.is_chief()
