"""Prometheus text exposition (format 0.0.4) of a :class:`MetricsRegistry`.

Counterpart of ``photon_ml_tpu/telemetry/prometheus.py``: :func:`render`
turns a registry snapshot into the text every Prometheus-compatible scraper
ingests, as ``GET /metrics`` serves it, and :func:`parse_text` is its
inverse for the families this package emits. The parse → render round trip
is byte-identical: a :class:`ParsedSnapshot` keeps the ``# HELP`` / ``#
TYPE`` headers and the document order, and :func:`render` accepts one, so
the fleet router's fold (:mod:`photon_ml_tpu_torch.telemetry.aggregate`)
re-emits exactly the bytes it was given. Layout per family::

    # HELP name help text
    # TYPE name counter|gauge|histogram
    name{label="value"} 1

Histograms expand to cumulative ``name_bucket{le="..."}`` series (including
``le="+Inf"``) plus ``name_sum`` and ``name_count``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

from photon_ml_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    default_registry,
    host_owned_gauges,
)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def format_value(v: float) -> str:
    """Prometheus float formatting: integers without a trailing ``.0``,
    infinities as ``+Inf``/``-Inf``."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_text(names, values, extra=None) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            out.append({"n": "\n", "\\": "\\"}.get(s[i + 1], s[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def render(registry=None,
           host_tag: Optional[tuple[str, str]] = None) -> str:
    """The registry's current state as exposition text (ends with ``\\n``);
    the process-global registry when ``registry`` is None. A
    :class:`ParsedSnapshot` is re-emitted byte-identically. ``host_tag``
    (e.g. ``("process", "1")``) is appended to every series of a
    host-owned gauge family (``metrics.mark_host_owned``), so a
    multi-process fold never collapses one host's gauge into another's."""
    if isinstance(registry, ParsedSnapshot):
        return render_parsed(registry)
    registry = registry if registry is not None else default_registry()
    host_owned = host_owned_gauges() if host_tag is not None else ()
    lines: list[str] = []
    for fam in registry.collect():
        tag = (host_tag if fam.type == "gauge" and fam.name in host_owned
               else None)
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for values, child in fam.children():
            if isinstance(child, (Counter, Gauge)):
                lines.append(
                    f"{fam.name}{_labels_text(fam.label_names, values, tag)} "
                    f"{format_value(child.value)}")
            elif isinstance(child, Histogram):
                cum, total, count = child.snapshot()
                bounds = [format_value(b) for b in child.uppers] + ["+Inf"]
                for bound, c in zip(bounds, cum):
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labels_text(fam.label_names, values, ('le', bound))}"
                        f" {c}")
                lines.append(
                    f"{fam.name}_sum{_labels_text(fam.label_names, values)} "
                    f"{format_value(total)}")
                lines.append(
                    f"{fam.name}_count{_labels_text(fam.label_names, values)} "
                    f"{count}")
    return "\n".join(lines) + "\n" if lines else ""


def _parse_label_block(block: str) -> dict[str, str]:
    out: dict[str, str] = {}
    i = 0
    while i < len(block):
        eq = block.index("=", i)
        name = block[i:eq].strip().lstrip(",").strip()
        assert block[eq + 1] == '"', f"unquoted label value in {block!r}"
        j = eq + 2
        val = []
        while block[j] != '"':
            if block[j] == "\\":
                nxt = block[j + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                val.append(block[j])
                j += 1
        out[name] = "".join(val)
        i = j + 1
    return out


def parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    return float(s)


class ParsedSnapshot(dict):
    """:func:`parse_text` result: ``{series_name: [(labels, value), ...]}``
    (a plain dict, so pre-existing consumers keep working) plus
    ``families`` — ``{family_name: {"type": ..., "help": ...}}`` in
    document order, carrying the ``# HELP``/``# TYPE`` headers needed to
    re-render the text byte-identically and to merge snapshots
    type-correctly."""

    def __init__(self):
        super().__init__()
        self.families: dict[str, dict] = {}


def parse_text(text: str) -> ParsedSnapshot:
    """Exposition text → :class:`ParsedSnapshot`.

    Histogram series come back under their expanded names
    (``x_bucket``/``x_sum``/``x_count``) — the shape scrapers see. Not a
    general-purpose Prometheus parser (no exemplars, no timestamps — we
    emit neither), but ``render(parse_text(render(reg)))`` is
    byte-identical to ``render(reg)`` — the invariant the fleet
    aggregator depends on.
    """
    out = ParsedSnapshot()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                fam = out.families.setdefault(
                    parts[2], {"type": "untyped", "help": None})
                body = parts[3] if len(parts) > 3 else ""
                if parts[1] == "HELP":
                    fam["help"] = _unescape(body)
                else:
                    fam["type"] = body.strip() or "untyped"
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            block, value_s = rest.rsplit("}", 1)
            labels = _parse_label_block(block)
        else:
            name, value_s = line.rsplit(" ", 1)
            labels = {}
        out.setdefault(name.strip(), []).append(
            (labels, parse_value(value_s.strip())))
    return out


def _sample_line(name: str, labels: Mapping[str, str], value: float) -> str:
    if labels:
        block = ",".join(f'{k}="{_escape_label(v)}"'
                         for k, v in labels.items())
        return f"{name}{{{block}}} {format_value(value)}"
    return f"{name} {format_value(value)}"


def _label_key(labels: Mapping[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


def histogram_series_names(family: str) -> tuple[str, str, str]:
    """The expanded series names a histogram family ``family`` emits."""
    return family + "_bucket", family + "_sum", family + "_count"


def _emit_histogram(lines: list, parsed: ParsedSnapshot, name: str) -> None:
    """Re-emit a histogram family per-child (all of one label set's buckets,
    then its ``_sum`` and ``_count``) — the layout :func:`render` writes, so
    the round-trip stays byte-identical."""
    bucket_name, sum_name, count_name = histogram_series_names(name)
    sums = list(parsed.get(sum_name, ()))
    counts = list(parsed.get(count_name, ()))
    groups: dict[tuple, list] = {}
    for labels, value in parsed.get(bucket_name, ()):
        base = {k: v for k, v in labels.items() if k != "le"}
        groups.setdefault(_label_key(base), []).append((labels, value))

    def pop_matching(samples: list, key: tuple):
        for i, (labels, value) in enumerate(samples):
            if _label_key(labels) == key:
                return samples.pop(i)
        return None

    for key, buckets in groups.items():
        for labels, value in buckets:
            lines.append(_sample_line(bucket_name, labels, value))
        for series, samples in ((sum_name, sums), (count_name, counts)):
            got = pop_matching(samples, key)
            if got is not None:
                lines.append(_sample_line(series, got[0], got[1]))
    # stray _sum/_count with no bucket series (not produced by our
    # renderer, but tolerated rather than dropped)
    for series, samples in ((sum_name, sums), (count_name, counts)):
        for labels, value in samples:
            lines.append(_sample_line(series, labels, value))


def render_parsed(parsed: ParsedSnapshot) -> str:
    """A :class:`ParsedSnapshot` back as exposition text — the exact bytes
    :func:`render` would have produced for the snapshot it was parsed from
    (headers, family order and sample order preserved)."""
    lines: list[str] = []
    claimed: set[str] = set()
    for name, fam in parsed.families.items():
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['type']}")
        if fam["type"] == "histogram":
            claimed.update(histogram_series_names(name))
            _emit_histogram(lines, parsed, name)
        else:
            claimed.add(name)
            for labels, value in parsed.get(name, ()):
                lines.append(_sample_line(name, labels, value))
    for name, samples in parsed.items():  # headerless series, document order
        if name in claimed:
            continue
        for labels, value in samples:
            lines.append(_sample_line(name, labels, value))
    return "\n".join(lines) + "\n" if lines else ""
