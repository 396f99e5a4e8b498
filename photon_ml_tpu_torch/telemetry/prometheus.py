"""Prometheus text exposition (format 0.0.4) of a :class:`MetricsRegistry`.

The writer half of ``photon_ml_tpu/telemetry/prometheus.py``: :func:`render`
turns a registry snapshot into the text every Prometheus-compatible scraper
ingests, as ``GET /metrics`` serves it. Layout per family::

    # HELP name help text
    # TYPE name counter|gauge|histogram
    name{label="value"} 1

Histograms expand to cumulative ``name_bucket{le="..."}`` series (including
``le="+Inf"``) plus ``name_sum`` and ``name_count``.
"""

from __future__ import annotations

import math

from photon_ml_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    default_registry,
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


def render(registry=None) -> str:
    """The registry's current state as exposition text (ends with ``\\n``);
    the process-global registry when ``registry`` is None."""
    registry = registry if registry is not None else default_registry()
    lines: list[str] = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for values, child in fam.children():
            if isinstance(child, (Counter, Gauge)):
                lines.append(
                    f"{fam.name}{_labels_text(fam.label_names, values)} "
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
