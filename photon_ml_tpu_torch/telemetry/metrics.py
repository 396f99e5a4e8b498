"""Thread-safe labeled metrics registry: Counter / Gauge / Histogram.

A copy of ``photon_ml_tpu/telemetry/metrics.py`` (stdlib only).

The reference's observability surface is a durable per-run log
(``util/PhotonLogger.scala``) read after the fact; a system serving live
traffic (serving/) while training at hardware speed (game/) needs the
complementary live surface: process-local metric families any thread can
update in nanoseconds and any scraper can snapshot consistently. This module
is that surface — deliberately zero-dependency (stdlib only; no prometheus
client in the image) and small enough to audit:

- a **family** is (name, type, help, label names); ``labels(**kv)`` resolves
  a **child** (one time series). A family created twice with the same
  signature is the same object (idempotent get-or-create, so instrumented
  modules can declare their families at import time without coordination);
  a conflicting re-declaration raises.
- **Counter** only goes up; **Gauge** sets/adds; **Histogram** has fixed
  upper bounds (cumulative, Prometheus-style) plus ``sum``/``count`` and
  bucket-interpolated quantile estimation. ``Histogram.time()`` is the
  sanctioned latency timer: serving code times its stages through it, so
  every latency measurement flows through one accounting chokepoint.
- the **default registry** is process-global (``default_registry()``); the
  Prometheus exposition (:mod:`photon_ml_tpu_torch.telemetry.prometheus`) and the
  ``/metrics`` endpoint render it. Tests build private ``MetricsRegistry``
  instances for exact-count assertions.

Every update takes one small lock (registry lock for get-or-create, child
lock for the value); no allocation on the hot path after the first
``labels()`` resolution — cache the child in a local when instrumenting a
tight loop.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Iterator, Mapping, Optional, Sequence

#: Prometheus-idiomatic latency buckets (seconds): sub-millisecond serving
#: hits through multi-second compiles all land in a resolved bucket.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Timer:
    """``with histogram.time() as t: ...`` — observes the elapsed seconds on
    exit and leaves them on ``t.seconds`` for callers that also need the
    value (e.g. a response payload)."""

    __slots__ = ("_hist", "_t0", "seconds", "_discarded")

    def __init__(self, hist: "Histogram"):
        self._hist = hist
        self.seconds = 0.0
        self._discarded = False

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        """Running read of the open timer (for a mid-region log line) —
        the observation itself still happens once, at exit."""
        return time.perf_counter() - self._t0

    def discard(self) -> None:
        """Suppress the exit-time observation: the timed region turned out
        not to represent the measured population (e.g. a request shed by
        admission control must not pollute the latency distribution).
        ``seconds`` is still filled in at exit for the caller."""
        self._discarded = True

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if not self._discarded:
            self._hist.observe(self.seconds)


class Counter:
    """Monotonically increasing value (one labeled time series)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter can only go up, got inc({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Settable value (one labeled time series)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with cumulative counts (Prometheus layout:
    ``le``-bounded buckets + implicit ``+Inf``), total ``sum``/``count``,
    and bucket-interpolated quantiles."""

    __slots__ = ("uppers", "_lock", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        uppers = tuple(sorted(float(b) for b in buckets))
        if not uppers:
            raise ValueError("histogram needs at least one bucket bound")
        if len(set(uppers)) != len(uppers):
            raise ValueError(f"duplicate bucket bounds in {uppers}")
        self.uppers = uppers
        self._lock = threading.Lock()
        self._counts = [0] * (len(uppers) + 1)  # +1 = the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.uppers, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def time(self) -> _Timer:
        return _Timer(self)

    def snapshot(self) -> tuple[list[int], float, int]:
        """(cumulative counts per bound + +Inf, sum, count) — one consistent
        read."""
        with self._lock:
            counts = list(self._counts)
        cum = []
        running = 0
        for c in counts:
            running += c
            cum.append(running)
        return cum, self._sum, self._count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        cum, _, total = self.snapshot()
        return quantile_from_buckets(self.uppers, cum, q)


def quantile_from_buckets(uppers: Sequence[float],
                          cumulative_counts: Sequence[int],
                          q: float) -> float:
    """Estimate the ``q``-quantile from cumulative bucket counts
    (``cumulative_counts`` has one entry per upper bound plus a final
    ``+Inf`` entry). Linear interpolation within the crossing bucket — the
    same estimate Prometheus's ``histogram_quantile`` computes — with the
    first bucket's lower bound taken as 0 (these are latency histograms).
    Shared by :meth:`Histogram.quantile` and by consumers of *parsed*
    exposition text."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = cumulative_counts[-1]
    if total == 0:
        return math.nan
    rank = q * total
    prev_upper, prev_cum = 0.0, 0
    for upper, cum in zip(list(uppers) + [math.inf], cumulative_counts):
        if cum >= rank:
            if math.isinf(upper):
                # rank falls past the last finite bound: the bound itself is
                # the best (under-)estimate, as in Prometheus
                return prev_upper if prev_cum else float(uppers[-1])
            in_bucket = cum - prev_cum
            frac = 1.0 if in_bucket == 0 else (rank - prev_cum) / in_bucket
            return prev_upper + (upper - prev_upper) * frac
        prev_upper, prev_cum = upper, cum
    return float(uppers[-1])  # pragma: no cover - loop always crosses


_TYPES = ("counter", "gauge", "histogram")
_CHILD_CLS = {"counter": Counter, "gauge": Gauge}


class MetricFamily:
    """(name, type, help, label names) + the children keyed by label
    values. Zero-label families proxy updates straight through
    (``family.inc()`` == ``family.labels().inc()``)."""

    def __init__(self, name: str, type_: str, help_: str,
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        if type_ not in _TYPES:
            raise ValueError(f"metric type must be one of {_TYPES}, "
                             f"got {type_!r}")
        self.name = name
        self.type = type_
        self.help = help_
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(float(b) for b in buckets)) \
            if buckets else ()
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.label_names:
            # a label-free family IS its one series: materialize it so the
            # exposition shows it at zero from declaration (scrapers need
            # the zero to compute rates across the first increment)
            self._children[()] = self._make_child()

    def _make_child(self):
        if self.type == "histogram":
            return Histogram(self.buckets)
        return _CHILD_CLS[self.type]()

    def labels(self, **labels: str):
        got = tuple(sorted(labels))
        want = tuple(sorted(self.label_names))
        if got != want:
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(labels[k]) for k in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def children(self) -> Iterator[tuple[tuple[str, ...], object]]:
        """Snapshot of (label values, child) in insertion order."""
        with self._lock:
            return iter(list(self._children.items()))

    # --- zero-label conveniences -----------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def time(self) -> _Timer:
        return self.labels().time()

    def quantile(self, q: float) -> float:
        return self.labels().quantile(q)

    @property
    def value(self) -> float:
        return self.labels().value

    @property
    def count(self) -> int:
        return self.labels().count


class MetricsRegistry:
    """Thread-safe family store. Get-or-create is idempotent on an exact
    signature match and loud on a conflict — two modules disagreeing on what
    ``photon_x_total`` means should fail at declaration, not at scrape."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}

    def _get_or_create(self, name: str, type_: str, help_: str,
                       labels: Sequence[str],
                       buckets: Sequence[float]) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(name, type_, help_, labels, buckets)
                self._families[name] = fam
                return fam
        if fam.type != type_ or fam.label_names != tuple(labels) or (
                type_ == "histogram" and fam.buckets != tuple(
                    sorted(float(b) for b in buckets))):
            raise ValueError(
                f"metric {name!r} already registered as {fam.type} with "
                f"labels {fam.label_names}; conflicting re-declaration "
                f"({type_}, {tuple(labels)})")
        return fam

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, "counter", help_, labels, ())

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, "gauge", help_, labels, ())

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  ) -> MetricFamily:
        return self._get_or_create(name, "histogram", help_, labels, buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def collect(self) -> list[MetricFamily]:
        """Families in registration order (the exposition walks this)."""
        with self._lock:
            return list(self._families.values())


#: gauge families whose value is meaningful PER HOST (queue depth, RSS,
#: device memory): a fleet aggregate must fan them out under a ``process``
#: label instead of letting one host's value overwrite another's. The set
#: holds NAMES (not family objects) so marking works at declaration time
#: and the exposition layer can consult it without import cycles.
_HOST_OWNED_GAUGES: set[str] = set()


def mark_host_owned(name: str) -> None:
    """Declare gauge family ``name`` per-host-owned: multi-process renders
    tag its series with a ``process`` label (see ``prometheus.render``) so
    the fleet aggregate keeps one series per host. Counters and histograms
    never need this — they sum."""
    _HOST_OWNED_GAUGES.add(name)


def host_owned_gauges() -> frozenset:
    return frozenset(_HOST_OWNED_GAUGES)


#: the process-global registry — instrumented modules and the ``/metrics``
#: exposition meet here
_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT_REGISTRY


def counter(name: str, help_: str = "",
            labels: Sequence[str] = ()) -> MetricFamily:
    """Get-or-create on the default registry (module-level shorthand)."""
    return _DEFAULT_REGISTRY.counter(name, help_, labels)


def gauge(name: str, help_: str = "",
          labels: Sequence[str] = ()) -> MetricFamily:
    return _DEFAULT_REGISTRY.gauge(name, help_, labels)


def histogram(name: str, help_: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
              ) -> MetricFamily:
    return _DEFAULT_REGISTRY.histogram(name, help_, labels, buckets)
