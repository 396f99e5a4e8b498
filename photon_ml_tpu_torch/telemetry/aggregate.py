"""Fleet-wide metric aggregation: fold N registry snapshots into one.

Counterpart of ``photon_ml_tpu/telemetry/aggregate.py``, on the
:mod:`~photon_ml_tpu_torch.telemetry.prometheus` render/parse round trip,
so every transport shares one merge:

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
- :class:`FleetMetricsAggregator`: the in-training collective transport.
  Every process renders its registry and the texts ride
  :func:`~photon_ml_tpu_torch.parallel.multihost.allgather_text` (one
  symmetric host collective); process 0 keeps the aggregate. Training
  calls :func:`sweep_boundary` at coordinate-descent sweep (and GLM
  lambda) boundaries; the fold hook is installed only under
  ``--metrics-port``, on every process of the job, so bare runs pay
  nothing.
- :class:`MetricsHTTPServer`: the chief's live ``GET /metrics`` listener
  (``--metrics-port``), serving the latest fleet aggregate.
- :func:`merge_trace_files`: per-process ``trace.jsonl`` files folded into
  one wall-clock-ordered timeline, each record tagged with its
  ``process``; the unique span key there is ``(process, span_id)``.

The offline transport over the same fold is the repo's
``tools/metrics_fold.py``: both feed the same snapshot texts in process
order through :func:`aggregate_text`, so their outputs are byte-identical.
"""
from __future__ import annotations

import json
import logging
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Optional, Sequence

from photon_ml_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    default_registry,
)
from photon_ml_tpu_torch.telemetry.prometheus import (
    CONTENT_TYPE,
    ParsedSnapshot,
    histogram_series_names,
    parse_text,
    render,
)

logger = logging.getLogger(__name__)


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


# ---------------------------------------------------------------------------
# in-training collective fold + sweep-boundary hooks
# ---------------------------------------------------------------------------


class FleetMetricsAggregator:
    """Collective registry fold with a thread-safe "latest aggregate" slot.

    :meth:`fold` is a COLLECTIVE: every process of the job must call it at
    the same point (the sweep-boundary hook guarantees this — the hook is
    installed by the same ``--metrics-port`` flag on every process).
    Single-process jobs degrade to the identity fold and :meth:`latest`
    renders live instead of serving the last fold's snapshot.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self._lock = threading.Lock()
        self._latest: Optional[str] = None  # guarded-by: _lock

    def local_text(self) -> str:
        """This process's registry rendered for the fold (host-owned gauges
        tagged with this process's index on multi-process jobs)."""
        tag = process_tag()
        return render(self.registry,
                      host_tag=None if tag is None else ("process", tag))

    def fold(self, local_text: Optional[str] = None) -> Optional[str]:
        """Gather every process's rendered registry and materialize the
        aggregate on process 0 (returned there; None on workers). Pass
        ``local_text`` to fold an already-rendered snapshot — the close
        path does, so the dumped ``metrics.prom`` and the folded text are
        the same bytes."""
        text = local_text if local_text is not None else self.local_text()
        from photon_ml_tpu_torch.parallel.multihost import allgather_text

        texts = allgather_text(text)
        if not is_chief():
            return None
        agg = aggregate_text(texts)
        with self._lock:
            self._latest = agg
        return agg

    def latest(self) -> str:
        """The most recent aggregate (as fresh as the last sweep
        boundary); before the first fold — or on single-process jobs,
        where there is nothing to wait for — a live local render."""
        if process_tag() is not None:
            with self._lock:
                if self._latest is not None:
                    return self._latest
        return self.local_text()


#: sweep-boundary hooks; empty (the common case) costs one truthiness check
_SWEEP_HOOKS: list = []


def install_sweep_hook(fn: Callable) -> Callable[[], None]:
    """Register ``fn(**info)`` to run at every coordinate-descent sweep /
    GLM lambda boundary; returns the uninstaller. The telemetry session
    owns install/uninstall — a hook left behind after its run would turn
    the next single-process fit into a hung collective."""
    _SWEEP_HOOKS.append(fn)

    def uninstall() -> None:
        try:
            _SWEEP_HOOKS.remove(fn)
        except ValueError:
            pass

    return uninstall


def sweep_boundary(**info) -> None:
    """Training's fold point (called by ``game/coordinate_descent.py``,
    ``game/multiprocess.py`` and ``glm/training.py`` once per sweep or
    lambda, at a collective-symmetric position). No hooks installed — the default — is
    a no-op; hook failures are logged, never raised (telemetry must not
    kill a run)."""
    if not _SWEEP_HOOKS:
        return
    for fn in list(_SWEEP_HOOKS):
        try:
            fn(**info)
        except Exception:
            logger.warning("sweep-boundary telemetry hook failed",
                           exc_info=True)


# ---------------------------------------------------------------------------
# the chief's live scrape endpoint
# ---------------------------------------------------------------------------


def _make_handler(provider: Callable[[], str]):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, status: int, data: bytes, content_type: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            if self.path == "/metrics":
                try:
                    body = provider().encode("utf-8")
                except Exception as e:  # provider must not kill the server
                    self._reply(500, json.dumps(
                        {"error": repr(e)}).encode(), "application/json")
                    return
                self._reply(200, body, CONTENT_TYPE)
            elif self.path == "/healthz":
                self._reply(200, json.dumps({"status": "ok"}).encode(),
                            "application/json")
            else:
                self._reply(404, json.dumps(
                    {"error": f"unknown path {self.path}"}).encode(),
                    "application/json")

    return Handler


class MetricsHTTPServer:
    """Threaded ``GET /metrics`` listener serving ``provider()`` — the
    training-side sibling of ``serving/http.py::GameServer`` (same
    start/stop lifecycle, same exposition content type)."""

    def __init__(self, provider: Callable[[], str], *,
                 host: str = "127.0.0.1", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_handler(provider))
        #: start/stop are operator-lifecycle calls from one control thread
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MetricsHTTPServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="photon-metrics-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


# ---------------------------------------------------------------------------
# span-trace merge
# ---------------------------------------------------------------------------


def merge_trace_files(paths: Iterable[tuple[int, str]]) -> list[dict]:
    """Fold per-process ``trace.jsonl`` files into one timeline.

    ``paths`` yields ``(process_index, path)``. Every record gains a
    ``process`` attribute; the result is sorted by wall-clock ``ts``
    (stable, so same-timestamp records keep per-process file order) —
    cross-host sweep skew reads directly off adjacent ``cd.sweep`` spans.
    Span/parent ids keep their per-process scope: the unique span key in a
    merged trace is ``(process, span_id)``.
    """
    records: list[dict] = []
    for pid, path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                rec["process"] = pid
                records.append(rec)
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records
