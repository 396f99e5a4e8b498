"""Per-call compile and execute accounting, with the kernels' analytic work.

Counterpart of ``photon_ml_tpu/telemetry/profiling.py``, under the same
family names and ``fn`` labels. The JAX module drives each hot jitted
program through the AOT API and reads XLA's cost model; the port has no
program to compile per call, so its two halves are:

- :func:`profile_fn` wraps a training call site (the fixed-effect solve,
  a random-effect bucket solve, a GLM sweep's solve) and records, under
  ``fn=<name>``:

  - ``photon_execute_latency_seconds{fn}``: the call's wall on the host.
    As in the JAX package this is dispatch latency by default (CUDA
    launches are asynchronous); ``block=True`` synchronises the device
    before the clock stops;
  - ``photon_flops_total{fn}`` / ``photon_bytes_accessed_total{fn}``: the
    sums of the analytic operation and byte counts of the kernel launches
    made inside the call. Each count is computed beside its kernel's
    dispatch in ``ops/objective.py`` from the kernel's own count function
    (``ops/fused_glm.py::work`` for kernels 1 and 4,
    ``ops/fused_re.py::work`` for kernel 2, ``ops/fused_hvp.py::work`` for
    kernel 3, the same functions ``chip_smoke.py`` divides by the card's
    rates for its bounds), so the plain versions on the CPU count the
    work the kernels do on the card. Closed-form evaluations (sparse or
    normalized designs) launch no kernel and count nothing;
  - ``photon_peak_memory_bytes{fn}``: on the card, the caching
    allocator's peak of allocated bytes over the call
    (``torch.cuda.reset_peak_memory_stats`` at entry,
    ``torch.cuda.max_memory_allocated`` at exit: host-side reads, no
    sync). It covers every live tensor of the process, the call's inputs
    among them, where the JAX gauge is one program's arguments, outputs
    and temporaries. The gauge keeps the largest call under the name.

- :func:`record_compile` (or :func:`timed_compile` around the build)
  counts real builds: each ``nvcc`` build of a kernel library
  (``ops/cuda_build.py``, ``fn="cuda.<library>"``, with the nvcc wall; a
  cached library counts nothing) and each CUDA-graph
  capture of the serving engines (``fn="serving.score"`` and
  ``fn="serving.rank"``, the JAX package's labels).

The accounting runs while a telemetry session is live
(:func:`set_accounting`, turned on by
:class:`~photon_ml_tpu_torch.telemetry.TelemetrySession`): off, a wrapped
call is the bare call, and no live-row count (one host read per weights
tensor, ``ops/objective.py::live_rows``) is ever taken.

The random effects carry the JAX package's labels: a resident
coordinate's whole sweep under ``game.re.sweep_fused`` (one lockstep
drive of every bucket's solve), a streaming or projected one's bucket
solves each under ``game.re.solve_bucket``.

No counterpart, by design: ``install_xla_hooks`` and its
``photon_xla_compiles_total`` / ``photon_xla_compile_seconds_total``
families, which read XLA's compile pipeline.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterator, Optional

from photon_ml_tpu_torch.telemetry import metrics as _metrics
from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry

__all__ = [
    "ProfiledFunction",
    "profile_fn",
    "record_compile",
    "timed_compile",
    "total_compiles",
    "set_accounting",
    "accounting",
    "count",
]


def _families(registry: Optional[MetricsRegistry] = None):
    """The profiling metric families on ``registry`` (the default registry
    when None); get-or-create is idempotent, so every wrapper shares
    them."""
    reg = registry if registry is not None else _metrics.default_registry()
    return {
        "compiles": reg.counter(
            "photon_compiles_total",
            "Builds per fn label: nvcc builds of a kernel library, CUDA "
            "graph captures of the serving engines (flat after warmup = "
            "the zero-recompile contract)",
            labels=("fn",)),
        "compile_seconds": reg.counter(
            "photon_compile_seconds_total",
            "Wall seconds spent building, per fn label", labels=("fn",)),
        "execute": reg.histogram(
            "photon_execute_latency_seconds",
            "Per-call latency of a profiled call site (dispatch-side "
            "unless the wrapper blocks; CUDA launches are async)",
            labels=("fn",)),
        "flops": reg.counter(
            "photon_flops_total",
            "Operations of the kernel launches made inside the call "
            "(each kernel's analytic count), accumulated per call",
            labels=("fn",)),
        "bytes": reg.counter(
            "photon_bytes_accessed_total",
            "Bytes the kernel launches made inside the call must move "
            "(each kernel's analytic count), accumulated per call",
            labels=("fn",)),
        "peak_memory": reg.gauge(
            "photon_peak_memory_bytes",
            "Peak of the caching allocator's allocated bytes over the "
            "heaviest call under the fn label (CUDA only)",
            labels=("fn",)),
    }


def record_compile(name: str, seconds: float = 0.0,
                   registry: Optional[MetricsRegistry] = None) -> None:
    """Count one build under ``fn=name`` (``seconds`` of wall when the
    caller measured it)."""
    fams = _families(registry)
    fams["compiles"].labels(fn=name).inc()
    if seconds > 0:
        fams["compile_seconds"].labels(fn=name).inc(seconds)


@contextlib.contextmanager
def timed_compile(name: str, registry: Optional[MetricsRegistry] = None,
                  ) -> Iterator[None]:
    """``with timed_compile(name): <build>`` — :func:`record_compile` with
    the block's wall, once the block returns (a build that raises counts
    nothing)."""
    t0 = time.perf_counter()
    yield
    record_compile(name, time.perf_counter() - t0, registry)


def total_compiles(registry: Optional[MetricsRegistry] = None) -> float:
    """Sum of ``photon_compiles_total`` across every ``fn`` label — the
    number coordinate descent stamps on each ``cd.sweep`` span."""
    reg = registry if registry is not None else _metrics.default_registry()
    fam = reg.get("photon_compiles_total")
    if fam is None:
        return 0.0
    return sum(child.value for _labels, child in fam.children())


# --- the analytic work of kernel launches ----------------------------------

_accounting_lock = threading.Lock()
_accounting_users = 0  # guarded-by: _accounting_lock
#: open profiled calls of this thread, innermost last: [ops, bytes] each
_scopes = threading.local()


def set_accounting(on: bool) -> None:
    """Turn the accounting of :func:`profile_fn` on (a telemetry session
    starts) or off (it closes); sessions nest by count."""
    global _accounting_users
    with _accounting_lock:
        _accounting_users = max(0, _accounting_users + (1 if on else -1))


def accounting() -> bool:
    """True while a profiled call of this thread is open under a live
    session: the kernel dispatch then counts its work (:func:`count`)."""
    return bool(getattr(_scopes, "open", None))


def count(ops: float, nbytes: float) -> None:
    """Add one kernel launch's analytic work to every open profiled call
    of this thread (outer calls include their inner calls' work)."""
    for acc in getattr(_scopes, "open", ()):
        acc[0] += ops
        acc[1] += nbytes


def _cuda_peak_reset():
    """The CUDA device whose allocator peak was reset, or None (CPU, or
    CUDA not initialised by this process)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    dev = torch.cuda.current_device()
    torch.cuda.reset_peak_memory_stats(dev)
    return dev


class ProfiledFunction:
    """``fn`` with per-call execute and work accounting under
    ``fn=name`` (see the module docstring); same call surface."""

    def __init__(self, fn: Callable, name: str, *, block: bool = False,
                 registry: Optional[MetricsRegistry] = None):
        self.name = name
        self._fn = fn
        self._block = block
        self._registry = registry

    def __call__(self, *args, **kwargs):
        if not _accounting_users:
            return self._fn(*args, **kwargs)
        # the label sets appear with the first accounted call, as the JAX
        # wrapper's appear with its construction at the call site
        fams = _families(self._registry)
        opened = getattr(_scopes, "open", None)
        if opened is None:
            opened = _scopes.open = []
        acc = [0.0, 0.0]
        opened.append(acc)
        dev = _cuda_peak_reset()
        try:
            with fams["execute"].labels(fn=self.name).time():
                out = self._fn(*args, **kwargs)
                if self._block and dev is not None:
                    import torch

                    torch.cuda.synchronize(dev)
        finally:
            opened.pop()
        fams["flops"].labels(fn=self.name).inc(acc[0])
        fams["bytes"].labels(fn=self.name).inc(acc[1])
        if dev is not None:
            import torch

            gauge = fams["peak_memory"].labels(fn=self.name)
            peak = torch.cuda.max_memory_allocated(dev)
            if peak > gauge.value:
                gauge.set(peak)
        return out


def profile_fn(fn: Callable, name: str, *, block: bool = False,
               registry: Optional[MetricsRegistry] = None,
               ) -> ProfiledFunction:
    """Wrap ``fn`` with execute and work accounting under ``fn=name``: the
    port's counterpart of ``profile_jit`` at the hot call sites."""
    return ProfiledFunction(fn, name, block=block, registry=registry)
