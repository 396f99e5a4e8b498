"""Periodic host and device memory sampler → gauges.

Counterpart of ``photon_ml_tpu/telemetry/device.py``, with the same
gauges: host RSS (the Avro read and the host mirrors) and, per CUDA device
this process has touched, the bytes the caching allocator holds for live
tensors (``torch.cuda.memory_stats(dev)["allocated_bytes.all.current"]``)
and the card's total memory (``torch.cuda.mem_get_info(dev)[1]``). The
sampler polls on a background thread at a configurable interval; it is off
by default and gated behind the drivers' ``--telemetry-poll-s`` flag (0
disables). On the CPU, or before the process has initialised CUDA, it
reports RSS only, as the JAX sampler does on a plain CPU backend: a
sampler thread must never be what creates a CUDA context.

The wait uses ``threading.Event.wait``, so shutdown is immediate. A failed
sample logs at debug level and keeps polling: a flaky stat must never kill
telemetry, let alone the run.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from photon_ml_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    default_registry,
    mark_host_owned,
)

logger = logging.getLogger(__name__)

# per-host-owned gauges: a fleet aggregate keeps one series per process
# (tagged at render time), not the chief's RSS over a worker's
mark_host_owned("photon_host_rss_bytes")
mark_host_owned("photon_device_bytes_in_use")
mark_host_owned("photon_device_bytes_limit")


def host_rss_bytes() -> Optional[int]:
    """Resident set size of this process, or None when unreadable."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        # ru_maxrss is KiB on Linux
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


def cuda_memory() -> list[tuple[int, int, int]]:
    """``(device index, bytes in use, bytes limit)`` for each CUDA device,
    read from the caching allocator and the driver; empty on the CPU or
    before this process initialised CUDA (reading would create a
    context)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        in_use = torch.cuda.memory_stats(i).get(
            "allocated_bytes.all.current", 0)
        out.append((i, int(in_use), int(torch.cuda.mem_get_info(i)[1])))
    return out


class DeviceStatsSampler:
    """Background gauge poller; ``start()``/``close()`` lifecycle."""

    def __init__(self, interval_s: float,
                 registry: Optional[MetricsRegistry] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        reg = registry if registry is not None else default_registry()
        self._rss = reg.gauge("photon_host_rss_bytes",
                              "Process resident set size")
        self._in_use = reg.gauge("photon_device_bytes_in_use",
                                 "Accelerator memory in use, per device",
                                 labels=("device",))
        self._limit = reg.gauge("photon_device_bytes_limit",
                                "Accelerator memory limit, per device",
                                labels=("device",))
        self._samples = reg.counter("photon_device_samples_total",
                                    "Completed sampler polls")
        self._stop = threading.Event()
        #: start/close are operator-lifecycle calls from one control thread
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller

    def sample_once(self) -> None:
        """One poll (also callable synchronously from tests)."""
        rss = host_rss_bytes()
        if rss is not None:
            self._rss.set(rss)
        try:
            for dev, in_use, limit in cuda_memory():
                self._in_use.labels(device=str(dev)).set(in_use)
                self._limit.labels(device=str(dev)).set(limit)
        except Exception:
            logger.debug("device memory stats unavailable", exc_info=True)
        self._samples.inc()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # the sampler must never die mid-run
                logger.debug("telemetry sample failed", exc_info=True)

    def start(self) -> "DeviceStatsSampler":
        self.sample_once()  # one immediate sample: gauges exist right away
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="photon-telemetry-sampler")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
