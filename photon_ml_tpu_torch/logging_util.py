"""Run logging and stage timing (counterpart of
``photon_ml_tpu/logging_util.py``): a run logger that tees log lines to the
console and ``photon.log`` in the run directory and appends structured
metrics to ``metrics.jsonl``; ``timed`` stage sections, each a telemetry
span of ``kind="stage"`` that posts ``stage_started`` / ``stage_finished``
on the event bus; ``profiled``, a ``torch.profiler`` trace of a stage
(the CUDA activity included on the card) exported as a Chrome trace; and
optimizer traces."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Iterator, Optional

logger = logging.getLogger("photon_ml_tpu_torch")


class RunLogger:
    """Tees log lines to the console and a run-directory log file, and
    appends structured metrics to ``metrics.jsonl``."""

    def __init__(self, run_dir: Optional[str] = None, level=logging.INFO):
        self.run_dir = run_dir
        self._handlers: list[logging.Handler] = []
        root = logging.getLogger("photon_ml_tpu_torch")
        root.setLevel(level)
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
            sh = logging.StreamHandler()
            sh.setFormatter(fmt)
            root.addHandler(sh)
            self._handlers.append(sh)
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(run_dir, "photon.log"))
            fh.setFormatter(fmt)
            root.addHandler(fh)
            self._handlers.append(fh)
        self._metrics_path = (os.path.join(run_dir, "metrics.jsonl")
                              if run_dir else None)
        # one append handle for the logger's lifetime; the lock keeps lines
        # from several threads whole
        self._metrics_lock = threading.Lock()
        self._metrics_fh = (open(self._metrics_path, "a", encoding="utf-8")
                            if self._metrics_path else None)

    def metric(self, **kwargs) -> None:
        kwargs.setdefault("ts", time.time())
        line = json.dumps(kwargs) + "\n"
        with self._metrics_lock:
            if self._metrics_fh is not None:
                self._metrics_fh.write(line)
                self._metrics_fh.flush()
        logger.info("metric %s", kwargs)

    def close(self) -> None:
        with self._metrics_lock:
            if self._metrics_fh is not None:
                self._metrics_fh.close()
                self._metrics_fh = None
        root = logging.getLogger("photon_ml_tpu_torch")
        for h in self._handlers:
            root.removeHandler(h)
            h.close()
        self._handlers.clear()


def log_optimizer_trace(result, label: str,
                        run_logger: Optional[RunLogger] = None) -> None:
    """The per-iteration (value, gradient-norm) table in the run log — the
    reference's ``OptimizationStatesTracker`` dump. ``result`` is one lane's
    :class:`~photon_ml_tpu_torch.optimize.OptimizerResult` with traces
    recorded (``track_states=True``); runs of identical consecutive lines
    collapse into one."""
    import numpy as np

    values = result.values.detach().cpu().numpy()
    gnorms = result.grad_norms.detach().cpu().numpy()
    if values.size == 0:
        return  # traces off
    n = min(int(result.iterations) + 1, len(values))
    logger.info("%s: optimization states (%d iterations, converged=%s)",
                label, max(n - 1, 0), bool(result.converged))
    run_start = None
    run_end = None
    for i in range(n):
        same = (run_start is not None and np.isfinite(values[i])
                and i == run_end + 1
                and values[i] == values[run_start]
                and gnorms[i] == gnorms[run_start])
        if same:
            run_end = i
            continue
        if run_start is not None and run_end > run_start:
            logger.info("%s:   ... unchanged through iter %d", label, run_end)
        logger.info("%s: iter %4d  f=%.8e  |g|=%.4e",
                    label, i, values[i], gnorms[i])
        run_start = run_end = i
    if run_start is not None and run_end > run_start:
        logger.info("%s:   ... unchanged through iter %d", label, run_end)
    if run_logger is not None:
        run_logger.metric(stage="optimizer_states", label=label,
                          iterations=int(result.iterations),
                          converged=bool(result.converged),
                          final_value=float(values[min(n - 1,
                                                       len(values) - 1)]))


@contextlib.contextmanager
def profiled(output_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of a stage (CPU activity, and the CUDA
    activity when a card is present), exported as a Chrome trace
    (``trace.json``, open in ``chrome://tracing`` or Perfetto) under
    ``output_dir``; a no-op when ``output_dir`` is None. The trace is
    written even when the body raises."""
    if not output_dir:
        yield
        return
    import torch

    os.makedirs(output_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(output_dir, "trace.json")
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        # exported once the profiler has stopped (and flushed the device's
        # activity), in a finally, so a failing run still leaves its trace
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def timed(stage: str, run_logger: Optional[RunLogger] = None) -> Iterator[None]:
    """``with timed("Read training data", run_logger): ...`` — a telemetry
    span of ``kind="stage"`` (in the run's ``trace.jsonl`` when
    ``--telemetry-dir`` is configured) whose seconds are the stage's: it
    logs the stage's start and wall seconds, posts ``stage_started`` /
    ``stage_finished`` on the global event bus, and records ``{"stage":
    ..., "seconds": ...}`` in ``metrics.jsonl``."""
    from photon_ml_tpu_torch.events import GLOBAL_BUS
    from photon_ml_tpu_torch.telemetry.tracing import span

    logger.info("%s: start", stage)
    GLOBAL_BUS.post("stage_started", stage=stage)
    sp = None
    try:
        with span(stage, kind="stage") as sp:
            yield
    finally:
        # the span is the stage clock: one timing source
        dt = sp.seconds if sp is not None else 0.0
        logger.info("%s: done in %.2fs", stage, dt)
        GLOBAL_BUS.post("stage_finished", stage=stage, seconds=dt)
        if run_logger is not None:
            run_logger.metric(stage=stage, seconds=round(dt, 3))
