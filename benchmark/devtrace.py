"""The traced run's observers: the kernels' launches and the algorithm's
evaluation points, seen through wrappers of the benchmark's own, the
program's spans, and the device trace of ``torch.profiler``.

- Each launch of the four kernel wrappers, as ``ops/objective.py`` calls
  them, runs inside a ``bench.kernel:<kernel>`` range, and its shapes and
  live rows are recorded. The trace gives every device operation launched
  inside that range to the kernel: its device time. The frozen counts
  (``work/counts.py``) of the recorded shapes give its least time.
- Each evaluation point of ``GLMObjective`` (``value_and_grad``, and
  ``hvp_operator``'s curvature pass and products) is charged the frozen
  count of its shapes, whatever kernel or closed form serves it: the whole
  step's work, for the ``mfu`` metrics.
- Completed program spans (``cd.step`` and the rest) reach the
  observation through a tap on the program's tracer.

Live rows are counted on the device, once per weights (or curvature)
tensor, and read after the traced window.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Optional

import torch

from benchmark.work import counts
from benchmark.work.peaks import least_seconds

#: wrapper name in ``photon_ml_tpu_torch.ops.objective`` -> kernel name
KERNELS = {
    "fused_value_and_grad": "fused_glm",
    "fused_value_and_grad_multi": "fused_glm_multi",
    "fused_entity_value_and_grad": "fused_re",
    "fused_hvp": "fused_hvp",
}
KERNEL_RANGE = "bench.kernel:"
#: device events that take the device's time
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LIVE = "_bench_live_rows"


def live_count(t: torch.Tensor) -> torch.Tensor:
    """Entries of ``t`` above zero (all of them), a 0-d device tensor kept
    on ``t`` per version, so each tensor is counted once."""
    cached = getattr(t, _LIVE, None)
    if cached is not None and cached[0] == t._version:
        return cached[1]
    n = (t > 0).sum()
    setattr(t, _LIVE, (t._version, n))
    return n


def nonzero_count(t: torch.Tensor) -> torch.Tensor:
    cached = getattr(t, _LIVE, None)
    if cached is not None and cached[0] == t._version:
        return cached[1]
    n = (t != 0).sum()
    setattr(t, _LIVE, (t._version, n))
    return n


class TraceSummary:
    """What the traced units read: per kernel its device seconds, least
    seconds and launches; the evaluation points' least seconds; the
    device's busy seconds over the traced window; the heaviest device
    operations and the longest idle gaps by what the host was doing."""

    def __init__(self, window_s, units, busy_s, kernel_device_s,
                 kernel_least_s, kernel_launches, eval_least_s, device_ops,
                 idle_gaps):
        self.window_s = window_s
        self.units = units
        self.busy_s = busy_s
        self.kernel_device_s = kernel_device_s
        self.kernel_least_s = kernel_least_s
        self.kernel_launches = kernel_launches
        self.eval_least_s = eval_least_s
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops[:10],
                "idle_gaps": self.idle_gaps[:10]}


class DeviceTrace:
    """Installs the observers for a traced run and reads the trace."""

    def __init__(self):
        self.active = False
        self.launches: list = []  # (kernel, work fn, args, live tensor)
        self.evals: list = []  # (work fn, args, live tensor, multiplier)
        self._saved: list = []
        self._prof = None
        self._window = None
        self._units = 0
        self._untap = None

    # -- wrappers ---------------------------------------------------------
    def _kernel_wrapper(self, kernel: str, fn):
        trace = self

        def wrapped(*args):
            if not trace.active:
                return fn(*args)
            if kernel == "fused_hvp":
                x, v, d2w = args
                n, d = x.shape
                trace.launches.append((kernel, counts.fused_hvp,
                                       (n, d, x.element_size()),
                                       nonzero_count(d2w)))
            else:
                x, w, weights = args[1], args[2], args[5]
                isz = x.element_size()
                if kernel == "fused_re":
                    e, s, d = x.shape
                    rec = (counts.fused_re, (e, s, d, isz))
                elif kernel == "fused_glm_multi":
                    n, d = x.shape
                    m = w.shape[0]
                    rec = (counts.fused_glm, (n, d, isz, m, m))
                else:
                    n, d = x.shape
                    rec = (counts.fused_glm, (n, d, isz, 1, 1))
                trace.launches.append((kernel, *rec, live_count(weights)))
            with torch.profiler.record_function(KERNEL_RANGE + kernel):
                return fn(*args)

        return wrapped

    def _value_and_grad(self, fn):
        trace = self

        def wrapped(obj, w, data, l2=0.0):
            if trace.active:
                x = getattr(data.design, "x", None)
                if x is not None:
                    isz = x.element_size()
                    live = live_count(data.weights)
                    if x.dim() == 3:
                        e, s, d = x.shape
                        trace.evals.append((counts.fused_re,
                                            (e, s, d, isz), live, 1))
                    elif data.weights.dim() == 1:
                        n, d = x.shape
                        m = 1 if w.dim() == 1 else w.shape[0]
                        trace.evals.append((counts.fused_glm,
                                            (n, d, isz, m, m), live, 1))
            return fn(obj, w, data, l2)

        return wrapped

    def _hvp_operator(self, fn):
        trace = self

        def wrapped(obj, w, data, l2=0.0):
            op = fn(obj, w, data, l2)
            x = getattr(data.design, "x", None)
            if not trace.active or x is None or x.dim() != 2 \
                    or data.weights.dim() != 1:
                return op
            n, d = x.shape
            args = (n, d, x.element_size())
            live = live_count(data.weights)
            lanes = 1 if w.dim() == 1 else w.shape[0]
            # the curvature pass: one pass over the design, as a product
            trace.evals.append((counts.fused_hvp, args, live, lanes))

            def product(v):
                if trace.active:
                    trace.evals.append((counts.fused_hvp, args, live,
                                        1 if v.dim() == 1 else v.shape[0]))
                return op(v)

            return product

        return wrapped

    def install(self, obs) -> None:
        from photon_ml_tpu_torch.ops import objective
        from photon_ml_tpu_torch.telemetry import tracing

        for name, kernel in KERNELS.items():
            fn = getattr(objective, name)
            self._saved.append((objective, name, fn))
            setattr(objective, name, self._kernel_wrapper(kernel, fn))
        cls = objective.GLMObjective
        for name, make in (("value_and_grad", self._value_and_grad),
                           ("hvp_operator", self._hvp_operator)):
            fn = cls.__dict__[name]
            self._saved.append((cls, name, fn))
            setattr(cls, name, make(fn))

        def tap(record):
            if record.get("span_id") is not None:
                obs.spans.append(record)

        self._untap = tracing.GLOBAL_TRACER.add_tap(tap)

    def uninstall(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()
        if self._untap is not None:
            self._untap()
            self._untap = None

    # -- the profiled window ----------------------------------------------
    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.active = True

    def stop(self, window_s: float, units: int) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.active = False
        self._prof.stop()
        self._window = window_s
        self._units = units

    def summary(self) -> Optional[TraceSummary]:
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        return summarize(events, self._window, self._units, self.launches,
                         self.evals)


def _work_sums(records, by_kernel: bool):
    """Least seconds (per record, then summed) and records, by kernel
    (launch records) or under ``"all"`` (evaluation records). Each
    record's count function takes its live rows first. Bytes bind every
    count here: ~1 f32 operation a byte against the peaks' 20."""
    lives = [r[3] if by_kernel else r[2] for r in records]
    host = (torch.stack([t.reshape(()).to(torch.int64) for t in lives])
            .cpu().tolist() if lives else [])
    least, launches = {}, {}
    for rec, live in zip(records, host):
        if by_kernel:
            kernel, fn, args, _ = rec
            mult = 1
        else:
            fn, args, _, mult = rec
            kernel = "all"
        w = fn(live, *args)
        sec, _ = least_seconds(w.ops * mult, w.nbytes * mult)
        least[kernel] = least.get(kernel, 0.0) + sec
        launches[kernel] = launches.get(kernel, 0) + mult
    return least, launches


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _short(name: str, width: int = 96) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name if len(name) <= width else name[:width - 3] + "..."


def summarize(events, window_s, units, launches, evals) -> TraceSummary:
    """Reads the profiler's chrome-trace events (times in microseconds)."""
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    runtime = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                runtime[corr] = e
    ranges = sorted(
        (e["ts"], e["ts"] + e.get("dur", 0), e.get("tid"),
         e["name"][len(KERNEL_RANGE):])
        for e in events if e.get("ph") == "X"
        and e.get("cat") == "user_annotation"
        and e.get("name", "").startswith(KERNEL_RANGE))
    starts = [r[0] for r in ranges]

    def kernel_of(ev) -> Optional[str]:
        rt = runtime.get(ev.get("args", {}).get("correlation"))
        if rt is None:
            return None
        t = rt["ts"]
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ranges[i][1] >= t:
            if ranges[i][2] == rt.get("tid"):
                return ranges[i][3]
            i -= 1
        return None

    kernel_device = {}
    ops = {}
    for ev in device:
        dur = ev.get("dur", 0) * 1e-6
        k = kernel_of(ev)
        if k is not None:
            kernel_device[k] = kernel_device.get(k, 0.0) + dur
        label = (f"{k}: " if k else "") + _short(ev.get("name", "?"))
        ops[label] = ops.get(label, 0.0) + dur
    busy = _union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6

    kernel_least, kernel_launches = _work_sums(launches, True)
    eval_least, _ = _work_sums(evals, False)
    gaps = idle_gaps(events, busy)
    return TraceSummary(
        window_s=window_s, units=units, busy_s=busy_s,
        kernel_device_s=kernel_device, kernel_least_s=kernel_least,
        kernel_launches=kernel_launches,
        eval_least_s=eval_least.get("all", 0.0),
        device_ops=sorted(([k, v] for k, v in ops.items()),
                          key=lambda kv: -kv[1]),
        idle_gaps=gaps)


def idle_gaps(events, busy) -> list:
    """Idle seconds between device operations, summed by what the host's
    unit thread was doing at each gap's middle: the innermost program
    range (``cd.step[...]``, ``re.sweep[...]``; the harness's own ranges
    left out) and the innermost host operation. Longest first."""
    units = [e for e in events if e.get("ph") == "X"
             and e.get("name") == "bench.unit"]
    if not units or len(busy) < 2:
        return []
    tid = units[0].get("tid")
    host = sorted(
        ((e["ts"], e["ts"] + e.get("dur", 0), e.get("cat"), e["name"])
         for e in events if e.get("ph") == "X" and e.get("tid") == tid
         and e.get("cat") in ("user_annotation", "cpu_op", "python_function",
                              "cuda_runtime", "cuda_driver")),
        key=lambda r: (r[0], -r[1]))
    gaps = sorted(((s + e) / 2, e - s) for (_, s), (e, _) in
                  zip(busy[:-1], busy[1:]) if e > s)
    totals: dict = {}
    stack: list = []
    j = 0
    for mid, length in gaps:
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        live = [h for h in stack if h[1] >= mid]
        program = next((h[3] for h in reversed(live)
                        if h[2] == "user_annotation"
                        and not h[3].startswith("bench.")), "")
        inner = next((h[3] for h in reversed(live)
                      if not h[3].startswith("bench.")), "host")
        label = _short(f"{program} | {inner}" if program and
                       program != inner else inner)
        totals[label] = totals.get(label, 0.0) + length * 1e-6
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])


def roofline_share(obs, kernel: str) -> Optional[float]:
    """Kernel ``kernel``'s share of its roofline over the traced units, in
    %: its launches' least time over its device time."""
    t = obs.trace
    if t is None or t.kernel_device_s.get(kernel, 0.0) <= 0.0 \
            or kernel not in t.kernel_least_s:
        return None
    return 100.0 * t.kernel_least_s[kernel] / t.kernel_device_s[kernel]


def mfu(obs) -> Optional[float]:
    """The traced units' share of the chip's roofline peak, in %: the
    least time of the work charged at the evaluation points over the
    traced window's wall."""
    t = obs.trace
    if t is None or t.eval_least_s <= 0.0 or not t.window_s:
        return None
    return 100.0 * t.eval_least_s / t.window_s


def idle_share(obs) -> Optional[float]:
    t = obs.trace
    if t is None or not t.window_s or t.busy_s <= 0.0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)

