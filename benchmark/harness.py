"""The benchmark's harness: one cell's set-up, measured window, metrics,
correctness check and result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

- ``workloads/<cell>.json``: the cell's configuration, traffic name and
  parameters, chips, why, and the limit of each number compared;
- ``configs/<config>.json``: the configuration's sizes, its source, its
  cuts (``reduced``) and its assumptions, and the driver that runs it;
- ``drivers/<driver>.py``: ``setup``, ``unit``, ``keep``, ``check``;
- ``metrics/<metric>.py``: ``read(obs)``, one reader per metric name of
  ``BENCHMARK.json`` (end-to-end and per-layer alike); a reader that finds
  nothing to read returns None and the metric is left out of the line.

A driver's ``setup(config, traffic, seed, device, obs)`` draws the cell's
data from the seed and builds what the program needs; ``unit(state, obs)``
runs one unit of work (a fit, a sweep) and returns its output, which
``keep`` shrinks to what the check needs; ``check(state, kept, seed)``
frees the program's state and compares the kept outputs with the plain
reference under ``benchmark/reference/``, returning ``{name: number}``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import random
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"

#: top-level module names no run may load: JAX and the JAX package (whose
#: name the port's begins with, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "photon_ml_tpu")

#: the longest stretch of a ``--trace 1`` window the profiler records, in
#: whole units (at least one): the rest of the window runs untraced
TRACE_SECONDS = 3.0


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def set_host_threads(wl: dict) -> None:
    """The cell's ``host_threads``, if it names them, for the CPU side of
    torch and numpy; to take effect before torch is first imported. On a
    shared host a GLM sweep's walls swung by half between runs of the
    same work with a thread a core, and steadied with one; a GAME fit,
    whose host-side index and sort operations run in parallel, is slower
    with one and no steadier."""
    threads = wl.get("host_threads")
    if threads:
        os.environ["OMP_NUM_THREADS"] = str(threads)
        os.environ["MKL_NUM_THREADS"] = str(threads)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    key = f"benchmark._{kind}." + name.replace(".", "__").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: with ``trace`` the per-layer
    ones, else the end-to-end ones, each only where its ``workloads`` name
    the cell (an end-to-end metric without ``workloads`` goes with every
    cell; a per-layer metric always lists its cells)."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules
                   if name.split(".", 1)[0] in FORBIDDEN})


class Observation:
    """What one run saw, for the metric readers: the window's units and
    seconds, the program's counters and spans, the harness's own clock
    readings, the driver's notes and, in a traced run, the device trace's
    summary (:class:`benchmark.devtrace.TraceSummary`)."""

    def __init__(self):
        self.setup_seconds: Optional[float] = None
        self.window_seconds = 0.0
        self.completed = 0
        self.attempted = 0
        self.failed = 0
        self.unit_seconds: list[float] = []
        self.peak_bytes = 0
        self.counters: dict[str, float] = {}
        self.spans: list[dict] = []
        self.clock: dict[str, float] = {}
        self.info: dict = {}
        self.trace = None
        #: every number the reference read, the judged ones and the rest
        self.numbers: dict = {}

    def add_clock(self, name: str, seconds: float) -> None:
        self.clock[name] = self.clock.get(name, 0.0) + seconds


def finite_tensors(obj) -> bool:
    """False if any tensor inside ``obj`` (lists, tuples, dicts) holds a
    NaN or an Inf."""
    import torch

    if isinstance(obj, torch.Tensor):
        return bool(torch.isfinite(obj).all()) if obj.is_floating_point() \
            else True
    if isinstance(obj, dict):
        return all(finite_tensors(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(finite_tensors(v) for v in obj)
    return True


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(driver, state, seconds: float, obs: Observation, device,
               devtrace=None) -> list:
    """Whole units back to back until ``seconds`` have passed, stopping at
    the first unit boundary after that; each ends in a synchronize. Returns
    the kept outputs of the units completed. With ``devtrace`` the first
    units, up to :data:`TRACE_SECONDS`, run under the profiler."""
    import torch

    from photon_ml_tpu_torch.optimize import common

    kept = []
    reads0 = common.drive.reads
    tracing = devtrace is not None
    if tracing:
        devtrace.start()  # the profiler's own start-up stays outside
    sync(device)
    t0 = time.perf_counter()
    while True:
        obs.attempted += 1
        u0 = time.perf_counter()
        try:
            with torch.profiler.record_function("bench.unit"):
                out = driver.unit(state, obs)
            sync(device)
            if not driver.finite(out):
                raise FloatingPointError("the unit's output is not finite")
            kept.append(driver.keep(out))
            obs.completed += 1
        except Exception:  # a failed unit is counted; the window goes on
            sync(device)
            obs.failed += 1
            traceback.print_exc()
        now = time.perf_counter()
        obs.unit_seconds.append(now - u0)
        if tracing and now - t0 >= min(TRACE_SECONDS, seconds):
            devtrace.stop(now - t0, units=obs.attempted)
            tracing = False
            # the traced stretch ends inside the window: the profiler's
            # stop and the rest of the window's units start afresh
            now = time.perf_counter()
        if now - t0 >= seconds:
            break
    obs.window_seconds = time.perf_counter() - t0
    obs.counters["drive.reads"] = float(common.drive.reads - reads0)
    return kept


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def read_metrics(specs: list[dict], obs: Observation) -> dict:
    out = {}
    for spec in specs:
        value = load_module("metrics", spec["name"]).read(obs)
        if value is None:
            continue
        out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number of ``limits`` beside its limit: correct only if every
    one was computed, is finite and is at most its limit. Numbers the
    reference reads besides (for the calibration) are not judged."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = ok and value is not None and math.isfinite(value) \
            and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def prepare_cell(cell: str, overrides: Optional[dict] = None):
    """(workload, configuration, driver) of ``cell``; ``overrides`` replace
    configuration keys (the control's precision, a test's small sizes)."""
    wl = workload(cell)
    cfg = dict(config(wl["config"]))
    cfg.update(overrides or {})
    return wl, cfg, load_module("drivers", cfg["driver"])


def setup_cell(cell: str, seed: int, device, obs: Observation,
               overrides: Optional[dict] = None):
    """The cell's set-up and its one untimed unit, which warms every shape
    the window uses. Returns (workload, driver, state)."""
    wl, cfg, driver = prepare_cell(cell, overrides)
    state = driver.setup(cfg, wl["traffic_params"], seed, device, obs)
    driver.unit(state, obs)
    sync(device)
    obs.clock.clear()
    return wl, driver, state


def check_kept(driver, state, kept: list, seed: int) -> dict:
    """The driver's comparison of the last unit's output and of one drawn
    from the seed (the program's state is freed inside)."""
    if not kept:
        return {}
    pick = sorted({random.Random(seed).randrange(len(kept)),
                   len(kept) - 1})
    chosen = [kept[i] for i in pick]
    kept.clear()
    return driver.check(state, chosen, seed)


def run_cell(cell: str, seed: int, seconds: float, trace: bool = False,
             device="cuda", overrides: Optional[dict] = None,
             started: Optional[float] = None) -> tuple[dict, Observation]:
    """One run of ``cell`` after the look for a card: set-up, the window,
    the metrics, the check. Returns the result object (without the import
    guard's verdict) and what the run observed."""
    import torch

    started = time.perf_counter() if started is None else started
    bench = manifest()
    obs = Observation()
    wl, driver, state = setup_cell(cell, seed, device, obs, overrides)
    sync(device)
    obs.setup_seconds = time.perf_counter() - started

    devtrace = None
    if trace:
        from benchmark import devtrace as dt

        devtrace = dt.DeviceTrace()
        devtrace.install(obs)
    try:
        kept = run_window(driver, state, seconds, obs, device, devtrace)
    finally:
        if devtrace is not None:
            devtrace.uninstall()
    if devtrace is not None:
        obs.trace = devtrace.summary()
    sync(device)
    cuda = torch.device(device).type == "cuda"
    obs.peak_bytes = int(torch.cuda.max_memory_allocated()) if cuda else 0
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": obs.peak_bytes}
    metrics = read_metrics(cell_metrics(bench, cell, trace), obs)

    obs.numbers = check_kept(driver, state, kept, seed)
    del state
    gc.collect()
    correct, checks = judge(obs.numbers, wl["limits"])
    result = {"correct": bool(correct and obs.completed > 0
                              and obs.failed == 0),
              "attempted": obs.attempted, "failed": obs.failed,
              "metrics": metrics, "device": dev}
    if trace and obs.trace is not None:
        dev["busy_s"] = obs.trace.busy_s
        dev["window_s"] = obs.trace.window_s
        result["breakdown"] = obs.trace.breakdown()
    result["checks"] = checks
    return result, obs


def main(argv=None, started: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = time.perf_counter() if started is None else started

    wl = workload(args.workload)
    chips = int(wl["chips"])
    set_host_threads(wl)

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); found "
              f"{found} (no fallback to the CPU)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result, obs = run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", started=started)
    bad = forbidden_modules()
    if bad:
        print("benchmark: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    print(f"card: {power_limit()}; host threads {torch.get_num_threads()}; "
          f"setup_s {obs.setup_seconds!r}; units "
          f"{obs.completed} in {obs.window_seconds!r} s; peak "
          f"{obs.peak_bytes} bytes; unit walls "
          f"{[round(u, 4) for u in obs.unit_seconds]}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
