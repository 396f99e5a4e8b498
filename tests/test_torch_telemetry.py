"""The port's live telemetry plane against the JAX package's, on the CPU.

- the EventBus bridge: one event sequence on each package's bus renders
  the same families and values;
- the fleet fold (``aggregate_text``), the trace merge
  (``merge_trace_files``) and the chief's ``GET /metrics`` listener agree
  with the JAX functions on the same inputs;
- the memory sampler's RSS gauge;
- ``profile_fn``'s accounting is exact against the kernels' count
  functions (``ops/fused_{glm,re,hvp}.py::work``), and off it counts and
  reads nothing; ``profiled`` writes its Chrome trace when its body
  raises;
- ``train_game`` and ``train_glm`` with ``--telemetry-dir`` in both
  packages on one tiny Avro set (each package in a process of its own, so
  each registry holds one run's families): the span names, the
  ``cd.step`` set per (sweep, coordinate), the stage names, and the metric
  family names with their label names agree up to :data:`NOT_IN_PORT` /
  :data:`PORT_ONLY_LABELS`; ``photon_game_coordinate_loss`` agrees within
  the slice's parity tolerance; ``tools/perf_report.py`` renders the
  port's directory; the port's coefficients are bit-identical with and
  without telemetry;
- ``--debug-nans`` with a NaN injected at the ``optimizer.step`` fault
  site: both packages raise :class:`FloatingPointError` (the divergence
  guard's cause) and neither writes ``best/``; a NaN reaching the kernel
  dispatch names the kernel's plain version and its shape;
- ``serve_game --telemetry-dir``: the ``serving.*`` spans, scores
  bit-identical to serving without a trace, and no new build.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from photon_ml_tpu import resilience as jr
from photon_ml_tpu.cli import train_game as j_train_game
from photon_ml_tpu.events import EventBus as JBus
from photon_ml_tpu.telemetry import aggregate as j_aggregate
from photon_ml_tpu.telemetry import bridge as j_bridge
from photon_ml_tpu.telemetry import device as j_device
from photon_ml_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from photon_ml_tpu.telemetry.prometheus import parse_text as j_parse
from photon_ml_tpu.telemetry.prometheus import render as j_render
from photon_ml_tpu_torch import resilience as tr
from photon_ml_tpu_torch.cli import serve_game as t_serve
from photon_ml_tpu_torch.cli import train_game as t_train_game
from photon_ml_tpu_torch.events import EventBus as TBus
from photon_ml_tpu_torch.io.avro import iter_avro_file
from photon_ml_tpu_torch.ops import fused_glm, fused_hvp, fused_re
from photon_ml_tpu_torch.ops import losses as tl
from photon_ml_tpu_torch.ops import objective as tobj
from photon_ml_tpu_torch.ops.design import DenseDesign
from photon_ml_tpu_torch.telemetry import aggregate as t_aggregate
from photon_ml_tpu_torch.telemetry import bridge as t_bridge
from photon_ml_tpu_torch.telemetry import device as t_device
from photon_ml_tpu_torch.telemetry import profiling
from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry as TRegistry
from photon_ml_tpu_torch.telemetry.prometheus import render as t_render
from test_torch_cli import SHARDS, _bench_args, _write_bench_file
from test_torch_glm_cli import _write as _write_glm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import perf_report  # noqa: E402

#: families the JAX package emits and the port has no counterpart of:
#: XLA's compile pipeline (``install_xla_hooks``)
NOT_IN_PORT = ("photon_xla_compiles_total", "photon_xla_compile_seconds_total")
#: label names that differ, by family: the port's build info carries the
#: torch version where the JAX package's carries jax's
PORT_ONLY_LABELS = {"photon_build_info": ({"torch_version"},
                                          {"jax_version"})}
#: ``fn`` label values of the JAX package with no port counterpart, by the
#: port's label for the same work: none (the port sweeps a resident
#: random-effect coordinate as one program too, ``game.re.sweep_fused``)
FN_IN_PORT = {}
#: the port's stage around its manifest build, which the JAX package
#: builds outside a stage (both hand the write to the background saver)
PORT_ONLY_STAGES = {"Build data manifest"}
#: families the port declares but fills with no series on the CPU: it
#: builds no kernel there, captures no CUDA graph and has no caching
#: allocator to read a peak from
NO_SERIES_ON_CPU = {"photon_compiles_total", "photon_compile_seconds_total",
                    "photon_peak_memory_bytes"}
#: the slice's parity tolerance for the f32 fits: both packages' CLIs
#: solve in float32 (tests/test_torch_cli.py holds their AUCs to 1e-4)
LOSS_RTOL = 1e-4


# --- the bridge ---------------------------------------------------------------

EVENTS = [
    ("serving_request", {"batch": 3}),
    ("serving_request", {}),
    ("retry_attempt", {"op": "avro.read:part-00001.avro"}),
    ("retry_exhausted", {"op": "ckpt.save:7"}),
    ("retry_succeeded", {"op": "avro.read:part-00002.avro"}),
    ("stage_finished", {"stage": "Train", "seconds": 2.5}),
    ("span_finished", {"span": "cd.step", "seconds": 0.02}),
    ("divergence_detected", {"coordinate": "perUser"}),
    ("coordinate_rollback", {"coordinate": "perUser"}),
    ("coordinate_frozen", {"coordinate": "perSong"}),
    ("model_loaded", {"version": 1}),
    ("model_reload_rejected", {"path": "x"}),
    ("model_activated", {"version": 2}),
    ("training_started", {"driver": "train_game"}),
    ("supervisor_fault_detected", {"reason": "stall"}),
    ("supervisor_restart", {}),
    ("supervisor_exhausted", {}),
    ("quality_drift_detected", {"coordinate": "perUser"}),
    ("canary_evaluated", {"verdict": "divergent"}),
    ("brownout_changed", {"level": 2, "previous": 1}),
    ("brownout_changed", {"level": 0, "previous": 2}),
    ("slo_burn_alert", {"window": "fast"}),
    ("an_unknown_event", {"x": 1}),
]


def test_bridge_renders_the_same_families_and_values():
    texts = []
    for bus_cls, reg_cls, bridge, render in (
            (TBus, TRegistry, t_bridge, t_render),
            (JBus, JRegistry, j_bridge, j_render)):
        bus, reg = bus_cls(), reg_cls()
        unbind = bridge.bind(bus=bus, registry=reg)
        # idempotent per (bus, registry): no second listener
        assert bridge.bind(bus=bus, registry=reg)() is None
        for name, payload in EVENTS:
            bus.post(name, **payload)
        texts.append(render(reg))
        unbind()
        bus.post("serving_request")  # unbound: counts nothing
        assert render(reg) == texts[-1]
    assert texts[0] == texts[1]
    assert 'photon_retry_attempts_total{op="avro.read"} 1' in texts[0]


# --- the fold, the trace merge and the listener --------------------------------

def _snapshot(reg_cls, render, process, scale):
    """A registry a process would dump: counters, a histogram and a
    host-owned gauge, rendered with the process tag."""
    reg = reg_cls()
    reg.counter("photon_x_total", "x", labels=("fn",)).labels(
        fn="a").inc(3 * scale)
    reg.counter("photon_x_total", "x", labels=("fn",)).labels(
        fn=f"only{process}").inc(1)
    h = reg.histogram("photon_h_seconds", "h", labels=("stage",),
                      buckets=(0.1, 1.0))
    h.labels(stage="s").observe(0.05 * scale)
    h.labels(stage="s").observe(2.0)
    reg.gauge("photon_device_bytes_in_use", "g", labels=("device",)).labels(
        device="0").set(100 * scale)
    reg.gauge("photon_replicated", "r").set(7 + process)
    return render(reg, host_tag=("process", str(process)))


def test_fold_matches_the_jax_fold():
    texts = [_snapshot(TRegistry, t_render, p, p + 1) for p in range(3)]
    j_texts = [_snapshot(JRegistry, j_render, p, p + 1) for p in range(3)]
    assert texts == j_texts
    got = t_aggregate.aggregate_text(texts)
    assert got == j_aggregate.aggregate_text(texts)
    parsed = j_parse(got)
    assert parsed.get("photon_x_total")[0][1] == 18  # 3 + 6 + 9
    # the host-owned gauge fans out, one series a process
    assert len(parsed.get("photon_device_bytes_in_use")) == 3


def test_trace_merge_matches_the_jax_merge(tmp_path):
    paths = []
    for pid, ts in ((0, (3.0, 1.0)), (1, (2.0, 1.0))):
        p = tmp_path / f"trace-{pid}.jsonl"
        p.write_text("".join(
            json.dumps({"name": f"s{i}", "span_id": i + 1, "parent_id": None,
                        "ts": t, "seconds": 0.1}) + "\n"
            for i, t in enumerate(ts)) + "\n")
        paths.append((pid, str(p)))
    got = t_aggregate.merge_trace_files(paths)
    assert got == j_aggregate.merge_trace_files(paths)
    assert [(r["process"], r["name"]) for r in got] == [
        (0, "s1"), (1, "s1"), (1, "s0"), (0, "s0")]


def _fetch(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_metrics_listener_answers_as_the_jax_one():
    text = _snapshot(TRegistry, t_render, 0, 1)
    replies = []
    for server_cls in (t_aggregate.MetricsHTTPServer,
                       j_aggregate.MetricsHTTPServer):
        server = server_cls(lambda: text).start()
        try:
            replies.append([_fetch(server.url + path)
                            for path in ("/metrics", "/healthz", "/nope")])
        finally:
            server.stop()
    assert replies[0] == replies[1]
    assert replies[0][0] == (200, "text/plain; version=0.0.4; charset=utf-8",
                             text.encode())
    assert replies[0][2][0] == 404


def test_sampler_reports_rss_as_the_jax_sampler():
    renders = []
    for sampler_cls, reg_cls, render in (
            (t_device.DeviceStatsSampler, TRegistry, t_render),
            (j_device.DeviceStatsSampler, JRegistry, j_render)):
        reg = reg_cls()
        sampler_cls(0.5, registry=reg).sample_once()
        parsed = j_parse(render(reg))
        renders.append(parsed)
        (labels, rss), = parsed.get("photon_host_rss_bytes")
        assert labels == {} and rss > 0
        (_, polls), = parsed.get("photon_device_samples_total")
        assert polls == 1
    # on the CPU neither reports device memory
    for parsed in renders:
        assert not parsed.get("photon_device_bytes_in_use")
    assert t_device.cuda_memory() == []


# --- profile_fn accounting -------------------------------------------------------

def _glm_data(gen, n, d, lanes=None, zero_rows=0):
    shape = (n,) if lanes is None else (lanes, n)
    x = torch.randn((n, d), generator=gen)
    weights = torch.ones(shape)
    weights[..., :zero_rows] = 0.0
    return tobj.GLMData(
        design=DenseDesign(x=x),
        labels=(torch.rand(shape, generator=gen) < 0.5).float(),
        offsets=torch.zeros(shape), weights=weights)


def test_profile_fn_counts_exactly_the_kernels_work():
    gen = torch.Generator().manual_seed(0)
    obj = tobj.GLMObjective(tl.LogisticLoss)
    n, d, m = 257, 9, 3
    one = _glm_data(gen, n, d, zero_rows=17)
    multi = _glm_data(gen, n, d)
    lanes = _glm_data(gen, n, d, lanes=m, zero_rows=5)
    e, s, dd = 4, 11, 3
    bw = torch.ones(e, s)
    bw[:, 7:] = 0.0
    bucket = tobj.GLMData(design=DenseDesign(x=torch.randn((e, s, dd),
                                                             generator=gen)),
                          labels=torch.ones(e, s), offsets=torch.zeros(e, s),
                          weights=bw)
    tobj.seed_live_rows(bw, bw.numpy())
    w = torch.randn(d, generator=gen)

    def body():
        obj.value_and_grad(w, one, 0.5)
        obj.value_and_grad(torch.zeros(m, d), multi,
                           torch.tensor([1.0, 2.0, 3.0]))
        obj.value_and_grad(torch.zeros(m, d), lanes, 1.0)
        obj.value_and_grad(torch.zeros(e, dd), bucket, 1.0)
        hv = obj.hvp_operator(w, one, 0.5)
        hv(torch.randn(d, generator=gen))
        hv(torch.randn(d, generator=gen))

    want = [fused_glm.work(n - 17, n, d, 4, 1),
            fused_glm.work(n, n, d, 4, m, lanes=m)]
    want += [fused_glm.work(n - 5, n, d, 4, 1)] * m
    want += [fused_re.work(e * 7, e, s, dd, 4)]
    want += [fused_hvp.work(n - 17, n, d, 4)] * 2
    reg = TRegistry()
    run = profiling.profile_fn(lambda: body(), "test.body", registry=reg)
    run()  # accounting off: the bare call, nothing counted
    assert reg.get("photon_flops_total") is None
    assert not hasattr(multi.weights, "_photon_live_rows")
    profiling.set_accounting(True)
    try:
        run()
        run()
    finally:
        profiling.set_accounting(False)
    parsed = j_parse(t_render(reg))
    (_, flops), = parsed.get("photon_flops_total")
    (_, nbytes), = parsed.get("photon_bytes_accessed_total")
    assert flops == 2 * sum(wk.ops for wk in want)
    assert nbytes == 2 * sum(wk.nbytes for wk in want)
    (labels, calls), = parsed.get("photon_execute_latency_seconds_count")
    assert labels == {"fn": "test.body"} and calls == 2
    # the live rows were counted once a weights tensor, and kept on it
    assert one.weights._photon_live_rows[1] == n - 17
    assert lanes.weights._photon_live_rows[1] == [n - 5] * m


def test_profiled_writes_its_trace_when_the_body_raises(tmp_path):
    from photon_ml_tpu_torch.logging_util import profiled

    with profiled(None):  # no directory: a no-op
        pass
    out = tmp_path / "profile"
    with pytest.raises(ValueError):
        with profiled(str(out)):
            torch.ones(8).cumsum(0)
            raise ValueError("the body failed")
    with open(out / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


# --- debug-nans at the dispatch -------------------------------------------------

def test_debug_nans_names_the_plain_op_and_shape():
    gen = torch.Generator().manual_seed(1)
    data = _glm_data(gen, 64, 5)
    obj = tobj.GLMObjective(tl.LogisticLoss)
    bad = torch.full((5,), float("nan"))
    # off: a NaN passes through unchecked
    value, _ = obj.value_and_grad(bad, data)
    assert torch.isnan(value)
    tobj.set_debug_nans(True)
    try:
        with pytest.raises(FloatingPointError,
                           match=r"fused_value_and_grad_plain at shape "
                                 r"\(64, 5\)"):
            obj.value_and_grad(bad, data)
        with pytest.raises(FloatingPointError, match=r"fused_hvp_plain"):
            obj.hvp_operator(torch.zeros(5), data)(bad)
        bucket = tobj.GLMData(
            design=DenseDesign(x=torch.randn((2, 3, 4), generator=gen)),
            labels=torch.ones(2, 3), offsets=torch.full((2, 3), np.nan),
            weights=torch.ones(2, 3))
        with pytest.raises(FloatingPointError,
                           match=r"fused_entity_value_and_grad_plain at "
                                 r"shape \(2, 3, 4\)"):
            obj.value_and_grad(torch.zeros(2, 4), bucket)
        # finite evaluations pass the check unchanged
        v0, g0 = obj.value_and_grad(torch.zeros(5), data)
    finally:
        tobj.set_debug_nans(False)
    v1, g1 = obj.value_and_grad(torch.zeros(5), data)
    assert torch.equal(v0, v1) and torch.equal(g0, g1)


# --- the CLIs in both packages -------------------------------------------------

#: runs one package's train_game (with telemetry, and for the port once
#: more without) and train_glm in a fresh process: argv[1] is the package,
#: argv[2] a JSON list of (name, argv) runs
_DRIVER = """
import json, sys
pkg, runs = sys.argv[1], json.loads(sys.argv[2])
import importlib
for name, argv in runs:
    cli = importlib.import_module(f"{pkg}.cli.{name}")
    cli.run(argv)
"""


def _tiny_files(root):
    return dict(
        game=(_write_bench_file(os.path.join(root, "train.avro"), 600, 1,
                                users=20, songs=10),
              _write_bench_file(os.path.join(root, "valid.avro"), 300, 2,
                                users=20, songs=10)),
        glm=(_write_glm(os.path.join(root, "glm_train.avro"),
                        "LOGISTIC_REGRESSION", 300, 1),
             _write_glm(os.path.join(root, "glm_valid.avro"),
                        "LOGISTIC_REGRESSION", 300, 2)))


def _game_args(files, out, tel):
    args = _bench_args(*files["game"], "float32") + ["--output-dir", out]
    return args + (["--telemetry-dir", tel] if tel else [])


def _glm_args(files, out, tel):
    train, valid = files["glm"]
    return ["--training-data", train, "--validation-data", valid,
            "--regularization-weights", "10;1", "--evaluators", "AUC",
            "--optimizer", "TRON", "--max-iterations", "20",
            "--output-dir", out, "--telemetry-dir", tel]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both packages' runs, each package in a process of its own, run at
    once: ``{pkg: {"game": dir, "glm": dir}}`` plus the port's run without
    telemetry under ``"bare"``."""
    root = str(tmp_path_factory.mktemp("telemetry_cli"))
    files = _tiny_files(root)
    dirs = {}
    procs = []
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for pkg in ("photon_ml_tpu_torch", "photon_ml_tpu"):
        d = os.path.join(root, pkg)
        dirs[pkg] = {"game": os.path.join(d, "game"),
                     "glm": os.path.join(d, "glm")}
        extra = ["--device", "cpu"] if pkg == "photon_ml_tpu_torch" else []
        runs = [("train_glm", _glm_args(files, dirs[pkg]["glm"],
                                        os.path.join(dirs[pkg]["glm"],
                                                     "telemetry")) + extra),
                ("train_game", _game_args(files, dirs[pkg]["game"],
                                          os.path.join(dirs[pkg]["game"],
                                                       "telemetry"))
                 + extra)]
        if pkg == "photon_ml_tpu_torch":
            dirs["bare"] = os.path.join(d, "bare")
            runs.append(("train_game",
                         _game_args(files, dirs["bare"], None) + extra))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DRIVER, pkg, json.dumps(runs)],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
    dirs["files"] = files
    return dirs


def _trace(run_dir):
    with open(os.path.join(run_dir, "telemetry", "trace.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _spans(run_dir):
    return [r for r in _trace(run_dir) if "t0" in r]


def _families(run_dir):
    """``{family: set of label names}`` of a run's ``metrics.prom``."""
    with open(os.path.join(run_dir, "telemetry", "metrics.prom")) as f:
        text = f.read()
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            out.setdefault(line.split()[2], set())
    for name, series in j_parse(text).items():
        family = next((f for f in out if name == f or name in (
            f + "_bucket", f + "_sum", f + "_count")), name)
        for labels, _ in series:
            out[family] |= set(labels) - {"le"}
    return out


@pytest.mark.parametrize("command", ["game", "glm"])
def test_span_tree_and_stages_match(cli_runs, command):
    t = _spans(cli_runs["photon_ml_tpu_torch"][command])
    j = _spans(cli_runs["photon_ml_tpu"][command])
    root = {"game": "train_game", "glm": "train_glm"}[command]
    for spans in (t, j):
        roots = [s for s in spans if s["parent_id"] is None]
        assert [s["name"] for s in roots] == [root]
    # the same span names, up to the documented difference: the
    # background saver's and the background read's spans among them
    assert ({s["name"] for s in t} - PORT_ONLY_STAGES
            == {s["name"] for s in j})
    stages = [{s["name"] for s in spans if s.get("kind") == "stage"}
              for spans in (t, j)]
    assert stages[0] - PORT_ONLY_STAGES == stages[1] and stages[1]
    steps = [sorted((s["sweep"], s["coordinate"]) for s in spans
                    if s["name"] == "cd.step") for spans in (t, j)]
    assert steps[0] == steps[1]
    if command == "game":
        assert steps[0] == [(0, "global"), (0, "perSong"), (0, "perUser")]


def _nests(spans):
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        p = by_id.get(s["parent_id"])
        if p is not None:
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (s, p)


@pytest.mark.parametrize("command", ["game", "glm"])
def test_spans_nest_and_stages_are_histogrammed(cli_runs, command):
    run = cli_runs["photon_ml_tpu_torch"][command]
    spans = _spans(run)
    _nests(spans)
    with open(os.path.join(run, "telemetry", "metrics.prom")) as f:
        parsed = j_parse(f.read())
    seen = {labels["stage"] for labels, _ in
            parsed.get("photon_stage_seconds_count")}
    assert {s["name"] for s in spans if s.get("kind") == "stage"} <= seen


@pytest.mark.parametrize("command", ["game", "glm"])
def test_metric_families_and_labels_match(cli_runs, command):
    t = _families(cli_runs["photon_ml_tpu_torch"][command])
    j = _families(cli_runs["photon_ml_tpu"][command])
    for name in NOT_IN_PORT:
        j.pop(name, None)
    assert set(t) == set(j), (set(t) ^ set(j))
    for name in t:
        if not t[name] and name in NO_SERIES_ON_CPU:
            continue
        want = j[name]
        if name in PORT_ONLY_LABELS:
            port_only, jax_only = PORT_ONLY_LABELS[name]
            want = (want - jax_only) | port_only
        assert t[name] == want, name


def _fn_labels(run_dir, family):
    """The ``fn`` labels of ``family``'s nonzero series (the JAX package
    declares its module-level wrappers' series at import)."""
    with open(os.path.join(run_dir, "telemetry", "metrics.prom")) as f:
        parsed = j_parse(f.read())
    return {labels["fn"] for labels, v in parsed.get(family, ()) if v}


def test_profiled_call_sites_carry_the_jax_labels(cli_runs):
    for command in ("game", "glm"):
        t = _fn_labels(cli_runs["photon_ml_tpu_torch"][command],
                       "photon_execute_latency_seconds_count")
        j = _fn_labels(cli_runs["photon_ml_tpu"][command],
                       "photon_execute_latency_seconds_count")
        assert t == {FN_IN_PORT.get(fn, fn) for fn in j} and t, (command,
                                                                  t, j)


def test_coordinate_loss_agrees(cli_runs):
    losses = []
    for pkg in ("photon_ml_tpu_torch", "photon_ml_tpu"):
        with open(os.path.join(cli_runs[pkg]["game"], "telemetry",
                               "metrics.prom")) as f:
            losses.append({labels["coordinate"]: v for labels, v in
                           j_parse(f.read()).get(
                               "photon_game_coordinate_loss")})
    assert set(losses[0]) == {"global", "perUser", "perSong"}
    for cid, want in losses[1].items():
        assert abs(losses[0][cid] - want) <= LOSS_RTOL * abs(want), cid
    # each step's loss rides its cd.step span, the gauge's last value
    steps = {s["coordinate"]: s["loss"] for s in
             _spans(cli_runs["photon_ml_tpu_torch"]["game"])
             if s["name"] == "cd.step"}
    assert steps == losses[0]


def test_perf_report_reads_the_port_directory(cli_runs, capsys):
    tel = os.path.join(cli_runs["photon_ml_tpu_torch"]["game"], "telemetry")
    assert perf_report.main([tel]) == 0
    out = capsys.readouterr().out
    assert out.startswith("== photon performance report ==")
    assert "-- critical path" in out
    assert "-- coordinate descent: per-coordinate --" in out
    for cid in ("global", "perUser", "perSong"):
        assert cid in out.split("-- coordinate descent")[1]
    # the background saver's and the background read's spans: the async
    # I/O overlap section has both classes
    overlap = out.split("-- async I/O overlap (hidden under train) --")[1]
    assert "\nsave: " in overlap and "\nread: " in overlap


def test_chip_smoke_overlap_is_perf_reports(cli_runs):
    """``chip_smoke.py`` computes the overlap on the card with the port's
    own code (the tool imports the JAX package): the same numbers as the
    tool's on the port's trace."""
    tel = os.path.join(cli_runs["photon_ml_tpu_torch"]["game"], "telemetry")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    spans, _ = smoke.read_telemetry(tel)
    want = perf_report.io_overlap(perf_report.load_spans(
        os.path.join(tel, "trace.jsonl")))
    assert want is not None and {"save", "read"} <= set(want)
    assert smoke.io_overlap(spans) == want


def _coefficients(run):
    from photon_ml_tpu_torch.io import model_io as tio

    out = {}
    for kind in ("fixed-effect", "random-effect"):
        for cid in sorted(os.listdir(os.path.join(run, "best", kind))):
            part = os.path.join(run, "best", kind, cid, "coefficients",
                                "part-00000.avro")
            out[cid] = list(iter_avro_file(part))
    assert tio.model_kind(os.path.join(run, "best"))
    return out


def test_telemetry_changes_no_coefficient(cli_runs):
    with_tel = _coefficients(cli_runs["photon_ml_tpu_torch"]["game"])
    bare = _coefficients(cli_runs["bare"])
    assert with_tel == bare and len(bare) == 3


@pytest.fixture(scope="module")
def nan_runs(cli_runs, tmp_path_factory):
    """Each package's ``train_game --debug-nans`` with a NaN at the second
    coordinate step: (the exception chain's types, best/ written)."""
    root = tmp_path_factory.mktemp("debug_nans")
    files = cli_runs["files"]
    out = {}
    for pkg, cli, res in (("torch", t_train_game, tr),
                          ("jax", j_train_game, jr)):
        run = str(root / pkg)
        args = _game_args(files, run, None) + ["--debug-nans"]
        if pkg == "torch":
            args += ["--device", "cpu"]
        chain = []
        try:
            with res.injected(res.FaultPlan([res.FaultSpec(
                    site="optimizer.step", at=(1,), mode="nan")])):
                cli.run(args)
        except Exception as e:
            while e is not None:
                chain.append(e)
                e = e.__cause__
        finally:
            jax.config.update("jax_debug_nans", False)
        out[pkg] = (chain, os.path.exists(os.path.join(run, "best")))
    return out


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_debug_nans_fails_fast_in_both_packages(nan_runs, pkg):
    chain, wrote_best = nan_runs[pkg]
    assert any(isinstance(e, FloatingPointError) for e in chain), chain
    assert "perUser" in str(chain[0])
    assert not wrote_best
    if pkg == "torch":
        assert "cd.step[perUser] scores" in str(chain[-1])
        assert not tobj.debug_nans()  # the run restored the setting


# --- serve_game ------------------------------------------------------------------

def _score(url, records):
    req = urllib.request.Request(
        url + "/score", data=json.dumps({"records": records}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["scores"]


def test_serve_game_spans_with_unchanged_scores(cli_runs, tmp_path):
    run = cli_runs["photon_ml_tpu_torch"]["game"]
    records = list(iter_avro_file(cli_runs["files"]["game"][1]))[:40]
    base = ["--model-dir", run, "--feature-shards", SHARDS, "--port", "0",
            "--device", "cpu", "--microbatch", "4", "--brownout-poll-s", "0"]
    scores, compiles = [], []
    tel = str(tmp_path / "serve")
    for extra in ([], ["--telemetry-dir", tel]):
        server = t_serve.build_server(base + extra).start()
        try:
            engine = server.service.registry.active().engine
            before = engine.compile_count
            got = _score(server.url, records)
            # single records through the microbatcher, from threads
            singles = [None] * 8
            threads = [threading.Thread(
                target=lambda i=i: singles.__setitem__(
                    i, _score(server.url, [records[i]])[0]))
                for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            scores.append((got, singles))
            compiles.append(engine.compile_count - before)
        finally:
            server.stop()
            server.telemetry.close()
    assert scores[0] == scores[1]
    assert scores[0][1] == scores[0][0][:8]
    assert compiles == [0, 0]
    with open(os.path.join(tel, "trace.jsonl")) as f:
        spans = [json.loads(line) for line in f]
    names = {s["name"] for s in spans}
    assert {"serving.request", "serving.parse", "serving.score",
            "serving.respond"} <= names
    scored = [s for s in spans if s["name"] == "serving.score"]
    assert len(scored) == 9 and all(s["version"] == 1 for s in scored)
    with open(os.path.join(tel, "metrics.prom")) as f:
        parsed = j_parse(f.read())
    built = {labels["fn"]: v for labels, v in
             parsed.get("photon_compiles_total", ())}
    assert built.get("serving.score", 0) >= engine.compile_count > 0
    assert parsed.get("photon_build_info")
