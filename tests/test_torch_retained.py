"""The port's retained telemetry plane against the JAX package's, on the CPU.

- the history ring: ``subset_text``, ``derive_series``, ``history_payload``
  and ``fold_history`` give equal output from the same exposition text (a
  registry filled from a seed), and the ring wraps the same way;
- ``SaturationSampler``: equal gauges from the same probes on the same
  injected clock, and both packages refuse a resource outside the
  vocabulary;
- the flight recorder: a dump of the same records is equal line for line
  apart from timestamps, ``tools/postmortem.py`` renders both dumps
  byte-identically with a fixed ``ts``, and the cooldown and the ring's
  wrap behave the same;
- ``HotShardAdvisor`` fed the same synthetic ring latches on the same tick,
  does not flap inside the hysteresis band, and gives an equal
  ``status()``;
- both packages' ``serve_game`` and an in-process 2-shard ``serve_fleet``
  (each package in a process of its own, the rings ticked by hand on an
  injected clock, the router's leg-latency windows fed the same seeded
  samples): equal ``/history`` series and equal ``/advisor`` bodies (but
  for the binding resources, which the timed utilizations pick), the
  router's newest ``/history?raw=1`` row equal to ``tools/metrics_fold.py``
  over the rings, scores bit-identical to the JAX package's with the plane
  on, and the ``serving.execute`` / ``serving.parse`` fault sites failing a
  request with the same status in both, each trip leaving a flight dump.

Tolerances: every comparison is exact, except the series that time the
requests (``latency_p50``, ``latency_p99``, ``duty_cycle``,
``resource_util``, ``shard_binding`` and the advisor's binding resources:
same keys, values in their range), the fleet's ``open_connections`` (the
router's pooled legs) and ``compiles``,
which counts each package's own builds (JAX's XLA compiles, the port's
bucket programs). On the card the same path runs in ``chip_smoke.py``
phase 18."""

import json
import logging
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from photon_ml_tpu.events import EventBus as JBus
from photon_ml_tpu.fleet import advisor as j_advisor
from photon_ml_tpu.fleet.observe import fold_fleet_snapshots as j_fold_fleet
from photon_ml_tpu.fleet.sharding import ShardMap as JShardMap
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.telemetry import flightrec as j_flightrec
from photon_ml_tpu.telemetry import history as j_history
from photon_ml_tpu.telemetry import saturation as j_saturation
from photon_ml_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from photon_ml_tpu.telemetry.prometheus import parse_text as j_parse
from photon_ml_tpu.telemetry.prometheus import render as j_render
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.events import EventBus as TBus
from photon_ml_tpu_torch.fleet import advisor as t_advisor
from photon_ml_tpu_torch.fleet.observe import fold_fleet_snapshots as t_fold_fleet
from photon_ml_tpu_torch.fleet.sharding import ShardMap as TShardMap
from photon_ml_tpu_torch.telemetry import flightrec as t_flightrec
from photon_ml_tpu_torch.telemetry import history as t_history
from photon_ml_tpu_torch.telemetry import saturation as t_saturation
from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry as TRegistry
from photon_ml_tpu_torch.telemetry.prometheus import parse_text as t_parse
from photon_ml_tpu_torch.telemetry.prometheus import render as t_render
from test_fleet import COMMON2, SHARDS2, _records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import metrics_fold  # noqa: E402
import postmortem  # noqa: E402

# the folds fan out the gauges their process marked host-owned, which the
# serving and fleet modules of each package mark when imported, as a live
# router process has them (tools/metrics_fold.py folds with the JAX set)
import photon_ml_tpu.fleet.router  # noqa: E402,F401
import photon_ml_tpu.quality  # noqa: E402,F401
import photon_ml_tpu.serving  # noqa: E402,F401
import photon_ml_tpu.telemetry.device  # noqa: E402,F401
import photon_ml_tpu_torch.fleet.router  # noqa: E402,F401
import photon_ml_tpu_torch.quality  # noqa: E402,F401
import photon_ml_tpu_torch.serving  # noqa: E402,F401
import photon_ml_tpu_torch.telemetry.device  # noqa: E402,F401

PACKAGES = ("photon_ml_tpu_torch", "photon_ml_tpu")


# --- the history ring ---------------------------------------------------------

def _fill(reg_cls, seed, scale):
    """A registry holding every watched family (and one that is not
    watched), its values drawn from ``seed``; ``scale`` grows the counters
    and histograms, so two fills make an interval."""
    rng = np.random.default_rng(seed)
    reg = reg_cls()
    reg.counter("photon_serving_requests_total", "requests").inc(
        float(rng.integers(50, 100)) * scale)
    shed = reg.counter("photon_shed_total", "sheds", labels=("reason",))
    for reason in ("queue_full", "deadline"):
        shed.labels(reason=reason).inc(float(rng.integers(0, 9)) * scale)
    reg.counter("photon_fleet_requests_total", "fleet requests",
                labels=("endpoint",)).labels(endpoint="score").inc(
                    40.0 * scale)
    reg.counter("photon_fleet_hedges_total", "hedges",
                labels=("shard",)).labels(shard="0").inc(3.0 * scale)
    reg.counter("photon_fleet_upstream_errors_total", "errors",
                labels=("shard", "reason")).labels(
                    shard="1", reason="timeout").inc(scale)
    reg.counter("photon_slo_burn_total", "burn",
                labels=("window",)).labels(window="5m").inc(scale)
    reg.counter("photon_compiles_total", "compiles",
                labels=("fn",)).labels(fn="serving.score").inc(11)
    reg.gauge("photon_connections_open", "open").set(
        float(rng.integers(0, 8)))
    reg.gauge("photon_serving_queue_depth", "depth").set(
        float(rng.integers(0, 30)))
    util = reg.gauge("photon_resource_utilization", "util",
                     labels=("resource",))
    sat = reg.gauge("photon_resource_saturation", "sat",
                    labels=("resource",))
    for resource in ("device", "batcher_queue", "http_connections"):
        util.labels(resource=resource).set(float(rng.uniform()))
        sat.labels(resource=resource).set(float(rng.integers(0, 5)))
    for name in ("photon_fleet_shard_load", "photon_fleet_shard_p50_seconds",
                 "photon_fleet_shard_p99_seconds"):
        g = reg.gauge(name, name, labels=("shard",))
        for s in range(3):
            g.labels(shard=str(s)).set(float(rng.uniform(0.001, 0.05)))
    lat = reg.histogram("photon_serving_request_latency_seconds", "latency")
    for v in rng.exponential(0.01, size=int(200 * scale)):
        lat.observe(float(v))
    reg.counter("photon_not_watched_total", "dropped by the subset").inc()
    return reg


def _texts(seed):
    """(JAX text, port text) of the same fill at two instants."""
    return [(j_render(_fill(JRegistry, seed, k)),
             t_render(_fill(TRegistry, seed, k))) for k in (1, 2)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subset_and_derived_series_match(seed):
    (j0, t0), (j1, t1) = _texts(seed)
    assert j0 == t0 and j1 == t1  # the two registries render alike
    assert t_history.subset_text(t1) == j_history.subset_text(j1)
    assert "photon_not_watched_total" not in t_history.subset_text(t1)
    prev = [j_parse(j_history.subset_text(j0)),
            t_parse(t_history.subset_text(t0))]
    cur = [j_parse(j_history.subset_text(j1)),
           t_parse(t_history.subset_text(t1))]
    for p in (None, 0):
        want = j_history.derive_series(p if p is None else prev[0],
                                       cur[0], 2.5)
        got = t_history.derive_series(p if p is None else prev[1],
                                      cur[1], 2.5)
        assert got == want
        assert sorted(got) == list(t_history.HISTORY_SERIES)


def test_host_owned_gauges_are_the_jax_packages():
    from photon_ml_tpu.telemetry.metrics import host_owned_gauges as j_owned
    from photon_ml_tpu_torch.telemetry.metrics import (
        host_owned_gauges as t_owned,
    )

    # the ring's families are the ones the folds below fan out (other test
    # files of a worker may mark gauges of their own)
    watched = set(t_history.WATCHED_FAMILIES)
    assert "photon_resource_utilization" in t_owned() & watched
    assert t_owned() & watched == j_owned() & watched


def test_vocabularies_are_the_jax_packages():
    assert t_history.WATCHED_FAMILIES == j_history.WATCHED_FAMILIES
    assert t_history.HISTORY_SERIES == j_history.HISTORY_SERIES
    assert t_saturation.RESOURCES == j_saturation.RESOURCES
    assert t_flightrec.DUMP_REASONS == j_flightrec.DUMP_REASONS
    assert t_flightrec.RECORD_KINDS == j_flightrec.RECORD_KINDS


def _sampled(mod, reg_cls, capacity, ticks):
    """A sampler over a registry whose counter grows by a seeded step each
    tick, ticked at an injected clock."""
    reg = reg_cls()
    requests = reg.counter("photon_serving_requests_total", "requests")
    rng = np.random.default_rng(5)
    sampler = mod.HistorySampler(registry=reg, capacity=capacity,
                                 source="host")
    seen = []
    sampler.add_listener(lambda snap: seen.append(snap["tick"]))
    for k in range(ticks):
        requests.inc(float(rng.integers(1, 20)))
        sampler.sample(now=100.0 + 0.5 * k)
    return sampler, seen


def test_ring_wrap_and_payload_match():
    j_s, j_seen = _sampled(j_history, JRegistry, 4, 7)
    t_s, t_seen = _sampled(t_history, TRegistry, 4, 7)
    assert t_seen == j_seen == list(range(1, 8))
    assert [s["tick"] for s in t_s.snapshots()] == [4, 5, 6, 7]
    assert t_s.snapshots() == j_s.snapshots()
    for kw in ({}, {"window": 2}, {"series": ("requests", "shed_rate")},
               {"window": 1, "include_prom": True}):
        assert t_s.payload_json(**kw) == j_s.payload_json(**kw)
    for mod in (t_history, j_history):
        with pytest.raises(ValueError, match="closed"):
            mod.history_payload([], source="host", capacity=1,
                                series=("nope",))
        with pytest.raises(ValueError, match="capacity"):
            mod.HistorySampler(capacity=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_fold_history_matches(seed):
    rng = np.random.default_rng(seed)

    def ring(mod, reg_cls, render, n, base):
        reg = _fill(reg_cls, base, 1.0)
        sampler = mod.HistorySampler(registry=reg, capacity=8)
        steps = np.random.default_rng(base).integers(1, 9, size=n)
        for k in range(n):
            reg.counter("photon_serving_requests_total", "requests").inc(
                float(steps[k]))
            sampler.sample(now=10.0 + k)
        return sampler.snapshots()

    lens = [int(v) for v in rng.integers(2, 6, size=3)]
    out = []
    for mod, reg_cls, render, fold in (
            (j_history, JRegistry, j_render, j_fold_fleet),
            (t_history, TRegistry, t_render, t_fold_fleet)):
        router = ring(mod, reg_cls, render, 5, seed + 10)
        hosts = [(s, 0, ring(mod, reg_cls, render, lens[s], seed + s))
                 for s in range(3)]
        out.append(mod.fold_history(fold, router, hosts))
    assert len(out[1]) == min(lens)
    assert out[1] == out[0]


# --- saturation -------------------------------------------------------------------

def _saturation_run(mod, reg_cls, render):
    reg = reg_cls()
    sampler = mod.SaturationSampler(registry=reg)
    with pytest.raises(ValueError, match="closed"):
        sampler.add_probe("gpu_memory", lambda: {})
    rng = np.random.default_rng(11)
    depth = [0]
    busy = [0.0]
    refused = [0.0]
    sampler.add_probe("batcher_queue", mod.queue_probe(
        lambda: depth[0], lambda: 64, lambda: refused[0]))
    sampler.add_probe("rank_batcher_queue", mod.queue_probe(
        lambda: depth[0], lambda: None))
    sampler.add_probe("device", mod.busy_probe(lambda: busy[0]))
    pool = ThreadPoolExecutor(max_workers=3)
    sampler.add_probe("saver_pool", mod.executor_probe(pool))

    def boom():
        raise RuntimeError("probe failure reads zeros")

    sampler.add_probe("reqlog", boom)
    ticks = []
    for k in range(5):
        depth[0] = int(rng.integers(0, 100))
        busy[0] += float(rng.uniform(0.0, 0.8))
        refused[0] += float(rng.integers(0, 4))
        ticks.append(sampler.sample(now=50.0 + 0.5 * k))
    pool.shutdown()
    assert sampler.resources() == ("batcher_queue", "device",
                                   "rank_batcher_queue", "reqlog",
                                   "saver_pool")
    return ticks, mod.device_busy_seconds(reg), render(reg)


def test_saturation_sampler_matches():
    want = _saturation_run(j_saturation, JRegistry, j_render)
    got = _saturation_run(t_saturation, TRegistry, t_render)
    assert got == want
    ticks = got[0]
    assert ticks[0]["device"]["utilization"] == 0.0  # no interval yet
    assert 0.0 < ticks[-1]["device"]["utilization"] <= 1.0


def test_device_busy_seconds_sums_the_two_sources():
    for mod, reg_cls in ((j_saturation, JRegistry),
                         (t_saturation, TRegistry)):
        reg = reg_cls()
        reg.histogram("photon_execute_latency_seconds", "exec",
                      labels=("fn",)).labels(fn="a").observe(0.25)
        stages = reg.histogram("photon_serving_stage_seconds", "stages",
                               labels=("stage",))
        stages.labels(stage="execute").observe(0.5)
        stages.labels(stage="parse").observe(4.0)  # not the device
        assert mod.device_busy_seconds(reg) == 0.75


# --- the flight recorder ----------------------------------------------------------

#: the context header of the golden dumps below
CONTEXT = {"status": "ok", "version": 3, "model_lineage_id": "lin-a1b2",
           "shard_map": {"version": 2, "hash": "cafebabe12345678",
                         "nShards": 2}}


def _record_all(rec, seed):
    """The same seeded records into ``rec``, every lane."""
    rng = np.random.default_rng(seed)
    for i in range(int(rng.integers(6, 12))):
        lane = int(rng.integers(0, 5))
        if lane == 0:
            rec.note("reshard_started", request_id=f"r-{i}")
        elif lane == 1:
            rec.record_event("slo_burn_alert",
                             {"window": "5m",
                              "burn_rate": float(rng.uniform(1, 9))},
                             ts=float(i))
        elif lane == 2:
            rec.record_history({"tick": i, "ts": float(i),
                                "series": {"requests": float(i),
                                           "shed_rate": 0.25,
                                           "shard_p99": {
                                               "0": float(rng.uniform()),
                                               "1": 0.004}}})
        elif lane == 3:
            rec.record_log(f"queue saturated {i}", level="WARNING")
        else:
            rec.record_span({"name": "serving.score", "span_id": i,
                             "parent_id": 1, "request_id": f"r-{i}",
                             "seconds": float(rng.uniform(0.001, 0.02)),
                             "shard": "0"})


def _strip_ts(obj):
    if isinstance(obj, dict):
        return {k: _strip_ts(v) for k, v in obj.items() if k != "ts"}
    return obj


@pytest.mark.parametrize("seed", [0, 1])
def test_flight_dump_and_postmortem_match(tmp_path, seed):
    dumps = []
    for mod in (j_flightrec, t_flightrec):
        d = tmp_path / mod.__name__
        rec = mod.FlightRecorder(str(d), capacity=8, source="host",
                                 context_fn=lambda: CONTEXT)
        _record_all(rec, seed)
        dumps.append((rec.dump("manual", ts=1.5), rec.records()))
        assert sorted(os.listdir(d)) == ["flight-1500.jsonl"]  # no .tmp
    (j_path, j_records), (t_path, t_records) = dumps
    assert t_records == j_records
    with open(j_path) as f:
        j_lines = [json.loads(line) for line in f]
    with open(t_path) as f:
        t_lines = [json.loads(line) for line in f]
    assert [_strip_ts(r) for r in t_lines] == [_strip_ts(r) for r in j_lines]
    # with the same fixed ts, the page is the same bytes
    assert (postmortem.build_report(*postmortem.load_dump(t_path))
            == postmortem.build_report(*postmortem.load_dump(j_path)))


def test_cooldown_wrap_and_vocabularies_match(tmp_path):
    outcomes = []
    for mod in (j_flightrec, t_flightrec):
        rec = mod.FlightRecorder(str(tmp_path / mod.__name__), capacity=3,
                                 cooldown_s=3600.0)
        for i in range(7):
            rec.note("step", index=i)
        got = [r["fields"]["index"] for r in rec.records()]
        first = rec.dump("fault_site", ts=2.0)
        again = rec.dump("fault_site", ts=3.0)  # inside the cooldown
        other = rec.dump("sigterm", ts=4.0)  # another reason dumps
        forced = rec.dump("fault_site", ts=5.0, force=True)
        errors = []
        for bad in (lambda: rec.dump("nope"),
                    lambda: rec.note("Bad-Name"),
                    lambda: mod.FlightRecorder(str(tmp_path), capacity=0)):
            with pytest.raises(ValueError) as err:
                bad()
            errors.append(type(err.value).__name__)
        outcomes.append((got, rec.seq, os.path.basename(first), again,
                         os.path.basename(other),
                         os.path.basename(forced), errors))
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][0] == [4, 5, 6] and outcomes[1][3] is None


def test_watchdog_and_event_triggers_match(tmp_path):
    results = []
    for mod, bus_cls in ((j_flightrec, JBus), (t_flightrec, TBus)):
        d = tmp_path / mod.__name__
        rec = mod.FlightRecorder(str(d), capacity=16, cooldown_s=0.0)
        bus = bus_cls()
        log = logging.getLogger(f"retained-test-{mod.__name__}")
        undo = rec.install(bus=bus, logger=log)
        log.warning("a warning line")
        bus.post("fault_injected", site="serving.execute", index=0)
        bus.post("supervisor_fault_detected", reason="stall", process=1)
        bus.post("supervisor_fault_detected", reason="exit", process=1)
        dog = mod.Watchdog(rec, timeout_s=2.0)
        dog.pet(now=10.0)
        stalls = [dog.check(now=11.0), dog.check(now=12.5),
                  dog.check(now=13.0)]
        dog.pet(now=20.0)
        undo()
        reasons = []
        for name in sorted(os.listdir(d)):
            with open(d / name) as f:
                reasons.append(json.loads(f.readline())["reason"])
        results.append((sorted(reasons), [s is None for s in stalls],
                        [r["kind"] for r in rec.records()]))
    assert results[1] == results[0]
    assert results[1][0] == ["fault_site", "watchdog_stall",
                             "watchdog_stall"]


# --- the hot-shard advisor --------------------------------------------------------

class _Ring:
    def __init__(self):
        self.snaps = []

    def feed(self, tick, p99, load):
        self.snaps.append({"tick": tick, "ts": float(tick), "series": {
            "shard_p99": dict(p99), "shard_load": dict(load),
            "shard_binding": {"0": "device", "1": "batcher_queue"}}})

    def snapshots(self, window=0):
        return self.snaps[-window:] if window else list(self.snaps)


def _advise(mod, smap, bus_cls, ratios):
    """Tick an advisor once per ratio (shard 0's p99 over its peers');
    returns each tick's detections, the events and the final status."""
    ring = _Ring()
    bus = bus_cls()
    events = []
    bus.subscribe(lambda e: events.append(e.name)
                  if e.name.startswith("hot_shard") else None)
    adv = mod.HotShardAdvisor(history=ring, shard_map_fn=lambda: smap,
                              bus=bus)
    rng = np.random.default_rng(21)
    per_tick = []
    for tick, ratio in enumerate(ratios, start=1):
        base = float(rng.uniform(0.005, 0.02))
        ring.feed(tick, {"0": base * ratio, "1": base,
                         "2": base * float(rng.uniform(0.9, 1.1))},
                  {"0": 0.0, "1": 0.0, "2": 0.0})
        per_tick.append(adv.tick())
        assert adv.tick() == []  # the same snapshot adds no evidence
    return per_tick, events, adv.status()


def test_advisor_latches_on_the_same_tick_without_flapping():
    # hot for 3 ticks, then inside the hysteresis band, then cool
    ratios = [3.0, 3.0, 3.0] + [1.3, 1.9] * 4 + [1.0, 1.0, 1.0]
    want = _advise(j_advisor, JShardMap.default(3), JBus, ratios)
    got = _advise(t_advisor, TShardMap.default(3), TBus, ratios)
    assert got == want
    per_tick, events, status = got
    assert [i for i, d in enumerate(per_tick) if d] == [2]  # tick 3
    assert per_tick[2][0]["shard"] == 0
    assert per_tick[2][0]["binding_resource"] == "device"
    assert events == ["hot_shard_detected", "hot_shard_cleared"]
    assert status["hot"] == [] and status["recommendation"] is None


def test_advisor_recommendation_matches_rebalanced():
    ratios = [4.0] * 3
    smaps = (JShardMap.default(3), TShardMap.default(3))
    want = _advise(j_advisor, smaps[0], JBus, ratios)[2]
    got = _advise(t_advisor, smaps[1], TBus, ratios)[2]
    assert got == want
    rec = got["recommendation"]
    target = smaps[1].rebalanced(4)
    assert rec["moves"] == {str(b): target.buckets[b]
                            for b in sorted(smaps[1].moved_buckets(target))}
    for mod in (t_advisor, j_advisor):
        with pytest.raises(ValueError, match="hysteresis"):
            mod.HotShardAdvisor(history=_Ring(), shard_map_fn=lambda: None,
                                enter_ratio=2.0, exit_ratio=2.0)


# --- both packages' servers, each in a process of its own ----------------------

#: runs one package's serve_game and 2-shard serve_fleet with the plane on:
#: argv[1] is the package, argv[2] the JSON config, argv[3] the output path
_DRIVER = r"""
import importlib, json, sys, time, urllib.error, urllib.request
import numpy as np

pkg, cfg_path, out_path = sys.argv[1:4]
with open(cfg_path) as f:
    cfg = json.load(f)
serve_game = importlib.import_module(pkg + ".cli.serve_game")
serve_fleet = importlib.import_module(pkg + ".cli.serve_fleet")
faults = importlib.import_module(pkg + ".resilience.faults")
reqs = cfg["requests"]


def call(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def settle(trackers):
    # ticks read the connection gauges: let every handler close first
    limit = time.monotonic() + 10
    while any(t.stats()["open"] for t in trackers):
        assert time.monotonic() < limit, [t.stats() for t in trackers]
        time.sleep(0.01)


out = {}
base = ["--model-dir", cfg["model"], "--feature-shards", cfg["shards"],
        "--port", "0", "--no-warmup", "--microbatch", "4",
        "--history-capacity", "16", "--history-period-s", "0"] + cfg["extra"]
server = serve_game.build_server(
    base + ["--brownout-poll-s", "0", "--flight-dir", cfg["flight"] + "/host",
            "--flight-capacity", "64", "--watchdog-timeout-s", "30"]).start()
tracker = server.service.connections
scores = []
server.history.sample(now=10.0)
for k, (lo, hi) in enumerate(((0, 8), (8, 20))):
    scores += call(server.url + "/score",
                   {"records": reqs[lo:hi]})[1]["scores"]
    for r in reqs[hi:hi + 3]:
        scores += call(server.url + "/score", {"record": r})[1]["scores"]
    settle([tracker])
    server.history.sample(now=11.0 + k)
out["host_scores"] = scores
out["host_history"] = call(server.url + "/history")[1]
out["host_window"] = call(server.url + "/history?series=requests,"
                          "queue_depth&window=2")
out["host_bad"] = call(server.url + "/history?series=nope")[0]
out["host_bad_window"] = call(server.url + "/history?window=x")[0]
trips = []
for site in ("serving.execute", "serving.parse"):
    plan = faults.FaultPlan.from_json(
        {"seed": 0, "specs": [{"site": site, "at": [0]}]})
    with faults.injected(plan):
        trips.append([call(server.url + "/score", {"record": reqs[0]})[0]
                      for _ in range(2)])
out["trips"] = trips
server.stop()
server.telemetry.close()

fleet = serve_fleet.build_fleet(base + ["--fleet-shards", "2",
                                        "--flight-dir",
                                        cfg["flight"] + "/fleet"])
router = fleet.router
trackers = [h.service.connections for h in fleet.hosts]
rng = np.random.default_rng(7)
fleet_scores, statuses = [], []
for tick in range(1, 6):
    status, body = call(fleet.url + "/score",
                        {"records": reqs[4 * tick:4 * tick + 6]})
    assert status == 200, body
    fleet_scores += body["scores"]
    # the same leg-latency windows in both packages: shard 0 three times
    # its peer's for three ticks, then cool
    hot = 3.0 if tick <= 3 else 1.0
    with router._lat_lock:
        for s, d in enumerate(router._latency):
            d.clear()
            d.extend(float(v) * (hot if s == 0 else 1.0)
                     for v in rng.uniform(0.004, 0.006, size=20))
    for h in fleet.hosts:
        h.history.sample(now=100.0 + tick)
    fleet.history.sample(now=100.0 + tick)
    statuses.append(fleet.advisor.status())
out["fleet_scores"] = fleet_scores
out["single_scores"] = [call(fleet.url + "/score", {"record": r})[1]
                        ["scores"][0] for r in reqs[4:10]]
out["advisor_ticks"] = statuses
out["advisor"] = call(fleet.url + "/advisor")[1]
out["fleet_history"] = call(fleet.url + "/history")[1]
raw = call(fleet.url + "/history?raw=1&window=1")[1]
out["fleet_newest_prom"] = raw["snapshots"][-1]["prom"]
out["router_prom"] = fleet.history.snapshots()[-1]["prom"]
out["host_rings_prom"] = [[s, r, ring[-1]["prom"]] for s, r, ring
                          in router.observer.scrape_history()]
path = fleet.flight.dump("manual", ts=2.0)
out["fleet_dump"] = path
fleet.stop()
with open(out_path, "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' runs of :data:`_DRIVER` at once, on one port-trained
    global + perUser + perSong model: ``{package: output}``."""
    tmp = str(tmp_path_factory.mktemp("retained"))
    data = os.path.join(tmp, "d0.avro")
    write_training_examples(data, _records(300, 0, songs=True))
    model = os.path.join(tmp, "model")
    t_train.run(["--training-data", data, "--output-dir", model]
                + COMMON2 + ["--device", "cpu"])
    requests = _records(40, 11, cold_users=3, songs=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs, outs = [], {}
    for pkg in PACKAGES:
        cfg = os.path.join(tmp, f"{pkg}.json")
        with open(cfg, "w") as f:
            json.dump({"model": model, "shards": SHARDS2,
                       "requests": requests,
                       "flight": os.path.join(tmp, pkg, "flight"),
                       "extra": (["--device", "cpu"]
                                 if pkg == "photon_ml_tpu_torch" else [])},
                      f)
        outs[pkg] = os.path.join(tmp, f"{pkg}.out.json")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DRIVER, pkg, cfg, outs[pkg]],
            env=env, cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    result = {}
    for pkg, path in outs.items():
        with open(path) as f:
            result[pkg] = json.load(f)
    result["flight"] = {pkg: os.path.join(tmp, pkg, "flight")
                        for pkg in PACKAGES}
    result["tmp"] = tmp
    return result


#: the series whose values time the requests: same keys, values in range
#: (``shard_binding`` names each shard's most utilized resource)
TIMED = ("latency_p50", "latency_p99", "duty_cycle", "resource_util",
         "shard_binding")
#: counts each package's own builds (documented difference)
OWN_BUILDS = ("compiles",)


def _check_timed(row):
    for key in ("latency_p50", "latency_p99"):
        assert row[key] is None or row[key] >= 0.0
    assert row["duty_cycle"] >= 0.0
    for v in row["resource_util"].values():
        assert 0.0 <= v <= 1.0
    assert set(row["shard_binding"].values()) <= set(t_saturation.RESOURCES)


def _untimed(status):
    """An advisor status without the binding resources, which come from
    the timed ``shard_binding`` series."""
    out = json.loads(json.dumps(status))
    for evidence in out["shards"].values():
        assert evidence.pop("binding_resource") in (
            t_saturation.RESOURCES + ("unknown",))
    if out["recommendation"] is not None:
        assert sorted(out["recommendation"].pop("binding_resources")) == \
            [str(s) for s in out["hot"]]
    return out


def _hold_history(port, jax, timed=TIMED):
    assert {k: port[k] for k in ("source", "capacity", "series")} == \
        {k: jax[k] for k in ("source", "capacity", "series")}
    assert [(s["tick"], s["ts"]) for s in port["snapshots"]] == \
        [(s["tick"], s["ts"]) for s in jax["snapshots"]]
    for p, j in zip(port["snapshots"], jax["snapshots"]):
        ps, js = p["series"], j["series"]
        exact = [k for k in ps if k not in timed + OWN_BUILDS]
        assert {k: ps[k] for k in exact} == {k: js[k] for k in exact}
        assert sorted(ps["resource_util"]) == sorted(js["resource_util"])
        assert sorted(ps["shard_binding"]) == sorted(js["shard_binding"])
        _check_timed(ps)


def test_host_history_matches(served):
    port, jax = served["photon_ml_tpu_torch"], served["photon_ml_tpu"]
    _hold_history(port["host_history"], jax["host_history"])
    rows = port["host_history"]["snapshots"]
    assert [r["tick"] for r in rows] == [1, 2, 3]
    assert sum(r["series"]["requests"] for r in rows) == 2 + 3 + 3
    assert rows[-1]["series"]["duty_cycle"] <= 1.0
    assert port["host_window"] == jax["host_window"]
    assert port["host_window"][1]["series"] == ["requests", "queue_depth"]
    assert port["host_bad"] == jax["host_bad"] == 400
    assert port["host_bad_window"] == jax["host_bad_window"] == 400


def test_scores_bit_identical_with_the_plane_on(served):
    port, jax = served["photon_ml_tpu_torch"], served["photon_ml_tpu"]
    assert port["host_scores"] == jax["host_scores"]
    assert port["fleet_scores"] == jax["fleet_scores"]
    # the router's merge equals the host's scores of the same records
    assert port["single_scores"] == port["host_scores"][4:10]


def test_fault_sites_fail_one_request_in_both_packages(served):
    # serving.execute fails the batch (500), serving.parse the request
    # (500); the next request scores. The second trip lands inside the
    # first dump's cooldown, so one dump holds both
    port, jax = served["photon_ml_tpu_torch"], served["photon_ml_tpu"]
    assert port["trips"] == jax["trips"] == [[500, 200], [500, 200]]
    for pkg in PACKAGES:
        d = os.path.join(served["flight"][pkg], "host")
        names = sorted(os.listdir(d))
        assert len(names) == 1 and names[0].endswith(".jsonl")
        for name in names:
            header, records = postmortem.load_dump(os.path.join(d, name))
            assert header["reason"] == "fault_site"
            assert header["capacity"] == 64 and len(records) <= 64
            assert "fault_injected" in postmortem.build_report(header,
                                                               records)


def test_fleet_history_and_advisor_match(served):
    port, jax = served["photon_ml_tpu_torch"], served["photon_ml_tpu"]
    # the hosts' open connections include the router's pooled legs, as
    # many as its fan-out threads happened to open
    _hold_history(port["fleet_history"], jax["fleet_history"],
                  timed=TIMED + ("open_connections",))
    rows = port["fleet_history"]["snapshots"]
    assert len(rows) == 5 and rows[0]["series"]["shard_p99"]
    assert [_untimed(t) for t in port["advisor_ticks"]] == \
        [_untimed(t) for t in jax["advisor_ticks"]]
    assert _untimed(port["advisor"]) == _untimed(jax["advisor"])
    # latched on the third hot tick; two cool ticks are not yet enough to
    # clear it
    assert [t["hot"] for t in port["advisor_ticks"]] == [[], [], [0], [0],
                                                         [0]]
    assert port["advisor_ticks"][2]["detections"] == 1
    assert port["advisor_ticks"][2]["recommendation"]["n_shards"] == 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_router_newest_row_is_metrics_fold_of_the_rings(served, pkg):
    out = served[pkg]
    run = os.path.join(served["tmp"], f"layout-{pkg}")
    os.makedirs(run)
    with open(os.path.join(run, "metrics.prom"), "w") as f:
        f.write(out["router_prom"])
    for s, r, text in out["host_rings_prom"]:
        d = os.path.join(run, "hosts", f"shard-{s}-replica-{r}")
        os.makedirs(d)
        with open(os.path.join(d, "metrics.prom"), "w") as f:
            f.write(text)
    with open(metrics_fold.fold_metrics(run)) as f:
        assert f.read() == out["fleet_newest_prom"]


def test_fleet_flight_dump_renders(served):
    pages = {}
    for pkg in PACKAGES:
        header, records = postmortem.load_dump(served[pkg]["fleet_dump"])
        assert header["reason"] == "manual" and header["source"] == "fleet"
        assert {r["kind"] for r in records} >= {"span", "history"}
        pages[pkg] = postmortem.build_report(header, records)
    assert "== photon flight postmortem ==" in pages["photon_ml_tpu_torch"]
    assert "fleet.request" in pages["photon_ml_tpu_torch"]
