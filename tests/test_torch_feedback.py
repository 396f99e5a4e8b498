"""The port's closed feedback loop (``photon_ml_tpu_torch/feedback/``,
``cli/join_feedback.py``, ``serve_fleet --autopilot-config``) against the
JAX package's, on the CPU.

- **The join**: from the same request log and labels both packages'
  ``join_feedback`` write byte-identical ``TrainingExampleAvro`` and the
  same accounting (inline, external, late, duplicate and zero-row cases);
  ``load_labels`` reads CSV and Avro alike; the ``feedback.join`` site
  aborts a pass in both.
- **The autopilot's guards**: a too-small join aborts and a re-post inside
  the debounce window is suppressed, a ``feedback.refresh_launch`` fault
  aborts before any work, other events are ignored, in both packages with
  equal statistics; ``AutopilotConfig``'s JSON is the JAX package's both
  ways.
- **The loop**: each package's 2-shard ``serve_fleet --reqlog-dir
  --autopilot-config --router-watch-dir`` on the same trained model, under
  the same client-stamped traffic and label CSV, each in a process of its
  own, run at once: one refresh and no abort, equal join counts and
  ``solved``, the other coordinate carried bit for bit, the watcher's
  activation fleet-wide with no program built on the untouched host, a
  partial patch set refused with the probe scores unchanged; the two
  refreshed models agree at ``tests/test_torch_continuous.py``'s f32 GAME
  tolerances (the fixed effect rtol 1e-3 / atol 1e-4, an entity row rtol
  2e-3 / atol 5e-4: the refresh's parity tolerance).
- **The CLI**: both ``join_feedback`` commands over the port loop's two
  host logs give the same report, ``delta`` included, and the same bytes.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

import photon_ml_tpu.feedback as jfb
import photon_ml_tpu_torch.feedback as tfb
from photon_ml_tpu.cli.join_feedback import run as j_join_cli
from photon_ml_tpu.events import EventBus as JEventBus
from photon_ml_tpu.io.avro import write_avro_file
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.io.schemas import FEEDBACK_LABEL_AVRO
from photon_ml_tpu.resilience import FaultPlan as JFaultPlan
from photon_ml_tpu.resilience import InjectedFault as JInjectedFault
from photon_ml_tpu.resilience import injected as j_injected
from photon_ml_tpu_torch.__main__ import _COMMANDS
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.cli.join_feedback import run as t_join_cli
from photon_ml_tpu_torch.events import EventBus as TEventBus
from photon_ml_tpu_torch.fleet.sharding import shard_of_id
from photon_ml_tpu_torch.resilience import FaultPlan as TFaultPlan
from photon_ml_tpu_torch.resilience import injected as t_injected
from photon_ml_tpu_torch.resilience.faults import (
    InjectedFault as TInjectedFault,
)
from photon_ml_tpu_torch.serving import RequestLog
from test_torch_continuous import RE_TOL, TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's loop test data (tests/test_feedback.py): two
# random-effect coordinates, so the drifted coordinate's refresh has a
# second one whose carry is observable
SHARDS = "global=g|intercept,user=u|noIntercept,item=s|noIntercept"
COORDS = [
    "global=fixed,shard=global,reg=L2",
    "perUser=random,entity=userId,shard=user,reg=L2",
    "perItem=random,entity=songId,shard=item,reg=L2",
]
SEQUENCE = "global,perUser,perItem"
GRID = ("global=0.1", "perUser=1", "perItem=1")
D_FIXED, D_USER, D_ITEM = 4, 2, 2
USERS = [f"u{i}" for i in range(10)]
SONGS = [f"s{i}" for i in range(8)]
#: the loop's client-stamped requests, one record each
K = 24


def _features(rng):
    return ([{"name": f"g.x{j}", "term": "", "value": float(rng.normal())}
             for j in range(D_FIXED)]
            + [{"name": f"u.z{j}", "term": "", "value": float(rng.normal())}
               for j in range(D_USER)]
            + [{"name": f"s.w{j}", "term": "", "value": float(rng.normal())}
               for j in range(D_ITEM)])


def _records(n, seed):
    rng = np.random.default_rng(seed)
    return [{"uid": str(i), "response": float(rng.integers(2)),
             "offset": None, "weight": None, "features": _features(rng),
             "metadataMap": {"userId": USERS[i % len(USERS)],
                             "songId": SONGS[i % len(SONGS)]}}
            for i in range(n)]


# --- the join ----------------------------------------------------------------

def _log(log_dir, rows, segment_records=8):
    rl = RequestLog(log_dir, sample_rate=1.0,
                    segment_records=segment_records)
    try:
        for rid, recs in rows:
            rl.log(request_id=rid, records=recs, scores=[0.0] * len(recs),
                   version=1)
    finally:
        rl.close()


def _rows(k=4):
    rng = np.random.default_rng(7)
    rows = []
    for i in range(k):
        rec = {"features": _features(rng), "offset": 0.25 * i,
               "metadataMap": {"userId": USERS[i % len(USERS)],
                               "songId": SONGS[i % len(SONGS)]}}
        rows.append((f"r{i:03d}", [dict(rec), dict(rec)]))
    return rows


def _case(tmp_path, case):
    """(log dirs, labels) of one join case."""
    log = str(tmp_path / "log")
    if case == "zero-rows":
        os.makedirs(log)
        return [log], None
    rows = _rows(4)
    if case == "inline-only":
        rows[1][1][0]["label"] = 0.0
        rows[2][1][1]["label"] = 1.0
        _log(log, rows)
        return [log], None
    rows[0][1][0]["label"] = 1.0  # inline, which wins over r000's CSV row
    rows.append((rows[3][0], [dict(r) for r in rows[3][1]]))  # a re-log
    if case == "two-logs":
        _log(log, rows[:2])
        _log(str(tmp_path / "log2"), rows[2:])
        log = [log, str(tmp_path / "log2")]
    else:
        _log(log, rows)
        log = [log]
    labels = [("r000", 0, 0.0), ("r001", 0, 1.0), ("r002", 1, 0.0),
              ("r003", 0, 1.0), ("r003", 1, 0.0), ("r003", 1, 1.0),
              ("ghost", 0, 1.0)]
    if case == "avro-labels":
        path = str(tmp_path / "labels.avro")
        write_avro_file(path, ({"requestId": rid, "recordIndex": idx,
                                "label": y} for rid, idx, y in labels),
                        FEEDBACK_LABEL_AVRO)
    else:
        path = str(tmp_path / "labels.csv")
        with open(path, "w") as f:
            f.write("request_id,record_index,label\n")
            for rid, idx, y in labels:
                # a 2-column row is record index 0
                f.write(f"{rid},{y}\n" if rid == "r001"
                        else f"{rid},{idx},{y}\n")
    return log, path


@pytest.mark.parametrize("case", ["external-late-duplicate", "two-logs",
                                  "avro-labels", "inline-only",
                                  "zero-rows"])
def test_join_bytes_and_accounting_equal_jax(tmp_path, case):
    dirs, labels = _case(tmp_path, case)
    out = {}
    for name, mod in (("t", tfb), ("j", jfb)):
        path = str(tmp_path / f"{name}.avro")
        out[name] = (mod.join_feedback(dirs, labels, path).as_dict(), path)
        if labels is not None:
            assert mod.load_labels(labels) == jfb.load_labels(labels)
    (t, tp), (j, jp) = out["t"], out["j"]
    assert t.pop("output_path") == tp and j.pop("output_path") == jp
    assert t == j
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    if case == "external-late-duplicate":
        # joined: r000#0 inline, r001#0, r002#1, r003#0, r003#1 (the CSV,
        # first wins); late: ghost and r000#0's external label, which the
        # inline label outranks and so never matches
        assert (t["joined"], t["unjoined"], t["duplicates"], t["late"],
                t["requests"]) == (5, 3, 2, 2, 5)
    if case == "zero-rows":
        assert t["joined"] == 0 and t["last_ts"] is None
        assert os.path.getsize(tp) > 0


def test_join_fault_site_aborts_a_pass_in_both(tmp_path):
    os.makedirs(tmp_path / "log")
    spec = {"seed": 0, "specs": [{"site": "feedback.join", "rate": 1.0}]}
    for mod, plan_of, inject, fault in (
            (tfb, TFaultPlan, t_injected, TInjectedFault),
            (jfb, JFaultPlan, j_injected, JInjectedFault)):
        plan = plan_of.from_json(spec)
        with inject(plan), pytest.raises(fault):
            mod.join_feedback(str(tmp_path / "log"), None,
                              str(tmp_path / "o.avro"))
        assert [r.site for r in plan.fired()] == ["feedback.join"]
        assert not os.path.exists(tmp_path / "o.avro")


# --- the autopilot's guards ---------------------------------------------------

def _guard_config(mod, tmp_path, **over):
    base = dict(prior_dir=str(tmp_path / "nope"),
                publish_dir=str(tmp_path / "publish"),
                feature_shards=SHARDS, coordinates=tuple(COORDS),
                update_sequence=SEQUENCE, grid=GRID, evaluators="",
                data_validation="VALIDATE_DISABLED", min_rows=1,
                debounce_s=0.0, min_interval_s=0.0)
    base.update(over)
    return mod.AutopilotConfig(**base)


def _wait_stats(ap, pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = ap.stats()
        if pred(s):
            return s
        time.sleep(0.02)
    return ap.stats()


PACKAGES = [("torch", tfb, TEventBus, TFaultPlan, t_injected),
            ("jax", jfb, JEventBus, JFaultPlan, j_injected)]


def test_empty_join_aborts_and_the_debounce_suppresses(tmp_path):
    stats = {}
    for name, mod, bus_cls, _, _ in PACKAGES:
        root = tmp_path / name
        os.makedirs(root / "log")
        bus = bus_cls()
        ap = mod.FeedbackAutopilot(
            bus, _guard_config(mod, root, debounce_s=3600.0),
            reqlog_dirs=[str(root / "log")]).start()
        try:
            bus.post("quality_drift_detected", version=1, kind="psi",
                     coordinate="perUser", drift=1.0)
            _wait_stats(ap, lambda s: s["aborts"] == 1 and not s["busy"])
            # the evaluator's re-post inside the window
            bus.post("quality_drift_detected", version=1, kind="psi",
                     coordinate="perUser", drift=1.0)
            stats[name] = _wait_stats(ap, lambda s: s["suppressed"] == 1,
                                      timeout_s=5.0)
        finally:
            ap.stop()
        # 0 joined rows < min_rows: nothing published, the staging gone
        assert os.listdir(root / "publish") == [".staging"]
        assert os.listdir(root / "publish" / ".staging") == []
    assert stats["torch"] == stats["jax"] == {
        "refreshes": 0, "aborts": 1, "suppressed": 1, "busy": False,
        "last": None}


def test_launch_fault_aborts_before_any_work(tmp_path):
    stats = {}
    for name, mod, bus_cls, plan_of, inject in PACKAGES:
        root = tmp_path / name
        bus = bus_cls()
        ap = mod.FeedbackAutopilot(bus, _guard_config(mod, root),
                                   reqlog_dirs=[str(root / "none")]).start()
        plan = plan_of.from_json({"seed": 0, "specs": [
            {"site": "feedback.refresh_launch", "rate": 1.0}]})
        try:
            with inject(plan):
                bus.post("quality_drift_detected", version=1, kind="psi",
                         coordinate="perUser", drift=1.0)
                stats[name] = _wait_stats(
                    ap, lambda s: s["aborts"] == 1 and not s["busy"])
        finally:
            ap.stop()
        assert [r.site for r in plan.fired()] == ["feedback.refresh_launch"]
        assert not os.path.exists(root / "publish")
    assert stats["torch"] == stats["jax"]
    assert stats["torch"]["aborts"] == 1


def test_other_events_ignored(tmp_path):
    stats = {}
    for name, mod, bus_cls, _, _ in PACKAGES:
        bus = bus_cls()
        ap = mod.FeedbackAutopilot(bus, _guard_config(mod, tmp_path),
                                   reqlog_dirs=[str(tmp_path)]).start()
        try:
            bus.post("model_saved", path="x")
            bus.post("training_finished", driver="train_game")
            stats[name] = ap.stats()
        finally:
            ap.stop()
    assert stats["torch"] == stats["jax"] == {
        "refreshes": 0, "aborts": 0, "suppressed": 0, "busy": False,
        "last": None}


def test_config_json_is_the_jax_packages_both_ways(tmp_path):
    j_cfg = _guard_config(jfb, tmp_path, fleet_shards=2, labels="l.csv")
    path = str(tmp_path / "ap.json")
    with open(path, "w") as f:
        json.dump(j_cfg.as_dict(), f)
    t_cfg = tfb.AutopilotConfig.load(path)
    assert t_cfg.as_dict() == j_cfg.as_dict()
    assert isinstance(t_cfg.coordinates, tuple)
    assert t_cfg == _guard_config(tfb, tmp_path, fleet_shards=2,
                                  labels="l.csv")
    with open(path, "w") as f:
        json.dump(t_cfg.as_dict(), f)
    assert jfb.AutopilotConfig.load(path) == j_cfg


# --- the loop ----------------------------------------------------------------

_LOOP = r"""
import json, os, sys, time, urllib.request

pkg, spec_path = sys.argv[1], sys.argv[2]
with open(spec_path) as f:
    spec = json.load(f)
import importlib

serve_fleet = importlib.import_module(pkg + ".cli.serve_fleet")
GLOBAL_BUS = importlib.import_module(pkg + ".events").GLOBAL_BUS
PATCH_KIND = importlib.import_module(pkg + ".io.model_io").PATCH_KIND


def http(url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def wait(pred, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not pred():
        time.sleep(0.05)


fleet = serve_fleet.build_fleet(spec["argv"])
facts = {"fleet_shards": fleet.autopilot.config.fleet_shards}
try:
    for i, rec in enumerate(spec["requests"]):
        http(fleet.url + "/score", {"records": [rec]},
             {"X-Photon-Request-Id": "fb-%03d" % i})
    facts["health0"] = [http(u + "/healthz") for u in fleet.host_urls()]
    GLOBAL_BUS.post("quality_drift_detected", version=1, kind="psi",
                    coordinate="perUser", drift=1.0, threshold=0.25,
                    rows=len(spec["requests"]))
    ap = fleet.autopilot
    wait(lambda: (ap.stats()["refreshes"] + ap.stats()["aborts"] >= 1
                  and not ap.stats()["busy"]), 240)
    facts["stats"] = ap.stats()
    w = fleet.watcher
    wait(lambda: w.n_applied >= 1 or w.n_rejected > 0, 60)
    facts["applied"], facts["rejected0"] = w.n_applied, w.n_rejected
    facts["health1"] = [http(u + "/healthz") for u in fleet.host_urls()]
    probe = {"records": [spec["probe"]]}
    facts["probe"] = http(fleet.url + "/score", probe)["scores"]
    bad = os.path.join(spec["publish"], "zz-bad", "patch-shard-0")
    os.makedirs(bad)
    with open(os.path.join(bad, "model-metadata.json"), "w") as f:
        json.dump({"kind": PATCH_KIND, "fleetShard": 0,
                   "fleetShardCount": 2, "modelId": "m1",
                   "parentModel": "p0"}, f)
    wait(lambda: w.n_rejected > facts["rejected0"], 30)
    facts["rejected"] = w.n_rejected
    facts["health2"] = [http(u + "/healthz") for u in fleet.host_urls()]
    facts["probe_after"] = http(fleet.url + "/score", probe)["scores"]
finally:
    fleet.stop()
with open(spec["out"], "w") as f:
    json.dump(facts, f)
"""


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """Both packages' closed loops on one model the port trained, each in
    a process of its own, run at once: ``{pkg: facts}`` plus the paths."""
    tmp = str(tmp_path_factory.mktemp("feedback_loops"))
    d0 = os.path.join(tmp, "d0.avro")
    write_training_examples(d0, _records(500, 0))
    r0 = os.path.join(tmp, "r0")
    t_train.run(["--training-data", d0, "--output-dir", r0,
                 "--feature-shards", SHARDS, "--coordinates", *COORDS,
                 "--update-sequence", SEQUENCE, "--grid", *GRID,
                 "--evaluators", "", "--data-validation",
                 "VALIDATE_DISABLED", "--device", "cpu"])
    # every request's user and song live on shard 0: shard 1's patch has
    # no rows
    users0 = [u for u in USERS if shard_of_id(u, 2) == 0]
    songs0 = [s for s in SONGS if shard_of_id(s, 2) == 0]
    assert len(users0) >= 2 and songs0, (users0, songs0)
    rng = np.random.default_rng(42)
    requests = [{"features": _features(rng), "offset": None,
                 "metadataMap": {"userId": users0[i % len(users0)],
                                 "songId": songs0[i % len(songs0)]}}
                for i in range(K)]
    probe = {"features": _features(np.random.default_rng(7)),
             "offset": None,
             "metadataMap": {"userId": users0[0], "songId": songs0[0]}}
    labels = os.path.join(tmp, "labels.csv")
    with open(labels, "w") as f:
        f.write("request_id,label\n")
        for i in range(K):
            f.write(f"fb-{i:03d},{float(i % 2)}\n")
        f.write("ghost,0,1.0\n")  # a label the log never saw: late
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs, paths = [], {}
    for pkg in ("photon_ml_tpu_torch", "photon_ml_tpu"):
        d = os.path.join(tmp, pkg)
        os.makedirs(d)
        publish = os.path.join(d, "publish")
        cfg = os.path.join(d, "autopilot.json")
        with open(cfg, "w") as f:
            json.dump(_guard_config(jfb, pathlib.Path(d), prior_dir=r0,
                                    publish_dir=publish,
                                    labels=labels).as_dict(), f)
        argv = ["--model-dir", r0, "--feature-shards", SHARDS,
                "--port", "0", "--fleet-shards", "2",
                "--microbatch", "8", "--max-wait-ms", "1",
                "--reqlog-dir", os.path.join(d, "reqlog"),
                "--reqlog-segment-records", "8",
                "--autopilot-config", cfg,
                "--router-watch-dir", publish,
                "--router-watch-poll-s", "0.2"]
        if pkg == "photon_ml_tpu_torch":
            argv += ["--device", "cpu"]
        spec = os.path.join(d, "spec.json")
        paths[pkg] = dict(out=os.path.join(d, "facts.json"),
                          reqlog=os.path.join(d, "reqlog"))
        with open(spec, "w") as f:
            json.dump(dict(argv=argv, requests=requests, probe=probe,
                           publish=publish, out=paths[pkg]["out"]), f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _LOOP, pkg, spec], env=env, cwd=d,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
    facts = {}
    for pkg, p in paths.items():
        with open(p["out"]) as f:
            facts[pkg] = json.load(f)
    return dict(facts=facts, paths=paths, r0=r0, labels=labels,
                users0=users0)


def test_each_loop_published_one_refresh(loops):
    for pkg, f in loops["facts"].items():
        assert f["fleet_shards"] == 2, pkg  # the fleet's own shard count
        assert f["stats"]["refreshes"] == 1, (pkg, f["stats"])
        assert f["stats"]["aborts"] == 0, (pkg, f["stats"])
        assert f["stats"]["last"]["coordinate"] == "perUser"


def test_join_counts_and_solved_equal_jax(loops):
    t, j = (loops["facts"][p]["stats"]["last"]
            for p in ("photon_ml_tpu_torch", "photon_ml_tpu"))
    for key in ("joined", "unjoined", "late", "duplicates", "requests"):
        assert t["join"][key] == j["join"][key], key
    assert (t["join"]["joined"], t["join"]["late"],
            t["join"]["unjoined"]) == (K, 1, 0)
    assert t["solved"] == j["solved"]
    assert t["solved"]["perUser"] == len(loops["users0"])
    assert t["solved"]["perItem"] == 0


def _load(run):
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.io.index import IndexMap
    from photon_ml_tpu_torch.io.model_io import (
        game_model_entity_vocabs,
        load_game_model,
        resolve_game_model_dir,
    )

    best = resolve_game_model_dir(run)
    maps = {c.shard_id: IndexMap.load(os.path.join(
        run, "feature-indexes", f"{c.shard_id}.json"))
        for c in (parse_feature_shard_config(s) for s in SHARDS.split(","))}
    vocabs = game_model_entity_vocabs(best)
    model = load_game_model(best, maps, vocabs, device="cpu")
    rows = {}
    for cid, t in (("perUser", "userId"), ("perItem", "songId")):
        re = model.coordinates[cid]
        rows[cid] = {raw: re.entity_rows([dense])[0]
                     for raw, dense in vocabs[t].items()}
    return model, rows


def test_carried_coordinate_bit_identical_and_models_agree(loops):
    _, rows0 = _load(loops["r0"])
    got = {}
    for pkg, f in loops["facts"].items():
        model, rows = _load(f["stats"]["last"]["entry"])
        got[pkg] = (model, rows)
        assert set(rows["perItem"]) == set(rows0["perItem"])
        for raw, row in rows0["perItem"].items():
            assert np.array_equal(row, rows["perItem"][raw]), (pkg, raw)
        moved = [raw for raw in loops["users0"]
                 if not np.array_equal(rows0["perUser"][raw],
                                       rows["perUser"][raw])]
        assert moved, pkg
        # entities the traffic never named carry too
        for raw in set(rows0["perUser"]) - set(loops["users0"]):
            assert np.array_equal(rows0["perUser"][raw],
                                  rows["perUser"][raw]), (pkg, raw)
    (tm, tr), (jm, jr) = got["photon_ml_tpu_torch"], got["photon_ml_tpu"]
    np.testing.assert_allclose(
        tm.coordinates["global"].model.coefficients.means.numpy(),
        jm.coordinates["global"].model.coefficients.means.numpy(), **TOL)
    for raw in loops["users0"]:
        np.testing.assert_allclose(tr["perUser"][raw], jr["perUser"][raw],
                                   **RE_TOL, err_msg=raw)


def test_watcher_activates_fleet_wide_without_a_build_on_the_untouched_host(
        loops):
    for pkg, f in loops["facts"].items():
        assert (f["applied"], f["rejected0"]) == (1, 0), pkg
        for h0, h1 in zip(f["health0"], f["health1"]):
            assert h1["version"] > h0["version"], (pkg, h0, h1)
        # host 1 serves shard 1, which no logged entity lives on
        assert f["health1"][1]["compiles"] == f["health0"][1]["compiles"], \
            pkg


def test_refused_candidate_keeps_the_incumbent(loops):
    for pkg, f in loops["facts"].items():
        assert f["rejected"] == f["rejected0"] + 1, pkg
        assert [h["version"] for h in f["health2"]] == \
            [h["version"] for h in f["health1"]], pkg
        assert f["probe_after"] == f["probe"], pkg


# --- the CLI -------------------------------------------------------------------

def test_join_feedback_cli_reports_equal_jax(loops, tmp_path):
    assert _COMMANDS["join_feedback"] == "photon_ml_tpu_torch.cli.join_feedback"
    hosts = [os.path.join(loops["paths"]["photon_ml_tpu_torch"]["reqlog"],
                          f"host-{i}") for i in range(2)]
    reports, outputs = {}, {}
    for name, cli in (("t", t_join_cli), ("j", j_join_cli)):
        out = str(tmp_path / f"{name}.avro")
        rpt = str(tmp_path / f"{name}.json")
        argv = [a for h in hosts for a in ("--reqlog-dir", h)] + [
            "--labels", loops["labels"], "--output", out, "--report", rpt,
            "--prior-dir", loops["r0"], "--feature-shards", SHARDS,
            "--coordinates", *COORDS]
        report = cli(argv)
        with open(rpt) as f:
            assert json.load(f) == report
        report.pop("output_path")
        reports[name] = report
        with open(out, "rb") as f:
            outputs[name] = f.read()
    assert reports["t"] == reports["j"]
    assert outputs["t"] == outputs["j"]
    join = loops["facts"]["photon_ml_tpu_torch"]["stats"]["last"]["join"]
    for key in ("joined", "late", "duplicates"):
        assert reports["t"][key] == join[key], key
    # the logs also hold the loop's two probe requests, sent after the
    # autopilot's join, unlabeled
    assert reports["t"]["unjoined"] == join["unjoined"] + 2
    assert reports["t"]["requests"] == join["requests"] + 2
    delta = reports["t"]["delta"]
    assert delta["perUser"]["touched"] == len(loops["users0"])
    assert set(delta) == {"perUser", "perItem"}
    # --prior-dir without the training-time specs is refused
    with pytest.raises(SystemExit, match="--feature-shards"):
        t_join_cli(["--reqlog-dir", hosts[0], "--output",
                    str(tmp_path / "x.avro"), "--prior-dir", loops["r0"]])
