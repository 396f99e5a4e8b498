"""The port's model-quality layer (``photon_ml_tpu_torch.quality``) and its
serving wiring, on the CPU at a tiny size, against the JAX package's
``photon_ml_tpu.quality`` on the same inputs.

Held: the binning, PSI, KS, probe sample and top-k overlap equal; the
baseline's numbers equal (1e-10 relative on f64 quantities; the AUC and
the Hosmer–Lemeshow table, which both packages compute from f32 inputs,
within 1e-6) and its JSON byte-equal where no f32 statistic enters (no
labels, a linear task) and after a round trip through the other package;
the canary's decision and divergence equal; ``QualityMonitor.
drift_scores`` equal on the same batches. Then ``serve_game`` with
``--canary-gate``, ``--quality-poll-s`` and ``--rank-item-coordinate`` on
a GLMix trained by the port's ``train_game``: a candidate with a negated
item table is refused and the incumbent keeps its scores, the same model
activates with divergence 0, the drift evaluator reads the active
version's baseline and fires on shifted traffic, and ``/healthz`` carries
the baseline, canary and reservoir fields.
"""

import dataclasses
import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

from photon_ml_tpu import quality as jq
from photon_ml_tpu_torch import quality as tq
from photon_ml_tpu_torch.cli import serve_game as t_serve
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.io.index import IndexMap
from photon_ml_tpu_torch.io.model_io import load_serving_model, save_game_model
from photon_ml_tpu_torch.types import INTERCEPT_KEY, NAME_TERM_DELIMITER
from test_torch_cli import SHARDS, _write_bench_file
from test_torch_retrieval import _train_args

#: f64 statistics (moments, PSI inputs) on both sides
F64_RTOL = 1e-10
#: statistics both packages compute from f32 inputs (AUC, HL table)
F32_RTOL = 1e-6


def _scores(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=n)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-s))).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=n)
    return s, y, w


def test_binning_and_drift_arithmetic_match():
    s, _, _ = _scores()
    live = _scores(seed=1)[0] * 1.3 + 0.2
    for n_bins in (2, 10, 20):
        te, je = tq.quantile_edges(s, n_bins), jq.quantile_edges(s, n_bins)
        assert np.array_equal(te, je)
        tb, jb = tq.bin_scores(live, te), jq.bin_scores(live, je)
        assert np.array_equal(tb, jb)
        base = tq.bin_scores(s, te)
        assert tq.population_stability_index(base, tb) == \
            jq.population_stability_index(base, jb)
        assert tq.ks_statistic(base, tb) == jq.ks_statistic(base, jb)
    # discrete scores dedupe their edges
    assert np.array_equal(tq.quantile_edges(np.repeat([1.0, 2.0], 50)),
                          jq.quantile_edges(np.repeat([1.0, 2.0], 50)))
    with pytest.raises(ValueError):
        tq.population_stability_index([1, 2], [1, 2, 3])
    users = [f"u{i}" for i in range(300)] + ["u7"]
    assert tq.rank_probe_sample(users, 16) == jq.rank_probe_sample(users, 16)
    assert tq.rank_probe_records(["u1"], ["userId"]) == \
        jq.rank_probe_records(["u1"], ["userId"])
    for ref, live_ids in (([], ["a"]), (["a", "b", "c"], ["c", "x", "a"]),
                          (["a"], [])):
        assert tq.topk_overlap(ref, live_ids) == jq.topk_overlap(ref,
                                                                 live_ids)


def _compare_baselines(t, j):
    """Equal keys and non-float values; floats at their tolerances."""
    assert t.keys() == j.keys()
    for key in t:
        a, b = t[key], j[key]
        if key in ("auc", "calibration"):
            tol = F32_RTOL
        else:
            tol = F64_RTOL
        _close(a, b, tol, key)


def _close(a, b, tol, path):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= tol * max(abs(b), 1.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


_CASES = {
    "logistic": dict(task="LOGISTIC_REGRESSION", labels=True),
    "linear": dict(task="LINEAR_REGRESSION", labels=True),
    "unlabeled": dict(task="LOGISTIC_REGRESSION", labels=False),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_compute_baseline_matches_jax(case, tmp_path):
    cfg = _CASES[case]
    s, y, w = _scores()
    rng = np.random.default_rng(4)
    kw = dict(
        task=cfg["task"],
        margins={"global": s * 0.6, "perUser": rng.normal(size=s.size)},
        cold_rates={"perUser": 0.125}, coverage={"global": 0.375},
        lineage={"parentModel": None, "trainedAt": "t",
                 "dataManifest": "d"})
    labels = y if cfg["labels"] else None
    tb = tq.compute_baseline(s, labels, w, **kw)
    jb = jq.compute_baseline(s, labels, w, **kw)
    _compare_baselines(tb.to_dict(), jb.to_dict())
    if case == "logistic":
        assert tb.calibration is not None and tb.auc is not None
        # the same bins, counts and observed positives
        for key in ("binCounts", "observedPositives"):
            assert tb.calibration[key] == jb.calibration[key]
    tp, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tq.save_baseline(tp, tb)
    jq.save_baseline(jp, jb)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        same = a.read() == b.read()
    # byte-equal where no f32 statistic enters the file
    assert same or case == "logistic"
    # each package writes the other's baseline back to the same bytes
    jq.save_baseline(str(tmp_path / "jt.json"), jq.load_baseline(tp))
    tq.save_baseline(str(tmp_path / "tj.json"), tq.load_baseline(jp))
    for mine, theirs in (("t.json", "jt.json"), ("j.json", "tj.json")):
        with open(tmp_path / mine, "rb") as a, \
                open(tmp_path / theirs, "rb") as b:
            assert a.read() == b.read()
    assert tq.load_baseline(str(tmp_path / "missing.json")) is None


def test_canary_matches_jax():
    recs = [{"i": i} for i in range(20)]
    base = np.linspace(-3, 3, 20).astype(np.float32)

    def inc(records):
        return base[[r["i"] for r in records]]

    for shift, gate in ((0.0, True), (0.01, False), (0.2, False),
                        (0.2, True)):
        def cand(records, shift=shift):
            return inc(records) * (1 + shift)

        out = {}
        for name, mod in (("t", tq), ("j", jq)):
            try:
                out[name] = mod.run_canary(inc, cand, recs, bound=0.05,
                                           gate=gate, candidate_dir="c")
            except mod.CanaryRejected as e:
                out[name] = ("rejected", str(e))
        if isinstance(out["t"], tuple):
            assert out["t"] == out["j"]
            continue
        for key in ("divergence", "bound", "n", "verdict"):
            assert out["t"][key] == out["j"][key], key
    assert tq.score_divergence(base, base * 1.1) == \
        jq.score_divergence(base, base * 1.1)
    assert tq.CanaryConfig(gate=True).bound_for("int8") == \
        jq.CanaryConfig(gate=True).bound_for("int8") == 5e-2
    r_t, r_j = tq.RequestReservoir(8, seed=3), jq.RequestReservoir(8, seed=3)
    for batch in (recs[:5], recs[5:17], recs[17:]):
        r_t.add(batch)
        r_j.add(batch)
    assert r_t.sample() == r_j.sample() and len(r_t) == 8


def test_monitor_drift_scores_match_jax():
    s, y, w = _scores()
    d = jq.compute_baseline(s, y, w, task="LOGISTIC_REGRESSION",
                            cold_rates={"perUser": 0.1},
                            coverage={"item": 0.5}).to_dict()
    t_mon = tq.QualityMonitor(tq.QualityBaseline.from_dict(d))
    j_mon = jq.QualityMonitor(jq.QualityBaseline.from_dict(d))
    assert t_mon.drift_scores() == j_mon.drift_scores() == {}
    rng = np.random.default_rng(9)
    for i in range(6):
        batch = rng.normal(size=40) * (1 + 0.2 * i)
        cold = {"perUser": int(i)}
        cov = {"item": (10 * i, 80)}
        t_mon.observe(batch, cold=cold, coverage=cov)
        j_mon.observe(batch, cold=cold, coverage=cov)
    t, j = t_mon.drift_scores(), j_mon.drift_scores()
    assert t.keys() == j.keys() and len(t) == 5
    for key in t:
        assert abs(t[key] - j[key]) <= 1e-12 * max(abs(j[key]), 1.0), key
    assert t_mon.n_rows == j_mon.n_rows == 240
    assert tq.QualityMonitor(None).drift_scores() == {}


# --- serve_game with the quality and rank flags ---------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_quality")
    train = _write_bench_file(str(d / "train.avro"), 600, 3, users=20,
                              songs=40)
    valid = _write_bench_file(str(d / "valid.avro"), 300, 4, users=20,
                              songs=40)
    out = str(d / "run")
    t_train.run(_train_args(train, out) + ["--validation-data", valid])
    return {"dir": str(d), "run": out, "valid": valid}


def _negated_candidate(run_dir, out_dir):
    """``run_dir``'s model with its perSong table negated, as a run dir."""
    index_dir = os.path.join(run_dir, "feature-indexes")
    maps = {s: IndexMap.load(os.path.join(index_dir, f"{s}.json"))
            for s in ("global", "item")}
    model, vocabs, _ = load_serving_model(os.path.join(run_dir, "best"),
                                          maps, device="cpu")
    song = model.coordinates["perSong"]
    model = dataclasses.replace(model, coordinates=dict(
        model.coordinates, perSong=dataclasses.replace(
            song, coeffs=-song.coeffs)))
    save_game_model(os.path.join(out_dir, "best"), model, maps, vocabs)
    shutil.copytree(index_dir, os.path.join(out_dir, "feature-indexes"))
    return out_dir


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _requests(path, feature=None, shift=0.0):
    """The Avro file's records as requests; with ``feature``, that
    feature's value moved by ``shift`` in every record (added where
    absent)."""
    from photon_ml_tpu_torch.io.avro import iter_avro_file

    out = []
    for r in iter_avro_file(path):
        feats = [dict(f) for f in r["features"]]
        if feature is not None:
            hit = [f for f in feats if f["name"] == feature]
            if hit:
                hit[0]["value"] += shift
            else:
                feats.append({"name": feature, "term": "", "value": shift})
        out.append({"features": feats, "metadataMap": r["metadataMap"],
                    "offset": r.get("offset")})
    return out


def test_serve_game_canary_drift_and_rank(run, monkeypatch):
    assert os.path.exists(os.path.join(run["run"], tq.BASELINE_NAME))
    server = t_serve.build_server([
        "--model-dir", run["run"], "--feature-shards", SHARDS,
        "--port", "0", "--device", "cpu", "--canary-gate",
        "--quality-poll-s", "3600", "--drift-threshold", "0.25",
        "--rank-item-coordinate", "perSong", "--rank-max-k", "16"]).start()
    try:
        registry = server.service.registry
        assert registry.canary.gate and registry.canary.bound is None
        v1 = registry.active()
        assert v1.baseline is not None and v1.baseline.rank_k == 10
        assert len(v1.baseline.rank_probes) == 16
        records = _requests(run["valid"])
        for rec in records[:40]:
            status, body = _post(f"{server.url}/score", {"record": rec})
            assert status == 200
        before = np.array(
            _post(f"{server.url}/score", {"records": records[:40]})[1]
            ["scores"], np.float32)
        health = json.loads(urllib.request.urlopen(
            f"{server.url}/healthz").read())
        assert health["quality_baseline"] is True
        assert health["reservoir"] == 80
        assert "canary" not in health
        # a candidate with a negated item table: refused, incumbent intact
        bad = _negated_candidate(run["run"], os.path.join(run["dir"],
                                                          "negated"))
        events = []
        unsubscribe = registry.bus.subscribe(events.append)
        status, body = _post(f"{server.url}/reload", {"model_dir": bad})
        assert status == 409 and "CanaryRejected" in body["error"]
        assert registry.active_version == 1 and registry.versions() == [1]
        after = np.array(
            _post(f"{server.url}/score", {"records": records[:40]})[1]
            ["scores"], np.float32)
        assert np.array_equal(before, after)
        verdicts = [e.payload["verdict"] for e in events
                    if e.name == "canary_evaluated"]
        assert verdicts == ["rejected"]
        # the same model again: active, with divergence 0 annotated
        status, body = _post(f"{server.url}/reload",
                             {"model_dir": run["run"]})
        assert status == 200 and body["version"] == 2
        assert body["canary"]["divergence"] == 0.0
        assert body["canary"]["verdict"] == "pass"
        health = json.loads(urllib.request.urlopen(
            f"{server.url}/healthz").read())
        assert health["canary"]["verdict"] == "pass"
        status, body = _post(f"{server.url}/rank",
                             {"record": records[0], "k": 5})
        assert status == 200 and len(body["ids"]) == 5
        # drift: the served validation records read below the threshold,
        # the same records with one feature shifted above it
        drift = server.drift_evaluator
        assert drift is not None and drift.threshold == 0.25
        for lo in range(0, len(records), 64):
            registry.active().score(records[lo:lo + 64])
        scores = drift.evaluate_once()
        assert scores[(tq.TOTAL_COORDINATE, "psi")] < 0.25
        assert ("perSong", "rank_overlap") in scores
        assert not [e for e in events if e.name == "quality_drift_detected"]
        # the fixed effect's heaviest feature, moved by three score
        # standard deviations' worth
        v2 = registry.active()
        w = v2.model.coordinates["global"].model.coefficients.means.numpy()
        imap = v2.index_maps["global"]
        j = int(np.argmax(np.abs(w) * (np.arange(len(w))
                                       != imap.key_to_index[INTERCEPT_KEY])))
        shift = 3.0 * v2.baseline.std_score / abs(float(w[j]))
        name = imap.names()[j].split(NAME_TERM_DELIMITER)[0]
        shifted = _requests(run["valid"], name, shift)
        v2.engine.monitor = tq.QualityMonitor(v2.baseline)
        v2.score(shifted)
        scores = drift.evaluate_once()
        assert scores[(tq.TOTAL_COORDINATE, "psi")] > 0.25
        fired = [e for e in events if e.name == "quality_drift_detected"]
        assert fired and fired[0].payload["kind"] == "psi"
        unsubscribe()
    finally:
        server.stop()
    assert drift._thread is None
