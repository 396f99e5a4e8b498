"""The port's ``--multihost`` and ``--supervise`` drivers on the CPU.

One 2-rank gloo job runs ``train_glm --multihost`` (L-BFGS and TRON),
``train_game --multihost`` (with ``--telemetry-dir`` and
``--metrics-port``: the fleet fold of the two ranks' registries) and
``score_game --multihost`` on multi-file Avro inputs, and the refusals of
the multi-process paths. Held against
the single-process port and the JAX package's single-process drivers at
the JAX package's multi-process tolerances (coefficients atol 2e-3 / rtol
2e-2, AUC 5e-3, scores equal), with the ranks' models bit-identical.
``train_game --supervise 2`` with one process killed mid-run recovers to
the uninterrupted run's model; the supervisor's budget, stall detection
and flag handling are checked on small commands.

Rank functions live at module level (the ranks import this module by
name); JAX is imported inside the tests only.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.io.avro import read_avro_file
from photon_ml_tpu_torch.testing import run_ranks

TOL = dict(atol=2e-3, rtol=2e-2)
GAME_SHARDS = "global=fixed|intercept,user=user|noIntercept"


def _write_game(path, n, seed, d_fixed=4, d_user=2, n_users=11):
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    prng = np.random.default_rng(99)
    w = prng.normal(size=d_fixed)
    u = 1.5 * prng.normal(size=(n_users, d_user))
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(n, d_fixed))
    xu = rng.normal(size=(n, d_user))
    users = rng.integers(0, n_users, size=n)
    margin = xf @ w + np.einsum("nd,nd->n", xu, u[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(float)
    write_training_examples(path, (
        {"uid": str(i), "response": float(y[i]), "offset": None,
         "weight": None,
         "features": [{"name": f"fixed.x{j}", "term": "",
                       "value": float(xf[i, j])} for j in range(d_fixed)]
         + [{"name": f"user.z{j}", "term": "", "value": float(xu[i, j])}
            for j in range(d_user)],
         "metadataMap": {"userId": f"u{users[i]}"}} for i in range(n)))


def _write_glm(path, n, seed, d=12):
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    w = np.random.default_rng(77).normal(size=d)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ w))).astype(float)
    write_training_examples(path, (
        {"uid": str(i), "response": float(y[i]), "offset": None,
         "weight": None,
         "features": [{"name": f"x{j}", "term": "", "value": float(x[i, j])}
                      for j in range(d) if (i + j) % 5],
         "metadataMap": {}} for i in range(n)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multihost_cli"))
    for d in ("game_train", "game_valid", "glm_train"):
        os.makedirs(os.path.join(root, d))
    for k in range(4):
        _write_game(os.path.join(root, "game_train", f"part-{k}.avro"),
                    120, k)
    for k in range(2):
        _write_game(os.path.join(root, "game_valid", f"part-{k}.avro"),
                    120, 9 + k)
    for k in range(3):
        _write_glm(os.path.join(root, "glm_train", f"part-{k}.avro"),
                   150 + 20 * k, k)
    _write_glm(os.path.join(root, "glm_valid.avro"), 200, 9)
    return root


def _glm_args(root, opt):
    return ["--training-data", os.path.join(root, "glm_train"),
            "--validation-data", os.path.join(root, "glm_valid.avro"),
            "--evaluators", "AUC", "--regularization-weights", "10;1;0.1",
            "--optimizer", opt, "--max-iterations", "60"]


def _game_args(root, sweeps=1):
    return ["--training-data", os.path.join(root, "game_train"),
            "--validation-data", os.path.join(root, "game_valid"),
            "--feature-shards", GAME_SHARDS,
            "--coordinates", "global=fixed,shard=global,reg=L2",
            "perUser=random,entity=userId,shard=user,reg=L2",
            "--update-sequence", "global,perUser", "--grid", "global=0.01",
            "perUser=1", "--evaluators", "AUC",
            "--cd-iterations", str(sweeps)]


def _tuning_args(root):
    args = _game_args(root)
    i = args.index("--grid")
    return args[:i] + args[i + 3:] + ["--tuning", "RANDOM",
                                      "--tuning-iterations", "2",
                                      "--tuning-range", "1e-2:1e2"]


def _score_args(root, model_dir):
    return ["--data", os.path.join(root, "game_valid"),
            "--model-dir", model_dir, "--feature-shards", GAME_SHARDS,
            "--evaluators", "AUC"]


def _capture(module, name, seen):
    """Wrap ``module.name`` so each call's result lands in ``seen``."""
    orig = getattr(module, name)

    def wrapper(*a, **k):
        out = orig(*a, **k)
        seen.append(out)
        return out

    setattr(module, name, wrapper)


def _refusal(fn, argv):
    try:
        fn(argv)
    except SystemExit as e:
        return str(e)
    return None


def _cli_rank(rank, root):
    """Every multi-process driver of the port in one 2-rank job."""
    from photon_ml_tpu_torch.cli import score_game, train_game, train_glm
    from photon_ml_tpu_torch.game import multiprocess

    out = {}
    for opt in ("LBFGS", "TRON"):
        seen = []
        _capture(train_glm, "train_glm_sweep", seen)
        res = train_glm.run(_glm_args(root, opt) + [
            "--output-dir", os.path.join(root, f"mp-glm-{opt}"),
            "--multihost", "--device", "cpu"])
        out[f"glm-{opt}"] = (res, [tm.model.coefficients.means.numpy()
                                   for tm in seen[0]])
    base = _glm_args(root, "LBFGS") + ["--output-dir",
                                       os.path.join(root, "mp-refused"),
                                       "--multihost", "--device", "cpu"]
    out["refused-batched"] = _refusal(train_glm.run,
                                      base + ["--sweep-mode", "batched"])
    out["refused-diagnostics"] = _refusal(
        train_glm.run, base + ["--training-diagnostics"])
    seen = []
    _capture(multiprocess, "train_game_multiprocess", seen)
    game_out = os.path.join(root, "mp-game")
    # the fold hook is installed on every rank; only the chief listens
    from photon_ml_tpu_torch.resilience.supervisor import _free_loopback_port

    port = _free_loopback_port()
    res = train_game.run(_game_args(root) + [
        "--output-dir", game_out, "--multihost", "--device", "cpu",
        "--telemetry-dir", os.path.join(game_out, "telemetry"),
        "--metrics-port", str(port)])
    m = seen[0].model.coordinates
    out["game"] = (res, m["global"].model.coefficients.means.numpy(),
                   m["perUser"].keys, m["perUser"].coeffs)
    # a seeded random search, each point one collective fit
    out["tuned"] = train_game.run(_tuning_args(root) + [
        "--output-dir", os.path.join(root, "mp-tuned"), "--multihost",
        "--device", "cpu"])
    # a warm start from the run above with its fixed effect locked
    seen.clear()
    out["locked-result"] = train_game.run(_game_args(root) + [
        "--output-dir", os.path.join(root, "mp-locked"), "--multihost",
        "--device", "cpu", "--model-input-dir", game_out,
        "--locked-coordinates", "global"])
    m = seen[0].model.coordinates
    out["locked"] = (m["global"].model.coefficients.means.numpy(),
                     m["perUser"].coeffs)
    out["refused-mesh"] = _refusal(train_game.run, _game_args(root) + [
        "--output-dir", os.path.join(root, "mp-mesh"), "--multihost",
        "--mesh", "data=2", "--device", "cpu"])
    out["score"] = score_game.run(
        _score_args(root, game_out)
        + ["--output-dir", os.path.join(root, "mp-score"), "--multihost",
           "--device", "cpu"])
    return out


@pytest.fixture(scope="module")
def ranks(files):
    return run_ranks(_cli_rank, 2, files, timeout_s=240)


@pytest.fixture(scope="module")
def one_process(files):
    """The port's drivers on the same files in one process."""
    from photon_ml_tpu_torch.cli import train_game, train_glm

    out = {}
    for opt in ("LBFGS", "TRON"):
        d = os.path.join(files, f"sp-glm-{opt}")
        out[f"glm-{opt}"] = (train_glm.run(
            _glm_args(files, opt) + ["--output-dir", d, "--device", "cpu"]),
            d)
    d = os.path.join(files, "sp-game")
    out["game"] = (train_game.run(_game_args(files) + [
        "--output-dir", d, "--device", "cpu"]), d)
    return out


def _jax_run(fn, args):
    """A JAX driver in f32, as on its TPU (x64 restored after)."""
    import jax

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return fn(args)
    finally:
        jax.config.update("jax_enable_x64", x64)


def _glm_means(pkg, run_dir, lam):
    if pkg == "torch":
        from photon_ml_tpu_torch.io import model_io
        from photon_ml_tpu_torch.io.index import IndexMap

        imap = IndexMap.load(os.path.join(run_dir, "feature-index.json"))
        return imap, model_io.load_glm_model(
            os.path.join(run_dir, "all", f"lambda-{lam:g}", "model.avro"),
            imap, device="cpu").coefficients.means.numpy()
    from photon_ml_tpu.io import model_io
    from photon_ml_tpu.io.index import IndexMap

    imap = IndexMap.load(os.path.join(run_dir, "feature-index.json"))
    return imap, np.asarray(model_io.load_glm_model(
        os.path.join(run_dir, "all", f"lambda-{lam:g}", "model.avro"),
        imap).coefficients.means)


# --- train_glm --multihost -------------------------------------------------

@pytest.mark.parametrize("opt", ["LBFGS", "TRON"])
def test_train_glm_ranks_agree_bit_for_bit(ranks, opt):
    (res0, w0), (res1, w1) = (r[f"glm-{opt}"] for r in ranks)
    assert res0 == res1
    for a, b in zip(w0, w1):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("opt", ["LBFGS", "TRON"])
def test_train_glm_equals_one_process(ranks, one_process, files, opt):
    res, ws = ranks[0][f"glm-{opt}"]
    sp_res, sp_dir = one_process[f"glm-{opt}"]
    assert res["best_lambda"] == sp_res["best_lambda"]
    assert abs(res["best_evaluation"]["AUC"]
               - sp_res["best_evaluation"]["AUC"]) < 5e-3
    mp_dir = os.path.join(files, f"mp-glm-{opt}")
    for lam, w in zip((10.0, 1.0, 0.1), ws):
        _, sp_w = _glm_means("torch", sp_dir, lam)
        _, saved = _glm_means("torch", mp_dir, lam)
        np.testing.assert_array_equal(saved, w)  # the chief wrote its own
        np.testing.assert_allclose(w, sp_w, **TOL)


def test_train_glm_equals_jax_single_process(ranks, files, tmp_path):
    from photon_ml_tpu.cli import train_glm as j_cli

    j_dir = str(tmp_path / "jax-glm")
    j_res = _jax_run(j_cli.run, _glm_args(files, "LBFGS")
                     + ["--output-dir", j_dir])
    res, _ = ranks[0]["glm-LBFGS"]
    assert res["best_lambda"] == j_res["best_lambda"]
    assert abs(res["best_evaluation"]["AUC"]
               - j_res["best_evaluation"]["AUC"]) < 5e-3
    mp_dir = os.path.join(files, "mp-glm-LBFGS")
    for lam in (10.0, 1.0, 0.1):
        t_map, t_w = _glm_means("torch", mp_dir, lam)
        j_map, j_w = _glm_means("jax", j_dir, lam)
        order = [j_map.key_to_index[k] for k in t_map.names()]
        np.testing.assert_allclose(t_w, j_w[order], **TOL)


def test_train_glm_chief_writes_workers_log(ranks, files):
    d = os.path.join(files, "mp-glm-LBFGS")
    assert os.path.exists(os.path.join(d, "best", "model.avro"))
    assert os.path.exists(os.path.join(d, "workers", "proc-1",
                                       "metrics.jsonl"))
    assert not os.path.exists(os.path.join(d, "workers", "proc-1", "best"))


@pytest.mark.parametrize("key,flag", [
    ("refused-batched", "--sweep-mode batched"),
    ("refused-diagnostics", "--training-diagnostics")])
def test_train_glm_refusals(ranks, key, flag):
    for r in ranks:
        assert r[key].startswith(
            "multi-process --multihost training does not support")
        assert flag in r[key]


# --- train_game --multihost ------------------------------------------------

def test_train_game_ranks_agree_bit_for_bit(ranks):
    a, b = (r["game"] for r in ranks)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


def _coefficient_records(run_dir, pkg="torch"):
    mod = __import__(f"{'photon_ml_tpu_torch' if pkg == 'torch' else 'photon_ml_tpu'}.io.avro",
                     fromlist=["read_avro_file"])
    best = os.path.join(run_dir, "best")
    with open(os.path.join(best, "model-metadata.json")) as f:
        meta = json.load(f)
    out = {}
    for cid, info in meta["coordinates"].items():
        parts = sorted(glob.glob(os.path.join(
            best, info["type"], cid, "coefficients", "part-*.avro")))
        out[cid] = {r["modelId"] + "/" + m["name"] + m["term"]: m["value"]
                    for p in parts for r in mod.read_avro_file(p)
                    for m in r["means"]}
    return out


def _records_close(got, want):
    assert got.keys() == want.keys()
    for cid in want:
        assert got[cid].keys() == want[cid].keys(), cid
        keys = sorted(want[cid])
        np.testing.assert_allclose([got[cid][k] for k in keys],
                                   [want[cid][k] for k in keys],
                                   err_msg=cid, **TOL)


def test_train_game_equals_one_process(ranks, one_process, files):
    res = ranks[0]["game"][0]
    sp_res, sp_dir = one_process["game"]
    assert abs(res["best_evaluation"]["AUC"]
               - sp_res["best_evaluation"]["AUC"]) < 5e-3
    _records_close(_coefficient_records(os.path.join(files, "mp-game")),
                   _coefficient_records(sp_dir))


def test_train_game_equals_jax_single_process(ranks, files, tmp_path):
    from photon_ml_tpu.cli import train_game as j_cli

    j_dir = str(tmp_path / "jax-game")
    j_res = _jax_run(j_cli.run, _game_args(files) + ["--output-dir", j_dir])
    res = ranks[0]["game"][0]
    assert abs(res["best_evaluation"]["AUC"]
               - j_res["best_evaluation"]["AUC"]) < 5e-3
    _records_close(_coefficient_records(os.path.join(files, "mp-game")),
                   _coefficient_records(j_dir, "jax"))


def test_train_game_fleet_fold_equals_both_folds(ranks, files):
    """The chief's ``metrics.aggregate.prom`` (the final collective fold at
    close) is byte for byte the port's and the JAX package's
    ``aggregate_text`` of the two ranks' ``metrics.prom``, and what
    ``tools/metrics_fold.py`` folds offline."""
    from photon_ml_tpu.telemetry.aggregate import aggregate_text as j_fold
    from photon_ml_tpu_torch.telemetry.aggregate import aggregate_text

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import metrics_fold

    tel = os.path.join(files, "mp-game", "telemetry")
    texts = []
    for d in (tel, os.path.join(tel, "workers", "proc-1")):
        with open(os.path.join(d, "metrics.prom")) as f:
            texts.append(f.read())
    with open(os.path.join(tel, "metrics.aggregate.prom")) as f:
        live = f.read()
    assert live == aggregate_text(texts) == j_fold(texts)
    offline = metrics_fold.fold_metrics(tel, os.path.join(
        tel, "offline.prom"))
    with open(offline) as f:
        assert f.read() == live
    # each rank's build info and its own RSS series, both in the fold
    assert 'process="1"' in texts[1]
    assert live.count("photon_build_info{") == 2
    assert not os.path.exists(os.path.join(tel, "workers", "proc-1",
                                           "metrics.aggregate.prom"))


def test_train_game_merged_trace_nests(ranks, files):
    """``trace.merged.jsonl`` (tools/metrics_fold.py over the ranks'
    traces) is the port's ``merge_trace_files`` of them; each rank's spans
    have one ``train_game`` root and nest inside their parents."""
    from photon_ml_tpu_torch.telemetry.aggregate import merge_trace_files

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import metrics_fold

    tel = os.path.join(files, "mp-game", "telemetry")
    path = metrics_fold.fold_traces(tel)
    with open(path) as f:
        merged = [json.loads(line) for line in f]
    assert merged == merge_trace_files(
        [(0, os.path.join(tel, "trace.jsonl")),
         (1, os.path.join(tel, "workers", "proc-1", "trace.jsonl"))])
    spans = [r for r in merged if "t0" in r]
    by_key = {(s["process"], s["span_id"]): s for s in spans}
    for pid in (0, 1):
        roots = [s["name"] for s in spans
                 if s["process"] == pid and s["parent_id"] is None]
        assert roots == ["train_game"], (pid, roots)
    for s in spans:
        parent = by_key.get((s["process"], s["parent_id"]))
        if parent is not None:
            assert parent["t0"] <= s["t0"] and s["t1"] <= parent["t1"]
    stages = [{s["name"] for s in spans
               if s["process"] == pid and s.get("kind") == "stage"}
              for pid in (0, 1)]
    assert "Train (grid, multi-process)" in stages[0] & stages[1]


def test_train_game_chief_outputs(ranks, files):
    d = os.path.join(files, "mp-game")
    assert os.path.exists(os.path.join(d, "best", "model-metadata.json"))
    assert os.path.exists(os.path.join(d, "quality-baseline.json"))
    assert os.path.isdir(os.path.join(d, "workers", "proc-1"))
    assert not os.path.exists(os.path.join(d, "workers", "proc-1", "best"))
    with open(os.path.join(d, "best", "model-metadata.json")) as f:
        assert json.load(f)["dataManifest"] is None  # no partial manifest


def test_train_game_tuning_equals_one_process(ranks, files):
    from photon_ml_tpu_torch.cli import train_game

    one = train_game.run(_tuning_args(files) + [
        "--output-dir", os.path.join(files, "sp-tuned"), "--device", "cpu"])
    a, b = (r["tuned"] for r in ranks)
    assert a == b and a["n_configurations"] == 2
    assert a["best_config"] == one["best_config"]
    assert abs(a["best_evaluation"]["AUC"]
               - one["best_evaluation"]["AUC"]) < 5e-3


def test_train_game_locked_warm_start(ranks):
    (w0, c0), (w1, c1) = (r["locked"] for r in ranks)
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_array_equal(c0, c1)
    # the locked fixed effect is the input model's
    np.testing.assert_array_equal(w0, ranks[0]["game"][1])
    assert ranks[0]["locked-result"] == ranks[1]["locked-result"]


def test_train_game_refuses_mesh_beside_multihost(ranks):
    for r in ranks:
        assert "does not take --mesh" in r["refused-mesh"]


# --- score_game --multihost ------------------------------------------------

def _scores(path_glob):
    return [r["predictionScore"] for p in sorted(glob.glob(path_glob))
            for r in read_avro_file(p)]


def test_score_game_parts_equal_one_process(ranks, files):
    """The parts, in process order, are the one-process ``scores.avro`` of
    the same model, row for row, and the evaluations are equal."""
    from photon_ml_tpu_torch.cli import score_game

    out = os.path.join(files, "sp-score")
    res = score_game.run(_score_args(files, os.path.join(files, "mp-game"))
                         + ["--output-dir", out, "--device", "cpu"])
    for r in ranks:
        assert r["score"]["n_scored"] == res["n_scored"] == 240
        assert r["score"]["evaluation"] == res["evaluation"]
    mp = _scores(os.path.join(files, "mp-score", "scores-part-*.avro"))
    assert mp == _scores(os.path.join(out, "scores.avro"))


def test_score_game_parts_equal_jax_single_process(ranks, files, tmp_path):
    from photon_ml_tpu.cli import score_game as j_score

    out = str(tmp_path / "jax-score")
    j_res = j_score.run(_score_args(files, os.path.join(files, "mp-game"))
                        + ["--output-dir", out])
    assert abs(ranks[0]["score"]["evaluation"]["AUC"]
               - j_res["evaluation"]["AUC"]) < 1e-6
    np.testing.assert_allclose(
        _scores(os.path.join(files, "mp-score", "scores-part-*.avro")),
        _scores(os.path.join(out, "scores.avro")), rtol=1e-6, atol=1e-6)


# --- the supervisor ----------------------------------------------------------

def _best_records(out_dir):
    best = os.path.join(out_dir, "best")
    with open(os.path.join(best, "model-metadata.json")) as f:
        meta = json.load(f)
    return {cid: [r for p in sorted(glob.glob(os.path.join(
        best, info["type"], cid, "coefficients", "part-*.avro")))
        for r in read_avro_file(p)]
        for cid, info in meta["coordinates"].items()}


def test_supervised_kill_recovers_the_uninterrupted_model(files, tmp_path,
                                                          monkeypatch):
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.events import GLOBAL_BUS

    argv = _game_args(files, sweeps=2) + ["--device", "cpu",
                                           "--supervise", "2",
                                           "--max-restarts", "2"]
    monkeypatch.delenv("PHOTON_FAULT_PLAN", raising=False)
    clean = train_game.run(argv + ["--output-dir", str(tmp_path / "clean")])
    assert clean["restarts"] == 0
    # process 1 dies at the start of sweep 1, on the first launch only
    monkeypatch.setenv("PHOTON_FAULT_PLAN", json.dumps({
        "seed": 0, "specs": [{"site": "worker.stall", "at": [1],
                              "mode": "kill", "processes": [1],
                              "attempts": [0]}]}))
    restarts = []
    unsub = GLOBAL_BUS.subscribe(
        lambda e: restarts.append(e.payload)
        if e.name == "supervisor_restart" else None)
    try:
        killed = train_game.run(argv + ["--output-dir",
                                        str(tmp_path / "kill")])
    finally:
        unsub()
    assert killed["restarts"] >= 1 and len(restarts) == killed["restarts"]
    assert killed["best_evaluation"] == clean["best_evaluation"]
    assert _best_records(str(tmp_path / "kill")) == \
        _best_records(str(tmp_path / "clean"))
    logs = glob.glob(str(tmp_path / "kill" / "supervisor" / "attempt-1" /
                         "proc-*.log"))
    assert len(logs) == 2


def test_supervised_train_glm_equals_multihost(ranks, files, tmp_path,
                                               monkeypatch):
    """``train_glm --supervise 2``: the supervisor's two ranks give the
    result of the 2-rank job (the sweep is deterministic)."""
    from photon_ml_tpu_torch.cli import train_glm

    monkeypatch.delenv("PHOTON_FAULT_PLAN", raising=False)
    out = str(tmp_path / "supervised-glm")
    res = train_glm.run(_glm_args(files, "LBFGS") + [
        "--output-dir", out, "--device", "cpu", "--supervise", "2"])
    assert res["restarts"] == 0
    want = ranks[0]["glm-LBFGS"][0]
    assert res["best_lambda"] == want["best_lambda"]
    assert res["best_evaluation"] == want["best_evaluation"]
    for lam in (10.0, 1.0, 0.1):
        np.testing.assert_array_equal(
            _glm_means("torch", out, lam)[1],
            _glm_means("torch", os.path.join(files, "mp-glm-LBFGS"),
                       lam)[1])


def test_supervisor_budget_and_stall(tmp_path):
    from photon_ml_tpu_torch.resilience.supervisor import (
        FleetExhaustedError,
        FleetSupervisor,
        SupervisorPolicy,
    )

    fail = [sys.executable, "-c", "import sys; sys.exit(3)"]
    sup = FleetSupervisor(fail, 2, str(tmp_path / "fail"), SupervisorPolicy(
        max_restarts=1, base_backoff_s=0.01, heartbeat_timeout_s=None))
    with pytest.raises(FleetExhaustedError, match="rc=3"):
        sup.run()
    assert sup.restarts == 1
    stall = [sys.executable, "-c", "import time; time.sleep(60)"]
    sup = FleetSupervisor(stall, 1, str(tmp_path / "stall"), SupervisorPolicy(
        max_restarts=0, heartbeat_timeout_s=1.0, grace_s=1.0))
    with pytest.raises(FleetExhaustedError, match="stall on process 0"):
        sup.run()
    ok = [sys.executable, "-c", "import os, json; json.dump({'a': 1}, "
          "open(os.environ['PHOTON_RESULT_FILE'], 'w')) if "
          "os.environ['PHOTON_PROCESS_ID'] == '0' else None"]
    result = FleetSupervisor(ok, 2, str(tmp_path / "ok")).run()
    assert (result.restarts, result.attempts, result.result) == (
        0, 1, {"a": 1})


def test_supervision_flags_are_stripped_and_checked():
    from photon_ml_tpu_torch.cli import train_game
    from photon_ml_tpu_torch.resilience.supervisor import (
        SupervisorPolicy,
        strip_supervision_flags,
    )

    assert strip_supervision_flags(
        ["--a", "1", "--supervise", "2", "--max-restarts=3",
         "--heartbeat-timeout-s", "5", "--restart-deadline-s", "9",
         "--b"]) == ["--a", "1", "--b"]
    with pytest.raises(ValueError, match="max_restarts"):
        SupervisorPolicy(max_restarts=-1)
    with pytest.raises(SystemExit, match="single-config grid"):
        train_game.run(["--training-data", "x", "--output-dir", "o",
                        "--feature-shards", "g=g", "--coordinates",
                        "g=fixed,shard=g", "--update-sequence", "g",
                        "--supervise", "2", "--grid", "g=1;2"])
    assert torch.cuda.is_available() is False
