"""The port's ``train_game`` CLI against the JAX package's: the bench's
end-to-end GLMix arguments (``bench.py::bench_end_to_end``: a fixed effect
and per-user, per-song random effects over a bench-shaped Avro file, L2,
L-BFGS, histogram buckets) through both packages' commands, the port on the CPU, in
f32 and bf16 designs. The same best configuration and validation AUC, model
directories that load and score alike in the other package, and the same
output file tree. Also the config DSL, the flags the port refuses, the
device default and the module runner."""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import train_game as j_cli
from photon_ml_tpu.evaluation import parse_evaluators as j_evaluators
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.data_reader import FeatureShardConfig as JShard
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu.io.index import IndexMap as JIndexMap
from photon_ml_tpu_torch.__main__ import main as t_main
from photon_ml_tpu_torch.cli import train_game as t_cli
from photon_ml_tpu_torch.cli.config import (
    parse_coordinate_config,
    parse_feature_shard_config,
    parse_grid,
)
from photon_ml_tpu_torch.evaluation import parse_evaluators as t_evaluators
from photon_ml_tpu_torch.io import model_io as tio
from photon_ml_tpu_torch.io.data_reader import AvroDataReader as TReader
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfig as TShard
from photon_ml_tpu_torch.io.index import IndexMap as TIndexMap


def _write_bench_file(path, n, seed, users=60, songs=30):
    """``bench.py::_write_e2e_file`` at a small size: 6 of 32 global
    features, 4 of 8 item features, user and song ids, labels from planted
    fixed, per-user and per-song effects."""
    prm = np.random.default_rng(99)
    d_fixed, d_item = 32, 8
    w_fixed = prm.normal(size=d_fixed)
    uu = prm.normal(size=(users, d_item))
    us = 0.7 * prm.normal(size=(songs, d_item))
    rng = np.random.default_rng(seed)
    user = rng.integers(0, users, n)
    song = rng.integers(0, songs, n)
    fi = rng.random((n, d_fixed)).argsort(axis=1)[:, :6]
    fv = rng.normal(size=(n, 6))
    ii = rng.random((n, d_item)).argsort(axis=1)[:, :4]
    iv = rng.normal(size=(n, 4))
    margin = ((w_fixed[fi] * fv).sum(1) / np.sqrt(6)
              + (np.take_along_axis(uu[user], ii, 1) * iv).sum(1)
              + (np.take_along_axis(us[song], ii, 1) * iv).sum(1))
    label = rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))
    write_training_examples(path, (
        {"uid": str(j), "response": float(label[j]), "offset": None,
         "weight": None,
         "features": ([{"name": f"g.x{k}", "term": "", "value": float(v)}
                       for k, v in zip(fi[j], fv[j])]
                      + [{"name": f"it.x{k}", "term": "", "value": float(v)}
                         for k, v in zip(ii[j], iv[j])]),
         "metadataMap": {"userId": f"u{user[j]}", "songId": f"s{song[j]}"}}
        for j in range(n)), codec="null")
    return path


SHARDS = "global=g|intercept,item=it|noIntercept"


def _bench_args(train, valid, dtype):
    """bench.py:1191-1209, with a validation file and the AUC evaluator."""
    return [
        "--training-data", train, "--validation-data", valid,
        "--feature-shards", SHARDS,
        "--coordinates",
        "global=fixed,shard=global,reg=L2,maxIter=25",
        ("perUser=random,entity=userId,shard=item,reg=L2,maxIter=25,"
         "buckets=histogram,maxSampleBuckets=4"),
        ("perSong=random,entity=songId,shard=item,reg=L2,maxIter=25,"
         "buckets=histogram,maxSampleBuckets=4"),
        "--update-sequence", "global,perUser,perSong",
        "--cd-iterations", "1",
        "--grid", "global=0.001", "perUser=1", "perSong=1",
        "--data-validation", "VALIDATE_DISABLED",
        "--design-dtype", dtype, "--evaluators", "AUC"]


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_data")
    return (_write_bench_file(str(d / "train.avro"), 2000, 1),
            _write_bench_file(str(d / "valid.avro"), 1000, 2))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def runs(request, data_files, tmp_path_factory):
    """One run of each package's command: (dtype, port result, port dir, JAX result,
    JAX dir)."""
    dtype = request.param
    d = tmp_path_factory.mktemp(f"cli_{dtype}")
    args = _bench_args(*data_files, dtype)
    t_dir, j_dir = str(d / "port"), str(d / "jax")
    t_res = t_cli.run(args + ["--output-dir", t_dir, "--device", "cpu"])
    j_res = j_cli.run(args + ["--output-dir", j_dir])
    return dtype, t_res, t_dir, j_res, j_dir


def test_best_config_and_auc_match(runs):
    _, t_res, t_dir, j_res, _ = runs
    assert t_res["best_config"] == j_res["best_config"] == {
        "global": 0.001, "perUser": 1.0, "perSong": 1.0}
    assert t_res["n_configurations"] == j_res["n_configurations"] == 1
    assert t_res["output_dir"] == t_dir
    ta, ja = t_res["best_evaluation"]["AUC"], j_res["best_evaluation"]["AUC"]
    assert ta > 0.75
    # tests/test_torch_game.py's AUC limit for the same fit, f32 and bf16
    assert abs(ta - ja) < 1e-4, (ta, ja)


def _score(pkg, run_dir, valid):
    """AUC of ``run_dir``'s best model on ``valid``, loaded and scored by
    ``pkg`` with the run's index maps and the validation file's own
    vocabularies."""
    if pkg == "torch":
        imap, shard, reader, io, evs = (TIndexMap, TShard, TReader, tio,
                                        t_evaluators)
    else:
        imap, shard, reader, io, evs = (JIndexMap, JShard, JReader, jio,
                                        j_evaluators)
    maps = {s: imap.load(os.path.join(run_dir, "feature-indexes",
                                      f"{s}.json"))
            for s in ("global", "item")}
    shards = tuple(parse_feature_shard_config(s) for s in SHARDS.split(","))
    data, _, vocabs = reader(
        shard_configs=tuple(shard(c.shard_id, c.feature_bags,
                                  c.has_intercept) for c in shards),
        index_maps=maps).read(valid, id_columns=("songId", "userId"))
    model_dir = io.resolve_game_model_dir(run_dir)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    model = io.load_game_model(model_dir, maps, vocabs, **kw)
    scores = np.asarray(model.score(data))
    return scores, evs(["AUC"])[0].evaluate(scores, data.labels)


@pytest.mark.parametrize("trained_by", ["port", "jax"])
def test_best_model_cross_loads(runs, data_files, trained_by):
    _, t_res, t_dir, j_res, j_dir = runs
    run_dir, res = (t_dir, t_res) if trained_by == "port" else (j_dir, j_res)
    t_scores, t_auc = _score("torch", run_dir, data_files[1])
    j_scores, j_auc = _score("jax", run_dir, data_files[1])
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-6, atol=1e-6)
    assert abs(t_auc - j_auc) < 1e-6
    # the reloaded model scores the validation file as the run did
    assert abs(t_auc - res["best_evaluation"]["AUC"]) < 1e-6


#: run-root artefacts of the JAX package's train_game that the port does not
#: write yet (none since the port writes quality-baseline.json)
NOT_WRITTEN: set = set()


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_output_tree_matches(runs):
    _, _, t_dir, _, j_dir = runs
    assert _tree(t_dir) == [p for p in _tree(j_dir) if p not in NOT_WRITTEN]
    for p in [os.path.join("feature-indexes", f"{shard}.json")
              for shard in ("global", "item")] + ["data-manifest.json"]:
        with open(os.path.join(t_dir, p), "rb") as a, \
                open(os.path.join(j_dir, p), "rb") as b:
            assert a.read() == b.read()
    meta = {}
    for name, root in (("port", t_dir), ("jax", j_dir)):
        with open(os.path.join(root, "best", "model-metadata.json")) as f:
            meta[name] = json.load(f)
        assert meta[name].pop("trainedAt")
    # the same Avro gives the same manifest and digest in both packages
    assert meta["port"]["dataManifest"] is not None
    assert meta["port"] == meta["jax"]
    with open(os.path.join(t_dir, "metrics.jsonl")) as f:
        stages = [json.loads(line)["stage"] for line in f]
    assert stages == ["Read training data", "Build data manifest",
                      "Validate data",
                      "Read validation data", "Train (grid)", "best",
                      "Save models"]


#: the baseline's label statistics (AUC, positive rate, bin masses), held
#: as the runs' AUCs are (absolute, floor 1)
BASELINE_TOL = 1e-4
#: its chi-square and p-value, functions of the per-bin sums (relative)
CHI_RTOL = 1e-2


def _margins(run_dir, valid, shards=SHARDS, ids=("songId", "userId")):
    """Per-coordinate margins and total scores of ``run_dir``'s best model
    on ``valid``, loaded by the port."""
    configs = tuple(parse_feature_shard_config(s) for s in shards.split(","))
    maps = {c.shard_id: TIndexMap.load(os.path.join(
        run_dir, "feature-indexes", f"{c.shard_id}.json")) for c in configs}
    data, _, vocabs = TReader(shard_configs=configs, index_maps=maps).read(
        valid, id_columns=ids)
    model = tio.load_game_model(tio.resolve_game_model_dir(run_dir), maps,
                                vocabs, device="cpu")
    out = {cid: np.asarray(m, np.float64)
           for cid, m in model.score_by_coordinate(data).items()}
    out["total"] = np.asarray(model.score(data), np.float64)
    return out


def assert_baselines_close(t_dir, j_dir, t_margins, j_margins, n):
    """The two runs' quality-baseline.json: the same keys and lineage (but
    the training time); the label statistics at the AUC tolerance; the
    score statistics within what the two fits' scores differ by
    (quantiles, means and standard deviations move by at most the largest
    score difference, a bin's expected positives by its count times a
    quarter of it)."""
    from photon_ml_tpu_torch.quality import BASELINE_NAME

    docs = {}
    for name, root in (("port", t_dir), ("jax", j_dir)):
        with open(os.path.join(root, BASELINE_NAME)) as f:
            docs[name] = json.load(f)
        assert docs[name]["lineage"].pop("trainedAt")
    t, j = docs["port"], docs["jax"]
    assert t.keys() == j.keys()
    for key in ("task", "nSamples", "coldRates", "coverage", "lineage",
                "rankProbes"):
        assert t[key] == j[key], key
    assert t["nSamples"] == n and t["rankProbes"] is None
    delta = {cid: float(np.abs(t_margins[cid] - j_margins[cid]).max())
             + 1e-6 for cid in t_margins}

    def close(a, b, tol):
        assert abs(a - b) <= tol, (a, b, tol)

    close(t["positiveRate"], j["positiveRate"], BASELINE_TOL)
    if j["auc"] is not None:
        close(t["auc"], j["auc"], BASELINE_TOL)
    for a, b in zip(t["scoreBins"]["proportions"],
                    j["scoreBins"]["proportions"]):
        close(a, b, BASELINE_TOL)
    assert len(t["scoreBins"]["edges"]) == len(j["scoreBins"]["edges"])
    for a, b in zip(t["scoreBins"]["edges"], j["scoreBins"]["edges"]):
        close(a, b, delta["total"])
    for key in ("meanScore", "stdScore"):
        close(t[key], j[key], delta["total"])
    assert t["coordinates"].keys() == j["coordinates"].keys()
    for cid, stats in t["coordinates"].items():
        for key, v in stats.items():
            close(v, j["coordinates"][cid][key], delta[cid])
    tc, jc = t["calibration"], j["calibration"]
    assert tc["binCounts"] == jc["binCounts"]
    assert tc["observedPositives"] == jc["observedPositives"]
    for count, a, b in zip(tc["binCounts"], tc["expectedPositives"],
                           jc["expectedPositives"]):
        close(a, b, count * delta["total"] / 4)
    for a, b in zip(tc["meanPredicted"], jc["meanPredicted"]):
        close(a, b, delta["total"] / 4)
    for key in ("chiSquare", "pValue"):
        close(tc[key], jc[key], CHI_RTOL * abs(jc[key]))


def assert_baselines_cross_load(t_dir, j_dir, shards):
    """Each package's registry finds and reads the other's baseline."""
    from photon_ml_tpu.quality import load_baseline as j_load
    from photon_ml_tpu.serving import ModelRegistry as JRegistry
    from photon_ml_tpu_torch.quality import BASELINE_NAME
    from photon_ml_tpu_torch.quality import load_baseline as t_load
    from photon_ml_tpu_torch.serving import ModelRegistry as TRegistry

    configs = tuple(parse_feature_shard_config(s) for s in shards.split(","))
    t_sm = TRegistry(configs, device="cpu").load(j_dir)
    j_sm = JRegistry(tuple(JShard(c.shard_id, c.feature_bags,
                                  c.has_intercept) for c in configs)).load(
        t_dir)
    assert t_sm.baseline.to_dict() == t_load(
        os.path.join(j_dir, BASELINE_NAME)).to_dict()
    assert j_sm.baseline.to_dict() == j_load(
        os.path.join(t_dir, BASELINE_NAME)).to_dict()
    assert t_sm.engine.monitor.baseline is t_sm.baseline


def test_quality_baseline_matches_and_cross_loads(runs, data_files):
    """quality-baseline.json of both packages' train_game on the
    validation file (:func:`assert_baselines_close`), read across."""
    _, _, t_dir, _, j_dir = runs
    assert_baselines_close(t_dir, j_dir, _margins(t_dir, data_files[1]),
                           _margins(j_dir, data_files[1]), 1000)
    assert_baselines_cross_load(t_dir, j_dir, SHARDS)


def test_build_index_matches_jax(data_files, tmp_path):
    """Both packages' build_index on one Avro write the same bytes."""
    from photon_ml_tpu.cli import build_index as j_build
    from photon_ml_tpu_torch.cli import build_index as t_build

    args = ["--data", data_files[0], "--feature-shards", SHARDS]
    t_res = t_build.run(args + ["--output-dir", str(tmp_path / "t")])
    j_res = j_build.run(args + ["--output-dir", str(tmp_path / "j")])
    assert t_res["sizes"] == j_res["sizes"] == {"global": 33, "item": 8}
    for shard in ("global", "item"):
        with open(tmp_path / "t" / f"{shard}.json", "rb") as a, \
                open(tmp_path / "j" / f"{shard}.json", "rb") as b:
            assert a.read() == b.read()
    assert t_main(["build_index"] + args
                  + ["--output-dir", str(tmp_path / "m")]) is None
    assert sorted(os.listdir(tmp_path / "m")) == sorted(
        os.listdir(tmp_path / "j"))


def test_output_all_models_publishes_best(data_files, tmp_path):
    out = str(tmp_path / "all")
    args = _bench_args(*data_files, "float32")
    grid = args.index("--grid")
    args[grid + 1:grid + 4] = ["global=1000;0.001", "perUser=1",
                               "perSong=1"]
    res = t_cli.run(args + ["--output-dir", out, "--device", "cpu",
                            "--output-all-models"])
    assert res["n_configurations"] == 2
    assert res["best_config"]["global"] == 0.001
    assert sorted(os.listdir(os.path.join(out, "all"))) == ["config-0",
                                                            "config-1"]
    with open(os.path.join(out, "best", "model-metadata.json")) as f:
        best = json.load(f)
    with open(os.path.join(out, "all", "config-1",
                           "model-metadata.json")) as f:
        src = json.load(f)
    assert best.pop("aliasOf") == os.path.join("all", "config-1")
    assert best == src
    assert _tree(os.path.join(out, "best")) == \
        _tree(os.path.join(out, "all", "config-1"))
    _, auc = _score("jax", out, data_files[1])
    assert abs(auc - res["best_evaluation"]["AUC"]) < 1e-6


def test_part_files_train_the_one_file_model(data_files, tmp_path):
    """The training rows split into contiguous part files (a directory,
    read in name order) give the one file's model: the same files, the
    same Avro records (each Avro file has its own random sync marker) and
    metadata but for the training time and the input files' manifest."""
    from photon_ml_tpu_torch.io.avro import iter_avro_file
    from photon_ml_tpu_torch.io.data_reader import (
        write_training_examples as t_write,
    )

    records = list(iter_avro_file(data_files[0]))
    parts = tmp_path / "parts"
    parts.mkdir()
    cuts = np.linspace(0, len(records), 4).astype(int)
    for k, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        t_write(str(parts / f"part-{k:05d}.avro"), records[lo:hi],
                codec="null")
    best = {}
    for name, train in (("one", data_files[0]), ("parts", str(parts))):
        out = str(tmp_path / name)
        t_cli.run(_bench_args(train, data_files[1], "bfloat16")
                  + ["--output-dir", out, "--device", "cpu"])
        root = os.path.join(out, "best")
        best[name] = {rel: list(iter_avro_file(os.path.join(root, rel)))
                      for rel in _tree(root) if rel.endswith(".avro")}
        with open(os.path.join(root, "model-metadata.json")) as f:
            meta = json.load(f)
        assert meta.pop("trainedAt") and meta.pop("dataManifest")
        best[name]["model-metadata.json"] = meta
    assert sorted(best["one"]) == _tree(root)
    assert best["parts"] == best["one"]


_REQUIRED = ["--training-data", "x.avro", "--output-dir", "out",
             "--feature-shards", "global=g", "--coordinates",
             "global=fixed,shard=global", "--update-sequence", "global"]


#: the multi-process and supervision flags, which run (see
#: tests/test_torch_multihost_cli.py)
_MULTI_PROCESS_FLAGS = ("--multihost", "--supervise", "--max-restarts",
                        "--heartbeat-timeout-s", "--restart-deadline-s")
#: the telemetry plane's flags, ported (tests/test_torch_telemetry.py runs
#: them): they parse
_TELEMETRY_FLAGS = ("--profile", "--debug-nans", "--telemetry-dir",
                    "--telemetry-poll-s", "--metrics-port")


@pytest.mark.parametrize("extra", [
    ["--tuning", "RANDOM"], ["--tuning", "BAYESIAN"],
    ["--tuning-iterations", "5"], ["--tuning-range", "1:10"],
    ["--multihost"],
    ["--supervise", "2"], ["--max-restarts", "1"],
    ["--heartbeat-timeout-s", "5"], ["--restart-deadline-s", "5"],
    ["--profile"], ["--debug-nans"], ["--telemetry-dir", "t"],
    ["--telemetry-poll-s", "1"], ["--metrics-port", "9"],
], ids=lambda e: e[0][2:] + ("-" + e[1] if e[0] == "--tuning" else ""))
def test_unported_flag_names_itself(tmp_path, extra):
    if extra[0].startswith("--tuning"):
        # the tuning flags are ported: a search needs the validation data
        # it selects on, which these arguments lack
        tuning = extra if extra[0] == "--tuning" else (
            ["--tuning", "RANDOM"] + extra)
        with pytest.raises(SystemExit, match="--tuning needs"):
            t_cli.run(_REQUIRED + tuning + ["--device", "cpu",
                                            "--output-dir", str(tmp_path)])
        return
    if extra[0] in _MULTI_PROCESS_FLAGS + _TELEMETRY_FLAGS:
        # ported (tests/test_torch_multihost_cli.py and
        # tests/test_torch_telemetry.py run them): they parse
        args = t_cli.build_parser().parse_args(_REQUIRED + extra)
        dest = extra[0][2:].replace("-", "_")
        assert getattr(args, dest) == (
            True if len(extra) == 1 else type(getattr(args, dest))(extra[1]))
        return
    with pytest.raises(NotImplementedError, match=extra[0]):
        t_cli.run(_REQUIRED + extra)


@pytest.mark.parametrize("spec,match", [
    ("u=factored,entity=userId,shard=item", "factored"),
    ("g=fixed,shard=global,downsample=0.5", "downsample"),
    ("u=random,entity=userId,shard=item,projector=RANDOM,projectedDim=2",
     "projector=RANDOM"),
])
def test_unported_coordinate_options_name_themselves(spec, match):
    """The options these specs name are ported: each parses into the
    configuration the JAX package's parser gives."""
    from photon_ml_tpu.cli.config import parse_coordinate_config as j_parse

    cid, cfg = parse_coordinate_config(spec)
    j_cid, j_cfg = j_parse(spec)
    assert cid == j_cid
    assert type(cfg).__name__ == type(j_cfg).__name__
    if match == "downsample":
        assert cfg.downsampler.rate == j_cfg.downsampler.rate == 0.5
        assert type(cfg.downsampler).__name__ == \
            type(j_cfg.downsampler).__name__
    else:
        assert cfg.dataset.projector_type.value == "RANDOM"
        assert cfg.dataset.projected_dim == j_cfg.dataset.projected_dim


def test_feature_shard_specs():
    cfg = parse_feature_shard_config("global=fixed+ctx|noIntercept")
    assert cfg.shard_id == "global"
    assert cfg.feature_bags == ("fixed", "ctx")
    assert not cfg.has_intercept
    assert parse_feature_shard_config("all=*").feature_bags is None
    with pytest.raises(ValueError):
        parse_feature_shard_config("bad")
    with pytest.raises(ValueError):
        parse_feature_shard_config("a=b|what")


def test_coordinate_specs():
    cid, cfg = parse_coordinate_config(
        "global=fixed,shard=g,reg=L2,optimizer=TRON,maxIter=40")
    assert cid == "global"
    assert cfg.feature_shard_id == "g"
    assert cfg.optimization.optimizer.value == "TRON"
    assert cfg.optimization.optimizer_config.max_iterations == 40
    cid, cfg = parse_coordinate_config(
        "perU=random,entity=userId,shard=u,reg=ELASTIC_NET,alpha=0.7,"
        "activeUpper=100,maxFeatures=50")
    assert cfg.dataset.random_effect_type == "userId"
    assert cfg.dataset.active_data_upper_bound == 100
    assert cfg.dataset.max_active_features == 50
    assert cfg.optimization.regularization.alpha == 0.7
    cid, cfg = parse_coordinate_config(
        "perU=random,entity=userId,shard=u,buckets=histogram,"
        "maxSampleBuckets=5")
    assert cfg.dataset.bucket_strategy == "histogram"
    assert cfg.dataset.max_sample_buckets == 5
    with pytest.raises(ValueError):
        parse_coordinate_config("perU=random,entity=u,shard=u,buckets=bogus")
    with pytest.raises(ValueError):
        parse_coordinate_config("x=fixed,shard=g,bogus=1")


def test_coordinate_specs_match_jax():
    from photon_ml_tpu.cli.config import (
        parse_coordinate_config as j_parse_coordinate_config,
    )

    for spec in _bench_args("t", "v", "float32")[7:10]:
        (tc, tcfg), (jc, jcfg) = (parse_coordinate_config(spec),
                                  j_parse_coordinate_config(spec))
        assert tc == jc
        t_opt, j_opt = tcfg.optimization, jcfg.optimization
        assert t_opt.optimizer.value == j_opt.optimizer.value
        assert t_opt.regularization.reg_type.value == \
            j_opt.regularization.reg_type.value
        assert t_opt.optimizer_config.max_iterations == \
            j_opt.optimizer_config.max_iterations
        if hasattr(jcfg, "dataset"):
            for f in ("random_effect_type", "feature_shard_id",
                      "bucket_strategy", "max_sample_buckets",
                      "max_feature_buckets", "active_data_lower_bound"):
                assert getattr(tcfg.dataset, f) == getattr(jcfg.dataset, f)


def test_grid():
    assert parse_grid(["a=1;10", "b=0.5"]) == [{"a": 1.0, "b": 0.5},
                                               {"a": 10.0, "b": 0.5}]
    assert parse_grid([]) == [{}]


def test_defaults_to_cuda_without_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.run(_REQUIRED[:2] + ["--output-dir", out] + _REQUIRED[4:])
    assert not os.path.exists(out)


def test_module_runner(capsys):
    with pytest.raises(SystemExit) as e:
        t_main([])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        t_main(["--help"])
    assert e.value.code == 0
    assert "train_game" in capsys.readouterr().out
