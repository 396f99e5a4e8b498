"""The port's background I/O (``photon_ml_tpu_torch/io/pipeline.py``)
against the JAX package's, on the CPU at tiny sizes.

- **Parity**: the same GAME model saved through both packages'
  ``BackgroundSaver`` gives the same ``model-metadata.json`` bytes, the
  same part-file records and the same lineage id; the port's background
  save is byte-identical to its synchronous save (sync marker pinned,
  pure-Python writer).
- **Crash-safe publication**: an ``io.model_save`` fault at visit 0
  retries and publishes the complete new model, in both packages alike; a
  fault at every visit fails the join and leaves the previous tree byte for
  byte, with no ``.tmp`` left.
- **Aliases**: ``publish_model_alias`` hardlinks the files and writes the
  JAX package's ``aliasOf``.
- **The saver and the background read**: ``join`` propagates the first
  error, submitted spans parent under the caller's span, a background read
  delivers its result or its exception at the join.
- **The repair**: the port's ``train_game`` under a fault plan on
  ``io.model_save`` at visit 0 fires the fault, publishes a loadable
  ``best/`` equal record for record to a run without the fault, and leaves
  no ``.tmp``; under ``--output-all-models`` the alias publish is the
  faulted one.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.game.model as jm
import photon_ml_tpu.io.model_io as jio
import photon_ml_tpu.io.pipeline as jpipe
import photon_ml_tpu_torch.game.model as tm
import photon_ml_tpu_torch.io.model_io as tio
import photon_ml_tpu_torch.io.pipeline as tpipe
from photon_ml_tpu.io.avro import read_avro_file
from photon_ml_tpu.io.index import build_index_map as j_index_map
from photon_ml_tpu.models.coefficients import Coefficients as JCoefficients
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_ml_tpu.resilience import FaultPlan as JFaultPlan
from photon_ml_tpu.resilience import FaultSpec as JFaultSpec
from photon_ml_tpu.resilience import injected as j_injected
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import feature_key
from photon_ml_tpu_torch import native as tnative
from photon_ml_tpu_torch.io.index import build_index_map as t_index_map
from photon_ml_tpu_torch.models.coefficients import Coefficients as TCoefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel as TGLM
from photon_ml_tpu_torch.resilience import FaultPlan, FaultSpec, injected
from photon_ml_tpu_torch.resilience.faults import InjectedFault
from photon_ml_tpu_torch.types import TaskType as TTask

sys.path.insert(0, os.path.dirname(__file__))

from test_cli import COORDS, SHARDS, make_avro_dataset  # noqa: E402

D_FIXED, DIM, N_ENTITIES = 5, 4, 6
LINEAGE = {"parentModel": None, "trainedAt": "2026-01-01T00:00:00+00:00",
           "dataManifest": "0" * 16}


def _arrays(seed):
    """Seeded coefficients of a fixed effect and a per-user random effect
    (two of the four features an entity, keys sorted)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=D_FIXED).astype(np.float32)
    keys = np.sort(np.concatenate([
        e * DIM + rng.choice(DIM, size=2, replace=False)
        for e in range(N_ENTITIES)]).astype(np.int64))
    coeffs = rng.normal(size=len(keys)).astype(np.float32)
    return means, keys, coeffs


def _keys():
    return ([feature_key(f"x{i}") for i in range(D_FIXED)],
            [feature_key(f"r{i}") for i in range(DIM)])


VOCABS = {"userId": {f"u{i}": i for i in range(N_ENTITIES)}}


def torch_model(seed=0):
    """The port's model of :func:`_arrays`, its index maps and vocabulary."""
    means, keys, coeffs = _arrays(seed)
    task = TTask.LOGISTIC_REGRESSION
    model = tm.GameModel(coordinates={
        "global": tm.FixedEffectModel(
            TGLM(TCoefficients(torch.as_tensor(means)), task), "fixed"),
        "perUser": tm.RandomEffectModel(
            random_effect_type="userId", feature_shard_id="re", task=task,
            dim=DIM, keys=keys, coeffs=coeffs)}, task=task)
    fixed, re = _keys()
    maps = {"fixed": t_index_map(fixed, add_intercept=False),
            "re": t_index_map(re, add_intercept=False)}
    return model, maps, VOCABS


def jax_model(seed=0):
    """The JAX package's model of the same arrays."""
    means, keys, coeffs = _arrays(seed)
    task = JTask.LOGISTIC_REGRESSION
    model = jm.GameModel(coordinates={
        "global": jm.FixedEffectModel(
            JGLM(JCoefficients(jnp.asarray(means)), task), "fixed"),
        "perUser": jm.RandomEffectModel(
            random_effect_type="userId", feature_shard_id="re", task=task,
            dim=DIM, keys=keys, coeffs=coeffs)}, task=task)
    fixed, re = _keys()
    maps = {"fixed": j_index_map(fixed, add_intercept=False),
            "re": j_index_map(re, add_intercept=False)}
    return model, maps, VOCABS


def tree_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def tree_records(root):
    """A model directory as decoded content: Avro files as record lists,
    JSON parsed, anything else raw."""
    out = {}
    for rel, raw in tree_bytes(root).items():
        if rel.endswith(".avro"):
            out[rel] = read_avro_file(os.path.join(root, rel))
        elif rel.endswith(".json"):
            out[rel] = json.loads(raw)
        else:
            out[rel] = raw
    return out


def stray_tmp(root):
    return [n for _, dirs, files in os.walk(root) for n in dirs + files
            if n.endswith(".tmp")]


def background_save(pipe, out, model, maps, vocabs, **kw):
    saver = pipe.BackgroundSaver()
    try:
        saver.submit_game_save(out, model, maps, vocabs, **kw)
        saver.join()
    finally:
        saver.close()


# --- parity ---------------------------------------------------------------

def test_background_save_byte_identical_to_synchronous(tmp_path,
                                                       monkeypatch):
    # the container's sync marker pinned and the native writer (whose
    # marker comes from C++) off: the only nondeterminism of the writers
    monkeypatch.setattr(os, "urandom", lambda n: b"\x07" * n)
    monkeypatch.setattr(tnative, "available", lambda: False)
    model, maps, vocabs = torch_model()
    sync_dir, bg_dir = str(tmp_path / "sync"), str(tmp_path / "bg")
    tio.save_game_model(sync_dir, model, maps, vocabs, lineage=LINEAGE)
    background_save(tpipe, bg_dir, model, maps, vocabs, lineage=LINEAGE)
    assert tree_bytes(sync_dir) == tree_bytes(bg_dir)
    assert stray_tmp(str(tmp_path)) == []


@pytest.mark.parametrize("writer", ["native", "python"])
def test_both_packages_background_saves_record_identical(tmp_path,
                                                         monkeypatch,
                                                         writer):
    if writer == "python":
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert tnative.available()
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    background_save(tpipe, t_dir, *torch_model(), lineage=LINEAGE)
    background_save(jpipe, j_dir, *jax_model(), lineage=LINEAGE)
    with open(os.path.join(t_dir, "model-metadata.json"), "rb") as a, \
            open(os.path.join(j_dir, "model-metadata.json"), "rb") as b:
        assert a.read() == b.read()
    assert tree_records(t_dir) == tree_records(j_dir)
    assert tio.model_lineage_id(t_dir) == jio.model_lineage_id(j_dir)
    # and the port's synchronous save of the same model names the same
    # lineage: the saver changes no byte of what it identifies
    sync_dir = str(tmp_path / "sync")
    tio.save_game_model(sync_dir, *torch_model(), lineage=LINEAGE)
    assert tio.model_lineage_id(sync_dir) == tio.model_lineage_id(t_dir)


# --- crash-safe publication -------------------------------------------------

def test_fault_at_visit_zero_publishes_atomically_in_both(tmp_path):
    outs = {}
    for name, pipe, make, plan_of, inject in (
            ("t", tpipe, torch_model, FaultPlan, injected),
            ("j", jpipe, jax_model, JFaultPlan, j_injected)):
        spec = (FaultSpec if name == "t" else JFaultSpec)(
            site="io.model_save", at=(0,))
        out = str(tmp_path / name / "model")
        pipe.save_game_model_atomic(out, *make(1), lineage=LINEAGE)
        before = tree_records(out)
        plan = plan_of([spec])
        with inject(plan):
            background_save(pipe, out, *make(2), lineage=LINEAGE)
        assert [r.site for r in plan.fired()] == ["io.model_save"], name
        assert plan.visits("io.model_save") == 2, name  # one retry
        outs[name] = tree_records(out)
        assert outs[name] != before
        assert stray_tmp(str(tmp_path / name)) == []
    assert outs["t"] == outs["j"]
    model, maps, vocabs = torch_model(2)
    loaded = tio.load_game_model(str(tmp_path / "t" / "model"), maps, vocabs,
                                 device="cpu")
    np.testing.assert_array_equal(loaded.coordinates["perUser"].coeffs,
                                  model.coordinates["perUser"].coeffs)


def test_fault_at_every_visit_keeps_the_previous_tree(tmp_path):
    out = str(tmp_path / "model")
    tpipe.save_game_model_atomic(out, *torch_model(1), lineage=LINEAGE)
    before = tree_bytes(out)
    plan = FaultPlan([FaultSpec(site="io.model_save", rate=1.0)])
    saver = tpipe.BackgroundSaver()
    try:
        with injected(plan):
            saver.submit_game_save(out, *torch_model(2), lineage=LINEAGE)
            with pytest.raises(InjectedFault):
                saver.join()
    finally:
        saver.close()
    assert len(plan.fired()) == plan.visits("io.model_save") > 1
    assert tree_bytes(out) == before
    assert stray_tmp(str(tmp_path)) == []


# --- aliases -----------------------------------------------------------------

def test_alias_hardlinks_and_names_its_source_as_jax_does(tmp_path):
    metas = {}
    for name, pipe, make in (("t", tpipe, torch_model),
                             ("j", jpipe, jax_model)):
        root = tmp_path / name
        src, dst = str(root / "all" / "config-1"), str(root / "best")
        pipe.save_game_model_atomic(src, *make(), lineage=LINEAGE)
        pipe.publish_model_alias(src, dst)
        with open(os.path.join(dst, "model-metadata.json")) as f:
            metas[name] = json.load(f)
        part = os.path.join("random-effect", "perUser", "coefficients",
                            "part-00000.avro")
        assert (os.stat(os.path.join(src, part)).st_ino
                == os.stat(os.path.join(dst, part)).st_ino)
    assert metas["t"] == metas["j"]
    assert metas["t"]["aliasOf"] == os.path.join("all", "config-1")
    # a second alias publish replaces the first whole
    root = tmp_path / "t"
    src0 = str(root / "all" / "config-0")
    tpipe.save_game_model_atomic(src0, *torch_model(3), lineage=LINEAGE)
    tpipe.publish_model_alias(src0, str(root / "best"))
    assert tree_records(str(root / "best"))["random-effect/perUser/"
                                             "coefficients/part-00000.avro"] \
        == tree_records(src0)["random-effect/perUser/coefficients/"
                              "part-00000.avro"]
    assert stray_tmp(str(root)) == []


# --- the saver and the background read ---------------------------------------

def test_join_propagates_the_first_error():
    saver = tpipe.BackgroundSaver()
    try:
        saver.submit(lambda: None)
        saver.submit(lambda: (_ for _ in ()).throw(RuntimeError("disk full")))
        saver.submit(lambda: (_ for _ in ()).throw(OSError("second")))
        with pytest.raises(RuntimeError, match="disk full"):
            saver.join()
        saver.join()  # the failed batch is drained
        assert saver.collect() == []
    finally:
        saver.close()


def test_submitted_spans_parent_under_the_callers_span(tmp_path):
    from photon_ml_tpu_torch.telemetry import tracing

    trace = str(tmp_path / "trace.jsonl")
    tracing.configure(trace)
    try:
        saver = tpipe.BackgroundSaver()
        with tracing.span("stage"):
            saver.submit(lambda: None, label="io.save.task")
            saver.submit_file_write(
                lambda p: open(p, "w").write("{}"),
                str(tmp_path / "x.json"), label="io.save.index")
            saver.submit_game_save(str(tmp_path / "m"), *torch_model())
            fut = tpipe.read_in_background(lambda: 1)
            assert fut.result(timeout=30) == 1
            saver.join()
        saver.close()
    finally:
        tracing.close()
    with open(trace) as f:
        spans = [json.loads(line) for line in f if line.strip()]
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], s)
    stage = by_name["stage"]["span_id"]
    for name in ("io.save.task", "io.save.index", "io.save.model",
                 "io.read.validation"):
        assert by_name[name]["parent_id"] == stage, name
    # the part writes parent under their model's save
    parts = [s for s in spans if s["name"] == "io.save.part"]
    assert len(parts) == 2
    assert {s["parent_id"] for s in parts} == {
        by_name["io.save.model"]["span_id"]}


def test_background_read_delivers_result_or_exception():
    fut = tpipe.read_in_background(lambda a, b: a + b, 2, b=3)
    assert fut.result(timeout=30) == 5

    def boom():
        raise OSError("no such file")

    with pytest.raises(OSError, match="no such file"):
        tpipe.read_in_background(boom).result(timeout=30)


# --- the repair: train_game under the io.model_save fault ---------------------

def _train_game_args(train, out, extra=()):
    return ["--training-data", train, "--output-dir", out,
            "--feature-shards", SHARDS, "--coordinates", *COORDS,
            "--update-sequence", "global,perUser",
            "--grid", "global=0.1", "perUser=1", *extra,
            "--device", "cpu"]


@pytest.fixture(scope="module")
def small_avro(tmp_path_factory):
    return make_avro_dataset(tmp_path_factory.mktemp("pipeline") /
                             "train.avro", n=300, seed=0)


def _model_records(run):
    records = tree_records(os.path.join(run, "best"))
    meta = records.pop("model-metadata.json")
    meta.pop("trainedAt")  # the run's timestamp
    meta.pop("aliasOf", None)
    return records, meta


def test_train_game_survives_an_io_model_save_fault(tmp_path, small_avro):
    from photon_ml_tpu_torch.cli import train_game as t_cli

    clean, out = str(tmp_path / "clean"), str(tmp_path / "out")
    t_cli.run(_train_game_args(small_avro, clean))
    plan = FaultPlan([FaultSpec(site="io.model_save", at=(0,))])
    with injected(plan):
        result = t_cli.run(_train_game_args(small_avro, out))
    assert result["n_configurations"] == 1
    assert [r.site for r in plan.fired()] == ["io.model_save"]
    assert stray_tmp(out) == []
    assert _model_records(out) == _model_records(clean)
    from photon_ml_tpu_torch.io.index import IndexMap

    maps = {s: IndexMap.load(os.path.join(out, "feature-indexes",
                                          f"{s}.json"))
            for s in ("global", "user")}
    best = os.path.join(out, "best")
    model = tio.load_game_model(best, maps,
                                tio.game_model_entity_vocabs(best),
                                device="cpu")
    assert set(model.coordinates) == {"global", "perUser"}


def test_train_game_all_models_alias_under_the_fault(tmp_path, small_avro):
    from photon_ml_tpu_torch.cli import train_game as t_cli

    out = str(tmp_path / "out")
    # two configurations, saved as all/config-0 and all/config-1 (visits 0
    # and 1, in either order), then best/ published as an alias (visit 2)
    plan = FaultPlan([FaultSpec(site="io.model_save", at=(2,))])
    with injected(plan):
        t_cli.run(_train_game_args(small_avro, out, (
            "--grid", "global=0.1;10", "perUser=1",
            "--output-all-models")))
    assert [r.site for r in plan.fired()] == ["io.model_save"]
    assert plan.visits("io.model_save") == 4
    with open(os.path.join(out, "best", "model-metadata.json")) as f:
        alias = json.load(f)["aliasOf"]
    assert alias in (os.path.join("all", "config-0"),
                     os.path.join("all", "config-1"))
    src = os.path.join(out, alias)
    part = os.path.join("fixed-effect", "global", "coefficients",
                        "part-00000.avro")
    assert (os.stat(os.path.join(src, part)).st_ino
            == os.stat(os.path.join(out, "best", part)).st_ino)
    assert stray_tmp(out) == []
