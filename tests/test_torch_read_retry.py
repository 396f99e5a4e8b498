"""Avro reads under the resilience retry policy, and ``train_glm``'s
resilience flags, in the port against the JAX package, on the CPU.

Every file read of the port's ``AvroDataReader`` (the Python codec and the
native decoder) runs under ``retry`` with the ``io.read`` fault site, as
the reference's ``_read_records_with_retry`` and native path do: one
injected ``io.read`` fault through both packages' ``train_game`` gives the
same retry events and the model of a clean run. A lambda whose
coefficients turn NaN through both packages' ``train_glm`` under
``--on-divergence rollback`` or ``freeze`` selects the same lambda and
posts the same events; under ``fail`` both raise the same message."""

import os

import numpy as np
import pytest

import photon_ml_tpu.glm.training as j_training
import photon_ml_tpu.resilience as jr
import photon_ml_tpu_torch.glm.training as t_training
import photon_ml_tpu_torch.resilience as tr
from photon_ml_tpu.cli import train_game as j_train
from photon_ml_tpu.events import GLOBAL_BUS as J_BUS
from photon_ml_tpu.io.data_reader import write_training_examples
from photon_ml_tpu_torch.cli import train_game as t_train
from photon_ml_tpu_torch.cli import train_glm as t_glm
from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.events import GLOBAL_BUS as T_BUS
from photon_ml_tpu_torch.io.avro import iter_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from test_torch_continuous import (
    COMMON,
    RE_TOL,
    SHARDS,
    TOL,
    _load,
    _records,
    _rows_by_raw,
)
from test_torch_glm_cli import _jax_run, _write

RETRY_EVENTS = ("retry_attempt", "retry_succeeded", "retry_exhausted")


class _Events:
    """Retry and divergence events posted on both packages' buses."""

    def __init__(self):
        self.seen = {"torch": [], "jax": []}

    def __enter__(self):
        self._off = [T_BUS.subscribe(lambda e: self.seen["torch"].append(e)),
                     J_BUS.subscribe(lambda e: self.seen["jax"].append(e))]
        return self

    def __exit__(self, *exc):
        for off in self._off:
            off()

    def retries(self, pkg):
        return [(e.name, e.payload["op"],
                 e.payload.get("attempt", e.payload.get("attempts")),
                 e.payload.get("delay_s"))
                for e in self.seen[pkg] if e.name in RETRY_EVENTS]

    def divergence(self, pkg):
        return [(e.name, e.payload["driver"],
                 e.payload["regularization_weight"])
                for e in self.seen[pkg]
                if e.name in ("divergence_detected", "coordinate_frozen")]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_reader_retries_a_transient_read_and_not_a_persistent_one(
        tmp_path, native):
    path = str(tmp_path / "d.avro")
    write_training_examples(path, _records(50, 3))
    reader = AvroDataReader(
        shard_configs=tuple(parse_feature_shard_config(s)
                            for s in SHARDS.split(",")), use_native=native)
    clean, _, _ = reader.read(path, id_columns=("userId",))
    with _Events() as ev:
        plan = tr.FaultPlan([tr.FaultSpec(site="io.read", at=(0,))])
        with tr.injected(plan):
            data, _, _ = reader.read(path, id_columns=("userId",))
        assert len(plan.fired("io.read")) == 1
        np.testing.assert_array_equal(data.labels, clean.labels)
        with tr.injected(tr.FaultPlan([tr.FaultSpec(site="io.read",
                                                    rate=1.0)])):
            with pytest.raises(tr.InjectedFault):
                reader.read(path)
    names = [(name, op, attempt) for name, op, attempt, _ in
             ev.retries("torch")]
    assert names == [
        ("retry_attempt", "io.read:d.avro", 1),
        ("retry_succeeded", "io.read:d.avro", 2),
        ("retry_attempt", "io.read:d.avro", 1),
        ("retry_attempt", "io.read:d.avro", 2),
        ("retry_exhausted", "io.read:d.avro", 3)]


def _coefficient_records(run):
    best = os.path.join(run, "best")
    out = {}
    for kind in ("fixed-effect", "random-effect"):
        for cid in sorted(os.listdir(os.path.join(best, kind))):
            out[cid] = list(iter_avro_file(os.path.join(
                best, kind, cid, "coefficients", "part-00000.avro")))
    return out


def test_read_fault_through_train_game_equals_jax(tmp_path):
    """One io.read fault: the port's train_game no longer fails; both
    packages post the same retry events; the port's model equals its
    clean run's bit for bit and the JAX model at the GAME tolerances."""
    path = str(tmp_path / "d0.avro")
    write_training_examples(path, _records(600, 0))
    runs = {k: str(tmp_path / k) for k in ("clean", "torch", "jax")}
    cpu = ["--device", "cpu"]
    t_train.run(["--training-data", path, "--output-dir", runs["clean"]]
                + COMMON + cpu)
    with _Events() as ev:
        for pkg, mod, plan_cls, spec in (
                ("torch", t_train, tr.FaultPlan, tr.FaultSpec),
                ("jax", j_train, jr.FaultPlan, jr.FaultSpec)):
            plan = plan_cls([spec(site="io.read", at=(0,))])
            inject = tr.injected if pkg == "torch" else jr.injected
            with inject(plan):
                mod.run(["--training-data", path, "--output-dir", runs[pkg]]
                        + COMMON + (cpu if pkg == "torch" else []))
            assert len(plan.fired("io.read")) == 1, pkg
    assert ev.retries("torch") == ev.retries("jax")
    assert [r[:3] for r in ev.retries("torch")] == [
        ("retry_attempt", "io.read:d0.avro", 1),
        ("retry_succeeded", "io.read:d0.avro", 2)]
    assert _coefficient_records(runs["torch"]) == \
        _coefficient_records(runs["clean"])
    tm, tv = _load(runs["torch"])
    jm, jv = _load(runs["jax"])
    np.testing.assert_allclose(
        tm.coordinates["global"].model.coefficients.means.numpy(),
        jm.coordinates["global"].model.coefficients.means.numpy(), **TOL)
    rows_t, rows_j = _rows_by_raw(tm, tv), _rows_by_raw(jm, jv)
    assert set(rows_t) == set(rows_j)
    for raw in rows_t:
        np.testing.assert_allclose(rows_t[raw], rows_j[raw], **RE_TOL)


def _poison_second_lambda(monkeypatch, module):
    """The sweep's second lambda (1 of 10;1;0.1) turns NaN on its way to
    the original space, in either package."""
    real, calls = module.to_original_space, []

    def poisoned(coeffs, normalization):
        out = real(coeffs, normalization)
        calls.append(1)
        if len(calls) != 2:
            return out
        return type(out)(means=out.means * float("nan"),
                         variances=out.variances)

    monkeypatch.setattr(module, "to_original_space", poisoned)


@pytest.mark.parametrize("mode", ["rollback", "freeze", "fail"])
def test_nan_lambda_through_train_glm_equals_jax(tmp_path, monkeypatch,
                                                 mode):
    train = _write(str(tmp_path / "t.avro"), "LOGISTIC_REGRESSION", 300, 1)
    valid = _write(str(tmp_path / "v.avro"), "LOGISTIC_REGRESSION", 600, 2)
    _poison_second_lambda(monkeypatch, t_training)
    _poison_second_lambda(monkeypatch, j_training)
    args = ["--training-data", train, "--validation-data", valid,
            "--regularization-weights", "10;1;0.1", "--evaluators", "AUC",
            "--on-divergence", mode]
    previous = tr.get_default_policy(), jr.get_default_policy()
    results, errors = {}, {}
    try:
        with _Events() as ev:
            for pkg, run, extra in (
                    ("torch", t_glm.run, ["--device", "cpu"]),
                    ("jax", _jax_run, [])):
                out = str(tmp_path / pkg)
                try:
                    results[pkg] = run(args + ["--output-dir", out] + extra)
                except (tr.DivergenceError, jr.DivergenceError) as e:
                    errors[pkg] = str(e)
    finally:
        tr.set_default_policy(previous[0])
        jr.set_default_policy(previous[1])
    assert ev.divergence("torch") == ev.divergence("jax")
    if mode == "fail":
        assert not results and errors["torch"] == errors["jax"]
        assert "[1.0]" in errors["torch"]
        assert ev.divergence("torch") == [
            ("divergence_detected", "train_glm", 1.0)]
        return
    assert results["torch"]["best_lambda"] == results["jax"]["best_lambda"]
    assert results["torch"]["best_lambda"] != 1.0
    assert ev.divergence("torch") == [
        ("divergence_detected", "train_glm", 1.0),
        ("coordinate_frozen", "train_glm", 1.0)]
    for pkg in ("torch", "jax"):
        assert sorted(os.listdir(tmp_path / pkg / "all")) == [
            "lambda-0.1", "lambda-10"], pkg
