"""The port's resilience layer against the JAX package's: the fault plan,
the retry policy and the divergence guard (``resilience/``), the
coordinate-descent checkpoints (``io/checkpoint.py``: atomic saves,
restores past a corrupt step, and one on-disk format for both packages),
a resumed coordinate descent, and the guard inside coordinate descent
(``optimizer.step`` NaN under rollback: the same events and backed-off λ
in both packages). The port runs on the CPU."""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.game as jg
import photon_ml_tpu.resilience as jr
import photon_ml_tpu_torch.game as tg
import photon_ml_tpu_torch.resilience as tr
from photon_ml_tpu.events import EventBus as JBus
from photon_ml_tpu.game.coordinate_descent import CoordinateDescent as JCD
from photon_ml_tpu.glm.problem import GLMOptimizationConfiguration as JOpt
from photon_ml_tpu.io.checkpoint import CheckpointManager as JManager
from photon_ml_tpu.io.checkpoint import CoordinateDescentState as JState
from photon_ml_tpu.models.coefficients import Coefficients as JCoef
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_ml_tpu.ops.regularization import L2Regularization as JL2
from photon_ml_tpu.optimize import OptimizerConfig as JOptimizer
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.events import GLOBAL_BUS
from photon_ml_tpu_torch.events import EventBus as TBus
from photon_ml_tpu_torch.game.coordinate_descent import CoordinateDescent as TCD
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration as TOpt
from photon_ml_tpu_torch.io.checkpoint import CheckpointManager as TManager
from photon_ml_tpu_torch.io.checkpoint import CoordinateDescentState as TState
from photon_ml_tpu_torch.models.coefficients import Coefficients as TCoef
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel as TGLM
from photon_ml_tpu_torch.ops.regularization import L2Regularization as TL2
from photon_ml_tpu_torch.optimize import OptimizerConfig as TOptimizer
from photon_ml_tpu_torch.types import TaskType as TTask

SEQ = ["global", "perUser"]
LAM = {"global": 0.1, "perUser": 1.0}
#: tests/test_torch_game.py's f32 GAME tolerances (fixed, random effect)
TOL = dict(rtol=1e-3, atol=1e-4)
RE_TOL = dict(rtol=2e-3, atol=5e-4)


# --- fault plan, retry policy, guard ----------------------------------------

def test_fault_plan_fires_like_jax():
    spec = {"seed": 7, "specs": [
        {"site": "io.read", "rate": 0.3},
        {"site": "optimizer.step", "at": [2, 5], "mode": "nan"},
        {"site": "ckpt.save", "at": [1], "max_fires": 1}]}
    plans = (tr.FaultPlan.from_json(dict(spec)),
             jr.FaultPlan.from_json(dict(spec)))
    for p in plans:
        p.bus = TBus() if isinstance(p, tr.FaultPlan) else JBus()
    fired = []
    for plan, err in zip(plans, (tr.InjectedFault, jr.InjectedFault)):
        out = []
        for i in range(40):
            for site in ("io.read", "optimizer.step", "ckpt.save"):
                try:
                    out.append(plan.visit(site, {}))
                except err:
                    out.append("raised")
        fired.append(out)
    assert fired[0] == fired[1]
    assert fired[0].count("raised") > 2 and "nan" in fired[0]
    assert plans[0].to_json() == plans[1].to_json()


def test_fault_value_corrupts_a_tensor_where_it_lies():
    x = torch.arange(4, dtype=torch.float32)
    plan = tr.FaultPlan([tr.FaultSpec("optimizer.step", at=(1,),
                                      mode="nan")], bus=TBus())
    with tr.injected(plan):
        a = tr.fault_value("optimizer.step", x)
        b = tr.fault_value("optimizer.step", x)
    assert a is x and torch.isnan(b).all() and b.device == x.device
    assert tr.fault_value("optimizer.step", x) is x  # no plan: untouched


def test_retry_policy_delays_equal_jax():
    import itertools

    t = tr.RetryPolicy(seed=3, base_delay_s=0.1, jitter=0.2)
    j = jr.RetryPolicy(seed=3, base_delay_s=0.1, jitter=0.2)
    assert (list(itertools.islice(t.delays(), 8))
            == list(itertools.islice(j.delays(), 8)))


def _guard_trace(pkg, bus_cls, mode, max_retries, calls):
    bus = bus_cls()
    seen = []
    bus.subscribe(lambda e: seen.append((e.name, dict(e.payload))))
    g = pkg.DivergenceGuard(pkg.DivergencePolicy(
        mode=mode, max_retries=max_retries), bus=bus)
    actions = []
    for cid, sweep, good in calls:
        try:
            actions.append(g.on_divergence(cid, sweep=sweep,
                                           has_good_model=good))
        except pkg.DivergenceError as e:
            actions.append(f"error: {e}")
    return actions, seen, dict(g.failures), sorted(g.frozen)


@pytest.mark.parametrize("mode,max_retries,calls", [
    ("rollback", 2, [("re", 0, True)] * 3 + [("g", 1, True)]),
    ("rollback", 0, [("re", 0, False)]),
    ("freeze", 2, [("g", 0, True), ("re", 1, False)]),
    ("fail", 2, [("re", 1, True)]),
], ids=["rollback-then-freeze", "rollback-no-model", "freeze", "fail"])
def test_guard_actions_and_events_equal_jax(mode, max_retries, calls):
    assert (_guard_trace(tr, TBus, mode, max_retries, calls)
            == _guard_trace(jr, JBus, mode, max_retries, calls))


def test_guard_reads_tensors_and_host_tables():
    g = tr.DivergenceGuard(tr.DivergencePolicy(mode="rollback"), bus=TBus())
    fe = tg.FixedEffectModel(TGLM(TCoef(torch.ones(3)),
                                  TTask.LOGISTIC_REGRESSION), "global")
    re = tg.RandomEffectModel("userId", "item", TTask.LOGISTIC_REGRESSION,
                              3, np.arange(3), np.ones(3, np.float32))
    scores = torch.ones(5)
    assert g.healthy(fe, scores) and g.healthy(re, scores)
    assert not g.healthy(fe, scores * float("nan"))
    bad_fe = tg.FixedEffectModel(TGLM(TCoef(torch.tensor(
        [1.0, float("inf")])), TTask.LOGISTIC_REGRESSION), "global")
    assert not g.healthy(bad_fe, scores)
    bad_re = dataclasses.replace(re, coeffs=np.array([0, np.nan, 0],
                                                     np.float32))
    assert not g.healthy(bad_re, scores)
    assert g.next_lam(0.5) == 5.0 and g.next_lam(0.0) == 10.0
    assert g.failures == {} and g.frozen == set()


def test_resilience_config_installs_policy_and_guard():
    from photon_ml_tpu_torch.cli.config import (
        ResilienceConfig,
        install_resilience,
    )

    cfg = ResilienceConfig(max_retries=4, retry_deadline_s=2.5,
                           on_divergence="rollback")
    prev = tr.get_default_policy()
    try:
        guard = install_resilience(cfg)
        assert tr.get_default_policy().max_attempts == 5
        assert tr.get_default_policy().deadline_s == 2.5
        assert guard.policy.mode == "rollback"
        assert guard.policy.max_retries == 4
    finally:
        tr.set_default_policy(prev)
    with pytest.raises(ValueError):
        ResilienceConfig(on_divergence="retry")


# --- checkpoints --------------------------------------------------------------

def _state(value, sweep=0):
    model = tg.GameModel(coordinates={"g": tg.FixedEffectModel(
        TGLM(TCoef(torch.full((3,), value)), TTask.LOGISTIC_REGRESSION),
        "g")}, task=TTask.LOGISTIC_REGRESSION)
    return TState(sweep=sweep, coordinate_index=0, model=model,
                  scores={"g": np.full(5, value, np.float32)})


def _means(state):
    return state.model.coordinates["g"].model.coefficients.means.numpy()


def _crash_plan():
    """Fires on every ckpt.save attempt, so the save fails outright."""
    return tr.FaultPlan([tr.FaultSpec("ckpt.save", rate=1.0)], bus=TBus())


def test_crash_mid_write_keeps_previous_step(tmp_path):
    mgr = TManager(str(tmp_path), keep=3)
    mgr.save(1, _state(1.0), fingerprint="fp")
    with tr.injected(_crash_plan()):
        with pytest.raises(tr.InjectedFault):
            mgr.save(2, _state(2.0), fingerprint="fp")
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    np.testing.assert_array_equal(
        _means(mgr.restore(expected_fingerprint="fp", device="cpu")),
        np.full(3, 1.0, np.float32))
    mgr.save(2, _state(2.0), fingerprint="fp")
    assert mgr.latest_step() == 2
    assert [n for n in os.listdir(tmp_path) if n.endswith(".tmp")] == []


def test_crash_during_overwrite_keeps_old_copy(tmp_path):
    mgr = TManager(str(tmp_path))
    mgr.save(5, _state(1.0), fingerprint="fp")
    with tr.injected(_crash_plan()):
        with pytest.raises(tr.InjectedFault):
            mgr.save(5, _state(99.0), fingerprint="fp")
    np.testing.assert_array_equal(
        _means(mgr.restore(5, expected_fingerprint="fp", device="cpu")),
        np.full(3, 1.0, np.float32))


def test_single_transient_fault_is_retried_through(tmp_path):
    names = []
    unsub = GLOBAL_BUS.subscribe(lambda e: names.append(e.name))
    try:
        mgr = TManager(str(tmp_path))
        with tr.injected(tr.FaultPlan([tr.FaultSpec("ckpt.save",
                                                    at=(0,))])):
            mgr.save(1, _state(3.0), fingerprint="fp")
    finally:
        unsub()
    assert mgr.latest_step() == 1
    np.testing.assert_array_equal(
        _means(mgr.restore(expected_fingerprint="fp", device="cpu")),
        np.full(3, 3.0, np.float32))
    assert names[:3] == ["fault_injected", "retry_attempt",
                         "retry_succeeded"]


def test_restore_walks_past_corrupt_latest(tmp_path):
    mgr = TManager(str(tmp_path))
    mgr.save(1, _state(1.0), fingerprint="fp")
    mgr.save(2, _state(2.0), fingerprint="fp")
    os.unlink(tmp_path / "step-2" / "manifest.json")
    np.testing.assert_array_equal(
        _means(mgr.restore(expected_fingerprint="fp", device="cpu")),
        np.full(3, 1.0, np.float32))
    with pytest.raises(Exception):
        mgr.restore(2, expected_fingerprint="fp", device="cpu")
    with pytest.raises(ValueError, match="refusing to resume"):
        mgr.restore(expected_fingerprint="other", device="cpu")


def test_pin_step_freezes_the_resume_point(tmp_path):
    mgr = TManager(str(tmp_path))
    mgr.save(1, _state(1.0))
    mgr.pin_step(1)
    mgr.save(2, _state(2.0))
    assert mgr.steps() == [1, 2] and mgr.latest_step() == 1
    np.testing.assert_array_equal(_means(mgr.restore(device="cpu")),
                                  np.full(3, 1.0, np.float32))
    mgr.pin_step(None)
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")


def _state_arrays(seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(40, 12, replace=False)).astype(np.int64)
    return dict(means=rng.normal(size=7).astype(np.float32),
                variances=rng.uniform(size=7).astype(np.float32),
                keys=keys, coeffs=rng.normal(size=12).astype(np.float32),
                scores={"global": rng.normal(size=9).astype(np.float32),
                        "perUser": rng.normal(size=9).astype(np.float32)})


def _jax_state(a):
    task = JTask.LOGISTIC_REGRESSION
    return JState(sweep=1, coordinate_index=1, model=jg.GameModel(
        coordinates={
            "global": jg.FixedEffectModel(JGLM(JCoef(
                jnp.asarray(a["means"]), jnp.asarray(a["variances"])), task),
                "global"),
            "perUser": jg.RandomEffectModel(
                random_effect_type="userId", feature_shard_id="item",
                task=task, dim=4, keys=a["keys"], coeffs=a["coeffs"])},
        task=task), scores=a["scores"])


def _torch_state(a):
    task = TTask.LOGISTIC_REGRESSION
    return TState(sweep=1, coordinate_index=1, model=tg.GameModel(
        coordinates={
            "global": tg.FixedEffectModel(TGLM(TCoef(
                torch.as_tensor(a["means"]), torch.as_tensor(a["variances"])),
                task), "global"),
            "perUser": tg.RandomEffectModel(
                "userId", "item", task, 4, a["keys"], a["coeffs"])},
        task=task), scores=a["scores"])


def _arrays_of(state):
    fe = state.model.coordinates["global"].model.coefficients
    re = state.model.coordinates["perUser"]
    return (state.sweep, state.coordinate_index, state.model.task.value,
            np.asarray(fe.means), np.asarray(fe.variances),
            np.asarray(re.keys), np.asarray(re.coeffs), re.dim,
            re.random_effect_type, {k: np.asarray(v)
                                    for k, v in state.scores.items()})


def _assert_same(a, b):
    assert a[:3] == b[:3] and a[7:9] == b[7:9]
    for x, y in zip(a[3:7], b[3:7]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a[9].keys() == b[9].keys()
    for k in a[9]:
        np.testing.assert_array_equal(a[9][k], b[9][k])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    a = _state_arrays(11)
    if writer == "jax":
        JManager(str(tmp_path)).save(4, _jax_state(a), fingerprint="fp")
        got = TManager(str(tmp_path)).restore(expected_fingerprint="fp",
                                              device="cpu")
        want = _torch_state(a)
    else:
        TManager(str(tmp_path)).save(4, _torch_state(a), fingerprint="fp")
        got = JManager(str(tmp_path)).restore(expected_fingerprint="fp")
        want = _jax_state(a)
    _assert_same(_arrays_of(got), _arrays_of(want))
    with open(tmp_path / "step-4" / "manifest.json") as f:
        manifest = f.read()
    other = tmp_path / "other"
    (TManager if writer == "jax" else JManager)(str(other)).save(
        4, (_torch_state if writer == "jax" else _jax_state)(a),
        fingerprint="fp")
    with open(other / "step-4" / "manifest.json") as f:
        assert f.read() == manifest  # the same manifest, byte for byte


def test_unported_checkpoint_state_raises(tmp_path):
    """RANDOM projector state and random-effect variances, once refused on
    restore, now restore from a JAX checkpoint."""
    from photon_ml_tpu.game.projector import RandomProjector

    a = _state_arrays(5)
    state = _jax_state(a)
    re = state.model.coordinates["perUser"]
    matrix = np.arange(16, dtype=np.float32).reshape(4, 4)
    var = np.linspace(0.1, 1.0, len(a["keys"])).astype(np.float32)
    state.model.coordinates["perUser"] = dataclasses.replace(
        re, projector=RandomProjector(matrix=matrix), variances=var)
    JManager(str(tmp_path)).save(1, state)
    got = TManager(str(tmp_path)).restore(device="cpu")
    m = got.model.coordinates["perUser"]
    np.testing.assert_array_equal(m.projector.matrix, matrix)
    np.testing.assert_array_equal(m.variances, var)
    np.testing.assert_array_equal(m.coeffs, a["coeffs"])


# --- coordinate descent: resume and the guard ---------------------------------

def _data(pkg, n=500, seed=0, n_users=12, d_global=5, d_item=3):
    prng = np.random.default_rng(4242)
    w = prng.normal(size=d_global)
    u = 1.2 * prng.normal(size=(n_users, d_item))
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(n, d_global)).astype(np.float32)
    xi = rng.normal(size=(n, d_item)).astype(np.float32)
    users = rng.integers(0, n_users, size=n)
    margin = xg @ w + np.einsum("nd,nd->n", xi, u[users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)

    def shard(x):
        nn, dd = x.shape
        return pkg.FeatureShard.from_coo(
            np.repeat(np.arange(nn), dd), np.tile(np.arange(dd), nn),
            x.ravel(), nn, dd)

    return pkg.GameData.build(labels=y, shards={"global": shard(xg),
                                                "item": shard(xi)},
                              id_columns={"userId": users})


def _recording(cls, log):
    """``cls`` with every train call logged as (coordinate, lambda)."""
    @dataclasses.dataclass(frozen=True)
    class Recording(cls):
        def train(self, offsets, warm_start=None, **kwargs):
            log.append((self.coordinate_id, float(self.lam)))
            return super().train(offsets, warm_start, **kwargs)
    return Recording


def _torch_coords(data, log=None):
    cfg = TOpt(regularization=TL2,
               optimizer_config=TOptimizer(max_iterations=40))
    fe_cls, re_cls = tg.FixedEffectCoordinate, tg.RandomEffectCoordinate
    if log is not None:
        fe_cls, re_cls = _recording(fe_cls, log), _recording(re_cls, log)
    task = TTask.LOGISTIC_REGRESSION
    fe = tg.FixedEffectDataset.build("global", data, "global", device="cpu")
    re = tg.RandomEffectDataset.build(
        "perUser", data, tg.RandomEffectDatasetConfig("userId", "item"))
    return {"global": fe_cls("global", fe, task, cfg, lam=LAM["global"]),
            "perUser": re_cls("perUser", re, data, task, cfg,
                              lam=LAM["perUser"])}


def _jax_coords(data, log):
    cfg = JOpt(regularization=JL2,
               optimizer_config=JOptimizer(max_iterations=40))
    task = JTask.LOGISTIC_REGRESSION
    fe = jg.FixedEffectDataset.build("global", data, "global")
    re = jg.RandomEffectDataset.build(
        "perUser", data, jg.RandomEffectDatasetConfig("userId", "item"))
    return {"global": _recording(jg.FixedEffectCoordinate, log)(
        "global", fe, task, cfg, lam=LAM["global"]),
        "perUser": _recording(jg.RandomEffectCoordinate, log)(
            "perUser", re, data, task, cfg, lam=LAM["perUser"])}


def _torch_run(data, cd, **kw):
    return cd.run(_torch_coords(data, kw.pop("log", None)), data,
                  TTask.LOGISTIC_REGRESSION, torch.device("cpu"), **kw)


def test_resumed_descent_matches_uninterrupted(tmp_path):
    """Restart after the earliest retained coordinate boundary and finish:
    the same model as the uninterrupted run, to solver tolerance
    (tests/test_game.py::TestMidRunResume's limits)."""
    data = _data(tg)
    cd = TCD(update_sequence=SEQ, n_iterations=3)
    mgr = TManager(str(tmp_path / "ckpts"))
    full = _torch_run(data, cd, checkpoint=mgr, config_fingerprint="t")
    steps = mgr.steps()
    assert steps == [4, 5, 6]
    for s in steps[1:]:
        shutil.rmtree(tmp_path / "ckpts" / f"step-{s}")
    resumed = _torch_run(data, cd, checkpoint=mgr, resume=True,
                         config_fingerprint="t")
    assert [c for _, c, _ in resumed.step_seconds] == ["global", "perUser"]
    np.testing.assert_allclose(
        resumed.model.coordinates["global"].model.coefficients.means,
        full.model.coordinates["global"].model.coefficients.means,
        rtol=5e-3, atol=1e-3)
    np.testing.assert_array_equal(resumed.model.coordinates["perUser"].keys,
                                  full.model.coordinates["perUser"].keys)
    np.testing.assert_allclose(resumed.model.coordinates["perUser"].coeffs,
                               full.model.coordinates["perUser"].coeffs,
                               rtol=5e-3, atol=1e-3)
    with pytest.raises(ValueError, match="refusing to resume"):
        _torch_run(data, cd, checkpoint=mgr, resume=True,
                   config_fingerprint="another run")


def test_healthy_guarded_run_is_bit_identical(tmp_path):
    data = _data(tg)
    cd = TCD(update_sequence=SEQ, n_iterations=2)
    plain = _torch_run(data, cd)
    guarded = _torch_run(data, cd, guard=tr.DivergenceGuard(
        tr.DivergencePolicy(mode="rollback"), bus=TBus()),
        checkpoint=TManager(str(tmp_path)))
    for cid in ("global", "perUser"):
        a, b = plain.model.coordinates[cid], guarded.model.coordinates[cid]
        if cid == "global":
            a, b = a.model.coefficients.means, b.model.coefficients.means
        else:
            a, b = a.coeffs, b.coeffs
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def rollbacks():
    """perUser's first solve turns NaN under --on-divergence rollback, in
    each package: (events, train calls, model)."""
    out = {}
    for pkg, name in ((tr, "torch"), (jr, "jax")):
        bus = TBus() if pkg is tr else JBus()
        events, log = [], []
        bus.subscribe(lambda e, events=events: events.append(
            (e.name, e.payload.get("coordinate"), e.payload.get("sweep"),
             e.payload.get("reg_backoff"))))
        plan = pkg.FaultPlan.from_json({"seed": 0, "specs": [
            {"site": "optimizer.step", "at": [1], "mode": "nan"}]})
        plan.bus = bus
        guard = pkg.DivergenceGuard(pkg.DivergencePolicy(mode="rollback"),
                                    bus=bus)
        with pkg.injected(plan):
            if pkg is tr:
                data = _data(tg)
                res = TCD(update_sequence=SEQ, n_iterations=1).run(
                    _torch_coords(data, log), data,
                    TTask.LOGISTIC_REGRESSION, torch.device("cpu"),
                    guard=guard)
            else:
                data = _data(jg)
                res = JCD(update_sequence=SEQ, n_iterations=1).run(
                    _jax_coords(data, log), data, JTask.LOGISTIC_REGRESSION,
                    guard=guard)
        out[name] = (events, log, res, guard)
    return out


def test_rollback_events_and_backed_off_lambda_equal_jax(rollbacks):
    (te, tlog, tres, tguard), (je, jlog, jres, jguard) = (
        rollbacks["torch"], rollbacks["jax"])
    assert te == je == [
        ("fault_injected", "perUser", 0, None),
        ("divergence_detected", "perUser", 0, None),
        ("coordinate_rollback", "perUser", 0, 10.0)]
    assert tlog == jlog == [("global", 0.1), ("perUser", 1.0),
                            ("perUser", 10.0)]
    assert tres.regularization_weights == {"global": 0.1, "perUser": 10.0}
    assert tguard.failures == jguard.failures == {"perUser": 1}
    np.testing.assert_allclose(
        tres.model.coordinates["global"].model.coefficients.means.numpy(),
        np.asarray(jres.model.coordinates["global"].model.coefficients.means),
        **TOL)
    tre, jre = tres.model.coordinates["perUser"], jres.model.coordinates[
        "perUser"]
    np.testing.assert_array_equal(tre.keys, jre.keys)
    np.testing.assert_allclose(tre.coeffs, np.asarray(jre.coeffs), **RE_TOL)


def test_rollback_through_checkpoint_equals_in_process(tmp_path, rollbacks):
    """With a checkpoint present the rollback re-reads the last step from
    disk (the restart path): the same model as the in-process rollback."""
    bus = TBus()
    plan = tr.FaultPlan.from_json({"seed": 0, "specs": [
        {"site": "optimizer.step", "at": [1], "mode": "nan"}]})
    plan.bus = bus
    data = _data(tg)
    with tr.injected(plan):
        res = _torch_run(data, TCD(update_sequence=SEQ, n_iterations=1),
                         checkpoint=TManager(str(tmp_path)),
                         guard=tr.DivergenceGuard(
                             tr.DivergencePolicy(mode="rollback"), bus=bus))
    want = rollbacks["torch"][2].model
    for cid in ("global", "perUser"):
        a, b = res.model.coordinates[cid], want.coordinates[cid]
        if cid == "global":
            a, b = a.model.coefficients.means, b.model.coefficients.means
        else:
            a, b = a.coeffs, b.coeffs
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode,match", [
    ("fail", "--on-divergence=rollback"), ("freeze", "nothing to freeze")])
def test_divergence_without_recovery_raises(mode, match):
    plan = tr.FaultPlan.from_json({"seed": 0, "specs": [
        {"site": "optimizer.step", "at": [1], "mode": "nan"}]})
    plan.bus = TBus()
    data = _data(tg)
    with tr.injected(plan), pytest.raises(tr.DivergenceError, match=match):
        _torch_run(data, TCD(update_sequence=SEQ, n_iterations=1),
                   guard=tr.DivergenceGuard(tr.DivergencePolicy(mode=mode),
                                            bus=TBus()))


def test_freeze_keeps_the_last_good_model():
    """A NaN in sweep 1 under freeze: the coordinate keeps its sweep-0
    model, and the run goes on."""
    data = _data(tg)
    cd = TCD(update_sequence=SEQ, n_iterations=1)
    one_sweep = _torch_run(data, cd)
    plan = tr.FaultPlan.from_json({"seed": 0, "specs": [
        {"site": "optimizer.step", "at": [3], "mode": "nan"}]})
    plan.bus = TBus()
    guard = tr.DivergenceGuard(tr.DivergencePolicy(mode="freeze"),
                               bus=TBus())
    with tr.injected(plan):
        res = _torch_run(data, TCD(update_sequence=SEQ, n_iterations=2),
                         guard=guard)
    assert guard.frozen == {"perUser"}
    np.testing.assert_array_equal(res.model.coordinates["perUser"].coeffs,
                                  one_sweep.model.coordinates["perUser"]
                                  .coeffs)
