"""The port's ``game/multiprocess.py`` against the JAX package's.

- the pure functions (entity partition, row owners, file shares, id
  reconciliation, the row shuffle) against the JAX functions, mirroring
  ``tests/test_multiprocess.py``;
- ``train_game_multiprocess`` in one process: bit for bit the port's
  ``GameEstimator`` fit, close to the JAX package's single-process
  ``train_game_multiprocess``, and resumed from its sweep checkpoints bit
  for bit the uninterrupted run;
- the same in 2 gloo ranks (each starting from half the rows): the ranks'
  models bit-identical, and within the JAX package's multi-process
  tolerance (atol 2e-3, rtol 2e-2) of the one-process fit — plain, with a
  down-sampled fixed effect and per-sweep validation, a warm start with a
  locked coordinate, a factored coordinate, a second entity type, a
  divergence rollback in lockstep, and a checkpoint resumed across ranks.

Rank functions live at module level (the ranks import this module by name);
JAX is imported inside the tests only.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.game import multiprocess as tmp_
from photon_ml_tpu_torch.testing import make_mixed_effect, run_ranks

TOL = dict(atol=2e-3, rtol=2e-2)
SEQ = ["global", "perEntity"]
LAM = {"global": 1e-3, "perEntity": 0.5, "perItem": 0.5}


def _game():
    game, _ = make_mixed_effect(n=240, d_fixed=5, d_re=3, n_entities=13,
                                seed=5)
    # a second entity type: 5 items, interleaved with the entities
    items = (np.arange(game.n_samples) * 7) % 5
    return dataclasses.replace(game, id_columns={
        **game.id_columns, "itemId": items.astype(np.int64)})


def _configs(kind="plain"):
    from photon_ml_tpu_torch.game.data import RandomEffectDatasetConfig
    from photon_ml_tpu_torch.game.estimator import (
        FactoredRandomEffectCoordinateConfig,
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_tpu_torch.game.projector import ProjectorType
    from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.ops.regularization import L2Regularization
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.sampling import BinaryClassificationDownSampler

    opt = GLMOptimizationConfiguration(
        regularization=L2Regularization,
        optimizer_config=OptimizerConfig(max_iterations=40))
    cfg = {"global": FixedEffectCoordinateConfig("fixed", opt),
           "perEntity": RandomEffectCoordinateConfig(
               RandomEffectDatasetConfig("entityId", "re",
                                         active_data_upper_bound=30), opt)}
    if kind == "downsampled":
        cfg["global"] = dataclasses.replace(
            cfg["global"],
            downsampler=BinaryClassificationDownSampler(rate=0.7, seed=11))
    elif kind == "factored":
        cfg["perEntity"] = FactoredRandomEffectCoordinateConfig(
            RandomEffectDatasetConfig("entityId", "re",
                                      projector_type=ProjectorType.RANDOM,
                                      projected_dim=2),
            optimization=opt, n_factored_iterations=2)
    elif kind == "two-types":
        cfg["perItem"] = RandomEffectCoordinateConfig(
            RandomEffectDatasetConfig("itemId", "re"), opt)
    return cfg


SEQS = {"plain": SEQ, "downsampled": SEQ, "factored": SEQ,
        "two-types": SEQ + ["perItem"]}
SWEEPS = {"plain": 2, "downsampled": 2, "factored": 1, "two-types": 2}


def _summary(model, game):
    """The arrays two fits are compared on."""
    out = {"scores": model.score(game)}
    for cid, m in model.coordinates.items():
        if hasattr(m, "keys"):
            out[f"{cid}.keys"] = m.keys
            out[f"{cid}.coeffs"] = m.coeffs
            if m.projector is not None:
                out[f"{cid}.projector"] = np.asarray(m.projector.matrix)
        else:
            out[f"{cid}.w"] = m.model.coefficients.means.numpy()
    return out


def _fit(local, kind, **kw):
    from photon_ml_tpu_torch.types import TaskType

    return tmp_.train_game_multiprocess(
        local, TaskType.LOGISTIC_REGRESSION, _configs(kind), SEQS[kind], LAM,
        n_cd_iterations=kw.pop("sweeps", SWEEPS[kind]), device="cpu", **kw)


def _half(game, rank, n_ranks=2):
    cuts = np.linspace(0, game.n_samples, n_ranks + 1).astype(int)
    return tmp_._take_rows(game, np.arange(cuts[rank], cuts[rank + 1]))


# --- pure functions -------------------------------------------------------

@pytest.mark.parametrize("counts,n_proc", [
    (np.random.default_rng(0).integers(0, 50, size=40), 3),
    (np.array([5, 5, 5, 5, 5, 5]), 4),
    (np.array([100, 1, 1, 1]), 2),
    (np.array([3, 0, 2]), 1),
    (np.zeros(0, np.int64), 3)],
    ids=["random", "ties", "skewed", "one-process", "empty"])
def test_balanced_entity_partition_equals_jax(counts, n_proc):
    from photon_ml_tpu.game import multiprocess as jmp

    got = tmp_.balanced_entity_partition(counts, n_proc)
    np.testing.assert_array_equal(
        got, jmp.balanced_entity_partition(counts, n_proc))
    assert got.dtype == np.int32


def test_owner_of_rows_equals_jax():
    from photon_ml_tpu.game import multiprocess as jmp

    rng = np.random.default_rng(1)
    ents = rng.integers(-1, 9, size=50)
    owner = tmp_.balanced_entity_partition(np.bincount(ents[ents >= 0]), 3)
    rows = np.arange(100, 150)
    np.testing.assert_array_equal(
        tmp_.owner_of_rows(ents, owner, rows, 3),
        jmp.owner_of_rows(ents, owner, rows, 3))


class _Reader:
    """The ``paths`` part of a reader, over a fixed directory."""

    def paths(self, input_path):
        return sorted(os.path.join(input_path, f)
                      for f in os.listdir(input_path))


def _files(root, sizes):
    os.makedirs(root, exist_ok=True)
    for i, s in enumerate(sizes):
        with open(os.path.join(root, f"part-{i:02d}.avro"), "wb") as f:
            f.write(b"x" * s)
    return root


def test_process_file_share_one_process_equals_jax(tmp_path):
    from photon_ml_tpu.game import multiprocess as jmp

    root = _files(str(tmp_path / "in"), [10, 500, 20, 30])
    assert tmp_.process_file_share(_Reader(), root) == \
        jmp.process_file_share(_Reader(), root) == _Reader().paths(root)


def _vocab_inputs():
    from photon_ml_tpu_torch.io.index import IndexMap

    game = _game()
    maps = {"fixed": IndexMap({"z": 0, "a": 1, "(INTERCEPT)": 2}),
            "re": IndexMap({"b": 0, "c": 1, "a": 2})}
    vocabs = {"entityId": {f"e{i}": (i * 5) % 13 for i in range(13)}}
    return game, maps, vocabs


def test_reconcile_global_ids_one_process_equals_jax():
    from photon_ml_tpu.game import multiprocess as jmp
    from photon_ml_tpu.game.data import FeatureShard as JShard
    from photon_ml_tpu.game.data import GameData as JGame
    from photon_ml_tpu.io.index import IndexMap as JMap

    game, maps, vocabs = _vocab_inputs()
    shards = {k: dataclasses.replace(s, cols=s.cols % len(maps[k]),
                                     dim=len(maps[k]))
              for k, s in game.shards.items()}
    game = dataclasses.replace(game, shards=shards)
    got = tmp_.reconcile_global_ids(game, maps, vocabs, ("entityId",))
    jgame = JGame(labels=game.labels, offsets=game.offsets,
                  weights=game.weights,
                  shards={k: JShard(indptr=s.indptr, cols=s.cols,
                                    vals=s.vals, dim=s.dim)
                          for k, s in shards.items()},
                  id_columns=dict(game.id_columns))
    want = jmp.reconcile_global_ids(
        jgame, {k: JMap(dict(m.key_to_index)) for k, m in maps.items()},
        vocabs, ("entityId",))
    for k in maps:
        assert got[1][k].key_to_index == want[1][k].key_to_index
        np.testing.assert_array_equal(got[0].shards[k].cols,
                                      want[0].shards[k].cols)
        assert got[0].shards[k].dim == want[0].shards[k].dim
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0].id_columns["entityId"],
                                  want[0].id_columns["entityId"])


def test_exchange_rows_one_process_keeps_own_rows():
    game = _game()
    dest = np.zeros(game.n_samples, np.int32)
    dest[::3] = 1  # rows for a process that does not exist here
    got, rows = tmp_.exchange_rows(game, dest)
    np.testing.assert_array_equal(rows, np.flatnonzero(dest == 0))
    np.testing.assert_array_equal(got.labels, game.labels[rows])
    np.testing.assert_array_equal(got.shards["re"].to_dense(),
                                  game.shards["re"].to_dense()[rows])


# --- one process ---------------------------------------------------------

@pytest.fixture(scope="module")
def one_process():
    """Each scenario fit in one process on every row."""
    game = _game()
    return {kind: _summary(_fit(game, kind).model, game)
            for kind in ("plain", "downsampled", "factored", "two-types")}


def test_one_process_equals_the_estimator(one_process):
    from photon_ml_tpu_torch.game.estimator import (
        GameEstimator,
        GameOptimizationConfiguration,
    )
    from photon_ml_tpu_torch.types import TaskType

    game = _game()
    est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                        coordinate_configs=_configs("two-types"),
                        update_sequence=SEQS["two-types"],
                        n_cd_iterations=2, device="cpu")
    want = _summary(est.fit(game, [GameOptimizationConfiguration(LAM)])[0]
                    .model, game)
    got = one_process["two-types"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_one_process_equals_jax_single_process(one_process):
    import jax

    from photon_ml_tpu import testing as jt
    from photon_ml_tpu.game import multiprocess as jmp
    from photon_ml_tpu.game.data import RandomEffectDatasetConfig as JRE
    from photon_ml_tpu.game.estimator import (
        FixedEffectCoordinateConfig as JFixed,
    )
    from photon_ml_tpu.game.estimator import (
        RandomEffectCoordinateConfig as JRandom,
    )
    from photon_ml_tpu.glm.problem import GLMOptimizationConfiguration
    from photon_ml_tpu.ops.regularization import L2Regularization
    from photon_ml_tpu.optimize import OptimizerConfig
    from photon_ml_tpu.types import TaskType

    jgame, _ = jt.make_mixed_effect(n=240, d_fixed=5, d_re=3, n_entities=13,
                                    seed=5)
    opt = GLMOptimizationConfiguration(
        regularization=L2Regularization,
        optimizer_config=OptimizerConfig(max_iterations=40))
    configs = {"global": JFixed("fixed", opt),
               "perEntity": JRandom(JRE("entityId", "re",
                                        active_data_upper_bound=30), opt)}
    jax.config.update("jax_enable_x64", False)
    try:
        mp = jmp.train_game_multiprocess(
            jgame, TaskType.LOGISTIC_REGRESSION, configs, SEQ, LAM,
            n_cd_iterations=2)
    finally:
        jax.config.update("jax_enable_x64", True)
    got = one_process["plain"]
    np.testing.assert_allclose(
        got["global.w"],
        np.asarray(mp.model.coordinates["global"].model.coefficients.means),
        **TOL)
    re = mp.model.coordinates["perEntity"]
    np.testing.assert_array_equal(got["perEntity.keys"], re.keys)
    np.testing.assert_allclose(got["perEntity.coeffs"], re.coeffs, **TOL)
    np.testing.assert_allclose(got["scores"], mp.model.score(jgame),
                               atol=5e-3)


def test_one_process_resume_equals_uninterrupted(tmp_path, one_process):
    game = _game()
    ckpt = str(tmp_path / "ckpt")
    _fit(game, "plain", sweeps=1, checkpoint_dir=ckpt)
    assert os.path.exists(os.path.join(ckpt, "proc-0", "sweep-0.npz"))
    resumed = _fit(game, "plain", sweeps=2, checkpoint_dir=ckpt, resume=True)
    got = _summary(resumed.model, game)
    for k, v in one_process["plain"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # a changed configuration refuses the state
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _fit(game, "downsampled", sweeps=3, checkpoint_dir=ckpt,
             resume=True)


# --- two ranks -----------------------------------------------------------

def _two_rank_job(rank, root):
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.game.model import GameModel
    from photon_ml_tpu_torch.parallel import multihost
    from photon_ml_tpu_torch.resilience import (
        DivergenceGuard,
        DivergencePolicy,
        FaultPlan,
        FaultSpec,
        injected,
    )

    game = _game()
    local = _half(game, rank)
    out = {}
    for kind in ("plain", "factored", "two-types"):
        mp = _fit(local, kind)
        out[kind] = _summary(mp.model, game)
        out[kind + ".rows"] = len(mp.global_rows)
        if kind == "plain":
            plain = mp.model
    mp = _fit(local, "downsampled",
              validation=(game, parse_evaluators(["AUC"])))
    out["downsampled"] = _summary(mp.model, game)
    out["downsampled.history"] = mp.validation_history
    # a warm start from the plain fit with the fixed effect locked
    mp = _fit(local, "plain", sweeps=1,
              initial_models=dict(plain.coordinates), locked=["global"])
    out["locked"] = _summary(mp.model, game)
    # a NaN from every rank's first step: rolled back in lockstep
    guard = DivergenceGuard(DivergencePolicy(mode="rollback"))
    with injected(FaultPlan([FaultSpec("optimizer.step", at=(0,),
                                       mode="nan")])):
        mp = _fit(local, "plain", guard=guard)
    out["guarded"] = _summary(mp.model, game)
    out["guarded.failures"] = dict(guard.failures)
    # one sweep checkpointed per process, then resumed to two
    ckpt = os.path.join(root, "ckpt")
    _fit(local, "plain", sweeps=1, checkpoint_dir=ckpt)
    out["resumed"] = _summary(
        _fit(local, "plain", checkpoint_dir=ckpt, resume=True).model, game)
    # file shares: 2 ranks over 4 unequal files, and too few files
    out["share"] = tmp_.process_file_share(
        _Reader(), os.path.join(root, "four"))
    try:
        tmp_.process_file_share(_Reader(), os.path.join(root, "one"))
    except SystemExit as e:
        out["too_few"] = str(e)
    # per-process feature names and vocabularies agreed
    from photon_ml_tpu_torch.io.index import IndexMap
    from photon_ml_tpu_torch.types import INTERCEPT_KEY

    names = [["x", "y", INTERCEPT_KEY], ["w", "x"]][rank]
    ids = [["u3", "u1"], ["u2", "u1", "u9"]][rank]
    sub = tmp_._take_rows(game, np.arange(3))
    sub = dataclasses.replace(sub, shards={"fixed": dataclasses.replace(
        sub.shards["fixed"], cols=np.arange(15, dtype=np.int32) % len(names),
        dim=len(names))}, id_columns={"userId": np.array([0, 1, -1])})
    data, maps, vocabs = tmp_.reconcile_global_ids(
        sub, {"fixed": IndexMap({k: i for i, k in enumerate(names)})},
        {"userId": {k: i for i, k in enumerate(ids)}}, ("userId",))
    out["reconciled"] = (maps["fixed"].key_to_index, vocabs,
                         data.shards["fixed"].cols,
                         data.id_columns["userId"])
    assert isinstance(plain, GameModel) and multihost.process_count() == 2
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mp"))
    _files(os.path.join(root, "four"), [100, 10, 10, 100])
    _files(os.path.join(root, "one"), [10])
    return run_ranks(_two_rank_job, 2, root, timeout_s=180)


SCENARIOS = ["plain", "downsampled", "factored", "two-types", "locked",
             "guarded", "resumed"]


@pytest.mark.parametrize("kind", SCENARIOS)
def test_two_ranks_agree_bit_for_bit(two_ranks, kind):
    a, b = two_ranks[0][kind], two_ranks[1][kind]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["plain", "downsampled", "factored",
                                  "two-types"])
def test_two_ranks_equal_one_process(two_ranks, one_process, kind):
    got, want = two_ranks[0][kind], one_process[kind]
    for k, v in want.items():
        if k.endswith(".keys"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        elif k == "scores":
            np.testing.assert_allclose(got[k], v, atol=1e-2, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


def test_two_ranks_own_their_entities(two_ranks):
    rows = [o["plain.rows"] for o in two_ranks]
    assert all(r > 0 for r in rows) and sum(rows) == 240


def test_two_ranks_validation_history(two_ranks):
    hist = [o["downsampled.history"] for o in two_ranks]
    assert hist[0] == hist[1] and len(hist[0]) == 2
    assert 0.5 < hist[0][-1]["AUC"] <= 1.0


def test_two_ranks_locked_coordinate_kept(two_ranks):
    got = two_ranks[0]
    np.testing.assert_array_equal(got["locked"]["global.w"],
                                  got["plain"]["global.w"])


def test_two_ranks_roll_back_in_lockstep(two_ranks):
    failures = [o["guarded.failures"] for o in two_ranks]
    assert failures[0] == failures[1] and failures[0].get("global") == 1
    assert np.isfinite(two_ranks[0]["guarded"]["scores"]).all()


def test_two_ranks_resume_equals_uninterrupted(two_ranks):
    for o in two_ranks:
        for k, v in o["plain"].items():
            np.testing.assert_array_equal(o["resumed"][k], v, err_msg=k)


def test_two_ranks_file_shares(two_ranks):
    shares = [[os.path.basename(p) for p in o["share"]] for o in two_ranks]
    # contiguous, byte-balanced, every rank at least one file
    assert shares == [["part-00.avro", "part-01.avro"],
                      ["part-02.avro", "part-03.avro"]]
    for o in two_ranks:
        assert "needs at least that many input files" in o["too_few"]


def test_two_ranks_reconcile_ids(two_ranks):
    from photon_ml_tpu_torch.types import INTERCEPT_KEY

    a, b = (o["reconciled"] for o in two_ranks)
    # sorted names, the intercept last: a one-process read's index
    assert a[0] == b[0] == {"w": 0, "x": 1, "y": 2, INTERCEPT_KEY: 3}
    assert a[1] == b[1] == {"userId": {"u1": 0, "u2": 1, "u3": 2,
                                       "u9": 3}}
    np.testing.assert_array_equal(a[3], [2, 0, -1])
    np.testing.assert_array_equal(b[3], [1, 0, -1])
    np.testing.assert_array_equal(b[2], np.array([0, 1] * 7 + [0]))
    torch.testing.assert_close(torch.as_tensor(a[2][:3]),
                               torch.as_tensor([1, 2, 3], dtype=torch.int32))
