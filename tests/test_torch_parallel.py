"""The port's ``parallel/`` package against the JAX package's.

- ``shard_glm_data`` / ``ShardBudget`` layouts (dense, CSR → chunked
  sparse) equal the JAX functions' leaf for leaf on the same numpy inputs;
- the port's ``DistributedGLMObjective`` over 2 gloo ranks (each holding
  its own, unequal, block of rows) equals the JAX ``DistributedGLMObjective``
  on a 2-device data mesh of the conftest's virtual devices (value,
  gradient, ``hvp`` and the Hessian diagonal) and the port's objective on
  every row in one process (those and the Hessian matrix, dense and
  chunked sparse), within 1e-10 relative (f64); the ranks' results are
  bit-identical;
- the host collectives (ragged gathers of numbers, strings and text, sums,
  maxima) in 2 ranks, the job's formation over TCP from the ``PHOTON_*``
  environment, and its errors on a partial environment;
- ``stat.py::allreduce`` over 2 ranks against the statistics of all rows;
- ``testing.py``'s data makers against the JAX package's.

The rank functions live at module level (spawned ranks import this module
by name), and JAX is imported inside the tests only, so a rank imports the
port alone.
"""

import socket

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops.design import ChunkedSparseDesign
from photon_ml_tpu_torch.ops.design import CsrDesign as TCsr
from photon_ml_tpu_torch.ops.design import DenseDesign as TDense
from photon_ml_tpu_torch.ops.objective import GLMData as TData
from photon_ml_tpu_torch.parallel import distributed as tdist
from photon_ml_tpu_torch.parallel import multihost as tmh
from photon_ml_tpu_torch.testing import run_ranks

N, D, NNZ = 64, 7, 300
#: rank 0 holds rows [0, SPLIT), rank 1 the rest: unequal blocks, so the
#: budget agreement pads rank 1
SPLIT = 34
RTOL = 1e-10
L2 = 0.7


def _problem(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[rng.uniform(size=x.shape) < 0.4] = 0.0
    labels = (rng.uniform(size=n) < 0.5).astype(np.float64)
    offsets = 0.1 * rng.normal(size=n)
    weights = rng.uniform(0.5, 2.0, size=n)
    w = 0.3 * rng.normal(size=d)
    v = rng.normal(size=d)
    mask = np.ones(d)
    mask[-1] = 0.0
    return x, labels, offsets, weights, w, v, mask


def _coo(x):
    r, c = np.nonzero(x)
    return r, c, x[r, c]


def _t_data(x, labels, offsets, weights, sparse):
    if sparse:
        r, c, v = _coo(x)
        design = TCsr.from_coo(r, c, v, x.shape[0], x.shape[1], device="cpu")
        design = TCsr(rows=design.rows, cols=design.cols,
                      values=design.values.double(), n_rows=design.n_rows,
                      n_cols=design.n_cols)
    else:
        design = TDense(x=torch.as_tensor(x))
    return TData(design=design, labels=torch.as_tensor(labels),
                 offsets=torch.as_tensor(offsets),
                 weights=torch.as_tensor(weights))


def _j_data(x, labels, offsets, weights, sparse):
    import jax.numpy as jnp

    from photon_ml_tpu.ops.design import CsrDesign, DenseDesign
    from photon_ml_tpu.ops.objective import GLMData

    if sparse:
        r, c, v = _coo(x)
        design = CsrDesign(rows=r.astype(np.int32), cols=c.astype(np.int32),
                           values=v, n_rows=x.shape[0], n_cols=x.shape[1])
    else:
        design = DenseDesign(x=jnp.asarray(x))
    return GLMData(design=design, labels=labels, offsets=offsets,
                   weights=weights)


# --- layouts -------------------------------------------------------------

_LEAVES = {False: ("x",),
           True: ("rvals", "rcols", "rrow", "cvals", "crows", "ccol")}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
@pytest.mark.parametrize("n_shards,budget", [
    (1, None), (3, None), (2, (40, 0, 0, 0, 0)), (2, "wider")],
    ids=["one", "three", "rows-budget", "wider-chunks"])
def test_shard_layout_equals_jax(sparse, n_shards, budget):
    from photon_ml_tpu.parallel import distributed as jdist

    x, labels, offsets, weights, *_ = _problem()
    if budget == "wider":
        # a budget from a denser host: wider chunks, more of them
        probe = tdist.shard_budget(tdist.shard_glm_data(
            _t_data(x, labels, offsets, weights, sparse), n_shards))
        budget = (probe.rows_per_shard + 5, 16 if sparse else 0,
                  16 if sparse else 0, probe.row_chunks + 40 if sparse else 0,
                  probe.col_chunks + 40 if sparse else 0)
    jb = None if budget is None else jdist.ShardBudget(*budget)
    tb = None if budget is None else tdist.ShardBudget(*budget)
    got = tdist.shard_glm_data(_t_data(x, labels, offsets, weights, sparse),
                               n_shards, budget=tb)
    want = jdist.shard_glm_data(_j_data(x, labels, offsets, weights, sparse),
                                n_shards, budget=jb, host_stage=True)
    assert tuple(tdist.shard_budget(got).to_array()) == tuple(
        jdist.shard_budget(want).to_array())
    for leaf in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(got, leaf).numpy(),
                                      np.asarray(getattr(want, leaf)))
    for leaf in _LEAVES[sparse]:
        np.testing.assert_array_equal(
            getattr(got.design, leaf).numpy(),
            np.asarray(getattr(want.design, leaf)), err_msg=leaf)


def test_budget_too_small_and_chunked_input_are_refused():
    x, labels, offsets, weights, *_ = _problem()
    data = _t_data(x, labels, offsets, weights, False)
    with pytest.raises(ValueError, match="cannot hold"):
        tdist.shard_glm_data(data, 2, budget=tdist.ShardBudget(10))
    r, c, v = _coo(x)
    chunked = TData(design=ChunkedSparseDesign.from_coo(
        r, c, v, N, D, device="cpu"), labels=data.labels,
        offsets=data.offsets, weights=data.weights)
    with pytest.raises(TypeError, match="CsrDesign"):
        tdist.shard_glm_data(chunked, 2)


def test_shard_budget_array_round_trip():
    b = tdist.ShardBudget(12, 8, 16, 30, 40)
    assert tdist.ShardBudget.from_array(b.to_array()) == b
    assert tmh.allreduce_shard_budget(b) is b  # one process: the identity


# --- the distributed objective over 2 ranks ------------------------------

def _objective_rank(rank):
    from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.glm.training import train_glm_sweep
    from photon_ml_tpu_torch.ops.losses import LogisticLoss
    from photon_ml_tpu_torch.ops.objective import GLMObjective
    from photon_ml_tpu_torch.ops.regularization import L2Regularization
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    x, labels, offsets, weights, w, v, mask = _problem()
    lo, hi = (0, SPLIT) if rank == 0 else (SPLIT, N)
    out = {}
    for sparse in (False, True):
        local = _t_data(x[lo:hi], labels[lo:hi], offsets[lo:hi],
                        weights[lo:hi], sparse)
        block = tmh.global_glm_data_multihost(local, "cpu")
        obj = tdist.DistributedGLMObjective(
            GLMObjective(LogisticLoss, reg_mask=torch.as_tensor(mask)))
        wt, vt = torch.as_tensor(w), torch.as_tensor(v)
        val, grad = obj.value_and_grad(wt, block, L2)
        out[sparse] = dict(
            value=val.item(), grad=grad.numpy(),
            value_only=obj.value(wt, block, L2).item(),
            hvp=obj.hvp(wt, vt, block, L2).numpy(),
            hessian_diagonal=obj.hessian_diagonal(wt, block, L2).numpy(),
            hessian_matrix=obj.hessian_matrix(wt, block, L2).numpy(),
            rows=int(block.labels.shape[0]))
    # a sweep through the distributed objective: L-BFGS and TRON
    for opt in (OptimizerType.LBFGS, OptimizerType.TRON):
        local = _t_data(x[lo:hi], labels[lo:hi], offsets[lo:hi],
                        weights[lo:hi], False)
        trained = train_glm_sweep(
            TaskType.LOGISTIC_REGRESSION,
            tmh.global_glm_data_multihost(local, "cpu"), [10.0, 0.1],
            GLMOptimizationConfiguration(
                optimizer=opt, regularization=L2Regularization,
                optimizer_config=OptimizerConfig(
                    max_iterations=50, tolerance=1e-9)),
            distributed=True)
        out[opt.value] = [tm.model.coefficients.means.numpy()
                          for tm in trained]
    out["device"] = str(tmh.local_device())
    out["backend"] = tmh.backend()
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return run_ranks(_objective_rank, 2, timeout_s=120)


@pytest.fixture(scope="module")
def jax_objective():
    """The JAX mesh objective on the dense problem (value, gradient, hvp
    and Hessian diagonal; each compiles, so the rest of the methods and the
    sparse design are held to the port's one-process objective below,
    which the port's own tests hold to the JAX package's)."""
    import jax
    import jax.numpy as jnp

    from photon_ml_tpu.ops.losses import LogisticLoss
    from photon_ml_tpu.ops.objective import GLMObjective
    from photon_ml_tpu.parallel import distributed as jdist
    from photon_ml_tpu.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    x, labels, offsets, weights, w, v, mask = _problem()
    sharded = jdist.shard_glm_data(_j_data(x, labels, offsets, weights,
                                           False), 2, device_put_mesh=mesh)
    obj = jdist.DistributedGLMObjective(
        objective=GLMObjective(LogisticLoss, reg_mask=jnp.asarray(mask)),
        mesh=mesh)
    wj, vj = jnp.asarray(w), jnp.asarray(v)
    val, grad = obj.value_and_grad(wj, sharded, L2)
    return dict(value=float(val), grad=np.asarray(grad),
                hvp=np.asarray(obj.hvp(wj, vj, sharded, L2)),
                hessian_diagonal=np.asarray(
                    obj.hessian_diagonal(wj, sharded, L2)))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= RTOL * scale, (got, want)


@pytest.mark.parametrize("key", ["value", "grad", "hvp",
                                 "hessian_diagonal"])
def test_distributed_objective_equals_jax_mesh(two_ranks, jax_objective,
                                               key):
    _close(two_ranks[0][False][key], jax_objective[key])


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("key", ["value", "value_only", "grad", "hvp",
                                 "hessian_diagonal", "hessian_matrix"])
def test_distributed_objective_equals_all_rows(two_ranks, sparse, key):
    """Against the port's objective on every row in one process."""
    from photon_ml_tpu_torch.ops.losses import LogisticLoss
    from photon_ml_tpu_torch.ops.objective import GLMObjective

    x, labels, offsets, weights, w, v, mask = _problem()
    data = _t_data(x, labels, offsets, weights, sparse)
    if sparse:
        data = TData(design=ChunkedSparseDesign.from_coo(
            *_coo(x), N, D, device="cpu"), labels=data.labels,
            offsets=data.offsets, weights=data.weights)
    obj = GLMObjective(LogisticLoss, reg_mask=torch.as_tensor(mask))
    wt, vt = torch.as_tensor(w), torch.as_tensor(v)
    want = {
        "value": lambda: obj.value_and_grad(wt, data, L2)[0],
        "value_only": lambda: obj.value(wt, data, L2),
        "grad": lambda: obj.value_and_grad(wt, data, L2)[1],
        "hvp": lambda: obj.hvp(wt, vt, data, L2),
        "hessian_diagonal": lambda: obj.hessian_diagonal(wt, data, L2),
        "hessian_matrix": lambda: obj.hessian_matrix(wt, data, L2),
    }[key]().numpy()
    _close(two_ranks[0][sparse][key], want)


def test_ranks_agree_bit_for_bit(two_ranks):
    a, b = two_ranks
    for sparse in (False, True):
        for key, val in a[sparse].items():
            if key != "rows":
                np.testing.assert_array_equal(val, b[sparse][key], key)
    for opt in ("LBFGS", "TRON"):
        for wa, wb in zip(a[opt], b[opt]):
            np.testing.assert_array_equal(wa, wb)
    # the blocks were padded to one agreed row count
    assert a[False]["rows"] == b[False]["rows"] == SPLIT
    assert (a["device"], a["backend"]) == ("cpu", "gloo")


@pytest.mark.parametrize("opt", ["LBFGS", "TRON"])
def test_distributed_sweep_equals_one_process(two_ranks, opt):
    """The 2-rank sweep against the same sweep on all rows in one process,
    at the JAX package's multi-process tolerance."""
    from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.glm.training import train_glm_sweep
    from photon_ml_tpu_torch.ops.regularization import L2Regularization
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    x, labels, offsets, weights, *_ = _problem()
    trained = train_glm_sweep(
        TaskType.LOGISTIC_REGRESSION,
        _t_data(x, labels, offsets, weights, False), [10.0, 0.1],
        GLMOptimizationConfiguration(
            optimizer=OptimizerType(opt), regularization=L2Regularization,
            optimizer_config=OptimizerConfig(
                max_iterations=50, tolerance=1e-9)))
    for got, tm in zip(two_ranks[0][opt], trained):
        np.testing.assert_allclose(got, tm.model.coefficients.means.numpy(),
                                   atol=2e-3, rtol=2e-2)


# --- host collectives ----------------------------------------------------

def _collectives_rank(rank):
    from photon_ml_tpu_torch.game.data import FeatureShard
    from photon_ml_tpu_torch.stat import FeatureDataStatistics

    rng = np.random.default_rng(rank)
    x, *_ = _problem()
    lo, hi = (0, SPLIT) if rank == 0 else (SPLIT, N)
    r, c, v = _coo(x[lo:hi])
    stats = FeatureDataStatistics.from_shard(
        FeatureShard.from_coo(r, c, v, hi - lo, D)).allreduce()
    return dict(
        int64=tmh.allgather_concat(
            np.arange(3 + 2 * rank, dtype=np.int64) + (1 << 40) * rank),
        f64=tmh.allgather_concat(rng.normal(size=(rank + 1, 3))),
        uint8=tmh.allgather_concat(np.full((rank, 2), 7 + rank, np.uint8)),
        strings=tmh.allgather_concat_strings(
            [f"k{rank}", "ünï", ""] * (rank + 1)),
        text=tmh.allgather_text(f"metrics of {rank}\n"),
        sum=tmh.allreduce_sum(np.array([0.5, rank, -1.0])),
        max=tmh.allreduce_max(np.array([rank, -rank], np.int64)),
        budget=tmh.allreduce_shard_budget(
            tdist.ShardBudget(10 + rank, 8, 16 - rank, 3, 4 * rank)),
        stats={f: getattr(stats, f) for f in (
            "mean", "variance", "min", "max", "max_magnitude",
            "num_nonzeros", "count")},
        index=tmh.process_index(), count=tmh.process_count(),
        chief=tmh.is_chief())


@pytest.fixture(scope="module")
def collectives():
    return run_ranks(_collectives_rank, 2, timeout_s=90)


def _expected_collectives():
    r0, r1 = (np.random.default_rng(r) for r in (0, 1))
    return dict(
        int64=np.concatenate([np.arange(3), np.arange(5) + (1 << 40)]),
        f64=np.concatenate([r0.normal(size=(1, 3)), r1.normal(size=(2, 3))]),
        uint8=np.full((1, 2), 8, np.uint8),
        strings=["k0", "ünï", "", "k1", "ünï", "", "k1", "ünï", ""],
        text=["metrics of 0\n", "metrics of 1\n"],
        sum=np.array([1.0, 1.0, -2.0]),
        max=np.array([1, 0]),
        budget=tdist.ShardBudget(11, 8, 16, 3, 4))


@pytest.mark.parametrize("key", ["int64", "f64", "uint8", "strings", "text",
                                 "sum", "max", "budget"])
def test_host_collective(collectives, key):
    want = _expected_collectives()[key]
    for rank_out in collectives:
        got = rank_out[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want


def test_ranks_know_their_place(collectives):
    assert [(o["index"], o["count"], o["chief"]) for o in collectives] == [
        (0, 2, True), (1, 2, False)]


def test_feature_statistics_allreduce_equals_all_rows(collectives):
    from photon_ml_tpu.game.data import FeatureShard as JShard
    from photon_ml_tpu.stat import FeatureDataStatistics as JStats

    x, *_ = _problem()
    r, c, v = _coo(x)
    want = JStats.from_shard(JShard.from_coo(r, c, v, N, D))
    for rank_out in collectives:
        got = rank_out["stats"]
        assert got["count"] == want.count
        for f in ("mean", "variance", "min", "max", "max_magnitude",
                  "num_nonzeros"):
            np.testing.assert_allclose(got[f], getattr(want, f), rtol=1e-12,
                                       atol=1e-12, err_msg=f)


# --- forming the job -----------------------------------------------------

def _tcp_rank(rank):
    from photon_ml_tpu_torch.parallel import multihost

    joined = multihost.initialize(device="cpu", timeout_s=60)
    return joined, multihost.allreduce_sum(np.array([rank + 1])), \
        multihost.backend()


def test_initialize_over_tcp_from_environment():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = run_ranks(_tcp_rank, 2, timeout_s=90, form_group=False, env={
        "PHOTON_COORDINATOR_ADDRESS": f"localhost:{port}",
        "PHOTON_NUM_PROCESSES": "2"})
    for joined, total, backend in out:
        assert joined and backend == "gloo"
        np.testing.assert_array_equal(total, [3])


@pytest.mark.parametrize("env,missing", [
    ({"PHOTON_COORDINATOR_ADDRESS": "localhost:1"}, "PHOTON_NUM_PROCESSES"),
    ({"PHOTON_NUM_PROCESSES": "2"}, "PHOTON_COORDINATOR_ADDRESS")],
    ids=["no-count", "no-address"])
def test_partial_environment_names_the_missing_variable(monkeypatch, env,
                                                        missing):
    for k in ("PHOTON_COORDINATOR_ADDRESS", "PHOTON_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=f"{missing} is missing"):
        tmh.initialize(device="cpu")


def test_no_environment_is_one_process(monkeypatch):
    for k in ("PHOTON_COORDINATOR_ADDRESS", "PHOTON_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    assert tmh.initialize(device="cpu") is False
    assert (tmh.process_index(), tmh.process_count(), tmh.is_chief()) == (
        0, 1, True)
    x = np.arange(4)
    assert tmh.allgather_concat(x) is x
    assert tmh.allgather_concat_strings(["a"]) == ["a"]


def test_backend_is_explicit(monkeypatch):
    monkeypatch.delenv(tmh.BACKEND_ENV, raising=False)
    assert tmh.resolve_backend("cpu") == "gloo"
    assert tmh.resolve_backend("cuda") == "nccl"
    monkeypatch.setenv(tmh.BACKEND_ENV, "gloo")
    assert tmh.resolve_backend("cuda") == "gloo"
    monkeypatch.setenv(tmh.BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="use 'nccl' or 'gloo'"):
        tmh.resolve_backend("cuda")
    with pytest.raises(ValueError, match="needs CUDA"):
        tmh.resolve_backend("cpu", "nccl")


def test_ranks_sharing_a_card_under_nccl_are_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="PHOTON_DIST_BACKEND=gloo"):
        tmh._check_nccl_layout(2, "cuda", "nccl")
    tmh._check_nccl_layout(1, "cuda", "nccl")
    tmh._check_nccl_layout(2, "cuda", "gloo")


def test_unreachable_coordinator_error_is_actionable(monkeypatch):
    from photon_ml_tpu_torch.resilience import RetryPolicy

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]  # closed again: nothing listens
    with pytest.raises(RuntimeError, match="unreachable from process 1"):
        tmh.initialize(f"localhost:{port}", 2, 1, device="cpu",
                       retry_policy=RetryPolicy(max_attempts=2,
                                                base_delay_s=0.01,
                                                deadline_s=1.0))
    assert tmh.process_count() == 1


# --- runs and test data --------------------------------------------------

def _failing_rank(rank):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def _sleeping_rank(rank):
    import time

    time.sleep(60)


def test_run_ranks_reports_failures_and_times_out():
    with pytest.raises(RuntimeError, match="rank one fails"):
        run_ranks(_failing_rank, 2, timeout_s=60)
    with pytest.raises(TimeoutError, match="gave no result"):
        run_ranks(_sleeping_rank, 1, timeout_s=3)


def test_data_makers_equal_jax():
    from photon_ml_tpu import testing as jt
    from photon_ml_tpu_torch import testing as tt

    got, gx, gy = tt.make_classification(n=50, d=4, seed=3, intercept=True,
                                         weights=True)
    want, wx, wy = jt.make_classification(n=50, d=4, seed=3, intercept=True,
                                          weights=True)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    g_game, g_parts = tt.make_mixed_effect(n=300, n_entities=9, seed=2)
    w_game, w_parts = jt.make_mixed_effect(n=300, n_entities=9, seed=2)
    for a, b in zip(g_parts, w_parts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g_game.labels, w_game.labels)
    for k in ("fixed", "re"):
        for f in ("indptr", "cols", "vals"):
            np.testing.assert_array_equal(
                getattr(g_game.shards[k], f), getattr(w_game.shards[k], f))
    np.testing.assert_array_equal(g_game.id_columns["entityId"],
                                  w_game.id_columns["entityId"])
    tt.assert_allclose_coefficients(torch.ones(3), np.ones(3))
    fd = tt.finite_difference_gradient(lambda w: float((w ** 2).sum()),
                                       np.array([1.0, -2.0]))
    np.testing.assert_allclose(fd, [2.0, -4.0], rtol=1e-6)
