"""Test utilities (counterpart of ``photon_ml_tpu/testing.py``, the
reference's ``photon-test-utils``).

The data makers give the same arrays as the JAX package's for the same
seeds. In place of its ``virtual_devices`` (a simulated device mesh in one
process), :func:`run_ranks` runs a function in N spawned processes joined
in one gloo process group over a ``FileStore`` — the real multi-process
code paths, on the CPU or on the card — with a time limit on every run, so
a rank that hangs fails the caller instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch


def make_classification(n: int = 500, d: int = 10, seed: int = 0,
                        intercept: bool = False, weights: bool = False,
                        device="cpu"):
    """Random logistic problem → (GLMData, x, labels), f64 on ``device``."""
    from photon_ml_tpu_torch.ops.design import DenseDesign
    from photon_ml_tpu_torch.ops.objective import GLMData

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    margins = x @ w
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-margins))).astype(
        np.float64)
    if intercept:
        x = np.concatenate([x, np.ones((n, 1))], axis=1)
    wts = rng.uniform(0.5, 2.0, size=n) if weights else np.ones(n)

    def put(a):
        return torch.as_tensor(a, device=device)

    data = GLMData(design=DenseDesign(x=put(x)), labels=put(labels),
                   offsets=put(np.zeros(n)), weights=put(wts))
    return data, x, labels


def dense_shard(x: np.ndarray):
    """A dense ``(n, d)`` matrix as a :class:`FeatureShard`."""
    from photon_ml_tpu_torch.game.data import FeatureShard

    nn, dd = x.shape
    return FeatureShard.from_coo(
        np.repeat(np.arange(nn), dd),
        np.tile(np.arange(dd, dtype=np.int32), nn),
        np.array(x, np.float32).ravel(), nn, dd)


def make_mixed_effect(n: int = 2000, d_fixed: int = 8, d_re: int = 4,
                      n_entities: int = 37, seed: int = 0,
                      param_seed: int = 12345,
                      entity_column: str = "entityId"):
    """Mixed-effect logistic GameData (a global effect and per-entity
    slopes, power-law entity sizes)."""
    from photon_ml_tpu_torch.game.data import GameData

    prng = np.random.default_rng(param_seed)
    w_fixed = prng.normal(size=d_fixed).astype(np.float32)
    u = (1.5 * prng.normal(size=(n_entities, d_re))).astype(np.float32)
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(n, d_fixed)).astype(np.float32)
    xr = rng.normal(size=(n, d_re)).astype(np.float32)
    probs = 1.0 / np.arange(1, n_entities + 1)
    probs /= probs.sum()
    ent = rng.choice(n_entities, size=n, p=probs).astype(np.int64)
    margin = xf @ w_fixed + np.einsum("nd,nd->n", xr, u[ent])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    data = GameData.build(
        labels=y, shards={"fixed": dense_shard(xf), "re": dense_shard(xr)},
        id_columns={entity_column: ent})
    return data, (xf, xr, ent, w_fixed, u)


def assert_allclose_coefficients(actual, desired, *, atol: float = 1e-6,
                                 rtol: float = 1e-5,
                                 err_msg: str = "") -> None:
    """Tolerance compare for coefficient vectors (numpy or tensors)."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    np.testing.assert_allclose(host(actual), host(desired), atol=atol,
                               rtol=rtol, err_msg=err_msg)


def finite_difference_gradient(fun, w: np.ndarray, eps: float = 1e-6
                               ) -> np.ndarray:
    """Central-difference gradient of ``fun`` at ``w``."""
    w = np.asarray(w, np.float64)
    g = np.zeros_like(w)
    for i in range(w.size):
        dw = np.zeros_like(w)
        dw[i] = eps
        g[i] = (float(fun(w + dw)) - float(fun(w - dw))) / (2 * eps)
    return g


# ---------------------------------------------------------------------------
# N ranks in spawned processes
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, n, store, backend, device, timeout_s, env,
               threads, args, out) -> None:
    """One rank: join the group (unless ``store`` is None: ``fn`` forms
    it), adopt it, run ``fn``, report."""
    import torch.distributed as dist

    from photon_ml_tpu_torch.parallel import multihost

    os.environ.update(env)
    os.environ["PHOTON_PROCESS_ID"] = str(rank)
    torch.set_num_threads(threads)
    try:
        if store is not None:
            dist.init_process_group(
                backend, init_method=f"file://{store}", rank=rank,
                world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
            multihost.adopt(device)
        # pickled here, in-band: the queue's own pickler would pass a
        # tensor's storage as a file descriptor, which dies with this
        # process
        out.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        multihost.shutdown()


def run_ranks(fn: Callable, n: int, *args, backend: str = "gloo",
              device: str = "cpu", timeout_s: float = 120.0,
              env: Optional[dict] = None, threads: int = 1,
              form_group: bool = True) -> list:
    """``[fn(rank, *args) for rank in range(n)]``, each call in its own
    spawned process, the N joined in one process group (``backend``, gloo
    by default) over a ``FileStore`` and adopted by
    :mod:`~photon_ml_tpu_torch.parallel.multihost` on ``device`` (``"cpu"``,
    or ``"cuda"`` for rank ``r`` on ``cuda:{r % device_count}``), so
    ``multihost.initialize`` inside ``fn`` (e.g. a CLI's ``--multihost``)
    joins it. ``fn`` must be importable by name (module level) and its
    result picklable. ``env`` is set in every rank, ``PHOTON_PROCESS_ID``
    to its rank; with ``form_group=False`` no group is formed and ``fn``
    forms its own (e.g. ``multihost.initialize`` from a ``PHOTON_*``
    environment over TCP). Raises with the failing ranks' tracebacks, or — after
    ``timeout_s`` — kills every rank and raises :class:`TimeoutError`."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="photon_ranks_")
    out = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, r, n, os.path.join(tmp, "store") if form_group else None,
              backend, device,
              timeout_s, dict(env or {}), threads, args, out))
        for r in range(n)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{n - len(results)} of {n} ranks gave no result within "
                    f"{timeout_s:g} s (done: {sorted(results)})")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank(s) {dead} died (exit codes "
                        f"{[procs[r].exitcode for r in dead]})")
                continue
            results[rank] = (ok, value)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    failed = {r: v for r, (ok, v) in results.items() if not ok}
    if failed:
        raise RuntimeError("rank(s) failed:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items())))
    return [pickle.loads(results[r][1]) for r in range(n)]
