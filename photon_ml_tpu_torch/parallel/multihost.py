"""Multi-process jobs: the process group, host collectives and the per-rank
data feed (counterpart of ``photon_ml_tpu/parallel/multihost.py``).

Every process runs the same program, one process a card. :func:`initialize`
forms the job from the same environment as the JAX package
(``PHOTON_COORDINATOR_ADDRESS``, ``PHOTON_NUM_PROCESSES``,
``PHOTON_PROCESS_ID``): a ``torch.distributed`` process group over a TCP
store at the coordinator address. Two groups serve the job:

- the **default group** carries device tensors only — the ``all_reduce`` of
  each distributed objective evaluation
  (:class:`~photon_ml_tpu_torch.parallel.distributed.DistributedGLMObjective`).
  Its backend is explicit: NCCL on the card, gloo on the
  CPU, or ``PHOTON_DIST_BACKEND`` (``gloo`` lets several ranks share one
  card, which NCCL refuses). Rank ``r`` drives ``cuda:{r % device_count}``;
- one **gloo group**, made once beside it, carries every host collective
  below (gathers of numpy arrays, strings, sums and maxima): gloo on a
  device tensor offers only ``all_reduce`` and ``broadcast``, so gathers go
  through the host, as the JAX package's host allgathers do.

The JAX package's ``make_multihost_mesh`` and ``local_axis_blocks`` have no
counterpart: the process group is the mesh, and each rank feeds exactly one
data block (:func:`global_glm_data_multihost`).

Every collective is the identity in a single process, so the multi-process
code paths run (and are tested) in one process too.
"""

from __future__ import annotations

import atexit
import datetime
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.ops.objective import GLMData
from photon_ml_tpu_torch.parallel.distributed import (
    ShardBudget,
    local_block,
    shard_budget,
    shard_glm_data,
)

#: names the default group's backend (``nccl`` or ``gloo``) where the
#: device's default does not fit, e.g. several ranks on one card
BACKEND_ENV = "PHOTON_DIST_BACKEND"
#: seconds a collective may wait for its peers before the run fails
DEFAULT_TIMEOUT_S = 600.0

_state: dict = {}


def _dist():
    import torch.distributed as dist

    return dist


def resolve_backend(device_type: str, backend: Optional[str] = None) -> str:
    """The default group's backend: ``backend``, else ``PHOTON_DIST_BACKEND``,
    else NCCL for a card and gloo for the CPU. Nothing is switched quietly:
    an unknown name, or NCCL for CPU ranks, raises."""
    name = backend or os.environ.get(BACKEND_ENV) or (
        "nccl" if device_type == "cuda" else "gloo")
    if name not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV}={name!r}: use 'nccl' or 'gloo'")
    if name == "nccl" and device_type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices; ranks on the "
                         "CPU take gloo")
    return name


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device rank ``rank`` drives: ``cuda:{rank % device_count}`` or
    the CPU."""
    if device_type == "cuda":
        from photon_ml_tpu_torch.device import resolve_device

        resolve_device("cuda")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _check_nccl_layout(world: int, device_type: str, backend: str) -> None:
    """NCCL refuses two ranks on one card ("Duplicate GPU detected"): say
    so before the job forms, naming the one setting that lets them share."""
    if backend != "nccl":
        return
    n_dev = torch.cuda.device_count()
    if world > n_dev:
        raise RuntimeError(
            f"{world} ranks over {n_dev} CUDA device(s): the NCCL backend "
            f"needs one card per rank. Run at most {n_dev} ranks, or set "
            f"{BACKEND_ENV}=gloo to let ranks share a card")


def _install(backend: str, device: torch.device) -> None:
    """Record the formed group and make the host (gloo) group beside it."""
    dist = _dist()
    world = dist.get_world_size()
    host = dist.new_group(backend="gloo") if world > 1 else None
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _state.update(backend=backend, device=device, rank=dist.get_rank(),
                  world=world, host_group=host, owned=True)
    atexit.register(shutdown)


def adopt(device_type: str = "cuda") -> None:
    """Take over a process group formed elsewhere (e.g. over a
    ``FileStore`` by :func:`photon_ml_tpu_torch.testing.run_ranks`): the
    device follows the rank and a host group is made beside it."""
    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError("no process group to adopt")
    if _state.get("owned"):
        return
    _install(dist.get_backend(), rank_device(dist.get_rank(), device_type))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: str = "cuda", backend: Optional[str] = None,
               retry_policy=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Form the job (idempotent); True when it has more than one process.

    Resolution order: explicit arguments, then ``PHOTON_COORDINATOR_ADDRESS``
    / ``PHOTON_NUM_PROCESSES`` / ``PHOTON_PROCESS_ID``; with neither, a
    single process. One of the two required variables without the other
    raises, naming the missing one. ``device`` (``"cuda"`` or ``"cpu"``)
    picks the ranks' devices and the default backend
    (:func:`resolve_backend`). ``init_process_group`` runs on a TCP store
    at the coordinator address under ``retry_policy`` (default: the
    process-wide policy), each attempt preceded by a heartbeat and a
    ``collective`` fault point; a coordinator that stays unreachable raises
    a :class:`RuntimeError` naming the address, this process and the
    attempt budget. ``timeout_s`` bounds every collective, so a dead peer
    fails the run instead of hanging it.
    """
    dist = _dist()
    if _state.get("owned"):
        return _state["world"] > 1
    if dist.is_initialized():
        adopt(device)
        return _state["world"] > 1
    if coordinator_address is None and num_processes is None:
        coordinator_address = os.environ.get("PHOTON_COORDINATOR_ADDRESS")
        n = os.environ.get("PHOTON_NUM_PROCESSES")
        if bool(coordinator_address) != bool(n):
            missing = ("PHOTON_NUM_PROCESSES" if coordinator_address
                       else "PHOTON_COORDINATOR_ADDRESS")
            raise ValueError(
                f"multi-host environment is partially set: {missing} is "
                "missing — set both PHOTON_COORDINATOR_ADDRESS and "
                "PHOTON_NUM_PROCESSES (or neither, for single-host)")
        num_processes = int(n) if n else None
        pid = os.environ.get("PHOTON_PROCESS_ID")
        process_id = int(pid) if pid else process_id
        if coordinator_address is None and num_processes is None:
            return False  # single process
    if process_id is None:
        raise ValueError("PHOTON_PROCESS_ID (this process's rank) is not set")
    name = resolve_backend(device, backend)
    _check_nccl_layout(int(num_processes), device, name)
    dev = rank_device(int(process_id), device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    from photon_ml_tpu_torch.resilience import (
        fault_point,
        get_default_policy,
        heartbeat,
        retry,
    )

    policy = retry_policy if retry_policy is not None \
        else get_default_policy()
    budget = timeout_s
    if policy.deadline_s is not None:
        budget = max(1.0, policy.deadline_s / policy.max_attempts)
    attempts = [0]

    def attempt() -> None:
        attempts[0] += 1
        heartbeat("initialize")
        fault_point("collective", op="initialize",
                    coordinator=coordinator_address)
        if process_id != 0 and ":" in coordinator_address:
            # a worker may start before the coordinator: wait for its
            # store within this attempt's budget, so an unreachable one
            # fails here with the actionable error below
            import socket

            from photon_ml_tpu_torch.resilience.retry import _sleep

            host, port = coordinator_address.rsplit(":", 1)
            t_start = time.monotonic()
            while True:
                try:
                    socket.create_connection(
                        (host, int(port)), timeout=min(budget, 10)).close()
                    break
                except OSError:
                    if time.monotonic() - t_start >= budget:
                        raise
                    _sleep(0.2)
        dist.init_process_group(
            backend=name, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s))

    t0 = time.monotonic()
    try:
        retry(attempt, policy, name="multihost.initialize")
    except Exception as e:
        raise RuntimeError(
            f"could not join the multi-process job: coordinator "
            f"{coordinator_address!r} unreachable from process "
            f"{process_id} of {num_processes} after {attempts[0]} "
            f"attempt(s) over {time.monotonic() - t0:.1f}s (deadline "
            f"{policy.deadline_s}s, max attempts {policy.max_attempts}). "
            f"Check that the coordinator process is up, "
            f"PHOTON_COORDINATOR_ADDRESS is its reachable host:port, and "
            f"every process agrees on PHOTON_NUM_PROCESSES; last error: "
            f"{e!r}") from e
    _install(name, dev)
    return _state["world"] > 1


def shutdown() -> None:
    """Leave the job (a no-op when this module did not form one)."""
    dist = _dist()
    if _state.pop("owned", False) and dist.is_initialized():
        dist.destroy_process_group()
    _state.clear()


def process_index() -> int:
    return _state.get("rank", 0)


def process_count() -> int:
    return _state.get("world", 1)


def is_chief() -> bool:
    """True on the process that writes outputs: process 0 writes, every
    process computes."""
    return process_index() == 0


def backend() -> Optional[str]:
    """The default group's backend, None in a single process."""
    return _state.get("backend")


def local_device(default=None) -> torch.device:
    """This rank's device; in a single process ``default`` resolved
    (``cuda`` unless the caller passes ``"cpu"``)."""
    if "device" in _state:
        return _state["device"]
    from photon_ml_tpu_torch.device import resolve_device

    return resolve_device(default)


def device_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the default group, in place: the distributed
    objective's one collective. A job of one process still makes the call
    (NCCL's identity); without a job it is the identity."""
    if _state.get("owned"):
        _dist().all_reduce(t)
    return t


# ---------------------------------------------------------------------------
# Host collectives (the gloo group)
# ---------------------------------------------------------------------------


def barrier() -> None:
    """Wait for every process (a no-op in one process): the drivers end on
    one, so a process returns only once the chief's outputs are written."""
    if process_count() > 1:
        from photon_ml_tpu_torch.resilience import heartbeat

        heartbeat("collective")
        _dist().barrier(group=_state["host_group"])


def _gather_stack(x: np.ndarray) -> list[np.ndarray]:
    """Every process's ``x`` in process order. Leading lengths may differ
    (trailing shapes must agree): the byte sizes are gathered first, each
    payload padded to the largest, gathered as bytes, then trimmed — so any
    dtype rides exactly, 64-bit keys and f64 included.

    A heartbeat and a ``collective`` fault point mark the boundary: a
    process whose peer died blocks inside the gather with this beat as its
    last sign of life, the staleness the fleet supervisor reads. Never
    retried: one process retrying a collective alone would desync the rest.
    """
    from photon_ml_tpu_torch.resilience import fault_point, heartbeat

    dist = _dist()
    heartbeat("collective")
    fault_point("collective", op="allgather", shape=tuple(x.shape))
    x = np.ascontiguousarray(x)
    group = _state["host_group"]
    n = process_count()
    raw = torch.from_numpy(x.reshape(-1).view(np.uint8).copy())
    size = torch.tensor([raw.numel()], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s.item()) for s in sizes]
    m = max(sizes)
    tail = x.shape[1:]
    if m == 0:
        return [np.zeros((0,) + tail, x.dtype) for _ in range(n)]
    buf = torch.zeros(m, dtype=torch.uint8)
    buf[:raw.numel()] = raw
    outs = [torch.empty(m, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(outs, buf, group=group)
    return [outs[p][:sizes[p]].numpy().view(x.dtype).reshape((-1,) + tail)
            for p in range(n)]


def allreduce_shard_budget(local: ShardBudget) -> ShardBudget:
    """Field-wise max of every process's :class:`ShardBudget`, so all ranks
    build identically shaped blocks (a larger budget only adds inert
    padding)."""
    if process_count() == 1:
        return local
    return ShardBudget.from_array(allreduce_max(local.to_array()))


def allgather_concat(x: np.ndarray) -> np.ndarray:
    """Every process's array concatenated along axis 0 in process order
    (identity in one process): the host collective behind the row shuffle
    and model assembly."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    return np.concatenate(_gather_stack(x), axis=0)


def allreduce_sum(x: np.ndarray) -> np.ndarray:
    """Element-wise sum over processes, added in process order (identity in
    one process)."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    return np.sum(np.stack(_gather_stack(x)), axis=0).astype(x.dtype)


def allreduce_max(x: np.ndarray) -> np.ndarray:
    """Element-wise max over processes (identity in one process)."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    return np.max(np.stack(_gather_stack(x)), axis=0).astype(x.dtype)


def allgather_concat_strings(strings: Sequence[str]) -> list[str]:
    """Every process's strings concatenated in process order (identity in
    one process): a lengths gather and one utf-8 byte gather."""
    strings = list(strings)
    if process_count() == 1:
        return strings
    data = [s.encode("utf-8") for s in strings]
    lens = allgather_concat(np.array([len(b) for b in data], np.int64))
    buf = allgather_concat(np.frombuffer(b"".join(data), np.uint8).copy())
    out, off = [], 0
    for ln in lens:
        ln = int(ln)
        out.append(bytes(buf[off:off + ln]).decode("utf-8"))
        off += ln
    return out


def allgather_text(text: str) -> list[str]:
    """Every process's ``text`` in process order (identity in one
    process)."""
    return allgather_concat_strings([text])


# ---------------------------------------------------------------------------
# Per-rank data feed
# ---------------------------------------------------------------------------


def global_glm_data_multihost(host_data: GLMData, device=None) -> GLMData:
    """This rank's block of the global row layout, on its device: its own
    rows (a host :class:`GLMData`, dense, CSR or factored design) padded
    with weight-0 rows to the row count every rank agreed on, and a sparse
    design's chunk widths and counts agreed the same way.

    Two agreement rounds, both unconditional (every rank calls every
    collective): the bucket geometry first (rows per block, chunk widths),
    then the chunk counts re-measured at that geometry — padding to a
    larger count is always legal, so no third round is needed."""
    local = shard_glm_data(host_data, 1)
    b0 = shard_budget(local)
    geo = allreduce_shard_budget(b0)
    if (geo.rows_per_shard, geo.row_chunk, geo.col_chunk) != (
            b0.rows_per_shard, b0.row_chunk, b0.col_chunk):
        local = shard_glm_data(host_data, 1, budget=ShardBudget(
            rows_per_shard=geo.rows_per_shard, row_chunk=geo.row_chunk,
            col_chunk=geo.col_chunk))
    b1 = shard_budget(local)
    final = allreduce_shard_budget(b1)
    if final != b1:
        local = shard_glm_data(host_data, 1, budget=final)
    return global_glm_data_from_local(local, device)


def global_glm_data_from_local(local: GLMData, device=None) -> GLMData:
    """The rank's one block of a stacked layout from
    :func:`~photon_ml_tpu_torch.parallel.distributed.shard_glm_data`
    (``n_shards=1``, built at the agreed budget) on ``device`` (this
    rank's device unless given)."""
    n_blocks = int(local.labels.shape[0])
    if n_blocks != 1:
        raise ValueError(
            f"local stack has {n_blocks} blocks; one process feeds one "
            f"block — build with shard_glm_data(data, 1)")
    return local_block(local, 0, local_device() if device is None
                       else torch.device(device))
