"""Fleet supervision: heartbeat liveness and restart from checkpoint
(counterpart of ``photon_ml_tpu/resilience/supervisor.py``).

In-process resilience (retry, divergence rollback, symmetric fault plans)
covers faults every process sees together. One process of a multi-process
job dying or stalling inside a collective is the asymmetric rest: the
survivors wait in their next collective and no process can recover the job.
:class:`FleetSupervisor` owns the fleet's lifecycle instead: it launches the
N training processes, watches them, and on any failure kills the survivors
and relaunches the WHOLE fleet, which resumes from the latest agreed
checkpoint, under a restart budget with exponential backoff and a deadline.

Liveness signals:

- **exit**: any nonzero exit (a crash, ``os._exit``, an OOM kill) fails the
  attempt at once; success is every process exiting 0;
- **heartbeat**: each process touches its file (``PHOTON_HEARTBEAT_FILE``,
  :func:`~photon_ml_tpu_torch.resilience.heartbeat.heartbeat`) at sweep,
  coordinate-step, lambda, read and collective boundaries; a file older than
  ``heartbeat_timeout_s`` declares its process stalled. A healthy
  collective does not beat while inside it, so size the timeout from the
  sweep wall.

Recovery posts ``supervisor_*`` events on the bus. This module is the only
one of the package that spawns or signals processes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

from photon_ml_tpu_torch.resilience.heartbeat import HEARTBEAT_ENV, heartbeat

logger = logging.getLogger(__name__)

__all__ = ["FleetExhaustedError", "FleetResult", "FleetSupervisor",
           "HEARTBEAT_ENV", "RESTART_COUNT_ENV", "RESULT_ENV",
           "SupervisorPolicy", "heartbeat", "strip_supervision_flags",
           "supervise_from_args", "write_result_file"]

#: where the chief driver writes its result dict as JSON
RESULT_ENV = "PHOTON_RESULT_FILE"
#: which supervisor attempt a process belongs to (0 = first launch)
RESTART_COUNT_ENV = "PHOTON_RESTART_COUNT"


def write_result_file(result: dict) -> None:
    """Driver side: the run's result dict where the supervisor asked for it
    (``PHOTON_RESULT_FILE``; a no-op unsupervised), written atomically."""
    path = os.environ.get(RESULT_ENV)
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, path)


@dataclasses.dataclass(frozen=True)
class SupervisorPolicy:
    """Restart budget and liveness thresholds. ``max_restarts`` bounds
    restarts (0: launch once); ``heartbeat_timeout_s`` None disables stall
    detection; ``deadline_s`` is the wall over every attempt and backoff
    (the supervisor never sleeps into a deadline it would then miss)."""

    max_restarts: int = 2
    heartbeat_timeout_s: Optional[float] = 300.0
    deadline_s: Optional[float] = None
    poll_interval_s: float = 0.2
    grace_s: float = 5.0
    base_backoff_s: float = 0.5
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 30.0

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}")
        if (self.heartbeat_timeout_s is not None
                and self.heartbeat_timeout_s <= 0):
            raise ValueError(
                f"heartbeat_timeout_s must be > 0 or None, "
                f"got {self.heartbeat_timeout_s}")


@dataclasses.dataclass
class FleetResult:
    """One supervised run: the chief's result payload (when it wrote one)
    and the recovery accounting."""

    restarts: int
    attempts: int
    result: Optional[dict]


class FleetExhaustedError(RuntimeError):
    """The fleet kept failing past its restart budget or deadline."""


@dataclasses.dataclass(frozen=True)
class _Fault:
    reason: str  # "exit" or "stall"
    process: int
    returncode: Optional[int] = None
    heartbeat_age_s: Optional[float] = None


def _free_loopback_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class FleetSupervisor:
    """Launch, watch and restart one N-process training fleet.

    ``command`` is the argv every process runs. Each process gets
    ``PHOTON_PROCESS_ID``, ``PHOTON_HEARTBEAT_FILE``,
    ``PHOTON_RESTART_COUNT``, ``PHOTON_RESULT_FILE`` (the chief only) and, at
    ``n_processes > 1``, ``PHOTON_COORDINATOR_ADDRESS`` /
    ``PHOTON_NUM_PROCESSES`` with a fresh loopback port per attempt (the
    dead attempt's port may linger in TIME_WAIT). ``run_dir`` receives the
    heartbeat files and per-attempt logs (``attempt-K/proc-I.log``), which
    the exhaustion error quotes."""

    def __init__(self, command: Sequence[str], n_processes: int,
                 run_dir: str, policy: SupervisorPolicy = SupervisorPolicy(),
                 *, env: Optional[dict] = None, bus=None):
        if n_processes < 1:
            raise ValueError(f"n_processes must be >= 1, got {n_processes}")
        self.command = list(command)
        self.n_processes = int(n_processes)
        self.run_dir = run_dir
        self.policy = policy
        self.base_env = dict(os.environ if env is None else env)
        if bus is None:
            from photon_ml_tpu_torch.events import GLOBAL_BUS as bus
        self.bus = bus
        self.restarts = 0
        self._procs: list[subprocess.Popen] = []
        self._hb_files: list[str] = []
        self._spawn_t = 0.0

    def run(self) -> FleetResult:
        """Supervise to completion: returns on an all-zero exit, raises
        :class:`FleetExhaustedError` past the budget or deadline."""
        from photon_ml_tpu_torch.resilience.retry import _sleep
        from photon_ml_tpu_torch.telemetry import tracing

        os.makedirs(self.run_dir, exist_ok=True)
        result_path = os.path.join(self.run_dir, "result.json")
        t0 = time.monotonic()
        attempt = 0
        self.bus.post("supervisor_started", processes=self.n_processes,
                      max_restarts=self.policy.max_restarts,
                      command=" ".join(self.command))
        with tracing.span("supervisor.run", processes=self.n_processes):
            while True:
                with tracing.span("supervisor.attempt", attempt=attempt):
                    self._spawn(attempt, result_path)
                    try:
                        fault = self._watch(t0)
                    except BaseException:
                        self._kill_fleet()
                        raise
                    if fault is None:
                        self.bus.post("supervisor_completed",
                                      attempts=attempt + 1,
                                      restarts=self.restarts,
                                      elapsed_s=time.monotonic() - t0)
                        return FleetResult(
                            restarts=self.restarts, attempts=attempt + 1,
                            result=self._read_result(result_path))
                    self.bus.post("supervisor_fault_detected",
                                  attempt=attempt, reason=fault.reason,
                                  process=fault.process,
                                  returncode=fault.returncode,
                                  heartbeat_age_s=fault.heartbeat_age_s)
                    logger.warning(
                        "fleet fault (attempt %d): %s on process %d (rc=%s, "
                        "heartbeat age %s)", attempt, fault.reason,
                        fault.process, fault.returncode,
                        fault.heartbeat_age_s)
                    self._kill_fleet()
                backoff = min(self.policy.base_backoff_s
                              * self.policy.backoff_multiplier ** attempt,
                              self.policy.max_backoff_s)
                elapsed = time.monotonic() - t0
                over_deadline = (
                    self.policy.deadline_s is not None
                    and elapsed + backoff >= self.policy.deadline_s)
                if attempt >= self.policy.max_restarts or over_deadline:
                    self.bus.post("supervisor_exhausted",
                                  attempts=attempt + 1,
                                  restarts=self.restarts,
                                  deadline_hit=over_deadline,
                                  elapsed_s=elapsed)
                    raise FleetExhaustedError(
                        f"fleet failed {attempt + 1} time(s) over "
                        f"{elapsed:.1f}s ({fault.reason} on process "
                        f"{fault.process}"
                        + (f", rc={fault.returncode}"
                           if fault.returncode is not None else "")
                        + (f"; deadline {self.policy.deadline_s}s hit"
                           if over_deadline else
                           f"; restart budget {self.policy.max_restarts} "
                           f"spent")
                        + "); last logs:\n" + self._log_tails(attempt))
                self.restarts += 1
                self.bus.post("supervisor_restart", attempt=attempt + 1,
                              backoff_s=backoff, reason=fault.reason)
                _sleep(backoff)
                attempt += 1

    def _spawn(self, attempt: int, result_path: str) -> None:
        port = _free_loopback_port() if self.n_processes > 1 else None
        attempt_dir = os.path.join(self.run_dir, f"attempt-{attempt}")
        os.makedirs(attempt_dir, exist_ok=True)
        self._procs, self._hb_files = [], []
        self._spawn_t = time.monotonic()
        for pid in range(self.n_processes):
            hb = os.path.join(self.run_dir, f"proc-{pid}.heartbeat")
            # pre-touched: staleness counts from the spawn
            with open(hb, "w") as f:
                f.write(f"attempt-{attempt}")
            env = dict(self.base_env)
            env["PHOTON_PROCESS_ID"] = str(pid)
            env[RESTART_COUNT_ENV] = str(attempt)
            env[HEARTBEAT_ENV] = hb
            if pid == 0:
                env[RESULT_ENV] = result_path
            else:
                env.pop(RESULT_ENV, None)
            if port is not None:
                env["PHOTON_COORDINATOR_ADDRESS"] = f"localhost:{port}"
                env["PHOTON_NUM_PROCESSES"] = str(self.n_processes)
            log = open(os.path.join(attempt_dir, f"proc-{pid}.log"), "w")
            try:
                proc = subprocess.Popen(
                    self.command, env=env, stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True)
            finally:
                log.close()  # the child holds its own descriptor
            self._procs.append(proc)
            self._hb_files.append(hb)

    def _watch(self, t0: float) -> Optional[_Fault]:
        """None on an all-zero exit, a :class:`_Fault` on the first nonzero
        exit or stale heartbeat; raises on the deadline."""
        from photon_ml_tpu_torch.resilience.retry import _sleep

        while True:
            rcs = [p.poll() for p in self._procs]
            for pid, rc in enumerate(rcs):
                if rc is not None and rc != 0:
                    return _Fault(reason="exit", process=pid, returncode=rc)
            if all(rc == 0 for rc in rcs):
                return None
            if self.policy.heartbeat_timeout_s is not None:
                now = time.time()
                for pid, rc in enumerate(rcs):
                    if rc is not None:
                        continue
                    try:
                        age = now - os.stat(self._hb_files[pid]).st_mtime
                    except OSError:
                        age = time.monotonic() - self._spawn_t
                    if age > self.policy.heartbeat_timeout_s:
                        return _Fault(reason="stall", process=pid,
                                      heartbeat_age_s=age)
            if (self.policy.deadline_s is not None
                    and time.monotonic() - t0 > self.policy.deadline_s):
                self._kill_fleet()
                self.bus.post("supervisor_exhausted",
                              attempts=self.restarts + 1,
                              restarts=self.restarts, deadline_hit=True,
                              elapsed_s=time.monotonic() - t0)
                raise FleetExhaustedError(
                    f"fleet ran past the {self.policy.deadline_s}s "
                    f"deadline; killed. Last logs:\n"
                    + self._log_tails(self.restarts))
            _sleep(self.policy.poll_interval_s)

    def _kill_fleet(self) -> None:
        """SIGTERM every survivor, a grace period, then SIGKILL: survivors
        typically wait inside a collective and cannot exit alone."""
        from photon_ml_tpu_torch.resilience.retry import _sleep

        for p in self._procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + self.policy.grace_s
        while (any(p.poll() is None for p in self._procs)
               and time.monotonic() < deadline):
            _sleep(min(0.05, self.policy.poll_interval_s))
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
                p.wait()

    def _read_result(self, path: str) -> Optional[dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _log_tails(self, attempt: int, n_bytes: int = 2000) -> str:
        out = []
        for pid in range(self.n_processes):
            path = os.path.join(self.run_dir, f"attempt-{attempt}",
                                f"proc-{pid}.log")
            try:
                with open(path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    f.seek(max(0, f.tell() - n_bytes))
                    tail = f.read().decode("utf-8", "replace")
            except OSError:
                tail = "<no log>"
            out.append(f"--- process {pid} ({path}) ---\n{tail}")
        return "\n".join(out)


#: supervision flags stripped from the workers' command (workers train,
#: they do not supervise)
_SUPERVISION_FLAGS = ("--supervise", "--max-restarts",
                      "--heartbeat-timeout-s", "--restart-deadline-s")


def strip_supervision_flags(argv: Sequence[str]) -> list[str]:
    out: list[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in _SUPERVISION_FLAGS:
            skip = True
            continue
        if any(a.startswith(f + "=") for f in _SUPERVISION_FLAGS):
            continue
        out.append(a)
    return out


def add_supervision_flags(parser) -> None:
    """``--supervise N`` and its policy flags, as the JAX drivers have
    them."""
    parser.add_argument(
        "--supervise", type=int, default=0, metavar="N",
        help="run N training processes under the fleet supervisor "
             "(restart from checkpoint on a crash or stall)")
    parser.add_argument("--max-restarts", type=int, default=2)
    parser.add_argument("--heartbeat-timeout-s", type=float, default=300.0,
                        help="declare a process stalled after this long "
                             "without a heartbeat (0 disables)")
    parser.add_argument("--restart-deadline-s", type=float, default=None,
                        help="wall-clock budget over every attempt")


def supervise_from_args(driver: str, raw_argv: Sequence[str], args,
                        *, worker_flags: Sequence[str] = ()) -> dict:
    """A driver's ``--supervise N``: relaunch this command (without the
    supervision flags, with ``worker_flags``, e.g. ``--checkpoint --resume
    --multihost``) as an N-process supervised fleet; returns the chief's
    result dict with a ``restarts`` count."""
    command = [sys.executable, "-m", "photon_ml_tpu_torch", driver]
    command += strip_supervision_flags(raw_argv)
    for f in worker_flags:
        if f not in command:
            command.append(f)
    hb = args.heartbeat_timeout_s
    policy = SupervisorPolicy(
        max_restarts=args.max_restarts,
        heartbeat_timeout_s=(hb if hb and hb > 0 else None),
        deadline_s=args.restart_deadline_s)
    # the workers import this package from where the supervisor did
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    fleet = FleetSupervisor(command, args.supervise,
                            os.path.join(args.output_dir, "supervisor"),
                            policy, env=env).run()
    out = dict(fleet.result or {})
    out.setdefault("output_dir", args.output_dir)
    out["restarts"] = fleet.restarts
    return out
