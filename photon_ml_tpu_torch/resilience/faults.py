"""Deterministic, seedable fault injection.

A copy of ``photon_ml_tpu/resilience/faults.py`` (host only). The sites
the port threads today are ``ckpt.save``, ``io.delta_publish`` and
``optimizer.step``; the others are listed for plans shared with the JAX
package. On a device tensor, ``fault_value``'s ``mode="nan"`` multiplies by
NaN where the tensor lies, so the corruption happens on the card.

A :class:`FaultPlan` names *injection sites* — fixed strings the framework
threads through its hot paths as :func:`fault_point` / :func:`fault_value`
calls — and decides, deterministically, which invocations of each site
misbehave. The registered sites:

========================  ====================================================
``io.read``               one visit per (file, attempt) in the Avro readers
``ckpt.save``             one visit per save attempt, *between* the tmp write
                          and the atomic rename — the crash-mid-write window
``io.model_save``         one visit per model-publish attempt, between the
                          fully-written staging tree and the atomic
                          retire-then-rename (``io/pipeline.py``) — the
                          background saver's crash window
``io.delta_publish``      the continuous-training delta path: one visit per
                          patch-publish attempt (``io/pipeline.py::
                          save_model_patch_atomic``, same crash window as
                          ``io.model_save``) and one per patch ACTIVATION
                          (``serving/registry.py::load_patch``, after
                          validation, before the version registers) — a
                          fault in either leaves the previously active
                          version serving with no partial patch visible
``collective``            host-side collectives (allgather/allreduce) and
                          ``jax.distributed.initialize``
``optimizer.step``        one visit per coordinate-descent coordinate step
                          (value hook: ``mode="nan"`` corrupts the scores)
``worker.stall``          one visit per sweep (``mode="stall"`` sleeps;
                          ``mode="kill"`` dies abruptly — the supervised-
                          recovery crash site)
``serving.parse``         one visit per POST parse in the serving front end
                          (``serving/http.py``) — a fault surfaces as a 500
                          on that request only
``serving.execute``       one visit per scoring call
                          (``serving/engine.py::ScoringEngine.score``) — a
                          fault fails that batch's requests; the batcher
                          worker and every other request survive
``serving.reload``        one visit per ``/reload``/watch-dir activation
                          attempt (``serving/registry.py::reload``) — a
                          fault rejects the candidate and the incumbent
                          keeps serving
``serving.watch_tick``    one visit per watch-dir poll
                          (``serving/watcher.py::scan_once``) — the poll
                          loop retries next tick, no candidate is lost
``io.save.reqlog``        one visit per request-log segment write on the
                          background pool (``serving/reqlog.py``) — a
                          fault counts the segment as dropped (loss, not
                          retention) and never disturbs traffic
``fleet.fanout``          one visit per per-host leg of a fleet-router
                          fan-out (``fleet/router.py::HostClient``) — a
                          fault surfaces as that host being unreachable:
                          the router maps it to a typed 503
                          (``reason=upstream``) for the affected request
                          and a two-phase reload epoch ABORTS with the
                          incumbent serving fleet-wide
``fleet.replica``         one visit per replica retry/hedge launch inside a
                          shard's replica group (``fleet/router.py::
                          FleetRouter._fanout_leg``) — a fault fails that
                          backup launch: the leg falls back to the remaining
                          replicas, or surfaces as a typed 503
                          (``reason=upstream``) when the rotation is
                          exhausted
``feedback.join``         one visit per feedback-join pass
                          (``feedback/joiner.py::join_feedback``) — a fault
                          aborts that join cleanly (counted in
                          ``photon_feedback_aborts_total{stage=join}`` when
                          the autopilot drove it); serving and the request
                          log are untouched and the next drift event retries
``feedback.refresh_launch``  one visit per autopilot refresh launch
                          (``feedback/autopilot.py``), before any join or
                          refresh work — a fault aborts the launch with the
                          incumbent serving; a wedged or faulted refresh
                          never blocks the score path
========================  ====================================================

Activation is explicit only: :func:`activate` / the :func:`injected` context
manager, or the ``PHOTON_FAULT_PLAN`` environment variable (a JSON object or
an ``@/path/to/plan.json`` reference) read once at import. With no active
plan every hook returns after a single module-global ``is None`` check, so
production paths pay nothing.

Determinism: explicit ``at`` invocation indices always fire; ``rate`` draws
ride a per-site ``numpy`` generator seeded from ``(plan.seed, crc32(site))``,
so two plans built from the same spec fire identically — what makes a chaos
sweep reproducible and a bisection meaningful.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Any, Mapping, Optional, Sequence

import numpy as np

# the one crc32 home: seeds each site's generator
from photon_ml_tpu_torch.fleet.sharding import stable_hash_u32

#: canonical site names (free-form strings are accepted; these are the ones
#: the framework threads)
SITES = ("io.read", "ckpt.save", "io.model_save", "io.delta_publish",
         "collective", "optimizer.step", "worker.stall",
         "serving.parse", "serving.execute", "serving.reload",
         "serving.watch_tick", "io.save.reqlog", "fleet.fanout",
         "fleet.replica", "feedback.join", "feedback.refresh_launch")

_MODES = ("raise", "nan", "stall", "kill")


def _process_index() -> int:
    """This process's fleet index, for ``FaultSpec.processes`` gating.
    ``PHOTON_PROCESS_ID`` (set by the fleet supervisor and by manual
    multi-controller launches) wins; 0 when unset — single-process runs
    and in-process tests are process 0."""
    try:
        return int(os.environ.get("PHOTON_PROCESS_ID", "0"))
    except ValueError:
        return 0


def _restart_count() -> int:
    """Which supervisor attempt this process belongs to (0 = first
    launch), for ``FaultSpec.attempts`` gating."""
    try:
        return int(os.environ.get("PHOTON_RESTART_COUNT", "0"))
    except ValueError:
        return 0


class InjectedFault(RuntimeError):
    """The exception raised by ``mode="raise"`` specs (retryable)."""

    def __init__(self, site: str, index: int, message: str = ""):
        self.site = site
        self.index = index
        super().__init__(
            message or f"injected fault at site {site!r} (invocation "
                       f"#{index})")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One rule: which invocations of ``site`` misbehave, and how.

    ``at`` lists explicit 0-based invocation indices; ``rate`` adds a
    seeded per-invocation probability on top. ``max_fires`` caps total
    firings (None = unlimited). ``mode``: ``"raise"`` raises
    :class:`InjectedFault`; ``"nan"`` corrupts the value passing through a
    :func:`fault_value` hook; ``"stall"`` sleeps ``stall_seconds`` (through
    the retry module's sanctioned sleep); ``"kill"`` terminates the process
    abruptly with ``exit_code`` (``os._exit`` — no cleanup, no atexit: the
    crash the fleet supervisor exists to recover from).

    ``processes`` restricts the spec to specific process indices
    (``PHOTON_PROCESS_ID``, 0 when unset) — the ASYMMETRIC fault class:
    unlike the symmetric default, a process-restricted spec fires on some
    processes only, so it must simulate faults the surviving processes
    cannot recover from in-process (kill/stall), not divergences the
    lockstep guard handles. ``attempts`` restricts to specific supervisor
    restart attempts (``PHOTON_RESTART_COUNT``, 0 when unset) — a kill
    gated ``attempts=(0,)`` fires on the first launch only, so the
    restarted fleet completes instead of dying deterministically forever.
    """

    site: str
    at: tuple[int, ...] = ()
    rate: float = 0.0
    max_fires: Optional[int] = None
    mode: str = "raise"
    stall_seconds: float = 0.0
    message: str = ""
    exit_code: int = 113
    processes: Optional[tuple[int, ...]] = None
    attempts: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"fault mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


@dataclasses.dataclass
class FaultRecord:
    """Audit entry for one firing (mirrored as a ``fault_injected`` event)."""

    site: str
    index: int
    mode: str
    context: dict


class FaultPlan:
    """Deterministic registry of :class:`FaultSpec` rules.

    Thread-compatibility note: visits mutate per-site counters; the
    training drivers visit sites from the main thread only (the reader's
    decode pool calls :func:`fault_point` from workers, where the GIL makes
    the counter increment atomic — ordering across files is then
    nondeterministic, so specs targeting ``io.read`` in multi-file runs
    should prefer ``rate`` over ``at``).
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0,
                 bus=None):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self.bus = bus
        self.records: list[FaultRecord] = []
        self._counts: dict[str, int] = {}
        self._fires: dict[int, int] = {i: 0 for i in range(len(self.specs))}
        self._rngs: dict[str, np.random.Generator] = {}

    # --- bookkeeping ------------------------------------------------------
    def visits(self, site: str) -> int:
        """How many times ``site`` has been visited so far."""
        return self._counts.get(site, 0)

    def fired(self, site: Optional[str] = None) -> list[FaultRecord]:
        if site is None:
            return list(self.records)
        return [r for r in self.records if r.site == site]

    def _rng(self, site: str) -> np.random.Generator:
        rng = self._rngs.get(site)
        if rng is None:
            rng = np.random.default_rng(
                (self.seed, stable_hash_u32(site)))
            self._rngs[site] = rng
        return rng

    # --- the decision -----------------------------------------------------
    def visit(self, site: str, context: Mapping[str, Any]) -> Optional[str]:
        """Advance ``site``'s invocation counter and apply the first firing
        spec. Returns the fired mode (``"nan"``/``"stall"``) for value
        hooks, raises for ``"raise"`` specs, None when nothing fires.

        ``processes``/``attempts``-restricted specs still consume their
        seeded ``rate`` draw on every process and attempt — the draw
        sequence stays aligned with the unrestricted plan, so restricting
        a spec never shifts which invocations OTHER specs hit."""
        index = self._counts.get(site, 0)
        self._counts[site] = index + 1
        for i, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if spec.max_fires is not None and self._fires[i] >= spec.max_fires:
                continue
            fire = index in spec.at
            if not fire and spec.rate > 0.0:
                fire = float(self._rng(site).random()) < spec.rate
            if fire and spec.processes is not None:
                fire = _process_index() in spec.processes
            if fire and spec.attempts is not None:
                fire = _restart_count() in spec.attempts
            if not fire:
                continue
            self._fires[i] += 1
            record = FaultRecord(site=site, index=index, mode=spec.mode,
                                 context=dict(context))
            self.records.append(record)
            self._post(record)
            if spec.mode == "raise":
                raise InjectedFault(site, index, spec.message)
            if spec.mode == "stall":
                from photon_ml_tpu_torch.resilience.retry import _sleep

                _sleep(spec.stall_seconds)
                return "stall"
            if spec.mode == "kill":
                # an abrupt death, not an exit: no finally blocks, no
                # atexit, no flushing — the asymmetric crash class only a
                # SUPERVISOR can recover (surviving processes are left
                # stuck in their next collective)
                os._exit(spec.exit_code)
            return spec.mode
        return None

    def _post(self, record: FaultRecord) -> None:
        bus = self.bus
        if bus is None:
            from photon_ml_tpu_torch.events import GLOBAL_BUS as bus
        bus.post("fault_injected", site=record.site, index=record.index,
                 mode=record.mode, **record.context)

    # --- (de)serialization ------------------------------------------------
    @classmethod
    def from_json(cls, obj: "str | Mapping") -> "FaultPlan":
        """Build from a JSON object/string:
        ``{"seed": 0, "specs": [{"site": "io.read", "at": [0]}, ...]}``."""
        if isinstance(obj, str):
            obj = json.loads(obj)
        specs = [FaultSpec(site=s["site"],
                           at=tuple(int(x) for x in s.get("at", ())),
                           rate=float(s.get("rate", 0.0)),
                           max_fires=(None if s.get("max_fires") is None
                                      else int(s["max_fires"])),
                           mode=s.get("mode", "raise"),
                           stall_seconds=float(s.get("stall_seconds", 0.0)),
                           message=s.get("message", ""),
                           exit_code=int(s.get("exit_code", 113)),
                           processes=(None if s.get("processes") is None
                                      else tuple(int(x)
                                                 for x in s["processes"])),
                           attempts=(None if s.get("attempts") is None
                                     else tuple(int(x)
                                                for x in s["attempts"])))
                 for s in obj.get("specs", ())]
        return cls(specs, seed=int(obj.get("seed", 0)))

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "specs": [{
                "site": s.site, "at": list(s.at), "rate": s.rate,
                "max_fires": s.max_fires, "mode": s.mode,
                "stall_seconds": s.stall_seconds, "message": s.message,
                "exit_code": s.exit_code,
                "processes": (None if s.processes is None
                              else list(s.processes)),
                "attempts": (None if s.attempts is None
                             else list(s.attempts)),
            } for s in self.specs],
        }, sort_keys=True)


# ---------------------------------------------------------------------------
# Global activation + the hooks
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def activate(plan: FaultPlan) -> FaultPlan:
    global _ACTIVE
    _ACTIVE = plan
    return plan


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Scope a plan's activation (test/chaos-sweep entry point)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def fault_point(site: str, **context: Any) -> None:
    """Injection hook for control-flow sites. No active plan (the
    production default): returns after one global ``is None`` check."""
    plan = _ACTIVE
    if plan is None:
        return
    plan.visit(site, context)


def fault_value(site: str, value, **context: Any):
    """Injection hook threaded through a data value (e.g. the coordinate
    step's new scores). ``mode="nan"`` corrupts the value; ``"raise"``
    raises; inactive plans pass the value through untouched."""
    plan = _ACTIVE
    if plan is None:
        return value
    if plan.visit(site, context) == "nan":
        return value * float("nan")
    return value


def _activate_from_env() -> None:
    spec = os.environ.get("PHOTON_FAULT_PLAN")
    if not spec:
        return
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    activate(FaultPlan.from_json(spec))


_activate_from_env()
