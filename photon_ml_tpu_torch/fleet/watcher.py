"""Router-side activation: the freshness loop's last hop.

Counterpart of ``photon_ml_tpu/fleet/watcher.py``. ``serving/watcher.py``
gives ONE host self-service model pickup; a fleet
needs the same discovery at the ROUTER, because per-shard coefficient
patches (``refresh_game --fleet-shards``) are only correct as a SET —
activating shard 2's patch while shard 0 serves the old version skews
scores. This watcher polls a publish directory on the router and drives
every discovery through :meth:`~photon_ml_tpu_torch.fleet.router.
FleetRouter.reload`'s two-phase prepare→activate epoch, so a fleet either moves to
the new version everywhere or refuses everywhere with the incumbent
serving (any host's canary or structural refusal aborts the epoch).

What an entry can be (a ``refresh_game --fleet-shards`` run dir is both at
once — the per-shard set wins, it is the cheaper path):

- a directory containing the COMPLETE ``patch-shard-0 … patch-shard-N-1``
  set for this fleet's N shards: each stamp is verified before any host
  is contacted — ``kind=coefficient-patch``, ``fleetShard`` matching its
  slot, ``fleetShardCount == N``, and one uniform ``modelId`` /
  ``parentModel`` across the set (a mixed set is two publishes
  interleaved; refuse it here, cheaply) — then activated via
  ``reload({"model_dirs": […]})``. Hosts whose shard has no touched rows
  activate with zero captures (their engines share the parent's programs);
- a full model dir (or run dir with ``best/``): activated fleet-wide via
  ``reload({"model_dir": …})``;
- anything else: ignored without being marked seen (a run dir that
  publishes later must still be picked up).

Seen/rejected entries are keyed by CONTENT
(:func:`~photon_ml_tpu_torch.serving.watcher.candidate_content_key`), same
as the single-host watcher: a corrected republish under the same name
re-attempts on the next poll. Waiting uses ``threading.Event.wait``:
serving code never sleeps.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from photon_ml_tpu_torch.resilience.faults import fault_point
from photon_ml_tpu_torch.serving.watcher import candidate_content_key

logger = logging.getLogger(__name__)


class FleetPatchWatcher:
    """Polls ``watch_dir`` and drives each discovered per-shard patch set
    (or full model) through the router's two-phase fleet epoch."""

    def __init__(self, router, watch_dir: str, *, poll_s: float = 10.0):
        self.router = router
        self.watch_dir = watch_dir
        self.poll_s = float(poll_s)
        self._lock = threading.Lock()
        #: (entry name, content key) pairs already attempted — content
        #: keyed, so a republish in place re-attempts (module docstring)
        self._seen: set = set()  # guarded-by: _lock
        self._stop = threading.Event()
        #: start/stop are operator-lifecycle calls from one control thread
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller
        self.n_applied = 0  # guarded-by: _lock
        self.n_rejected = 0  # guarded-by: _lock

    # --- stamp verification -----------------------------------------------
    def _verify_patch_set(self, shard_dirs: list) -> Optional[str]:
        """None when every stamp checks out, else why the set is refused
        (before any host sees a prepare)."""
        import json

        from photon_ml_tpu_torch.io.model_io import PATCH_KIND

        n = self.router.n_shards
        stamps = []
        for i, d in enumerate(shard_dirs):
            try:
                with open(os.path.join(d, "model-metadata.json")) as f:
                    meta = json.load(f)
            except (OSError, ValueError) as e:
                return f"patch-shard-{i}: unreadable metadata ({e!r})"
            if meta.get("kind") != PATCH_KIND:
                return (f"patch-shard-{i}: kind {meta.get('kind')!r} is "
                        f"not a coefficient patch")
            if meta.get("fleetShard") != i:
                return (f"patch-shard-{i}: stamped for shard "
                        f"{meta.get('fleetShard')!r}, sits in slot {i}")
            if meta.get("fleetShardCount") != n:
                return (f"patch-shard-{i}: stamped for a "
                        f"{meta.get('fleetShardCount')!r}-shard fleet, "
                        f"this fleet has {n}")
            stamps.append((meta.get("modelId"), meta.get("parentModel")))
        if len(set(stamps)) != 1:
            return ("mixed lineage across the shard set (two publishes "
                    f"interleaved?): {sorted(set(stamps))}")
        return None

    # --- one poll ---------------------------------------------------------
    def scan_once(self) -> int:
        """Drive every unseen entry (sorted by name) through a fleet
        epoch; returns how many activated. Directly callable — the thread
        loop is just this on a timer, and tests drive it synchronously."""
        # chaos site: a faulted tick is swallowed by the poll loop and the
        # NEXT tick picks up whatever this one missed (nothing is marked
        # seen before its epoch attempt, so no candidate is lost)
        fault_point("serving.watch_tick", dir=self.watch_dir)
        try:
            names = sorted(
                n for n in os.listdir(self.watch_dir)
                if not n.startswith(".")
                and os.path.isdir(os.path.join(self.watch_dir, n)))
        except FileNotFoundError:
            return 0  # publish dir not created yet — nothing to do
        applied = 0
        for name in names:
            path = os.path.join(self.watch_dir, name)
            # key BEFORE the attempt: a publisher updating the entry
            # mid-attempt changes the key and the next poll re-tries
            key = (name, candidate_content_key(path))
            with self._lock:
                if key in self._seen:
                    continue
            payload = self._classify(path)
            if payload is None:
                continue  # not (yet) activatable; NOT marked seen
            with self._lock:
                self._seen.add(key)
            if "refused" in payload:
                with self._lock:
                    self.n_rejected += 1
                logger.warning("fleet watch-dir refused %s before any "
                               "prepare: %s", path, payload["refused"])
                continue
            try:
                self.router.reload(payload)
            except Exception as e:
                # the epoch aborted (prepare refusal, canary divergence,
                # activation fault) — the router already rolled the fleet
                # back to the incumbent everywhere
                with self._lock:
                    self.n_rejected += 1
                logger.warning("fleet watch-dir candidate %s rejected — "
                               "incumbent keeps serving fleet-wide: %r",
                               path, e)
                continue
            with self._lock:
                self.n_applied += 1
            applied += 1
            logger.info("fleet watch-dir activated %s across %d shards",
                        path, self.router.n_shards)
        return applied

    def _classify(self, path: str) -> Optional[dict]:
        """An entry's activation payload: ``model_dirs`` for a complete,
        verified per-shard patch set, ``model_dir`` for a full model,
        ``{"refused": why}`` for a present-but-invalid set, None for
        not-our-business (skipped without being marked seen)."""
        n = self.router.n_shards
        shard_dirs = [os.path.join(path, f"patch-shard-{i}")
                      for i in range(n)]
        present = sum(os.path.isdir(d) for d in shard_dirs)
        if present == n:
            why = self._verify_patch_set(shard_dirs)
            if why is not None:
                return {"refused": why}
            return {"model_dirs": shard_dirs}
        if present or any(
                e.startswith("patch-shard-")
                for e in os.listdir(path) if not e.startswith(".")):
            # partial or wrong-count set: publication is atomic (one
            # rename), so this was CUT for a different fleet shape —
            # refuse it rather than activate a subset
            return {"refused": (f"{present} of {n} patch shards present "
                                f"(stamped for a different fleet?)")}
        try:
            from photon_ml_tpu_torch.io.model_io import (
                resolve_game_model_dir,
            )

            resolve_game_model_dir(path)
        except FileNotFoundError:
            return None  # scratch, logs, staging …
        return {"model_dir": path}

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "FleetPatchWatcher":
        def loop() -> None:
            # immediate first scan (catch-up on restart), then the timer
            while True:
                try:
                    self.scan_once()
                except Exception:
                    logger.exception("fleet watch-dir scan failed; will "
                                     "retry")
                if self._stop.wait(self.poll_s):
                    return

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="photon-fleet-watch")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
