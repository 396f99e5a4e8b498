"""Registry-driven model discovery: poll a publish directory, apply what
lands there.

Counterpart of ``photon_ml_tpu/serving/watcher.py``. A refreshing
deployment publishes into a directory (full model dirs from
``train_game`` / ``refresh_game``, coefficient patches from
``refresh_game``) and each serving host picks the versions up itself. The
watcher polls the directory and applies each new entry, in sorted name
order, through the registry's validate-then-activate path
(:meth:`~photon_ml_tpu_torch.serving.registry.ModelRegistry.reload`, which
routes full dirs and patches by metadata ``kind``). A rejected candidate
leaves the active version serving.

Publication is atomic on the training side (a staged directory renamed
into place, ``io/pipeline.py::publish_dir``), so a poll never sees half a
model; entries whose name starts with ``.`` are never read. The seen set
is keyed by content (:func:`candidate_content_key`), not by name alone: a
corrected republish under the same name changes the key and is attempted
again on the next poll. Under a canary-gated registry (``serve_game
--canary-gate``) a candidate whose shadow scores diverge past the bound is
rejected like an invalid one.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Optional

from photon_ml_tpu_torch.io.model_io import resolve_game_model_dir
from photon_ml_tpu_torch.resilience.faults import fault_point
from photon_ml_tpu_torch.serving.registry import ModelRegistry

logger = logging.getLogger(__name__)


def candidate_content_key(path: str) -> str:
    """Cheap content identity of a candidate directory: a fold of every
    file's (relative path, size, mtime_ns), no data read. Two publishes of
    the same bytes can key apart (mtime moves), which costs one redundant
    validation; what the key guarantees is that a change in place never
    reuses a rejected entry's key."""
    h = hashlib.blake2s(digest_size=12)
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames.sort()
        for name in sorted(filenames):
            fp = os.path.join(dirpath, name)
            try:
                st = os.stat(fp)
            except OSError:
                continue  # a racing publisher: the next poll keys again
            h.update(f"{os.path.relpath(fp, path)}|{st.st_size}|"
                     f"{st.st_mtime_ns}\n".encode())
    return h.hexdigest()


class ModelDirectoryWatcher:
    """Polls ``watch_dir`` for new model and patch directories and applies
    them to ``registry`` through validate-then-activate."""

    def __init__(self, registry: ModelRegistry, watch_dir: str, *,
                 poll_s: float = 10.0):
        self.registry = registry
        self.watch_dir = watch_dir
        self.poll_s = float(poll_s)
        self._lock = threading.Lock()
        #: (entry name, content key) pairs already attempted
        self._seen: set[tuple[str, str]] = set()  # guarded-by: _lock
        #: set by stop(), cleared by start() before the thread exists (an
        #: Event is safe across threads; the loop only waits on it)
        self._stop = threading.Event()  # guarded-by: caller
        #: start/stop are lifecycle calls from one control thread
        self._thread: Optional[threading.Thread] = None  # guarded-by: caller
        self.n_applied = 0  # guarded-by: _lock
        self.n_rejected = 0  # guarded-by: _lock

    # --- one poll ---------------------------------------------------------
    def scan_once(self) -> int:
        """Apply every unseen entry, in name order; returns how many
        activated. The thread's loop is this on a timer; tests call it
        directly."""
        # a faulted tick is logged by the loop, and the next tick picks up
        # what this one missed (nothing is marked seen before its attempt)
        fault_point("serving.watch_tick", dir=self.watch_dir)
        try:
            names = sorted(
                n for n in os.listdir(self.watch_dir)
                if not n.startswith(".")
                and os.path.isdir(os.path.join(self.watch_dir, n)))
        except FileNotFoundError:
            return 0  # the publish dir is not there yet
        applied = 0
        for name in names:
            path = os.path.join(self.watch_dir, name)
            # keyed before the attempt: a publisher changing the entry
            # during the attempt changes the key, and the next poll retries
            key = (name, candidate_content_key(path))
            with self._lock:
                if key in self._seen:
                    continue
            try:
                resolve_game_model_dir(path)
            except FileNotFoundError:
                # not a model dir (yet): not marked seen, so a run dir
                # whose best/ lands later is still picked up
                continue
            with self._lock:
                self._seen.add(key)
            try:
                sm = self.registry.reload(path)
            except Exception as e:
                # the registry posted model_reload_rejected; the active
                # version is untouched
                with self._lock:
                    self.n_rejected += 1
                logger.warning("watch-dir candidate %s rejected: %r",
                               path, e)
                continue
            with self._lock:
                self.n_applied += 1
            applied += 1
            if sm.canary is not None:
                logger.info(
                    "watch-dir activated %s as version %d (canary: %s, "
                    "divergence %.4g over %d records)", path, sm.version,
                    sm.canary["verdict"], sm.canary["divergence"],
                    sm.canary["n"])
            else:
                logger.info("watch-dir activated %s as version %d", path,
                            sm.version)
        return applied

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "ModelDirectoryWatcher":
        if self._thread is not None:
            return self

        def loop() -> None:
            # a first scan at once (catch up on restart), then the timer
            while True:
                try:
                    self.scan_once()
                except Exception:
                    logger.exception("watch-dir scan failed; will retry")
                if self._stop.wait(self.poll_s):
                    return

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="photon-serving-watch")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
