"""Checkpoint/resume for coordinate descent.

Counterpart of ``photon_ml_tpu/io/checkpoint.py``, in the same on-disk
format, so a checkpoint written by either package restores in the other:
one directory per step, ``arrays.npz`` (``np.savez``) beside a JSON
``manifest.json``, written into a ``.tmp`` sibling and renamed into place,
so a crash mid-write never corrupts the latest step. At every coordinate
boundary the manager can persist the sweep position, every coordinate's
model and the score decomposition; a run resumes from the last boundary
with its warm starts intact.

Fixed-effect coefficients restore onto the caller's device; random-effect
tables (with their variances and the RANDOM projector's matrix, when the
model has them) and scores stay host numpy.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.projector import RandomProjector
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.io.pipeline import publish_dir
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.resilience import fault_point, retry
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CoordinateDescentState:
    """Resumable CD position: models + score decomposition + sweep index."""

    sweep: int
    coordinate_index: int  # next coordinate to train within the sweep
    model: GameModel
    scores: dict[str, np.ndarray]


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class CheckpointManager:
    """Writes/reads checkpoint steps under a root directory, keeping the
    newest ``keep``."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self._pinned = False
        self._pinned_step: Optional[int] = None
        os.makedirs(root, exist_ok=True)

    def pin_step(self, step: Optional[int]) -> None:
        """Freeze what :meth:`latest_step` answers (the resume point agreed
        before training)."""
        self._pinned = True
        self._pinned_step = step

    # --- step bookkeeping -------------------------------------------------
    def steps(self) -> list[int]:
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step-") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("-", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        if self._pinned:
            return self._pinned_step
        steps = self.steps()
        return steps[-1] if steps else None

    def _gc(self) -> None:
        for step in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step-{step}"),
                          ignore_errors=True)
        # stale tmp dirs of a crashed or fault-injected save attempt (never
        # the live checkpoint under the rename protocol)
        for name in os.listdir(self.root):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    # --- save/restore -----------------------------------------------------
    def save(self, step: int, state: CoordinateDescentState,
             fingerprint: Optional[str] = None) -> str:
        """``fingerprint`` identifies the run's configuration; restore()
        refuses state written under a different one."""
        manifest = {
            "step": step,
            "sweep": state.sweep,
            "coordinate_index": state.coordinate_index,
            "task": state.model.task.value,
            "fingerprint": fingerprint,
            "coordinates": {},
        }
        arrays: dict[str, np.ndarray] = {}
        for cid, cm in state.model.coordinates.items():
            if isinstance(cm, FixedEffectModel):
                variances = cm.model.coefficients.variances
                manifest["coordinates"][cid] = {
                    "type": "fixed", "featureShardId": cm.feature_shard_id,
                    "has_variances": variances is not None}
                arrays[f"fixed:{cid}:means"] = _host(
                    cm.model.coefficients.means)
                if variances is not None:
                    arrays[f"fixed:{cid}:variances"] = _host(variances)
            else:
                manifest["coordinates"][cid] = {
                    "type": "random", "featureShardId": cm.feature_shard_id,
                    "randomEffectType": cm.random_effect_type, "dim": cm.dim,
                    "has_variances": cm.variances is not None,
                    "has_projector": cm.projector is not None}
                arrays[f"re:{cid}:keys"] = cm.keys
                arrays[f"re:{cid}:coeffs"] = cm.coeffs
                if cm.variances is not None:
                    arrays[f"re:{cid}:variances"] = cm.variances
                if cm.projector is not None:
                    arrays[f"re:{cid}:projector"] = cm.projector.matrix
        for cid, sc in state.scores.items():
            arrays[f"scores:{cid}"] = sc

        final = os.path.join(self.root, f"step-{step}")

        def attempt() -> None:
            tmp = tempfile.mkdtemp(prefix=f"step-{step}-", suffix=".tmp",
                                   dir=self.root)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2)
            # the crash-mid-write window: tmp fully written, not renamed —
            # a kill here must leave the previous step the loadable latest
            fault_point("ckpt.save", step=step, path=final)
            publish_dir(tmp, final)

        retry(attempt, name=f"ckpt.save:step-{step}")
        self._gc()
        return final

    def restore(self, step: Optional[int] = None,
                expected_fingerprint: Optional[str] = None, *,
                device=None) -> CoordinateDescentState:
        """The state at ``step`` (default: the newest readable step, walking
        back past corrupt ones). Fixed-effect coefficients land on
        ``device`` (``cuda`` unless the caller passes ``device="cpu"``)."""
        device = resolve_device(device)
        if step is not None or self._pinned:
            if step is None:
                step = self.latest_step()
                if step is None:
                    raise FileNotFoundError(
                        f"no checkpoints under {self.root}")
            return retry(
                lambda: self._restore_step(step, expected_fingerprint,
                                           device),
                name=f"ckpt.restore:step-{step}")
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        # a crashed writer cannot corrupt a renamed step, but disks can:
        # resuming one boundary earlier beats dying. Fingerprint mismatches
        # (ValueError) propagate.
        last_error: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                return retry(
                    lambda s=s: self._restore_step(s, expected_fingerprint,
                                                   device),
                    name=f"ckpt.restore:step-{s}")
            except ValueError:
                raise
            except Exception as e:
                logger.warning("checkpoint step-%d unreadable (%r); "
                               "falling back to the previous step", s, e)
                last_error = e
        raise last_error

    def _restore_step(self, step: int, expected_fingerprint: Optional[str],
                      device: torch.device) -> CoordinateDescentState:
        path = os.path.join(self.root, f"step-{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        saved_fp = manifest.get("fingerprint")
        if (expected_fingerprint is not None and saved_fp is not None
                and saved_fp != expected_fingerprint):
            raise ValueError(
                f"checkpoint at {path} was written under configuration "
                f"{saved_fp!r}, but this run is {expected_fingerprint!r}; "
                f"refusing to resume across configurations")
        arrays = np.load(os.path.join(path, "arrays.npz"))
        task = TaskType(manifest["task"])
        coordinates = {}
        for cid, info in manifest["coordinates"].items():
            if info["type"] == "fixed":
                variances = (torch.as_tensor(
                    arrays[f"fixed:{cid}:variances"], device=device)
                    if info["has_variances"] else None)
                coordinates[cid] = FixedEffectModel(
                    model=GeneralizedLinearModel(
                        coefficients=Coefficients(
                            means=torch.as_tensor(
                                arrays[f"fixed:{cid}:means"], device=device),
                            variances=variances),
                        task=task),
                    feature_shard_id=info["featureShardId"])
                continue
            coordinates[cid] = RandomEffectModel(
                random_effect_type=info["randomEffectType"],
                feature_shard_id=info["featureShardId"], task=task,
                dim=info["dim"], keys=arrays[f"re:{cid}:keys"],
                coeffs=arrays[f"re:{cid}:coeffs"],
                variances=(arrays[f"re:{cid}:variances"]
                           if info["has_variances"] else None),
                projector=(RandomProjector(
                    matrix=arrays[f"re:{cid}:projector"])
                    if info.get("has_projector") else None))
        scores = {k.split(":", 1)[1]: arrays[k]
                  for k in arrays.files if k.startswith("scores:")}
        return CoordinateDescentState(
            sweep=manifest["sweep"],
            coordinate_index=manifest["coordinate_index"],
            model=GameModel(coordinates=coordinates, task=task),
            scores=scores)
