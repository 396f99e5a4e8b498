"""Block coordinate descent over GAME coordinates.

Counterpart of ``photon_ml_tpu/game/coordinate_descent.py``: each sweep,
for each coordinate in the update sequence, subtract the coordinate's
previous scores from the running total, train on the residual offsets, add
the new scores back, and evaluate the validation data after the sweep.
Warm starts flow from each coordinate's previous-sweep model. The score
decomposition stays on the device for the whole run; the invariant is
``total = data.offsets + Σ_c scores[c]``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Mapping, Sequence

import torch

from photon_ml_tpu_torch.evaluation import evaluate_all
from photon_ml_tpu_torch.game.coordinate import Coordinate, CoordinateModel
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.model import GameModel
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    #: per-sweep validation metric dicts (empty without validation data)
    validation_history: list[dict[str, float]]
    #: the final sweep's evaluation (None without validation data)
    final_evaluation: object = None
    #: wall seconds per coordinate step, ``[(sweep, coordinate, seconds)]``,
    #: each step ending in a device synchronization
    step_seconds: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class CoordinateDescent:
    """Drives the sweep loop over an ordered update sequence."""

    update_sequence: Sequence[str]
    n_iterations: int = 1

    def run(self, coordinates: Mapping[str, Coordinate], data: GameData,
            task: TaskType, device: torch.device, validation=None
            ) -> CoordinateDescentResult:
        """``validation`` is ``(GameData, evaluators)`` or None."""
        for cid in self.update_sequence:
            if cid not in coordinates:
                raise KeyError(
                    f"update sequence names unknown coordinate {cid!r}")
        models: dict[str, CoordinateModel] = {}
        n = data.n_samples
        scores = {cid: torch.zeros(n, dtype=torch.float32, device=device)
                  for cid in self.update_sequence}
        total = torch.as_tensor(data.offsets, device=device)

        history: list[dict[str, float]] = []
        final_evaluation = None
        step_seconds = []
        for sweep in range(self.n_iterations):
            for cid in self.update_sequence:
                t0 = time.perf_counter()
                residual = total - scores[cid]
                with torch.profiler.record_function(f"cd.step[{cid}]"):
                    model, new_scores = coordinates[cid].train(
                        residual, models.get(cid))
                models[cid] = model
                total = residual + new_scores
                scores[cid] = new_scores
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                step_seconds.append((sweep, cid, time.perf_counter() - t0))
                logger.info("sweep %d coordinate %s trained in %.2fs", sweep,
                            cid, step_seconds[-1][2])
            if validation is not None:
                vdata, evaluators = validation
                gm = GameModel(coordinates=dict(models), task=task)
                results = evaluate_all(evaluators, gm.score(vdata),
                                       vdata.labels, weights=vdata.weights,
                                       id_tags=vdata.id_columns)
                history.append(results.as_dict())
                final_evaluation = results
                logger.info("sweep %d validation: %s", sweep, results)

        model = GameModel(
            coordinates={cid: models[cid] for cid in self.update_sequence},
            task=task)
        return CoordinateDescentResult(
            model=model, validation_history=history,
            final_evaluation=final_evaluation, step_seconds=step_seconds)
