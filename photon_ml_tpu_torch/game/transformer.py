"""GameTransformer: the scoring facade over a trained GAME model.

Counterpart of ``photon_ml_tpu/game/transformer.py`` (the reference's
``GameTransformer.scala``): apply a :class:`~photon_ml_tpu_torch.game.model.
GameModel` to a dataset → total scores (offset + sum of coordinate margins),
optionally the per-coordinate breakdown, the response-scale predictions
through the task's inverse link, and the evaluation of the scored output.
Scoring is the models' host numpy join, as in the JAX package; the
transformer owns orchestration only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation import (
    EvaluationResults,
    Evaluator,
    evaluate_all,
)
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.model import GameModel, sum_coordinate_margins
from photon_ml_tpu_torch.ops.losses import loss_for_task


@dataclasses.dataclass(frozen=True)
class ModelDataScores:
    """A scored dataset: total margins, optional response-scale
    predictions, optional per-coordinate breakdown, and the evaluation
    computed on them."""

    scores: np.ndarray  # (n,) float32 total margins incl. offsets
    predictions: Optional[np.ndarray] = None  # inverse-link(scores)
    by_coordinate: Optional[dict[str, np.ndarray]] = None
    evaluation: Optional[EvaluationResults] = None


@dataclasses.dataclass(frozen=True)
class GameTransformer:
    """Applies a GAME model to data: configure once, call
    :meth:`transform` per dataset."""

    model: GameModel
    evaluators: Sequence[Evaluator] = ()
    #: also return the per-coordinate margins
    score_breakdown: bool = False
    #: also return response-scale predictions (probability / rate / value
    #: through the task's inverse link, ``PointwiseLoss.mean``)
    predict_response: bool = False

    def transform(self, data: GameData) -> ModelDataScores:
        by_coordinate = None
        if self.score_breakdown:
            by_coordinate = self.model.score_by_coordinate(data)
            # the same reduction as GameModel.score (and the online
            # engine): breakdown totals are bit-identical to plain scores
            scores = sum_coordinate_margins(data.offsets,
                                            by_coordinate.values())
        else:
            scores = self.model.score(data)

        predictions = None
        if self.predict_response:
            mean = loss_for_task(self.model.task).mean
            predictions = mean(torch.from_numpy(scores)).numpy().astype(
                np.float32)

        evaluation = None
        if self.evaluators:
            evaluation = evaluate_all(
                self.evaluators, scores, data.labels,
                weights=data.weights, id_tags=data.id_columns)
        return ModelDataScores(scores=scores, predictions=predictions,
                               by_coordinate=by_coordinate,
                               evaluation=evaluation)
