"""Carry a trained GAME model's arrays across into the port.

:func:`game_model_from_arrays` builds the port's :class:`GameModel` from
plain numpy arrays — for example those of a model trained by the JAX
package (``photon_ml_tpu``) — so both packages can score the same data with
the same coefficients. It takes arrays, not objects, so the port never
imports the JAX package.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.models.coefficients import Coefficients
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.types import TaskType


def game_model_from_arrays(task, coordinates: Mapping[str, Mapping],
                           device=None) -> GameModel:
    """``task`` is a :class:`TaskType` or its name; ``coordinates`` maps
    each coordinate id, in update order, to either

    - ``{"kind": "fixed", "feature_shard_id": str, "means": (d,)}``, or
    - ``{"kind": "random", "random_effect_type": str,
      "feature_shard_id": str, "dim": int, "keys": (k,) int64 sorted,
      "coeffs": (k,)}``.

    Fixed-effect coefficients land on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``); random-effect tables stay host numpy,
    as the port keeps them."""
    task = TaskType(getattr(task, "value", task))
    device = resolve_device(device)
    models = {}
    for cid, spec in coordinates.items():
        kind = spec["kind"]
        if kind == "fixed":
            means = torch.tensor(np.asarray(spec["means"], np.float32),
                                 device=device)
            models[cid] = FixedEffectModel(
                model=GeneralizedLinearModel(
                    coefficients=Coefficients(means=means), task=task),
                feature_shard_id=spec["feature_shard_id"])
        elif kind == "random":
            keys = np.asarray(spec["keys"], np.int64)
            if len(keys) > 1 and (np.diff(keys) <= 0).any():
                raise ValueError(f"coordinate {cid!r}: keys must be strictly "
                                 "increasing")
            models[cid] = RandomEffectModel(
                random_effect_type=spec["random_effect_type"],
                feature_shard_id=spec["feature_shard_id"], task=task,
                dim=int(spec["dim"]), keys=keys,
                coeffs=np.asarray(spec["coeffs"], np.float32))
        else:
            raise ValueError(f"coordinate {cid!r}: unknown kind {kind!r}")
    return GameModel(coordinates=models, task=task)
