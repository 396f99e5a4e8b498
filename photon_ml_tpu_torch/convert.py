"""Carry trained models and training data across into the port as arrays.

:func:`game_model_from_arrays` builds the port's :class:`GameModel`,
:func:`glm_model_from_arrays` its :class:`GeneralizedLinearModel` and
:func:`glm_data_from_arrays` a dense :class:`GLMData`, from plain numpy
arrays — for example those of a model or data set of the JAX package
(``photon_ml_tpu``) — so both packages can score and train on the same data
with the same coefficients. They take arrays, not objects, so the port
never imports the JAX package.
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
from photon_ml_tpu_torch.game.data import design_dtype_of
from photon_ml_tpu_torch.ops.design import DenseDesign, accumulation_dtype
from photon_ml_tpu_torch.ops.objective import GLMData
from photon_ml_tpu_torch.types import TaskType


def glm_model_from_arrays(task, means, variances=None,
                          device=None) -> GeneralizedLinearModel:
    """A GLM of ``task`` (a :class:`TaskType` or its name) with
    coefficient ``means`` ``(d,)`` and optional ``variances`` ``(d,)``, on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``), in the
    arrays' float precision (f32 or f64)."""
    task = TaskType(getattr(task, "value", task))
    device = resolve_device(device)

    def put(a):
        return None if a is None else torch.as_tensor(np.array(a),
                                                      device=device)

    return GeneralizedLinearModel(
        coefficients=Coefficients(means=put(means), variances=put(variances)),
        task=task)


def glm_data_from_arrays(x, labels, offsets=None, weights=None,
                         dtype="float32", device=None) -> GLMData:
    """A dense :class:`GLMData` on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``): the design ``x`` ``(n, d)`` stored in
    ``dtype`` (``"float32"``, ``"bfloat16"`` or a ``torch.dtype``) and the
    ``(n,)`` vectors in f32 (f64 for an f64 design), offsets 0 and weights
    1 when not given — the dense branch of the JAX package's
    ``cli/train_glm.py::_to_glm_data``."""
    device = resolve_device(device)
    dt = design_dtype_of(dtype)
    vec = accumulation_dtype(dt)
    n = len(labels)

    def put(a, fill):
        a = np.full(n, fill) if a is None else np.asarray(a)
        return torch.as_tensor(a, device=device).to(vec)

    return GLMData(
        design=DenseDesign(x=torch.as_tensor(np.asarray(x),
                                             device=device).to(dt)),
        labels=put(labels, 0.0), offsets=put(offsets, 0.0),
        weights=put(weights, 1.0))


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
