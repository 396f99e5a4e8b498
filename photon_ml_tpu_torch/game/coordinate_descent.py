"""Block coordinate descent over GAME coordinates.

Counterpart of ``photon_ml_tpu/game/coordinate_descent.py``: each sweep,
for each coordinate in the update sequence, subtract the coordinate's
previous scores from the running total, train on the residual offsets, add
the new scores back, and evaluate the validation data after the sweep.
Warm starts flow from each coordinate's previous-sweep model (and, with
``initial_models``, from a saved model). The score decomposition stays on
the device for the whole run; the invariant is
``total = data.offsets + Σ_c scores[c]``.

Telemetry, as in the JAX package: each sweep is a ``cd.sweep`` span, each
coordinate step a ``cd.step`` span (with the block objective's ``loss``
and ``grad_norm`` after the step) and each validation a ``cd.validate``
span; the ``photon_game_coordinate_{loss,grad_norm,steps_total}`` families
and ``photon_game_step_dispatch_seconds``; and the fleet-metrics fold
point after every sweep. The per-step loss reads sync the device, so they
run only while a trace is being written (``tracing.enabled()``). Under
``--debug-nans`` (``ops/objective.py::debug_nans``) a step whose scores
are not finite raises :class:`FloatingPointError` inside the step, where
the divergence guard sees it as the step's error, as a NaN that JAX's
``jax_debug_nans`` catches there does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation import evaluate_all
from photon_ml_tpu_torch.game.coordinate import Coordinate, CoordinateModel
from photon_ml_tpu_torch.game.data import GameData
from photon_ml_tpu_torch.game.model import GameModel
from photon_ml_tpu_torch.ops.objective import check_finite, debug_nans
from photon_ml_tpu_torch.resilience import fault_point, fault_value, heartbeat
from photon_ml_tpu_torch.telemetry import aggregate as fleet
from photon_ml_tpu_torch.telemetry import metrics as _tmetrics
from photon_ml_tpu_torch.telemetry import profiling, tracing
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)

#: host-side dispatch wall per coordinate step (the device may still be
#: busy when it ends; ``step_seconds`` of the result ends in a sync)
_STEP_DISPATCH = _tmetrics.histogram(
    "photon_game_step_dispatch_seconds",
    "Host-side dispatch wall per committed coordinate-descent step "
    "(async: device work may continue past it)", labels=("coordinate",))


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
    #: the regularization weight each trained coordinate ended the run with
    #: (the divergence guard's rollbacks raise it)
    regularization_weights: dict = dataclasses.field(default_factory=dict)


def _device_memory_bytes(device: torch.device) -> int:
    """The card's memory for the score-memory guard; on the CPU the JAX
    package's fallback of 16 GiB."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 16 << 30


@dataclasses.dataclass(frozen=True)
class CoordinateDescent:
    """Drives the sweep loop over an ordered update sequence.

    ``max_score_memory_bytes`` guards the memory cliff of the score
    decomposition the run keeps on the device: K+1 vectors of
    ``n_samples`` f32 (K coordinate scores and the running total). Past
    the budget the run refuses up front, with guidance, rather than failing
    in the allocator mid-sweep. ``None`` is half the device's memory."""

    update_sequence: Sequence[str]
    n_iterations: int = 1
    max_score_memory_bytes: Optional[int] = None

    def run(self, coordinates: Mapping[str, Coordinate], data: GameData,
            task: TaskType, device: torch.device, validation=None,
            initial_models: Optional[Mapping[str, CoordinateModel]] = None,
            checkpoint=None, resume: bool = False, locked: Sequence[str] = (),
            config_fingerprint: Optional[str] = None, guard=None
            ) -> CoordinateDescentResult:
        """``validation`` is ``(GameData, evaluators)``, a zero-argument
        callable returning it (called at the first evaluation), or None.

        ``locked`` coordinates keep their ``initial_models`` entry: their
        scores take part in the residual accounting, but they never train,
        so they need no entry in ``coordinates``. ``checkpoint`` (an
        :class:`~photon_ml_tpu_torch.io.checkpoint.CheckpointManager`)
        saves the state after every coordinate step; ``resume`` restarts
        from its latest step. ``guard`` (a
        :class:`~photon_ml_tpu_torch.resilience.DivergenceGuard`) checks
        each step's outputs for NaN/Inf: on divergence the step is rolled
        back (re-read from ``checkpoint`` when one is present), the
        coordinate's regularization is raised, and the step retries; past
        the retry budget the coordinate freezes at its last good model.
        ``guard=None`` is the unguarded path, and a healthy guarded run is
        bit-identical to it (the checks only read)."""
        locked = set(locked)
        coordinates = dict(coordinates)  # guard retries may raise a lam
        for cid in locked:
            if not initial_models or cid not in initial_models:
                raise KeyError(
                    f"locked coordinate {cid!r} needs an initial model")
        for cid in self.update_sequence:
            if cid not in coordinates and cid not in locked:
                raise KeyError(
                    f"update sequence names unknown coordinate {cid!r}")
        # the memory-cliff guard: K coordinate score vectors and the
        # running total, f32 on the device for the whole run
        score_bytes = (len(self.update_sequence) + 1) * data.n_samples * 4
        budget = (self.max_score_memory_bytes
                  if self.max_score_memory_bytes is not None
                  else _device_memory_bytes(torch.device(device)) // 2)
        if score_bytes > budget:
            raise ValueError(
                f"score decomposition needs {score_bytes / 2**30:.1f} GiB "
                f"device memory ({len(self.update_sequence)}+1 vectors x "
                f"{data.n_samples} samples x 4 B) — over the "
                f"{budget / 2**30:.1f} GiB budget. Shard the run across "
                f"more cards or processes (game/multiprocess.py, "
                f"--multihost), or raise max_score_memory_bytes if you "
                f"know the design fits")
        models: dict[str, CoordinateModel] = dict(initial_models or {})
        n = data.n_samples
        scores = {cid: torch.zeros(n, dtype=torch.float32, device=device)
                  for cid in self.update_sequence}
        # host mirror for checkpoints, synced one coordinate a step (the
        # one just trained); a run without a checkpoint copies nothing back
        host_scores: dict[str, np.ndarray] = {}
        if checkpoint is not None:
            host_scores = {cid: np.zeros(n, np.float32)
                           for cid in self.update_sequence}
        # seed scores from the initial models (the warm-start path)
        for cid, model in models.items():
            if cid in scores:
                seeded = model.score(data).astype(np.float32)
                if checkpoint is not None:
                    host_scores[cid] = seeded
                scores[cid] = torch.as_tensor(seeded, device=device)

        def restore():
            state = checkpoint.restore(
                expected_fingerprint=config_fingerprint, device=device)
            for k, v in state.scores.items():
                if k in scores:
                    host_scores[k] = np.asarray(v, np.float32)
                    scores[k] = torch.as_tensor(host_scores[k],
                                                device=device)
            return state

        start_sweep, start_coord = 0, 0
        if (resume and checkpoint is not None
                and checkpoint.latest_step() is not None):
            state = restore()
            models = dict(state.model.coordinates)
            start_sweep, start_coord = state.sweep, state.coordinate_index
            logger.info("resumed from checkpoint: sweep %d coordinate %d",
                        start_sweep, start_coord)
        offsets = torch.as_tensor(data.offsets, device=device)
        total = offsets + sum(scores.values())

        # telemetry: live only while a trace is written, since the per-step
        # loss and grad-norm reads sync the device
        telemetry_on = tracing.enabled()
        if telemetry_on:
            from photon_ml_tpu_torch.ops.losses import loss_for_task

            _loss = loss_for_task(task)
            _labels_d = torch.as_tensor(data.labels, dtype=torch.float32,
                                        device=device)
            _weights_d = torch.as_tensor(data.weights, dtype=torch.float32,
                                         device=device)
            _loss_gauge = _tmetrics.gauge(
                "photon_game_coordinate_loss",
                "Weighted data objective (no regularizer) after the "
                "coordinate's step", labels=("coordinate",))
            _gnorm_gauge = _tmetrics.gauge(
                "photon_game_coordinate_grad_norm",
                "Norm of the weighted margin gradient after the "
                "coordinate's step", labels=("coordinate",))
            _steps_total = _tmetrics.counter(
                "photon_game_coordinate_steps_total",
                "Committed coordinate-descent steps",
                labels=("coordinate",))

        history: list[dict[str, float]] = []
        final_evaluation = None
        step_seconds = []
        for sweep in range(start_sweep, self.n_iterations):
            heartbeat("cd.sweep")
            fault_point("worker.stall", sweep=sweep)
            with tracing.span("cd.sweep", sweep=sweep) as sweep_span:
                if telemetry_on:
                    compiles_at_start = profiling.total_compiles()
                for ci, cid in enumerate(self.update_sequence):
                    if sweep == start_sweep and ci < start_coord:
                        continue
                    heartbeat("cd.step")
                    if cid in locked:
                        continue  # frozen: scores stay as seeded
                    if (guard is not None and cid in guard.frozen
                            and cid in models):
                        # diverged earlier in this fit: kept at its last
                        # good model (a fresh configuration with no model
                        # retrains)
                        continue
                    with tracing.span("cd.step", coordinate=cid,
                                      sweep=sweep) as step_span:
                        with _STEP_DISPATCH.labels(
                                coordinate=cid).time() as dispatch_timer:
                            while True:
                                residual = total - scores[cid]
                                try:
                                    with torch.profiler.record_function(
                                            f"cd.step[{cid}]"):
                                        model, new_scores = coordinates[
                                            cid].train(residual,
                                                       models.get(cid),
                                                       sweep=sweep)
                                    new_scores = fault_value(
                                        "optimizer.step", new_scores,
                                        coordinate=cid, sweep=sweep)
                                    if debug_nans():
                                        check_finite(
                                            f"cd.step[{cid}] scores",
                                            new_scores.shape, new_scores)
                                    step_error = None
                                except Exception as e:
                                    if guard is None:
                                        raise
                                    model, new_scores, step_error = \
                                        None, None, e
                                if guard is None or (
                                        step_error is None
                                        and guard.healthy(model,
                                                          new_scores)):
                                    break  # healthy: commit below
                                action = guard.on_divergence(
                                    cid, sweep=sweep,
                                    has_good_model=cid in models,
                                    error=step_error)
                                if action == "freeze":
                                    new_scores = None  # keep last good
                                    break
                                # roll back to the last durable state:
                                # nothing was committed in-process, and
                                # with a checkpoint the state is re-read
                                # from disk, as a restart would
                                if (checkpoint is not None
                                        and checkpoint.latest_step()
                                        is not None):
                                    models = dict(
                                        restore().model.coordinates)
                                    total = offsets + sum(scores.values())
                                # regularization backoff: stronger
                                # curvature is the standard fix for a
                                # diverged GLM solve
                                coord = coordinates[cid]
                                coordinates[cid] = dataclasses.replace(
                                    coord, lam=guard.next_lam(coord.lam))
                                logger.warning(
                                    "coordinate %s: retrying with "
                                    "regularization %g (was %g)", cid,
                                    coordinates[cid].lam, coord.lam)
                        if new_scores is None:
                            continue  # frozen mid-sweep: nothing to commit
                        models[cid] = model
                        total = residual + new_scores
                        scores[cid] = new_scores
                        if telemetry_on:
                            # progress of the block objective CD
                            # minimizes: the loss of the committed total
                            # margin and the norm of its margin gradient
                            margins = total.to(torch.float32)
                            obj = float(torch.sum(
                                _weights_d * _loss.loss(margins, _labels_d)))
                            gnorm = float(torch.linalg.norm(
                                _weights_d * _loss.d1(margins, _labels_d)))
                            step_span.set(loss=obj, grad_norm=gnorm)
                            _loss_gauge.labels(coordinate=cid).set(obj)
                            _gnorm_gauge.labels(coordinate=cid).set(gnorm)
                            _steps_total.labels(coordinate=cid).inc()
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
                        # the step's wall to here, device work included:
                        # the dispatch timer's running read (it observed
                        # the dispatch alone when its block closed)
                        step_seconds.append(
                            (sweep, cid, dispatch_timer.elapsed()))
                        logger.info("sweep %d coordinate %s trained in "
                                    "%.2fs", sweep, cid, step_seconds[-1][2])
                        if checkpoint is not None:
                            from photon_ml_tpu_torch.io.checkpoint import (
                                CoordinateDescentState,
                            )

                            host_scores[cid] = new_scores.cpu().numpy()
                            next_ci = (ci + 1) % len(self.update_sequence)
                            checkpoint.save(
                                sweep * len(self.update_sequence) + ci + 1,
                                CoordinateDescentState(
                                    sweep=sweep + (next_ci == 0),
                                    coordinate_index=next_ci,
                                    model=GameModel(
                                        coordinates=dict(models), task=task),
                                    scores=dict(host_scores)),
                                fingerprint=config_fingerprint)
                if validation is not None:
                    if callable(validation):
                        # a deferred validation set: its first use joins it
                        validation = validation()
                    vdata, evaluators = validation
                    with tracing.span("cd.validate", sweep=sweep):
                        gm = GameModel(coordinates=dict(models), task=task)
                        results = evaluate_all(
                            evaluators, gm.score(vdata), vdata.labels,
                            weights=vdata.weights, id_tags=vdata.id_columns)
                    history.append(results.as_dict())
                    final_evaluation = results
                    logger.info("sweep %d validation: %s", sweep, results)
                if telemetry_on:
                    sweep_span.set(compiles=profiling.total_compiles()
                                   - compiles_at_start)
            # the fleet-metrics fold point (a no-op unless --metrics-port
            # installed a hook), outside the sweep span so the fold's own
            # wall never counts as the sweep's
            fleet.sweep_boundary(sweep=sweep)

        model = GameModel(
            coordinates={cid: models[cid] for cid in self.update_sequence},
            task=task)
        if validation is not None and final_evaluation is None:
            # no sweep ran (resumed from a finished checkpoint): evaluate
            # the final model so the caller still gets its metrics
            if callable(validation):
                validation = validation()
            vdata, evaluators = validation
            final_evaluation = evaluate_all(
                evaluators, model.score(vdata), vdata.labels,
                weights=vdata.weights, id_tags=vdata.id_columns)
            history.append(final_evaluation.as_dict())
        return CoordinateDescentResult(
            model=model, validation_history=history,
            final_evaluation=final_evaluation, step_seconds=step_seconds,
            regularization_weights={cid: c.lam
                                    for cid, c in coordinates.items()})
