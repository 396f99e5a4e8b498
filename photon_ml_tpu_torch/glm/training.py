"""Single-model GLM training: the regularization sweep and model selection.

Counterpart of ``photon_ml_tpu/glm/training.py`` (the reference's
``ModelTraining.scala``): train one model per regularization weight,
descending, each solve warm-started from the previous lambda's solution
(:func:`train_glm_sweep`), or all lambdas at once as lanes of one batched
solve (:func:`train_glm_sweep_batched`); then pick the best by a validation
evaluator (:func:`validate_and_select`). Normalization is a
coefficient-space reparameterization inside the objective; trained
coefficients are mapped back to original feature space before models are
returned.

On a dense design the sequential sweep runs kernel 1 for every objective
evaluation (and kernel 3 for every CG product under TRON); the batched
sweep runs kernel 4, one pass over the design for all lambdas. L1 and
elastic net solve with OWL-QN in both sweeps. A sparse design
(:class:`~photon_ml_tpu_torch.ops.design.ChunkedSparseDesign`) takes the
closed forms, its lanes sharing each gather in the batched sweep. With
``distributed=True`` (a multi-process job, ``train_glm --multihost``) the
objective is :class:`~photon_ml_tpu_torch.parallel.distributed.
DistributedGLMObjective`: each rank solves on its own rows and one
``all_reduce`` a evaluation sums them, every rank running the same sweep in
lockstep. Each lambda beats the supervisor's heartbeat and passes the
``worker.stall`` fault point, and ends at the fleet-metrics fold point
(``telemetry/aggregate.py::sweep_boundary``); each solve is profiled as
``glm.sweep_solve`` (``glm.sweep_solve_batched`` for the batched sweep,
:mod:`~photon_ml_tpu_torch.telemetry.profiling`). Grouped evaluators read their groups from ``id_tags``. Host arrays
become a :class:`GLMData` on the device through
:func:`photon_ml_tpu_torch.convert.glm_data_from_arrays` (the dense branch
of the JAX package's ``cli/train_glm.py::_to_glm_data``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from photon_ml_tpu_torch.evaluation import (
    EvaluationResults,
    Evaluator,
    evaluate_all,
)
from photon_ml_tpu_torch.glm.problem import (
    GLMOptimizationConfiguration,
    OptimizationProblem,
)
from photon_ml_tpu_torch.models import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.design import accumulation_dtype
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.normalization import (
    NoNormalization,
    NormalizationContext,
)
from photon_ml_tpu_torch.ops.objective import GLMData, GLMObjective
from photon_ml_tpu_torch.optimize import OptimizerResult
from photon_ml_tpu_torch.telemetry import profiling
from photon_ml_tpu_torch.telemetry.aggregate import sweep_boundary
from photon_ml_tpu_torch.types import TaskType


def _solve(problem: OptimizationProblem, data: GLMData, w0, lam):
    return problem.run(data, w0, lam)


_sweep_solve = profiling.profile_fn(_solve, "glm.sweep_solve")
_sweep_solve_batched = profiling.profile_fn(_solve, "glm.sweep_solve_batched")


@dataclasses.dataclass(frozen=True)
class TrainedModel:
    """One (lambda, model, optimization trace) entry of the sweep. ``result``
    is the lambda's own lane: ``w`` ``(d,)``, scalar ``value``,
    ``iterations``, ``converged``, and its traces."""

    regularization_weight: float
    model: GeneralizedLinearModel
    result: OptimizerResult
    evaluation: Optional[EvaluationResults] = None


def build_problem(task: TaskType, config: GLMOptimizationConfiguration,
                  normalization: NormalizationContext = NoNormalization,
                  reg_mask: Optional[torch.Tensor] = None,
                  distributed: bool = False) -> OptimizationProblem:
    """The one place the sweep's optimization problem is assembled. A
    dense design with identity normalization runs the fused kernels; any
    other combination takes the closed forms. ``distributed`` sums the
    objective over the job's ranks (the JAX package's ``mesh``): ``data``
    is then this rank's block of rows."""
    objective = GLMObjective(loss=loss_for_task(task),
                             normalization=normalization, reg_mask=reg_mask)
    if distributed:
        from photon_ml_tpu_torch.parallel.distributed import (
            DistributedGLMObjective,
        )

        return OptimizationProblem(DistributedGLMObjective(objective), config)
    return OptimizationProblem(objective, config)


def lane_result(result: OptimizerResult, i: int) -> OptimizerResult:
    """Lane ``i`` of a batched :class:`OptimizerResult`."""
    return OptimizerResult(**{f.name: getattr(result, f.name)[i]
                              for f in dataclasses.fields(result)})


def _trained(problem, task, normalization, data, lam, result):
    variances = problem.compute_variances(result.w, data, lam)
    coeffs = Coefficients(means=result.w, variances=variances)
    model = GeneralizedLinearModel(
        coefficients=to_original_space(coeffs, normalization), task=task)
    return TrainedModel(float(lam), model, result)


def train_glm_sweep(
    task: TaskType,
    data: GLMData,
    regularization_weights: Sequence[float],
    config: GLMOptimizationConfiguration = GLMOptimizationConfiguration(),
    normalization: NormalizationContext = NoNormalization,
    reg_mask: Optional[torch.Tensor] = None,
    initial: Optional[torch.Tensor] = None,
    distributed: bool = False,
) -> list[TrainedModel]:
    """Train one GLM per regularization weight with warm starts.

    Weights are processed in descending order (strongest regularization
    first, the reference's warm-start direction); the returned list follows
    that order. ``reg_mask`` excludes coefficients (e.g. the intercept) from
    regularization. ``initial`` (transformed space) starts the first solve
    in place of zeros. The solve runs where ``data`` lies; with
    ``distributed`` over every rank's rows, ``data`` being this rank's."""
    from photon_ml_tpu_torch.resilience import fault_point, heartbeat

    for lam in regularization_weights:
        config.regularization.check_weight(lam)
    problem = build_problem(task, config, normalization, reg_mask,
                            distributed=distributed)
    design = data.design
    dt = accumulation_dtype(design.dtype)
    w = (torch.zeros(design.dim, dtype=dt, device=design.device)
         if initial is None
         else initial.to(dtype=dt, device=design.device))
    out: list[TrainedModel] = []
    for lam in sorted(regularization_weights, reverse=True):
        heartbeat("glm.sweep")
        fault_point("worker.stall", regularization_weight=float(lam))
        result = lane_result(_sweep_solve(problem, data, w, lam), 0)
        out.append(_trained(problem, task, normalization, data, lam, result))
        w = result.w
        # the lambda loop is the GLM driver's sweep boundary, in lockstep
        # on every rank of a distributed sweep
        sweep_boundary(regularization_weight=float(lam))
    return out


def train_glm_sweep_batched(
    task: TaskType,
    data: GLMData,
    regularization_weights: Sequence[float],
    config: GLMOptimizationConfiguration = GLMOptimizationConfiguration(),
    normalization: NormalizationContext = NoNormalization,
    reg_mask: Optional[torch.Tensor] = None,
) -> list[TrainedModel]:
    """All lambdas in one batched solve: each lambda is a lane starting from
    zero (no warm starts), every evaluation touches the design once for all
    lanes (kernel 4 on a dense design), and the solve runs until the
    slowest lane stops. Results follow the same descending-lambda order as
    :func:`train_glm_sweep`. As in the JAX package, the lambdas enter the
    solve as float32 values."""
    for lam in regularization_weights:
        config.regularization.check_weight(lam)
    problem = build_problem(task, config, normalization, reg_mask)
    lams = sorted((float(l) for l in regularization_weights), reverse=True)
    design = data.design
    dt = accumulation_dtype(design.dtype)
    w0 = torch.zeros((len(lams), design.dim), dtype=dt, device=design.device)
    batched = _sweep_solve_batched(
        problem, data, w0,
        torch.tensor(lams, dtype=torch.float32).to(design.device))
    return [_trained(problem, task, normalization, data, lam,
                     lane_result(batched, i))
            for i, lam in enumerate(lams)]


def to_original_space(coeffs: Coefficients,
                      normalization: NormalizationContext) -> Coefficients:
    """Map transformed-space coefficients (and variances, which scale by
    the squared factors) back to raw feature space for model output."""
    if normalization.is_identity:
        return coeffs
    means = normalization.model_to_original(coeffs.means)
    variances = coeffs.variances
    if variances is not None and normalization.factors is not None:
        variances = variances * normalization.factors ** 2
    return Coefficients(means=means, variances=variances)


def validate_and_select(
    trained: Sequence[TrainedModel],
    evaluators: Sequence[Evaluator],
    validation: GLMData,
    id_tags=None,
) -> tuple[int, list[TrainedModel]]:
    """Score every swept model on validation data and pick the best by the
    FIRST evaluator (reference ``ModelSelection.selectBestModel``). Returns
    ``(best_index, trained_with_evaluations)``; ``id_tags`` maps each id
    tag of a grouped evaluator to the validation rows' group ids."""
    labels = validation.labels.cpu().numpy()
    weights = validation.weights.cpu().numpy()
    best_idx, best_val = 0, None
    evaluated: list[TrainedModel] = []
    primary = evaluators[0]
    for i, tm in enumerate(trained):
        scores = tm.model.score(validation.design,
                                validation.offsets).cpu().numpy()
        ev = evaluate_all(evaluators, scores, labels, weights, id_tags)
        evaluated.append(dataclasses.replace(tm, evaluation=ev))
        val = ev.primary[1]
        if primary.better_than(val, best_val):
            best_idx, best_val = i, val
    return best_idx, evaluated
