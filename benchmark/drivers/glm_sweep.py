"""GLM logistic regression with L2: a regularization sweep and model
selection, through ``glm.train_glm_sweep`` (sequential lambdas with warm
starts) or ``glm.train_glm_sweep_batched`` (the lambdas as lanes of one
solve) and then ``glm.validate_and_select`` by the traffic's evaluator.

The data has the shape of the PASCAL 2008 ``epsilon`` set and is drawn on
the device: Gaussian features, each row scaled to unit L2 norm, and labels
from a planted logistic model whose margins have the standard deviation
``margin_scale``. The rows come from the configuration's ``data_seed``;
the run's seed flips the signs of features. The sweep's solves stop where
float32 no longer resolves their progress, so their steps, and the work
of a sweep, change by tens of percent with new rows or only a new row
order; sign flips leave every rounding as it was.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark.harness import finite_tensors
from benchmark.reference import glm as reference

#: rows drawn at a time on the device
CHUNK = 1 << 16


def draw(cfg, gen, device):
    """(x, y): ``rows + validation_rows`` unit-norm f32 rows and their
    labels; the last ``validation_rows`` are held out. The rows are the
    configuration's own (drawn from its ``data_seed``, a chunk at a time);
    ``gen`` draws the sign of each feature, which float32 represents
    exactly: every seed poses the same problem up to those signs, and the
    solves make the same steps bit for bit."""
    n, nv = cfg["rows"], cfg["validation_rows"]
    d = cfg["features"]
    signs = torch.randint(0, 2, (d,), generator=gen, device=device) * 2 - 1
    data = torch.Generator(device=device)
    data.manual_seed(cfg["data_seed"])
    w_true = torch.randn(d, generator=data, device=device)
    x = torch.empty(n + nv, d, dtype=torch.float32, device=device)
    y = torch.empty(n + nv, dtype=torch.float32, device=device)
    for c, lo in enumerate(range(0, n + nv, CHUNK)):
        hi = min(n + nv, lo + CHUNK)
        data.manual_seed(cfg["data_seed"] + 1 + c)
        xb = torch.randn(hi - lo, d, generator=data, device=device)
        xb /= torch.linalg.vector_norm(xb, dim=1, keepdim=True)
        # a unit row's margin x·w_true is standard normal
        margin = cfg["margin_scale"] * (xb @ w_true)
        u = torch.rand(hi - lo, generator=data, device=device)
        y[lo:hi] = (u < torch.sigmoid(margin)).to(torch.float32)
        x[lo:hi] = xb * signs
    return x, y


@dataclasses.dataclass
class State:
    cfg: dict
    x: torch.Tensor
    y: torch.Tensor
    train: object
    valid: object
    sweep: object
    opt: object
    evaluators: list
    device: torch.device


def glm_data(x, y, dtype):
    from photon_ml_tpu_torch.ops.design import DenseDesign
    from photon_ml_tpu_torch.ops.objective import GLMData

    return GLMData(design=DenseDesign(x=x.to(dtype).contiguous()), labels=y,
                   offsets=torch.zeros_like(y), weights=torch.ones_like(y))


def setup(cfg, traffic, seed, device, obs) -> State:
    from photon_ml_tpu_torch import glm
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.ops.regularization import L2Regularization
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType

    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x, y = draw(cfg, gen, device)
    n = cfg["rows"]
    dtype = getattr(torch, cfg["design_dtype"])
    sweeps = {"sequential": glm.train_glm_sweep,
              "batched": glm.train_glm_sweep_batched}
    opt = GLMOptimizationConfiguration(
        optimizer=OptimizerType(traffic["optimizer"]),
        regularization=L2Regularization,
        optimizer_config=OptimizerConfig(max_iterations=cfg["max_iter"],
                                         tolerance=cfg["tolerance"]))
    return State(cfg=cfg, x=x, y=y, train=glm_data(x[:n], y[:n], dtype),
                 valid=glm_data(x[n:], y[n:], dtype),
                 sweep=sweeps[traffic["sweep"]], opt=opt,
                 evaluators=parse_evaluators([traffic["evaluator"]]),
                 device=device)


def unit(state: State, obs):
    """One sweep over the configuration's lambdas from zero, then
    ``validate_and_select``; the selection's wall on the benchmark's
    clock (``select_s``)."""
    from photon_ml_tpu_torch import glm
    from photon_ml_tpu_torch.types import TaskType

    trained = state.sweep(TaskType.LOGISTIC_REGRESSION, state.train,
                          state.cfg["lambdas"], state.opt)
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, trained = glm.validate_and_select(trained, state.evaluators,
                                            state.valid)
    obs.add_clock("select_s", time.perf_counter() - t0)
    return best, trained


def finite(out) -> bool:
    _, trained = out
    return finite_tensors([tm.result.w for tm in trained])


def keep(out):
    best, trained = out
    return {"lambdas": [tm.regularization_weight for tm in trained],
            "w": [tm.result.w.detach().clone() for tm in trained],
            "auc": [float(tm.evaluation.primary[1]) for tm in trained],
            "best": best, "model": trained[best].model}


def check(state: State, kept: list, seed: int) -> dict:
    """The selected model's validation scores through the program's own
    scoring, then the program's state freed, then each kept sweep held to
    the plain reference (``reference/glm.py``): the worst over the sweeps
    of each number."""
    n = state.cfg["rows"]
    fits = []
    for k in kept:
        scores = k["model"].score(state.valid.design, state.valid.offsets)
        fits.append({"lambdas": k["lambdas"],
                     "w": [w.detach().to("cpu", torch.float64)
                           for w in k["w"]],
                     "best": k["best"], "auc": k["auc"],
                     "scores": scores.detach().to("cpu", torch.float64)})
    kept.clear()
    x, y = state.x, state.y
    state.train = state.valid = None
    if state.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    problem = reference.Problem(x[:n], y[:n], x[n:], y[n:])
    ref = problem.solve_path(fits[0]["lambdas"])
    numbers: dict = {}
    for fit in fits:
        for name, value in problem.compare(fit, ref).items():
            numbers[name] = max(value, numbers.get(name, 0.0))
    return numbers
