"""Hyperparameter search loops (reference
``photon-lib/.../hyperparameter/search/{RandomSearch, GaussianProcessSearch}.scala``).

Both searches work on a box of named parameter ranges; values are sampled /
modeled in [0,1]^d (log-scaled per dimension when the range spans decades —
regularization weights always do) and mapped back before calling the
evaluation function. The evaluation function is the reference's
``EvaluationFunction``: run training at a config, return the validation
metric (e.g. one ``GameEstimator.fit`` configuration).

A copy of ``photon_ml_tpu/hyperparameter/search.py`` (host numpy; the port
imports nothing of the JAX package): both packages draw the same points for
the same seed.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Mapping, Sequence

import numpy as np

from photon_ml_tpu_torch.hyperparameter.criteria import expected_improvement
from photon_ml_tpu_torch.hyperparameter.gp import GaussianProcessEstimator

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ParamRange:
    """One searched dimension. ``log_scale`` samples uniformly in log space."""

    low: float
    high: float
    log_scale: bool = True

    def __post_init__(self):
        if not self.high > self.low:
            raise ValueError(f"need high > low, got [{self.low}, {self.high}]")
        if self.log_scale and self.low <= 0:
            raise ValueError("log_scale ranges need low > 0")

    def to_unit(self, v: float) -> float:
        if self.log_scale:
            return float((np.log(v) - np.log(self.low))
                         / (np.log(self.high) - np.log(self.low)))
        return float((v - self.low) / (self.high - self.low))

    def from_unit(self, u: float) -> float:
        u = float(np.clip(u, 0.0, 1.0))
        if self.log_scale:
            return float(np.exp(np.log(self.low)
                                + u * (np.log(self.high) - np.log(self.low))))
        return float(self.low + u * (self.high - self.low))


@dataclasses.dataclass
class SearchResult:
    configs: list[dict[str, float]]
    values: list[float]

    def best(self, maximize: bool) -> tuple[dict[str, float], float]:
        i = int(np.argmax(self.values) if maximize else np.argmin(self.values))
        return self.configs[i], self.values[i]


@dataclasses.dataclass(frozen=True)
class RandomSearch:
    """Uniform (log-)random sampling of the box."""

    space: Mapping[str, ParamRange]
    seed: int = 0

    def find(self, evaluate: Callable[[dict[str, float]], float],
             n_iterations: int) -> SearchResult:
        rng = np.random.default_rng(self.seed)
        names = list(self.space)
        configs, values = [], []
        for _ in range(n_iterations):
            u = rng.uniform(size=len(names))
            config = {k: self.space[k].from_unit(ui)
                      for k, ui in zip(names, u)}
            configs.append(config)
            values.append(float(evaluate(config)))
        return SearchResult(configs=configs, values=values)


@dataclasses.dataclass(frozen=True)
class GaussianProcessSearch:
    """Bayesian optimization: GP surrogate + EI, seeded by random points
    (reference ``GaussianProcessSearch``: observed points fit a
    ``GaussianProcessEstimator``; the next config maximizes EI over a
    candidate pool)."""

    space: Mapping[str, ParamRange]
    maximize: bool = True
    n_seed_points: int = 3
    n_candidates: int = 1024
    estimator: GaussianProcessEstimator = GaussianProcessEstimator()
    seed: int = 0

    def find(self, evaluate: Callable[[dict[str, float]], float],
             n_iterations: int,
             prior_observations: Sequence[tuple[dict[str, float], float]] = (),
             ) -> SearchResult:
        rng = np.random.default_rng(self.seed)
        names = list(self.space)
        xs: list[np.ndarray] = []
        configs: list[dict[str, float]] = []
        values: list[float] = []
        for cfg, val in prior_observations:
            xs.append(np.array([self.space[k].to_unit(cfg[k]) for k in names]))
            configs.append(dict(cfg))
            values.append(float(val))

        def observe(u: np.ndarray):
            config = {k: self.space[k].from_unit(ui) for k, ui in zip(names, u)}
            value = float(evaluate(config))
            xs.append(np.asarray(u, np.float64))
            configs.append(config)
            values.append(value)
            logger.info("GP search: %s -> %g", config, value)

        n_seed = min(self.n_seed_points, n_iterations)
        if not xs and n_seed == 0 and n_iterations > 0:
            n_seed = 1  # the GP needs at least one observation to fit
        for _ in range(n_seed):
            observe(rng.uniform(size=len(names)))

        for _ in range(n_iterations - n_seed):
            model = self.estimator.fit(np.stack(xs), np.array(values))
            cand = rng.uniform(size=(self.n_candidates, len(names)))
            mean, var = model.predict(cand)
            best = max(values) if self.maximize else min(values)
            ei = expected_improvement(mean, var, best, maximize=self.maximize)
            observe(cand[int(np.argmax(ei))])

        return SearchResult(configs=configs, values=values)
