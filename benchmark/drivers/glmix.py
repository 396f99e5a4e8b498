"""GAME logistic regression (GLMix): a global fixed effect and per-entity
random effects, one coordinate-descent iteration, through
``GameEstimator.prepare`` once and ``GameEstimator.fit`` per unit.

The data is Music-shaped and drawn on the device: a global bag
(``global_nonzero`` of ``global_features`` features, plus an intercept
column), an item bag (``item_nonzero`` of ``item_features``), user and song
ids, and labels from a logistic model of planted fixed, per-user and
per-song effects. Entity sizes follow Zipf counts fixed by the
configuration. The rows come from the configuration's ``data_seed``; the
run's seed flips the signs of features (the intercept's aside). The solves
stop where float32 no longer resolves their progress, so fresh rows change
the iterations of every solve, and a fit's work, by tens of percent; sign
flips leave every rounding as it was, and every seed makes the same steps.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from benchmark.harness import finite_tensors
from benchmark.reference import glmix as reference

#: rows drawn at a time on the device
CHUNK = 1 << 20


def zipf_counts(total: int, n: int, exponent: float) -> np.ndarray:
    """Rows of each of ``n`` entities, by rank: ``total`` split in
    proportion to ``rank ** -exponent``, each at least 1, the rounding's
    remainder given to the first ranks."""
    p = np.arange(1, n + 1, dtype=np.float64) ** -exponent
    c = np.maximum(np.floor(total * p / p.sum()).astype(np.int64), 1)
    c[: total - int(c.sum())] += 1
    if int(c.sum()) != total:
        raise ValueError(f"cannot split {total} rows over {n} entities")
    return c


def entity_column(total, n, exponent, gen, device) -> torch.Tensor:
    counts = torch.as_tensor(zipf_counts(total, n, exponent), device=device)
    ids = torch.randperm(n, generator=gen, device=device)
    col = ids.repeat_interleave(counts)
    return col[torch.randperm(total, generator=gen, device=device)]


def _pick(rows, width, k, gen, device):
    """``k`` distinct sorted columns of ``width`` per row."""
    r = torch.rand(rows, width, generator=gen, device=device)
    return r.topk(k, dim=1).indices.sort(dim=1).values


def feature_signs(cfg, gen, device) -> tuple:
    """(global, item): a sign for each feature of the two bags, drawn by
    ``gen``."""
    return tuple(
        torch.randint(0, 2, (cfg[k],), generator=gen, device=device)
        .to(torch.float32) * 2 - 1
        for k in ("global_features", "item_features"))


def draw(cfg, rows, planted, signs, gen, device) -> dict:
    """One split's rows as host arrays: the bags' columns and values, the
    ids and the labels, all from ``gen``; then each value times its
    feature's sign from ``signs``, which float32 represents exactly: the
    labels, and the problem up to those signs, do not depend on them."""
    dg, kg = cfg["global_features"], cfg["global_nonzero"]
    di, ki = cfg["item_features"], cfg["item_nonzero"]
    user = entity_column(rows, cfg["users"], cfg["zipf_exponent"], gen,
                         device)
    song = entity_column(rows, cfg["songs"], cfg["zipf_exponent"], gen,
                         device)
    w_fixed, user_eff, song_eff = planted
    parts = {k: [] for k in ("g_cols", "g_vals", "i_cols", "i_vals", "y")}
    for lo in range(0, rows, CHUNK):
        hi = min(rows, lo + CHUNK)
        b = hi - lo
        fi = _pick(b, dg, kg, gen, device)
        fv = torch.randn(b, kg, generator=gen, device=device)
        ii = _pick(b, di, ki, gen, device)
        iv = torch.randn(b, ki, generator=gen, device=device)
        margin = ((w_fixed[fi] * fv).sum(1) / math.sqrt(kg)
                  + (user_eff[user[lo:hi]].gather(1, ii) * iv).sum(1)
                  + (song_eff[song[lo:hi]].gather(1, ii) * iv).sum(1))
        u = torch.rand(b, generator=gen, device=device)
        y = (u < torch.sigmoid(margin)).to(torch.float32)
        fv, iv = fv * signs[0][fi], iv * signs[1][ii]
        for k, v in (("g_cols", fi), ("g_vals", fv), ("i_cols", ii),
                     ("i_vals", iv), ("y", y)):
            parts[k].append(v.cpu())
    out = {k: torch.cat(v).numpy() for k, v in parts.items()}
    out["g_cols"] = out["g_cols"].astype(np.int32)
    out["i_cols"] = out["i_cols"].astype(np.int32)
    out["user"] = user.cpu().numpy().astype(np.int64)
    out["song"] = song.cpu().numpy().astype(np.int64)
    return out


def game_data(raw: dict, cfg):
    """The program's GameData over copies of ``raw``: a global shard with
    the intercept in column ``global_features``, and the item shard."""
    from photon_ml_tpu_torch.game.data import FeatureShard, GameData

    n, kg = raw["g_cols"].shape
    ki = raw["i_cols"].shape[1]
    dg = cfg["global_features"]
    g_cols = np.concatenate([raw["g_cols"], np.full((n, 1), dg, np.int32)],
                            axis=1)
    g_vals = np.concatenate([raw["g_vals"], np.ones((n, 1), np.float32)],
                            axis=1)
    shards = {
        "global": FeatureShard(
            indptr=np.arange(n + 1, dtype=np.int64) * (kg + 1),
            cols=g_cols.reshape(-1), vals=g_vals.reshape(-1), dim=dg + 1),
        "item": FeatureShard(
            indptr=np.arange(n + 1, dtype=np.int64) * ki,
            cols=raw["i_cols"].reshape(-1).copy(),
            vals=raw["i_vals"].reshape(-1).copy(),
            dim=cfg["item_features"]),
    }
    return GameData.build(labels=raw["y"].copy(), shards=shards,
                          id_columns={"userId": raw["user"].copy(),
                                      "songId": raw["song"].copy()})


@dataclasses.dataclass
class State:
    cfg: dict
    raw_train: dict
    raw_valid: dict
    train: object
    valid: object
    estimator: object
    datasets: object
    configuration: object
    evaluators: list
    device: torch.device


def setup(cfg, traffic, seed, device, obs) -> State:
    from photon_ml_tpu_torch.evaluation import parse_evaluators
    from photon_ml_tpu_torch.game import (
        GameEstimator,
        RandomEffectDatasetConfig,
    )
    from photon_ml_tpu_torch.game.estimator import (
        FixedEffectCoordinateConfig,
        GameOptimizationConfiguration,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
    from photon_ml_tpu_torch.ops.regularization import L2Regularization
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    signs = feature_signs(cfg, gen, device)
    data = torch.Generator(device=device)
    data.manual_seed(cfg["data_seed"])
    planted = (
        torch.randn(cfg["global_features"], generator=data, device=device),
        torch.randn(cfg["users"], cfg["item_features"], generator=data,
                    device=device),
        0.7 * torch.randn(cfg["songs"], cfg["item_features"], generator=data,
                          device=device))
    raw_train = draw(cfg, cfg["train_rows"], planted, signs, data, device)
    raw_valid = draw(cfg, cfg["validation_rows"], planted, signs, data,
                     device)
    del planted, signs

    t0 = time.perf_counter()
    train, valid = game_data(raw_train, cfg), game_data(raw_valid, cfg)
    opt = GLMOptimizationConfiguration(
        optimizer=OptimizerType(cfg["optimizer"]),
        regularization=L2Regularization,
        optimizer_config=OptimizerConfig(max_iterations=cfg["max_iter"],
                                         tolerance=cfg["tolerance"]))
    dtype = cfg["design_dtype"]
    coords = {"global": FixedEffectCoordinateConfig(
        "global", opt, design_dtype=dtype)}
    for cid, column in (("perUser", "userId"), ("perSong", "songId")):
        coords[cid] = RandomEffectCoordinateConfig(
            dataset=RandomEffectDatasetConfig(column, "item"),
            optimization=opt, design_dtype=dtype)
    estimator = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=coords,
        update_sequence=list(coords), n_cd_iterations=cfg["cd_iterations"],
        device=device)
    datasets = estimator.prepare(train)
    if device.type == "cuda":
        torch.cuda.synchronize()
    obs.info["build_s"] = time.perf_counter() - t0
    obs.info["random_effects"] = ["perUser", "perSong"]
    return State(cfg=cfg, raw_train=raw_train, raw_valid=raw_valid,
                 train=train, valid=valid, estimator=estimator,
                 datasets=datasets,
                 configuration=GameOptimizationConfiguration(
                     dict(cfg["lambda"])),
                 evaluators=parse_evaluators([traffic["evaluator"]]),
                 device=device)


def unit(state: State, obs):
    """One GAME fit from zero coefficients on the prepared datasets, with
    the validation set's evaluation."""
    return state.estimator.fit(
        state.train, [state.configuration],
        validation=(state.valid, state.evaluators),
        datasets=state.datasets)[0]


def _device_tables(result) -> list:
    out = []
    for m in result.model.coordinates.values():
        if hasattr(m, "coeffs_device") and m.coeffs_device is not None:
            out.append(m.coeffs_device)
        elif hasattr(m, "model"):
            out.append(m.model.coefficients.means)
    return out


def finite(result) -> bool:
    return finite_tensors(_device_tables(result))


def keep(result):
    return result


def validation_auc(result) -> float:
    """The validation AUC that the fit reported (its first evaluator)."""
    return float(result.evaluation.primary[1])


def coefficients(result, cfg) -> dict:
    """The fit's coefficients as dense host arrays: the fixed effect's, and
    each random effect's ``(entities, item_features)`` table."""
    from photon_ml_tpu_torch.game.model import RandomEffectModel

    model = result.model
    model.materialize()
    out = {}
    sizes = {"perUser": cfg["users"], "perSong": cfg["songs"]}
    for cid, m in model.coordinates.items():
        if isinstance(m, RandomEffectModel):
            w = np.zeros((sizes[cid], m.dim), np.float64)
            w.reshape(-1)[np.asarray(m.keys)] = np.asarray(m.coeffs)
            out[cid] = w
        else:
            out[cid] = m.model.coefficients.means.detach().cpu().double() \
                .numpy()
    return out


def check(state: State, kept: list, seed: int) -> dict:
    """Frees the program's state, then holds each kept fit (its
    coefficients and its reported validation AUC) to the plain reference
    (``reference/glmix.py``): the worst over the fits of each number."""
    cfg = state.cfg
    fits = [{**coefficients(r, cfg), "auc": validation_auc(r)}
            for r in kept]
    raw = state.raw_train
    device = state.device
    for data in (state.train, state.valid):
        data.clear_device_cache()
    state.estimator = state.datasets = state.train = state.valid = None
    kept.clear()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    problem = reference.Problem.from_raw(raw, cfg, device,
                                         valid=state.raw_valid)
    numbers: dict = {}
    for fit in fits:
        for name, value in problem.compare(
                fit, control=bool(cfg.get("reference_control"))).items():
            numbers[name] = max(value, numbers.get(name, 0.0))
    return numbers
