"""Inline config DSLs of the command-line tools (counterpart of
``photon_ml_tpu/cli/config.py``; the same grammar):

**Feature shard** (``--feature-shards``, comma-separated)::

    shardId=bag1+bag2            # bags; intercept on by default
    shardId=bag1+bag2|noIntercept
    shardId=*                    # every feature in the record

**Coordinate** (``--coordinates``, one argument per coordinate)::

    coordId=fixed,shard=global,optimizer=LBFGS,reg=L2,maxIter=80,tol=1e-6
    coordId=random,entity=userId,shard=user,reg=L2,activeUpper=1000,
           activeLower=1,maxFeatures=500,buckets=histogram

**Regularization weights** (``--grid``)::

    coordId=0.1;1;10  [space-separated groups → cartesian product]

Options the port does not run yet raise :class:`NotImplementedError` naming
the option: factored random effects, ``downsample`` and
``projector=RANDOM``. The resilience, telemetry, supervision and serving
flag groups are not ported: :func:`add_unported_flags` lets a command
accept such flags and :func:`refuse_unported` raise naming them.
"""

from __future__ import annotations

import argparse
import itertools
from typing import Mapping, Sequence

from photon_ml_tpu_torch.game.data import RandomEffectDatasetConfig
from photon_ml_tpu_torch.game.estimator import (
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.game.projector import ProjectorType
from photon_ml_tpu_torch.glm.problem import GLMOptimizationConfiguration
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfig
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.types import (
    OptimizerType,
    RegularizationType,
    VarianceComputationType,
)


def parse_feature_shard_config(spec: str) -> FeatureShardConfig:
    spec = spec.strip()
    if "=" not in spec:
        raise ValueError(f"feature shard spec needs shardId=bags, got {spec!r}")
    shard_id, rhs = spec.split("=", 1)
    has_intercept = True
    if "|" in rhs:
        rhs, flag = rhs.split("|", 1)
        if flag == "noIntercept":
            has_intercept = False
        elif flag != "intercept":
            raise ValueError(f"unknown shard flag {flag!r}")
    bags = None if rhs == "*" else tuple(b for b in rhs.split("+") if b)
    return FeatureShardConfig(shard_id=shard_id.strip(), feature_bags=bags,
                              has_intercept=has_intercept)


def _parse_kv(parts: Sequence[str]) -> dict[str, str]:
    out = {}
    for p in parts:
        if not p:
            continue
        if "=" not in p:
            raise ValueError(f"expected key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def _optimization(kv: dict) -> GLMOptimizationConfiguration:
    reg_type = RegularizationType(kv.pop("reg", "NONE").upper())
    alpha = float(kv.pop("alpha", 0.5))
    optimizer = OptimizerType(kv.pop("optimizer", "LBFGS").upper())
    opt_cfg = OptimizerConfig(
        max_iterations=int(kv.pop("maxIter", 80)),
        tolerance=float(kv.pop("tol", 1e-6)),
        history=int(kv.pop("history", 10)),
    )
    variance = VarianceComputationType(kv.pop("variance", "NONE").upper())
    return GLMOptimizationConfiguration(
        optimizer=optimizer,
        regularization=RegularizationContext(reg_type, alpha=alpha),
        optimizer_config=opt_cfg,
        variance_type=variance,
    )


def parse_coordinate_config(spec: str):
    """Returns (coordinateId, FixedEffect/RandomEffectCoordinateConfig)."""
    spec = spec.strip()
    if "=" not in spec:
        raise ValueError(f"coordinate spec needs coordId=kind,..., got {spec!r}")
    cid, rhs = spec.split("=", 1)
    cid = cid.strip()
    parts = rhs.split(",")
    kind = parts[0].strip()
    kv = _parse_kv(parts[1:])
    if kind == "fixed":
        shard = kv.pop("shard")
        if "downsample" in kv:
            raise NotImplementedError(
                f"coordinate {cid!r}: downsample (down-sampling) is not "
                "ported")
        cfg = FixedEffectCoordinateConfig(
            feature_shard_id=shard, optimization=_optimization(kv))
    elif kind == "factored":
        raise NotImplementedError(
            f"coordinate {cid!r}: factored random effects are not ported")
    elif kind == "random":
        entity = kv.pop("entity")
        shard = kv.pop("shard")
        cache = kv.pop("cacheBuckets", "true").lower()
        if cache not in ("true", "false"):
            raise ValueError(
                f"cacheBuckets must be true or false, got {cache!r}")
        projector_type = ProjectorType(
            kv.pop("projector", "INDEX_MAP").upper())
        if projector_type is ProjectorType.RANDOM:
            raise NotImplementedError(
                f"coordinate {cid!r}: projector=RANDOM is not ported")
        buckets = kv.pop("buckets", "geometric").lower()
        ds = RandomEffectDatasetConfig(
            random_effect_type=entity,
            feature_shard_id=shard,
            active_data_upper_bound=(int(kv.pop("activeUpper"))
                                     if "activeUpper" in kv else None),
            active_data_lower_bound=int(kv.pop("activeLower", 1)),
            max_active_features=(int(kv.pop("maxFeatures"))
                                 if "maxFeatures" in kv else None),
            projector_type=projector_type,
            projected_dim=(int(kv.pop("projectedDim"))
                           if "projectedDim" in kv else None),
            cache_device_buckets=cache == "true",
            bucket_strategy=buckets,
            max_sample_buckets=int(kv.pop("maxSampleBuckets", 8)),
            max_feature_buckets=int(kv.pop("maxFeatureBuckets", 4)),
        )
        cfg = RandomEffectCoordinateConfig(
            dataset=ds, optimization=_optimization(kv))
    else:
        raise ValueError(
            f"coordinate kind must be fixed|random|factored, got {kind!r}")
    if kv:
        raise ValueError(f"unknown coordinate options {sorted(kv)} in {spec!r}")
    return cid, cfg


def parse_grid(specs: Sequence[str]) -> list[Mapping[str, float]]:
    """``coordId=0.1;1;10`` groups → cartesian product of per-coordinate
    lambda lists."""
    axes: list[tuple[str, list[float]]] = []
    for spec in specs:
        cid, rhs = spec.split("=", 1)
        axes.append((cid.strip(), [float(x) for x in rhs.split(";") if x]))
    out = []
    for combo in itertools.product(*(vals for _, vals in axes)):
        out.append({cid: v for (cid, _), v in zip(axes, combo)})
    return out or [{}]


def add_unported_flags(parser: argparse.ArgumentParser,
                       flags: Mapping[str, dict]) -> None:
    """Accept each of the reference's ``flags`` (name → argparse settings)
    that a command does not run yet; :func:`refuse_unported` raises for the
    ones given. A ``default`` among the settings is the reference's
    default: giving the flag that value is accepted."""
    for flag, kwargs in flags.items():
        kwargs = {k: v for k, v in kwargs.items() if k != "default"}
        parser.add_argument(flag, default=argparse.SUPPRESS,
                            help="not ported: raises NotImplementedError",
                            **kwargs)


def refuse_unported(args: argparse.Namespace,
                    flags: Mapping[str, dict]) -> None:
    """Raise :class:`NotImplementedError` naming the first of ``flags``
    given on the command line away from its reference default."""
    for flag, kwargs in flags.items():
        dest = flag[2:].replace("-", "_")
        if not hasattr(args, dest):
            continue
        if "default" not in kwargs or getattr(args, dest) != kwargs["default"]:
            raise NotImplementedError(f"{flag} is not ported")
