"""Train-time model-quality baselines + the drift arithmetic (PSI/KS).

Counterpart of ``photon_ml_tpu/quality/baseline.py``: the same host numpy,
the same ``quality-baseline.json`` (each package's registry reads the
other's). The port's drivers compute and write it on the background
saver's writer pool, beside ``best/``; the Hosmer–Lemeshow bins come from
:mod:`photon_ml_tpu_torch.diagnostics.hl` and the AUC from
:mod:`photon_ml_tpu_torch.evaluation.metrics`.

The telemetry stack observes the SYSTEM — latency, compiles, FLOPs,
restarts — while the model's predictions serve blind: with the continuous
refresh loop auto-publishing versions into a watched directory
(CONTINUOUS.md) and quantized tables introducing documented score
tolerances (SERVING.md), the highest-risk failure mode is a silently
degraded model activating into production with no metric moving. The
quality layer closes that gap, and this module is its reference side:

- :func:`compute_baseline` distills a validation (or training) score set
  into a compact :class:`QualityBaseline` — equal-mass score-histogram
  bins with their baseline proportions, mean/std/positive-rate, AUC
  (:mod:`~photon_ml_tpu_torch.evaluation.metrics`), per-coordinate
  margin-contribution stats, per-coordinate cold-start rates,
  per-shard feature coverage, and Hosmer–Lemeshow calibration bins
  (:mod:`~photon_ml_tpu_torch.diagnostics.hl` — the same binning the
  offline diagnostics report);
- the drivers publish it as ``quality-baseline.json`` at the run root
  (next to ``best/`` and ``data-manifest.json``), and the serving
  registry rediscovers it at load time (:func:`find_baseline`) to seed
  the online monitors;
- :func:`population_stability_index` / :func:`ks_statistic` are the ONE
  home of the drift arithmetic, and :func:`bin_scores` /
  :func:`quantile_edges` the one home of score-histogram binning: a
  second PSI implementation that floors proportions differently would
  silently disagree about what "drift" means.

Everything here is host numpy over arrays the callers already hold — no
device work, no hot-path cost.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Mapping, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.fleet.sharding import stable_hash_u32

#: artifact name, published at the RUN root (``best/`` and
#: ``all/config-i`` are siblings under it, like ``data-manifest.json``)
BASELINE_NAME = "quality-baseline.json"

#: default number of equal-mass score-histogram bins (the standard PSI
#: decile binning)
DEFAULT_SCORE_BINS = 10

#: proportion floor for the PSI log ratio — an empty bin must contribute
#: a large, finite penalty, not an infinity
_EPS = 1e-6


# ---------------------------------------------------------------------------
# binning + drift arithmetic (their one home)
# ---------------------------------------------------------------------------


def quantile_edges(scores: np.ndarray,
                   n_bins: int = DEFAULT_SCORE_BINS) -> np.ndarray:
    """Interior edges of ``n_bins`` equal-mass bins over ``scores``
    (deduplicated — discrete score sets may yield fewer bins). The outer
    bins are implicitly open (``-inf`` / ``+inf``), so every live score
    lands somewhere."""
    scores = np.asarray(scores, np.float64)
    if scores.size == 0 or n_bins < 2:
        return np.zeros(0, np.float64)
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return np.unique(np.quantile(scores, qs))


def bin_scores(scores: np.ndarray, edges: Sequence[float]) -> np.ndarray:
    """Per-bin counts of ``scores`` against interior ``edges``
    (``len(edges) + 1`` bins). The single binning used on BOTH sides of
    every PSI/KS comparison — baseline proportions and the live monitor
    accumulate through this exact function."""
    edges = np.asarray(edges, np.float64)
    bins = np.searchsorted(edges, np.asarray(scores, np.float64),
                           side="right")
    return np.bincount(bins, minlength=len(edges) + 1).astype(np.float64)


def _proportions(counts_or_props: Sequence[float]) -> np.ndarray:
    p = np.asarray(counts_or_props, np.float64)
    total = p.sum()
    p = p / total if total > 0 else np.full(p.shape, 1.0 / max(len(p), 1))
    return np.clip(p, _EPS, None)


def population_stability_index(expected, actual) -> float:
    """PSI of ``actual`` vs ``expected`` over matched bins (counts or
    proportions — both are normalized). Rule of thumb: < 0.1 stable,
    0.1–0.25 moderate shift, > 0.25 significant drift."""
    e = _proportions(expected)
    a = _proportions(actual)
    if e.shape != a.shape:
        raise ValueError(f"PSI needs matched bins, got {e.shape} vs {a.shape}")
    return float(np.sum((a - e) * np.log(a / e)))


def ks_statistic(expected, actual) -> float:
    """Kolmogorov–Smirnov distance between two binned distributions:
    max |ΔCDF| over the shared bin edges, in [0, 1]."""
    e = _proportions(expected)
    a = _proportions(actual)
    if e.shape != a.shape:
        raise ValueError(f"KS needs matched bins, got {e.shape} vs {a.shape}")
    return float(np.max(np.abs(np.cumsum(a) - np.cumsum(e))))


# ---------------------------------------------------------------------------
# rank-drift reference + arithmetic (the ranked-serving half of rule 6)
# ---------------------------------------------------------------------------


def rank_probe_sample(user_ids: Sequence[str], n: int = 16) -> tuple:
    """Deterministic probe-user sample for the rank-drift reference:
    the ``n`` ids that sort first by ``crc32(id)`` — stable across
    processes, loads and vocabulary dict order, and uniform-ish over the
    id universe (the same fleet-joinable hashing discipline the request
    log samples by)."""
    ids = sorted({str(u) for u in user_ids},
                 key=lambda u: (stable_hash_u32(u), u))
    return tuple(ids[:max(int(n), 1)])


def rank_probe_records(user_ids: Sequence[str],
                       entity_types: Sequence[str]) -> list:
    """The probe users' rank request records — featureless, id-only (the
    intercept columns and the entity coefficient rows drive the
    ranking), exactly what ``GET /rank?user=...`` synthesizes, so the
    reference and the live surface rank the same inputs."""
    return [{"features": [],
             "metadataMap": {t: str(u) for t in entity_types},
             "offset": None} for u in user_ids]


def topk_overlap(reference: Sequence[str], live: Sequence[str]) -> float:
    """``|reference ∩ live| / |reference|`` in [0, 1] — the rank-drift
    statistic: 1.0 = the live top-k retrieves exactly the reference set
    (order-insensitive; a reordering within the same k items is not
    drift, a swapped-in item is). Empty reference compares as 1.0."""
    ref = {str(i) for i in reference}
    if not ref:
        return 1.0
    return len(ref & {str(i) for i in live}) / len(ref)


# ---------------------------------------------------------------------------
# the baseline artifact
# ---------------------------------------------------------------------------


def _none_or_float(v) -> Optional[float]:
    if v is None:
        return None
    v = float(v)
    return None if math.isnan(v) else v


@dataclasses.dataclass(frozen=True)
class QualityBaseline:
    """Compact quality profile of a model's reference score distribution
    — what the online monitors and the canary report compare live traffic
    against. All fields are plain JSON-serializable host values."""

    task: Optional[str]
    n_samples: int
    mean_score: float
    std_score: float
    #: weighted positive-label rate (None when labels were unavailable)
    positive_rate: Optional[float]
    #: weighted AUC on the reference set (logistic tasks with labels)
    auc: Optional[float]
    #: interior equal-mass score-bin edges (len n_bins - 1)
    edges: tuple
    #: per-bin reference mass (len n_bins, sums to 1)
    proportions: tuple
    #: per-coordinate margin-contribution stats {cid: {mean, std, abs_mean}}
    coordinates: Mapping[str, Mapping[str, float]]
    #: per-random-effect-coordinate fraction of reference rows with no
    #: entity id (the cold-start rate the live monitor compares against)
    cold_rates: Mapping[str, float]
    #: per-feature-shard mean fraction of nonzero design cells
    coverage: Mapping[str, float]
    #: Hosmer–Lemeshow calibration bins (logistic tasks with labels)
    calibration: Optional[Mapping] = None
    #: lineage passthrough (parentModel / trainedAt / dataManifest)
    lineage: Optional[Mapping] = None
    #: rank-drift reference: probe user id → that user's top-k item ids
    #: as the FULL model ranked them at load time (the serving registry
    #: pins this; patches inherit it, so patched-table ranking shifts
    #: surface as ``rank_overlap`` drift). None = no ranked workload.
    rank_probes: Optional[Mapping] = None
    #: the k the reference lists were computed at
    rank_k: int = 0

    @property
    def n_bins(self) -> int:
        return len(self.proportions)

    def to_dict(self) -> dict:
        return {
            "task": self.task,
            "nSamples": self.n_samples,
            "meanScore": self.mean_score,
            "stdScore": self.std_score,
            "positiveRate": self.positive_rate,
            "auc": self.auc,
            "scoreBins": {"edges": list(self.edges),
                          "proportions": list(self.proportions)},
            "coordinates": {cid: dict(st)
                            for cid, st in self.coordinates.items()},
            "coldRates": dict(self.cold_rates),
            "coverage": dict(self.coverage),
            "calibration": (None if self.calibration is None
                            else dict(self.calibration)),
            "lineage": (None if self.lineage is None
                        else dict(self.lineage)),
            "rankProbes": (None if self.rank_probes is None else {
                "k": self.rank_k,
                "users": {str(u): list(ids)
                          for u, ids in self.rank_probes.items()}}),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "QualityBaseline":
        bins = d.get("scoreBins") or {}
        return cls(
            task=d.get("task"),
            n_samples=int(d.get("nSamples", 0)),
            mean_score=float(d.get("meanScore", 0.0)),
            std_score=float(d.get("stdScore", 0.0)),
            positive_rate=_none_or_float(d.get("positiveRate")),
            auc=_none_or_float(d.get("auc")),
            edges=tuple(float(e) for e in bins.get("edges", ())),
            proportions=tuple(float(p)
                              for p in bins.get("proportions", ())),
            coordinates={str(c): {k: float(v) for k, v in st.items()}
                         for c, st in (d.get("coordinates") or {}).items()},
            cold_rates={str(c): float(v)
                        for c, v in (d.get("coldRates") or {}).items()},
            coverage={str(s): float(v)
                      for s, v in (d.get("coverage") or {}).items()},
            calibration=d.get("calibration"),
            lineage=d.get("lineage"),
            rank_probes=(None if d.get("rankProbes") is None else {
                str(u): tuple(str(i) for i in ids)
                for u, ids in (d["rankProbes"].get("users") or {}).items()}),
            rank_k=int((d.get("rankProbes") or {}).get("k", 0)),
        )


def compute_baseline(scores, labels=None, weights=None, *,
                     task=None,
                     margins: Optional[Mapping[str, np.ndarray]] = None,
                     cold_rates: Optional[Mapping[str, float]] = None,
                     coverage: Optional[Mapping[str, float]] = None,
                     n_bins: int = DEFAULT_SCORE_BINS,
                     lineage: Optional[Mapping] = None) -> QualityBaseline:
    """Distill a reference score set into a :class:`QualityBaseline`.

    ``scores`` are TOTAL model scores (raw margins — the same quantity the
    serving engine emits, so live traffic bins comparably); ``margins``
    maps coordinate id → that coordinate's margin contribution. AUC and
    the Hosmer–Lemeshow calibration table are computed only for logistic
    tasks with labels (reusing ``evaluation/metrics.py`` and
    ``diagnostics/hl.py`` — the offline diagnostics' own arithmetic).
    """
    scores = np.asarray(scores, np.float64)
    n = int(scores.size)
    w = (np.ones(n, np.float64) if weights is None
         else np.asarray(weights, np.float64))
    edges = quantile_edges(scores, n_bins)
    counts = bin_scores(scores, edges) if n else np.zeros(1, np.float64)
    proportions = counts / max(counts.sum(), 1.0)

    positive_rate = auc = calibration = None
    task_value = getattr(task, "value", task)
    if labels is not None and n:
        labels = np.asarray(labels, np.float64)
        positive_rate = float(np.sum(w * labels) / max(np.sum(w), _EPS))
        if task_value == "LOGISTIC_REGRESSION":
            probs = 1.0 / (1.0 + np.exp(-np.clip(scores, -60.0, 60.0)))
            from photon_ml_tpu_torch.diagnostics.hl import hosmer_lemeshow
            from photon_ml_tpu_torch.evaluation.metrics import (
                area_under_roc_curve,
            )

            auc = _none_or_float(area_under_roc_curve(
                np.asarray(scores, np.float32),
                np.asarray(labels, np.float32),
                np.asarray(w, np.float32)))
            hl = hosmer_lemeshow(np.asarray(probs, np.float32),
                                 np.asarray(labels, np.float32),
                                 np.asarray(w, np.float32))
            calibration = {
                "binCounts": [float(c) for c in hl.bin_counts],
                "observedPositives": [float(c)
                                      for c in hl.observed_positives],
                "expectedPositives": [float(c)
                                      for c in hl.expected_positives],
                "meanPredicted": [float(c) for c in hl.mean_predicted],
                "chiSquare": float(hl.chi_square),
                "pValue": float(hl.p_value),
            }

    coordinate_stats = {}
    for cid, m in (margins or {}).items():
        m = np.asarray(m, np.float64)
        coordinate_stats[cid] = {
            "mean": float(m.mean()) if m.size else 0.0,
            "std": float(m.std()) if m.size else 0.0,
            "abs_mean": float(np.abs(m).mean()) if m.size else 0.0,
        }

    return QualityBaseline(
        task=task_value,
        n_samples=n,
        mean_score=float(scores.mean()) if n else 0.0,
        std_score=float(scores.std()) if n else 0.0,
        positive_rate=positive_rate,
        auc=auc,
        edges=tuple(float(e) for e in edges),
        proportions=tuple(float(p) for p in proportions),
        coordinates=coordinate_stats,
        cold_rates=dict(cold_rates or {}),
        coverage=dict(coverage or {}),
        calibration=calibration,
        lineage=None if lineage is None else dict(lineage),
    )


def baseline_from_game(model, data, *, task=None,
                       n_bins: int = DEFAULT_SCORE_BINS,
                       lineage: Optional[Mapping] = None) -> QualityBaseline:
    """The drivers' one-call path: profile a trained
    :class:`~photon_ml_tpu_torch.game.model.GameModel` against a scored
    :class:`~photon_ml_tpu_torch.game.data.GameData` (validation when the
    run has it, training data otherwise — either is a reference
    distribution for drift). Host-side only (the models score in host
    numpy)."""
    from photon_ml_tpu_torch.game.model import (
        FixedEffectModel,
        sum_coordinate_margins,
    )

    margins = model.score_by_coordinate(data)
    # GameModel.score's sum of the same margins, without scoring twice
    scores = sum_coordinate_margins(data.offsets, margins.values())
    cold_rates = {}
    for cid, cm in model.coordinates.items():
        if isinstance(cm, FixedEffectModel):
            continue
        ids = data.id_columns.get(cm.random_effect_type)
        cold_rates[cid] = (float(np.mean(np.asarray(ids) < 0))
                          if ids is not None and len(ids) else 1.0)
    coverage = {
        sid: (shard.nnz / float(data.n_samples * shard.dim)
              if data.n_samples and shard.dim else 0.0)
        for sid, shard in data.shards.items()}
    return compute_baseline(
        scores, data.labels, data.weights, task=task, margins=margins,
        cold_rates=cold_rates, coverage=coverage, n_bins=n_bins,
        lineage=lineage)


# ---------------------------------------------------------------------------
# persistence + discovery
# ---------------------------------------------------------------------------


def save_baseline(path: str, baseline: QualityBaseline) -> None:
    """Write the baseline JSON atomically (tmp + rename — a scraper or a
    loading registry can never observe a torn file)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}-",
                               suffix=".tmp",
                               dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(baseline.to_dict(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_baseline(path: Optional[str]) -> Optional[QualityBaseline]:
    """Baseline at ``path``, or None when absent/unreadable — serving a
    model without a baseline is degraded observability, never an error."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            return QualityBaseline.from_dict(json.load(f))
    except (OSError, ValueError, KeyError):
        return None


def baseline_path_for(model_dir: str) -> str:
    """The baseline location for a resolved model dir: the RUN root
    (mirrors ``continuous/delta.py::manifest_path_for``)."""
    model_dir = os.path.normpath(model_dir)
    root = (os.path.dirname(model_dir)
            if os.path.basename(model_dir) == "best" else model_dir)
    return os.path.join(root, BASELINE_NAME)


def find_baseline(model_dir: str, *, max_up: int = 3) -> Optional[str]:
    """Locate ``quality-baseline.json`` for a model dir: it lives at the
    run root while the model may sit at ``<run>/best`` or
    ``<run>/all/config-N`` or ``<run>/patch`` — walk up like
    ``find_feature_index_dir``. None when no baseline was published."""
    probe = os.path.normpath(model_dir)
    for _ in range(max_up):
        candidate = os.path.join(probe, BASELINE_NAME)
        if os.path.exists(candidate):
            return candidate
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    return None
