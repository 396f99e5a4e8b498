"""Model-quality observability: train-time baselines, online drift
monitors, and canary-gated activation (counterpart of
``photon_ml_tpu/quality/``; host-side numpy, copied with the port's own
imports).

The telemetry stack (OBSERVABILITY.md) observes the SYSTEM; this package
observes the PREDICTIONS, spanning train → publish → serve:

- :mod:`~photon_ml_tpu_torch.quality.baseline` — the training/refresh drivers
  distill validation scores into ``quality-baseline.json`` (score bins,
  calibration, per-coordinate stats) published next to the model; also
  the ONE home of the PSI/KS/binning arithmetic;
- :mod:`~photon_ml_tpu_torch.quality.monitor` — the serving engine accumulates
  live scores / cold-start hits / feature coverage into
  ``photon_quality_*`` metrics; a background :class:`DriftEvaluator`
  renders live-vs-baseline drift into
  ``photon_quality_drift_score{coordinate,kind}`` and posts
  ``quality_drift_detected`` past the threshold;
- :mod:`~photon_ml_tpu_torch.quality.canary` — candidates shadow-score a
  reservoir of recent live requests against the incumbent at activation
  time; ``serve_game --canary-gate`` refuses divergent candidates like
  validation failures.

OBSERVABILITY.md "Model quality" documents the metric families.
"""

from photon_ml_tpu_torch.quality.baseline import (  # noqa: F401
    BASELINE_NAME,
    DEFAULT_SCORE_BINS,
    QualityBaseline,
    baseline_from_game,
    baseline_path_for,
    bin_scores,
    compute_baseline,
    find_baseline,
    ks_statistic,
    load_baseline,
    population_stability_index,
    quantile_edges,
    rank_probe_records,
    rank_probe_sample,
    save_baseline,
    topk_overlap,
)
from photon_ml_tpu_torch.quality.canary import (  # noqa: F401
    DEFAULT_BOUNDS,
    CanaryConfig,
    CanaryRejected,
    RequestReservoir,
    run_canary,
    score_divergence,
)
from photon_ml_tpu_torch.quality.monitor import (  # noqa: F401
    DEFAULT_DRIFT_THRESHOLD,
    TOTAL_COORDINATE,
    DriftEvaluator,
    QualityMonitor,
)
