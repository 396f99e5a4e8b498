"""The port's static-analysis framework: the counterpart of
``photon_ml_tpu/analysis/`` (see ANALYSIS.md for the rule catalog),
pointed at ``photon_ml_tpu_torch/`` and the port's root scripts.

One engine (:mod:`photon_ml_tpu_torch.analysis.engine`) behind every lint
pass, with the reference's rule ids one for one:

- :mod:`~photon_ml_tpu_torch.analysis.rules_resilience` — resilience
  hygiene (``res-*``)
- :mod:`~photon_ml_tpu_torch.analysis.rules_telemetry` — telemetry
  hygiene (``tel-*``)
- :mod:`~photon_ml_tpu_torch.analysis.rules_trace` — capture purity
  (``trace-*``): Python side effects inside code recorded into a CUDA
  graph, the port's counterpart of jit-traced code
- :mod:`~photon_ml_tpu_torch.analysis.rules_concurrency` — lock
  discipline (``lock-*``): the ``# guarded-by:`` annotation convention
- :mod:`~photon_ml_tpu_torch.analysis.rules_project` — whole-tree
  consistency (``obs-metric-catalog``, ``res-fault-coverage``)

CLI: ``python -m photon_ml_tpu_torch.analysis [root]``. Plain ``ast``: no
tensor, no device.
"""

from photon_ml_tpu_torch.analysis.engine import (
    Finding,
    Project,
    FileContext,
    Report,
    all_rules,
    check_source,
    run,
)

__all__ = [
    "Finding",
    "FileContext",
    "Project",
    "Report",
    "all_rules",
    "check_source",
    "run",
]
