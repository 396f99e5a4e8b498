"""The feedback subsystem: the fleet retrains itself (counterpart of
``photon_ml_tpu/feedback``).

- :mod:`photon_ml_tpu_torch.feedback.joiner` — deterministically join
  labels (the request log's inline nullable ``label`` field plus an
  external Avro/CSV source keyed by request id) to logged score records,
  emitting incremental ``TrainingExampleAvro`` data the refresh consumes;
  unjoinable, duplicate and late labels are counted, never dropped
  silently.
- :mod:`photon_ml_tpu_torch.feedback.autopilot` — subscribe to the
  registry bus; on ``quality_drift_detected``, join the logged traffic and
  run ``refresh_game`` in-process on the serving device for only the
  drifted coordinate, publishing the full model and the per-shard patches
  into a watch directory under debounce and max-refresh-rate guards and
  the ``feedback.join`` / ``feedback.refresh_launch`` fault sites.

Router-side activation, the loop's last hop, lives in
:mod:`photon_ml_tpu_torch.fleet.watcher`.
"""

from photon_ml_tpu_torch.feedback.autopilot import (  # noqa: F401
    AutopilotConfig,
    FeedbackAutopilot,
)
from photon_ml_tpu_torch.feedback.joiner import (  # noqa: F401
    JoinResult,
    join_feedback,
    load_labels,
)
