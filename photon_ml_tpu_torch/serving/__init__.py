"""Online serving on the GPU: low-latency GAME scoring with hot-swappable
versions (counterpart of ``photon_ml_tpu/serving``).

- :mod:`~photon_ml_tpu_torch.serving.registry`: validate-then-activate
  loading of ``train_game`` output dirs, atomic hot swap, rollback;
- :mod:`~photon_ml_tpu_torch.serving.store`: per-entity coefficients packed
  dense on the device (f32, bf16 or int8 with per-row scales) with O(1)
  raw-id lookup and a zeros fallback row (the cold-start contract);
- :mod:`~photon_ml_tpu_torch.serving.engine`: power-of-two batch buckets,
  one CUDA graph each, f64 accumulation: no capture after warmup, and f32
  scores bit-identical to ``score_game``;
- :mod:`~photon_ml_tpu_torch.serving.batcher` and
  :mod:`~photon_ml_tpu_torch.serving.http`: the microbatching queue and the
  stdlib JSON endpoint (``/score``, ``/reload``, ``/healthz``,
  ``/readyz``, ``/metrics``) behind
  ``python -m photon_ml_tpu_torch serve_game``;
- :mod:`~photon_ml_tpu_torch.serving.overload`: typed load shedding,
  deadlines and the brownout controller.

Not ported: the request log, the directory watcher, coefficient patches,
fleet shards, the canary and quality monitor, ranked retrieval and span
tracing.
"""

from photon_ml_tpu_torch.serving.overload import (  # noqa: F401
    OverloadController,
    Shed,
)
from photon_ml_tpu_torch.serving.batcher import MicroBatcher  # noqa: F401
from photon_ml_tpu_torch.serving.engine import (  # noqa: F401
    RequestBatch,
    ScoringEngine,
    next_bucket,
)
from photon_ml_tpu_torch.serving.http import (  # noqa: F401
    REQUEST_ID_HEADER,
    GameServer,
    ServingService,
)
from photon_ml_tpu_torch.serving.registry import (  # noqa: F401
    ModelRegistry,
    ServingModel,
)
from photon_ml_tpu_torch.serving.store import (  # noqa: F401
    EntityCoefficientStore,
)
