"""Online serving on the GPU: low-latency GAME scoring with hot-swappable
versions (counterpart of ``photon_ml_tpu/serving``).

- :mod:`~photon_ml_tpu_torch.serving.registry`: validate-then-activate
  loading of ``train_game`` output dirs and ``refresh_game`` coefficient
  patches, two-phase prepare/activate, atomic hot swap, rollback;
- :mod:`~photon_ml_tpu_torch.serving.store`: per-entity coefficients packed
  dense on the device (f32, bf16 or int8 with per-row scales) with O(1)
  raw-id lookup and a zeros fallback row (the cold-start contract), and a
  patch's O(touched) derivation of the next version's table;
- :mod:`~photon_ml_tpu_torch.serving.engine`: power-of-two batch buckets,
  one CUDA graph each, f64 accumulation: no capture after warmup, and f32
  scores bit-identical to ``score_game``;
- :mod:`~photon_ml_tpu_torch.serving.batcher` and
  :mod:`~photon_ml_tpu_torch.serving.http`: the microbatching queue and the
  stdlib JSON endpoint (``/score``, ``/rank``, ``/reload``,
  ``/healthz``, ``/readyz``, ``/metrics``) behind
  ``python -m photon_ml_tpu_torch serve_game``, with the connection
  budget;
- :mod:`~photon_ml_tpu_torch.serving.watcher`: polls a publish directory
  and applies each new full model or patch through the registry;
- :mod:`~photon_ml_tpu_torch.serving.reqlog`: the sampled, rotated Avro
  log of served requests;
- :mod:`~photon_ml_tpu_torch.serving.overload`: typed load shedding,
  deadlines and the brownout controller.

Each version carries its quality baseline and monitor, a canary can gate
its activation (:mod:`photon_ml_tpu_torch.quality`), and ``/rank`` ranks
an item coordinate (:mod:`photon_ml_tpu_torch.retrieval`). A host can be
one shard of an entity-sharded fleet (``fleet_shard=``, per-host patches,
the live reshard's prepare) behind the router of
:mod:`photon_ml_tpu_torch.fleet`. Requests are ``serving.*`` spans of the
telemetry plane, and the registry binds the EventBus bridge, so its
lifecycle events reach ``/metrics``.
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
from photon_ml_tpu_torch.serving.reqlog import (  # noqa: F401
    RequestLog,
    iter_reqlog,
)
from photon_ml_tpu_torch.serving.store import (  # noqa: F401
    EntityCoefficientStore,
)
from photon_ml_tpu_torch.serving.watcher import (  # noqa: F401
    ModelDirectoryWatcher,
    candidate_content_key,
)
