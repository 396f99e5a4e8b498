"""Telemetry of the serving path: the labeled metrics registry
(:mod:`~photon_ml_tpu_torch.telemetry.metrics`, a copy of the JAX
package's) and its Prometheus text exposition
(:mod:`~photon_ml_tpu_torch.telemetry.prometheus`), which ``GET /metrics``
serves, its fold across hosts
(:mod:`~photon_ml_tpu_torch.telemetry.aggregate`, the fleet router's
``/metrics``), and span tracing
(:mod:`~photon_ml_tpu_torch.telemetry.tracing`, a copy). Compile
accounting, the retained history and the flight recorder are not
ported."""
