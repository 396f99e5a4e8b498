"""Telemetry of the serving path: the labeled metrics registry
(:mod:`~photon_ml_tpu_torch.telemetry.metrics`, a copy of the JAX
package's) and its Prometheus text exposition
(:mod:`~photon_ml_tpu_torch.telemetry.prometheus`), which ``GET /metrics``
serves. Span tracing, compile accounting and the flight recorder are not
ported."""
