"""Liveness beats for a supervising process.

A copy of ``heartbeat`` in ``photon_ml_tpu/resilience/supervisor.py``: a
supervised run names a heartbeat file in ``PHOTON_HEARTBEAT_FILE`` and the
hot paths (Avro file reads, coordinate-descent sweeps and steps, lambdas,
host collectives) touch it. Unsupervised, a beat costs one environment
lookup. :mod:`~photon_ml_tpu_torch.resilience.supervisor` reads it.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

#: environment variable naming this process's heartbeat file
HEARTBEAT_ENV = "PHOTON_HEARTBEAT_FILE"


def heartbeat(site: str = "") -> None:
    """Touch this process's heartbeat file (no-op unsupervised). Never
    raises: a failed beat must not fail the step that beats."""
    path = os.environ.get(HEARTBEAT_ENV)
    if not path:
        return
    try:
        os.utime(path, None)
    except OSError:
        try:
            with open(path, "w") as f:
                f.write(site)
        except OSError:
            logger.warning("heartbeat touch failed for %s", path)
