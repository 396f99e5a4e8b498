"""Random-effect feature-space projectors (counterpart of
``photon_ml_tpu/game/projector.py``). Only INDEX_MAP — each entity's
observed features, compact-indexed — is ported; RANDOM raises
:class:`NotImplementedError` where a dataset is built."""

from __future__ import annotations

import enum


class ProjectorType(str, enum.Enum):
    """Reference ``projector/ProjectorType.scala``."""

    INDEX_MAP = "INDEX_MAP"
    RANDOM = "RANDOM"
