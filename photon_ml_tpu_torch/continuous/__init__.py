"""Continuous training: warm-start refresh, incremental refit, delta publish
(counterpart of ``photon_ml_tpu/continuous``).

- :mod:`~photon_ml_tpu_torch.continuous.delta` — per-entity data
  fingerprints and the ``data-manifest.json`` recorded with every
  published model, so a refresh can tell which entities' training data
  changed since the model it warm-starts from.
- :mod:`~photon_ml_tpu_torch.continuous.refresh` — the refresh loop: every
  optimizer seeded from the prior model, random-effect coordinates
  re-solving only the touched entities, every other entity's coefficients
  carried forward bit for bit; ``partition_patch_by_shard`` cuts the patch
  into a serving fleet's per-host patches.

The refresh writes a full model directory (the next refresh's parent) and
an entity-level coefficient patch
(``io/model_io.py::save_game_model_patch``) in the JAX package's format,
which either package's serving registry activates (``load_patch``).
"""

from photon_ml_tpu_torch.continuous.delta import (  # noqa: F401
    MANIFEST_NAME,
    EntityDelta,
    build_manifest,
    coordinate_deltas,
    entity_delta,
    entity_fingerprints,
    load_manifest,
    manifest_digest,
    manifest_path_for,
    save_manifest,
)
from photon_ml_tpu_torch.continuous.refresh import (  # noqa: F401
    RefreshResult,
    partition_patch_by_shard,
    refresh_game_model,
)
