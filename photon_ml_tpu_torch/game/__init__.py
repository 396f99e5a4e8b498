"""GAME: Generalized Additive Mixed-Effect models on one GPU.

Block coordinate descent over a fixed-effect coordinate (one GLM solve) and
random-effect coordinates (per-entity solves batched over size buckets).
"""

from photon_ml_tpu_torch.game.data import (  # noqa: F401
    FeatureShard,
    FixedEffectDataset,
    GameData,
    RandomEffectDataset,
    RandomEffectDatasetConfig,
)
from photon_ml_tpu_torch.game.projector import ProjectorType  # noqa: F401
from photon_ml_tpu_torch.game.model import (  # noqa: F401
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.coordinate import (  # noqa: F401
    Coordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.coordinate_descent import (  # noqa: F401
    CoordinateDescent,
    CoordinateDescentResult,
)
from photon_ml_tpu_torch.game.transformer import (  # noqa: F401
    GameTransformer,
    ModelDataScores,
)
from photon_ml_tpu_torch.game.estimator import (  # noqa: F401
    FixedEffectCoordinateConfig,
    GameEstimator,
    GameOptimizationConfiguration,
    GameResult,
    RandomEffectCoordinateConfig,
)
