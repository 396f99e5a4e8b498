"""Parallel training (counterpart of ``photon_ml_tpu/parallel``): meshes of
slots inside one process (:mod:`~photon_ml_tpu_torch.parallel.mesh`:
``make_mesh`` over the data, entity and feature axes); the data-parallel
GLM objective and its row layout, and the feature-sharded objective and
its column layout (:mod:`~photon_ml_tpu_torch.parallel.distributed`); the
process group and host collectives of several processes, one card each
(:mod:`~photon_ml_tpu_torch.parallel.multihost`, ``--multihost``)."""

from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ENTITY_AXIS,
    FEATURE_AXIS,
    Mesh,
    make_mesh,
)
from photon_ml_tpu_torch.parallel.distributed import (
    ColumnBlocks,
    DistributedGLMObjective,
    FeatureShardedGLMObjective,
    MeshGLMData,
    ShardBudget,
    local_block,
    shard_budget,
    shard_glm_data,
    shard_glm_data_features,
)
from photon_ml_tpu_torch.parallel.multihost import (
    allgather_concat,
    allgather_concat_strings,
    allgather_text,
    allreduce_max,
    allreduce_shard_budget,
    allreduce_sum,
    global_glm_data_from_local,
    global_glm_data_multihost,
    initialize,
    is_chief,
    process_count,
    process_index,
)

__all__ = [
    "DATA_AXIS",
    "ENTITY_AXIS",
    "FEATURE_AXIS",
    "Mesh",
    "make_mesh",
    "ColumnBlocks",
    "DistributedGLMObjective",
    "FeatureShardedGLMObjective",
    "MeshGLMData",
    "ShardBudget",
    "local_block",
    "shard_budget",
    "shard_glm_data",
    "shard_glm_data_features",
    "allgather_concat",
    "allgather_concat_strings",
    "allgather_text",
    "allreduce_max",
    "allreduce_shard_budget",
    "allreduce_sum",
    "global_glm_data_from_local",
    "global_glm_data_multihost",
    "initialize",
    "is_chief",
    "process_count",
    "process_index",
]
