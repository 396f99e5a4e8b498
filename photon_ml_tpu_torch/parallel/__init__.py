"""Multi-process training over ``torch.distributed`` (counterpart of
``photon_ml_tpu/parallel``): the process group and host collectives
(:mod:`~photon_ml_tpu_torch.parallel.multihost`), the data-parallel GLM
objective and its row layout (:mod:`~photon_ml_tpu_torch.parallel.
distributed`), and the axis names (:mod:`~photon_ml_tpu_torch.parallel.
mesh`). One process drives one card; several cards take several processes
(``--multihost``)."""

from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, ENTITY_AXIS
from photon_ml_tpu_torch.parallel.distributed import (
    DistributedGLMObjective,
    ShardBudget,
    local_block,
    shard_budget,
    shard_glm_data,
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
    "DistributedGLMObjective",
    "ShardBudget",
    "local_block",
    "shard_budget",
    "shard_glm_data",
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
