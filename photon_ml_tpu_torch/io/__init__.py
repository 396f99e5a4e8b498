"""Host-side IO: the Avro codec, feature index maps, the training-data
reader and model persistence in the reference's directory layout
(counterpart of ``photon_ml_tpu/io``)."""

from photon_ml_tpu_torch.io.avro import (  # noqa: F401
    read_avro_file,
    write_avro_file,
)
from photon_ml_tpu_torch.io.index import IndexMap, build_index_map  # noqa: F401
from photon_ml_tpu_torch.io.data_reader import (  # noqa: F401
    AvroDataReader,
    FeatureShardConfig,
)
from photon_ml_tpu_torch.io.model_io import (  # noqa: F401
    find_feature_index_dir,
    load_game_model,
    load_glm_model,
    resolve_game_model_dir,
    save_game_model,
    save_glm_model,
    save_glm_model_text,
)
