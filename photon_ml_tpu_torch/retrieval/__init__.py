"""Top-k retrieval on the card: the serving store turned into a
recommender (counterpart of ``photon_ml_tpu/retrieval/``).

- :mod:`~photon_ml_tpu_torch.retrieval.index`: :class:`ItemIndex`, one
  random-effect coordinate's store re-packed item-major (storage dtype
  kept, item axis padded to a power of two, O(touched) ``apply_patch``);
- :mod:`~photon_ml_tpu_torch.retrieval.engine`: :class:`RankingEngine`,
  a user's margins against every item row, summed by the GAME contract
  and stably sorted, one CUDA graph per (user bucket, k bucket).

``GET/POST /rank`` rides the serving stack (``serve_game
--rank-item-coordinate``).
"""

from photon_ml_tpu_torch.retrieval.engine import RankingEngine  # noqa: F401
from photon_ml_tpu_torch.retrieval.index import (  # noqa: F401
    ItemIndex,
    item_bucket,
)
