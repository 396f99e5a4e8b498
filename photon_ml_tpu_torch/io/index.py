"""Feature index maps: (name, term) string → dense int id.

Counterpart of ``photon_ml_tpu/io/index.py``: one host dict per feature
shard with a compact sorted-strings JSON form on disk. Keys are sorted and
the intercept goes last, so both packages give every key the same id and
write the same JSON bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, Mapping, Optional

from photon_ml_tpu_torch.types import INTERCEPT_KEY, feature_key


@dataclasses.dataclass(frozen=True)
class IndexMap:
    """Immutable feature-key → index map (+ reverse lookup)."""

    key_to_index: Mapping[str, int]

    def __post_init__(self):
        n = len(self.key_to_index)
        vals = set(self.key_to_index.values())
        if vals and (min(vals) < 0 or max(vals) >= n or len(vals) != n):
            raise ValueError("index map values must be a permutation of range(n)")

    def __len__(self) -> int:
        return len(self.key_to_index)

    def __contains__(self, key: str) -> bool:
        return key in self.key_to_index

    def index_of(self, name: str, term: str = "") -> Optional[int]:
        return self.key_to_index.get(feature_key(name, term))

    def names(self) -> list[str]:
        """Keys ordered by index (reverse map)."""
        out = [""] * len(self.key_to_index)
        for k, i in self.key_to_index.items():
            out[i] = k
        return out

    @property
    def has_intercept(self) -> bool:
        return INTERCEPT_KEY in self.key_to_index

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": 1, "keys": self.names()}, f)

    @staticmethod
    def load(path: str) -> "IndexMap":
        with open(path) as f:
            payload = json.load(f)
        return IndexMap({k: i for i, k in enumerate(payload["keys"])})


def build_index_map(feature_keys: Iterable[str], *,
                    add_intercept: bool = True) -> IndexMap:
    """Distinct keys in sorted order with contiguous ids; the intercept is
    appended last when requested."""
    uniq = sorted(set(feature_keys) - {INTERCEPT_KEY})
    if add_intercept:
        uniq.append(INTERCEPT_KEY)
    return IndexMap({k: i for i, k in enumerate(uniq)})
