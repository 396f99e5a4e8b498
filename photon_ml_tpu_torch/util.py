"""Small host-side helpers shared across modules (a copy of the JAX
package's ``util.py`` helpers the port needs; the port imports nothing of
that package)."""

from __future__ import annotations

import numpy as np


def group_starts(sorted_ids: np.ndarray) -> np.ndarray:
    """Indices where a new group begins in a group-sorted id array."""
    n = sorted_ids.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    new = np.empty(n, bool)
    new[0] = True
    np.not_equal(sorted_ids[1:], sorted_ids[:-1], out=new[1:])
    return np.flatnonzero(new)


def hash_uniform(ids: np.ndarray, seed: int) -> np.ndarray:
    """Uniform [0,1) key per id via a splitmix64 finalizer — a stateless,
    partition-invariant substitute for a sequential rng stream: the key of
    a row depends only on (seed, its global id)."""
    z = (np.asarray(ids, np.uint64)
         + np.uint64((seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF))
    z = (z + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return z.astype(np.float64) / float(2**64)


def materialize_thunk(obj, fields: tuple, lock) -> None:
    """Run a deferred fill at most once: ``fields[0]`` of ``obj`` holds
    either its value or a zero-argument thunk returning one value per
    field. Under ``lock``, a thunk still in place is called and its
    results are set with ``object.__setattr__`` (the holders are frozen
    dataclasses). The thunks share native scratch, so two racing calls
    would corrupt it: hence the lock and the second look under it."""
    with lock:
        val = object.__getattribute__(obj, fields[0])
        if callable(val):
            for f, v in zip(fields, val()):
                object.__setattr__(obj, f, v)
