"""Stable 64-bit hashing (host side): splitmix64 over numpy arrays.

A copy of the numpy half of the reference's hash, which the Locator
needs to route inserted rows to shards.  The device half (the routing
hash of redistribution) belongs to the cluster tier and is not ported
yet.
"""

from __future__ import annotations

import numpy as np

_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB
_GOLDEN = 0x9E3779B97F4A7C15


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over a uint64/int64 numpy array."""
    z = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        z += np.uint64(_GOLDEN)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(_C1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_C2)
        z = z ^ (z >> np.uint64(31))
    return z


def combine_np(h: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Multi-column hash combiner (host)."""
    with np.errstate(over="ignore"):
        return splitmix64_np(h.astype(np.uint64) ^ x.astype(np.uint64))


def hash_columns_np(cols: list[np.ndarray]) -> np.ndarray:
    """Hash one or more integer-representable columns row-wise -> uint64."""
    h = splitmix64_np(cols[0].astype(np.int64).view(np.uint64)
                      if cols[0].dtype == np.int64
                      else cols[0].astype(np.uint64))
    for c in cols[1:]:
        h = combine_np(h, c.astype(np.uint64))
    return h


def hash_string(s: str) -> int:
    """Stable scalar hash for string distribution keys (host-side only)."""
    h = np.uint64(0xCBF29CE484222325)
    with np.errstate(over="ignore"):
        for b in s.encode("utf-8"):
            h = (h ^ np.uint64(b)) * np.uint64(0x100000001B3)
    return int(splitmix64_np(np.asarray([h]))[0])
