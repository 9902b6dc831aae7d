"""Stable 64-bit hashing: splitmix64 over numpy arrays and torch tensors.

The numpy half is a copy of the reference's (opentenbase_tpu/utils/
hashing.py), which the Locator needs to route inserted rows to shards.
The torch half, `hash_columns_plain`, is the plain version of the K11
row-hash kernel (ops/kernels.py hash_columns, csrc/hash.cu): the
multi-column join key of the executor.  Both give the same 64-bit
pattern as the reference's hash_columns_np / hash_columns_jax.  The
routing hash of redistribution (bucket ids) belongs to the cluster tier
and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# torch half (plain version of the K11 kernel)
#
# torch has no uint64 arithmetic, so the plain version works on int64:
# + and * wrap exactly as uint64 does, the constants are their signed
# images, and every right shift is made logical by masking off the
# sign-extended top bits.
# ---------------------------------------------------------------------------

def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


_C1_S, _C2_S, _GOLDEN_S = _signed(_C1), _signed(_C2), _signed(_GOLDEN)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor's bit pattern."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64_plain(z: torch.Tensor) -> torch.Tensor:
    """splitmix64 over an int64 tensor holding uint64 bit patterns."""
    z = z + _GOLDEN_S
    z = (z ^ _shr(z, 30)) * _C1_S
    z = (z ^ _shr(z, 27)) * _C2_S
    return z ^ _shr(z, 31)


def hash_columns_plain(cols) -> torch.Tensor:
    """Row hash of int64 columns -> the uint64 hash's bit pattern as
    int64 (hash_columns_np's value, as the executor's join key casts
    it)."""
    h = splitmix64_plain(cols[0].to(torch.int64))
    for c in cols[1:]:
        h = splitmix64_plain(h ^ c.to(torch.int64))
    return h
