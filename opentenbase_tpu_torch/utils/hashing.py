"""Stable 64-bit hashing: splitmix64 over numpy arrays and torch tensors.

The numpy half is a copy of the reference's (opentenbase_tpu/utils/
hashing.py), which the Locator needs to route inserted rows to shards.
The torch half holds the plain versions of the K11 kernels (ops/
kernels.py, csrc/hash.cu): `hash_columns_plain`, the multi-column join
key of the executor, and the routing half of the cluster tier,
`route_hash_plain` / `bucket_ids_plain` / `route_dest_plain`.  All give
the same 64-bit pattern as the reference's hash_columns_np /
hash_columns_jax and its mesh routing hash.
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


def combine_plain(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Multi-column hash combiner (combine_np) over int64 bit patterns."""
    return splitmix64_plain(h ^ x.to(torch.int64))


def umod_plain(h: torch.Tensor, n: int) -> torch.Tensor:
    """The uint64 remainder h % n of int64 bit patterns, as int64.
    torch has no unsigned 64-bit modulo: a power of two masks, any
    other n splits h = 2 q + b with q = h >>> 1 (non-negative), so
    h % n = (2 (q % n) + b) % n, all in int64."""
    n = int(n)
    if n < 1:
        raise ValueError("num_buckets must be >= 1")
    if n & (n - 1) == 0:
        return h & (n - 1)
    return ((_shr(h, 1) % n) * 2 + (h & 1)) % n


def route_hash_plain(key_cols, null_masks=None, text_luts=None):
    """The routing hash of one batch's exchange keys (the reference's
    exec/mesh_exec.py _route_hash): a key whose null mask is set hashes
    as 0; a TEXT key maps its dictionary code, clipped into range,
    through `text_luts[i]` (int64 bit patterns of hash_string of each
    dictionary value); any other key hashes its int64 value.  Then
    splitmix64 of the first key and `combine_plain` over the rest."""
    hs = []
    for i, k in enumerate(key_cols):
        lut = text_luts[i] if text_luts is not None else None
        if lut is not None:
            x = lut[torch.clamp(k.to(torch.int64), 0, lut.shape[0] - 1)]
        else:
            x = k.to(torch.int64)
        nm = null_masks[i] if null_masks is not None else None
        if nm is not None:
            x = torch.where(nm, torch.zeros((), dtype=torch.int64,
                                            device=x.device), x)
        hs.append(x)
    h = splitmix64_plain(hs[0])
    for x in hs[1:]:
        h = combine_plain(h, x)
    return h


def bucket_ids_plain(key_cols, num_buckets: int) -> torch.Tensor:
    """hash_columns(keys) % num_buckets as int32 (reference: ops/
    kernels.py bucket_ids)."""
    return umod_plain(hash_columns_plain(list(key_cols)),
                      num_buckets).to(torch.int32)


def route_dest_plain(key_cols, null_masks, text_luts, valid, shard_map,
                     ndn: int, num_buckets: int = 4096) -> torch.Tensor:
    """Destination DataNode of every row: shard_map[route_hash %
    num_buckets] (the locator's placement), or the bucket itself when
    `shard_map` is None; `ndn` for a row that is not valid."""
    b = umod_plain(route_hash_plain(key_cols, null_masks, text_luts),
                   num_buckets)
    dest = shard_map.to(torch.int64)[b] if shard_map is not None else b
    return torch.where(valid, dest, torch.full((), ndn, dtype=torch.int64,
                                               device=dest.device)
                       ).to(torch.int32)
