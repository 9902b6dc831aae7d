"""Padding size classes and host -> device staging.

Device batches are padded to size classes so that every kernel sees a
small, bounded set of shapes (the reference's dynamic-shape strategy);
padded rows are masked by the scan's row-count belt.
"""

from __future__ import annotations

import numpy as np
import torch


def next_pow2(n: int, floor: int = 256) -> int:
    """Size class for padded device batches."""
    p = floor
    while p < n:
        p <<= 1
    return p


def size_class(n: int, floor: int = 256) -> int:
    """Quarter-step size class {1, 1.25, 1.5, 1.75}*2^k: staged base
    tables live at one size for their whole lifetime, so the finer
    ladder trades more shape classes for <=25% padding waste instead of
    <=100% — at SF1, lineitem pads to 6.29M instead of 8.39M."""
    p = floor
    while p < n:
        p <<= 1
    if p == floor:
        return p
    for num in (4, 5, 6, 7):
        c = (p >> 3) * num
        if c >= n:
            return c
    return p


def lut_capacity(n: int, floor: int = 16) -> int:
    """Dictionary-LUT capacity quantizer (storage/codec.py): pow2 with
    a floor, so an append-only integer dictionary keeps one aux-array
    shape until it doubles."""
    p = floor
    while p < n:
        p <<= 1
    return p


def stage_padded(host_cols, sel, device):
    """Host column slices -> pow2-padded tensors on `device` for one
    pass.  `sel` is a slice, an int index array, or slice(None)."""
    out = {}
    n = None
    for name, arr in host_cols.items():
        sub = np.asarray(arr[sel])
        if n is None:
            n = len(sub)
        padded = next_pow2(max(n, 1))
        buf = np.zeros((padded, *sub.shape[1:]), dtype=sub.dtype)
        buf[:n] = sub
        out[name] = torch.from_numpy(buf).to(device)
    return out, (n or 0)
