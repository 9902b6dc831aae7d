"""The flagship single-device step: the Q1 fragment (filter, projection,
dense grouped aggregation) over synthetic lineitem columns.

The counterpart of `__graft_entry__.entry()` of the reference repo.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import kernels as K

Q1_KINDS = ("sum", "sum", "sum", "sum", "sumf", "sumf", "count")


def q1_arrays(n: int = 8192, seed: int = 3) -> dict:
    """Synthetic Q1 columns (numpy; the same draws as the reference)."""
    rng = np.random.default_rng(seed)
    return {
        "qty": rng.integers(100, 5100, n).astype(np.int64),
        "price": rng.integers(90000, 110000, n).astype(np.int64),
        "disc": rng.integers(0, 11, n).astype(np.int64),
        "tax": rng.integers(0, 9, n).astype(np.int64),
        "ship": rng.integers(9000, 10600, n).astype(np.int32),
        "rf": rng.integers(0, 3, n).astype(np.int32),
        "ls": rng.integers(0, 2, n).astype(np.int32),
        "orderkey": rng.integers(1, 1 << 40, n).astype(np.int64),
    }


def q1_step(cols: dict):
    """Q1 fragment over a dict of tensors -> (aggregates, present)."""
    valid = cols["ship"] <= 10471
    disc_price = cols["price"] * (100 - cols["disc"])
    charge = disc_price * (100 + cols["tax"])
    gid = cols["rf"].to(torch.int64) * 2 + cols["ls"].to(torch.int64)
    return K.grouped_agg_dense(
        gid, valid,
        (cols["qty"], cols["price"], disc_price, charge,
         cols["qty"], cols["disc"], cols["qty"]),
        6, Q1_KINDS)


def entry(device=None):
    """(fn, example_args): the Q1 fragment and its inputs on `device`
    (CUDA unless the caller names another)."""
    from .exec.session import resolve_device
    dev = resolve_device(device)
    cols = {k: torch.from_numpy(v).to(dev) for k, v in q1_arrays().items()}
    return q1_step, (cols,)
