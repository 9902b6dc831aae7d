"""The data plane of N logical DataNodes on one card, as library calls.

The counterpart of opentenbase_tpu/parallel/mesh.py, whose table shards
live as device-sharded arrays over a jax Mesh (one DataNode per device)
and whose exchanges are XLA collectives.  Here a "mesh" is N logical
DataNodes on one CUDA device: a sharded column is one tensor of N equal
row ranges (DataNode d owns rows [d * per, (d + 1) * per)), the hash
redistribution is the K11 bucket hash + the K12 exchange kernels, and the
cross-DataNode sum of partials runs on K4's kernel, one group per output
slot.

The exchange sizes its outputs exactly (one host read of the count
matrix), so no row is ever dropped: the reference's fixed-size buckets,
their overflow count and redistribute_auto's doubling retry have no
counterpart here.  `redistribute` returns the count matrix instead; the
reference's overflow for a bucket b is sum(max(counts - b, 0)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..exec.session import resolve_device
from ..ops import kernels as K


@dataclasses.dataclass(frozen=True)
class Mesh:
    """N logical DataNodes on one device."""
    n: int
    device: torch.device


def make_mesh(n_devices: int, device=None) -> Mesh:
    """N logical DataNodes on one device (CUDA unless `device` names
    another)."""
    if n_devices < 1:
        raise ValueError("a mesh needs at least one DataNode")
    return Mesh(int(n_devices), resolve_device(device))


def shard_columns(mesh: Mesh, cols: dict, nrows: int):
    """Pad columns to a per-DataNode-even size and place them on the
    mesh: DataNode d owns rows [d * per, (d + 1) * per), as the
    reference's shard_columns splits them.  Returns (cols, valid)."""
    per = -(-nrows // mesh.n)
    padded = per * mesh.n
    out = {}
    for name, arr in cols.items():
        a = np.asarray(arr)
        buf = np.zeros((padded, *a.shape[1:]), dtype=a.dtype)
        buf[:nrows] = a[:nrows]
        out[name] = torch.from_numpy(buf).to(mesh.device)
    valid = np.zeros(padded, dtype=bool)
    valid[:nrows] = True
    return out, torch.from_numpy(valid).to(mesh.device)


def redistribute(mesh: Mesh, cols: dict, valid, key_col: str):
    """Hash-redistribute sharded columns by cols[key_col]: every valid
    row moves to DataNode splitmix64(key) % n (K11 bucket hash), each
    destination receiving its rows in source order, then row order
    (K12, every DataNode's row range read in place).  Returns (cols,
    valid, the n x n numpy matrix of rows each source sent each
    destination): DataNode d's share is rows [d * region, (d + 1) *
    region) of every output."""
    n = mesh.n
    per = valid.shape[0] // n
    dest = K.bucket_ids((cols[key_col],), n)
    names = list(cols)
    ranges = [slice(d * per, (d + 1) * per) for d in range(n)]
    outs, ovalid, counts, _region = K.exchange(
        [tuple(cols[c][r] for c in names) for r in ranges],
        [dest[r] for r in ranges], [valid[r] for r in ranges], n)
    return dict(zip(names, outs)), ovalid, counts


def psum_partial(mesh: Mesh, fn, cols: dict, valid, n_out: int):
    """Run fn(valid, cols) -> n_out per-DataNode partials on every
    DataNode's row range and sum them across the DataNodes (the
    partial -> final aggregate split).  The sum runs on K4's kernel: the
    DataNodes' partials of one output side by side, one group per
    element."""
    per = valid.shape[0] // mesh.n
    parts = []
    for d in range(mesh.n):
        sl = slice(d * per, (d + 1) * per)
        out = fn(valid[sl], {c: a[sl] for c, a in cols.items()})
        if len(out) != n_out:
            raise ValueError(f"fn returned {len(out)} partials, want "
                             f"{n_out}")
        parts.append(out)
    sums = []
    for i in range(n_out):
        p = [torch.as_tensor(pt[i], device=mesh.device) for pt in parts]
        shape = p[0].shape
        flat = torch.stack([x.reshape(-1) for x in p])       # [n, m]
        m = flat.shape[1]
        gid = torch.arange(m, device=mesh.device).repeat(mesh.n)
        kind = "sumf" if flat.dtype.is_floating_point else "sum"
        (s,), _present = K.grouped_agg_dense(
            gid, torch.ones(gid.shape[0], dtype=torch.bool,
                            device=mesh.device),
            (flat.reshape(-1).contiguous(),), m, (kind,))
        sums.append(s.reshape(shape))
    return tuple(sums)
