"""Device-resident columnar buffer cache: version-keyed residency.

The counterpart of the single-device tier of
opentenbase_tpu/storage/bufferpool.py.  Staged (padded, concatenated)
device columns stay resident across queries, keyed by the store's
monotonic `version` (bumped on every mutation), so an unchanged table is
never re-uploaded.  A version change restages the table in full.

Eligible integer columns stage ENCODED exactly as the reference's
`_stage_columns` does (storage/codec.py): the device tensor holds the
narrow codes and the column's aux tensor rides along under
`__enc.<family>.<col>`.  Every staged tensor is padded to
batch.size_class rows.

Not ported yet: the append-only tail path, the byte budget with LRU
eviction, pinning, morsel windows, mesh entries and host snapshots.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from . import codec
from .batch import size_class

_SYS_COLS = ("__xmin_ts", "__xmax_ts", "__xmin_txid", "__xmax_txid")
_NULL = "__null."


@dataclasses.dataclass
class DevEntry:
    """One store's padded device columns at one version."""
    version: int
    arrs: dict            # staged name -> device tensor [padded]
    n: int                # live (staged) row count


class DeviceBufferPool:
    """Per-node cache of staged device columns on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._dev: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.uploaded_bytes = 0     # host -> device bytes staged so far

    def get(self, store, colnames):
        """Staged device columns of `store` at its current version: value
        columns + MVCC sys columns + null masks.  Returns (arrs, n)."""
        ver = store.version
        nullwant = {_NULL + c for c in colnames
                    if c in store.null_columns}
        want = set(colnames) | set(_SYS_COLS) | nullwant
        e = self._dev.get(store)
        if e is not None and e.version == ver and want <= set(e.arrs):
            return e.arrs, e.n
        if e is not None and e.version == ver:
            # same version, new columns: stage only what is missing
            arrs = dict(e.arrs)
            arrs.update(self._stage_columns(store, want - set(e.arrs), e.n,
                                            codec.padded_of(e.arrs)))
            n = e.n
        else:
            n = store.row_count()
            arrs = self._stage_columns(store, want, n, size_class(max(n, 1)))
        self._dev[store] = DevEntry(ver, arrs, n)
        return arrs, n

    def invalidate(self, store):
        """Drop the store's residency now (DROP TABLE)."""
        self._dev.pop(store, None)

    def _upload(self, buf: np.ndarray) -> torch.Tensor:
        self.uploaded_bytes += buf.nbytes
        return torch.from_numpy(buf).to(self.device)

    def _stage_columns(self, store, names, n: int, padded: int) -> dict:
        """Full staging of rows [0:n] for the given staged-namespace
        names (value columns / __xmin_ts... / __null.c) into padded
        device tensors, encoding eligible integer columns."""
        table = store.td.name
        plain = sorted({nm for nm in names if not nm.startswith("__")}
                       | {nm[len(_NULL):] for nm in names
                          if nm.startswith(_NULL)})
        host = store.host_live_columns(plain)
        arrs = {}
        for name in names:
            h = host[name]
            r = codec.encode_staged(table, name, h[:n])
            if r is not None:
                code, enc, aux = r
                buf = np.zeros(padded, dtype=code.dtype)
                buf[:n] = code
                arrs[name] = self._upload(buf)
                arrs[codec.aux_name(name, enc)] = self._upload(aux)
            else:
                buf = np.zeros((padded, *h.shape[1:]), dtype=h.dtype)
                buf[:n] = h[:n]
                arrs[name] = self._upload(buf)
        return arrs
