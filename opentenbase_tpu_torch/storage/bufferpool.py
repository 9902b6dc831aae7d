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

A cluster's pool also holds its cluster entries (the counterpart of the
reference's MeshEntry / mesh_get / mesh_put): one table staged across
every logical DataNode (exec/mesh_exec.py _stage_table), keyed by the
tuple of per-DataNode store versions, so a warm repeat stages nothing
and any write on any DataNode restages the table.

A staged entry keeps its tensors, at stable addresses, for as long as
its version stands (new columns of the same version join the entry
without moving the old ones), and `get_entry` exposes that version: a
captured fragment program (exec/fused.py) bakes the staged tensors'
addresses, so its key carries the versions and a restage recaptures.
`shed_coldest` evicts the least recently used entries (the serving
tier's memory-pressure relief, exec/shield.py).

Not ported yet: the append-only tail path (for single-node and cluster
entries), the byte budget with LRU eviction on staging, pinning, morsel
windows and host snapshots.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
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
    last_use: int = 0     # pool-wide use sequence (LRU order)

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrs.values())


@dataclasses.dataclass
class ClusterEntry:
    """One table staged across a cluster's DataNodes."""
    table: str
    vkey: tuple           # per-DataNode store versions at staging time
    staged: object        # exec/mesh_exec._StagedTable


class DeviceBufferPool:
    """Per-node cache of staged device columns on `device`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._dev: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._cluster: dict[str, ClusterEntry] = {}
        self.uploaded_bytes = 0     # host -> device bytes staged so far
        self.cluster_misses = 0     # cluster entries staged (or restaged)
        # serving threads stage concurrently: one lock around the entry
        # map, and a use sequence for shed_coldest's LRU order
        self._lock = threading.RLock()
        self._use = itertools.count(1)

    def cluster_get(self, table: str, vkey: tuple):
        """The cluster entry of `table` at exactly this per-DataNode
        version tuple, or None (a stale entry is dropped)."""
        ent = self._cluster.get(table)
        if ent is not None and ent.vkey == vkey:
            return ent
        self.cluster_misses += 1
        self._cluster.pop(table, None)
        return None

    def cluster_put(self, entry: ClusterEntry) -> None:
        self._cluster[entry.table] = entry

    def cluster_invalidate(self, table: str) -> None:
        """Drop a cluster entry now (DROP TABLE)."""
        self._cluster.pop(table, None)

    def get(self, store, colnames):
        """Staged device columns of `store` at its current version: value
        columns + MVCC sys columns + null masks.  Returns (arrs, n)."""
        e = self.get_entry(store, colnames)
        return e.arrs, e.n

    def get_entry(self, store, colnames) -> DevEntry:
        """The DevEntry of `store` at its current version holding at
        least `colnames` (staged now if missing)."""
        with self._lock:
            ver = store.version
            nullwant = {_NULL + c for c in colnames
                        if c in store.null_columns}
            want = set(colnames) | set(_SYS_COLS) | nullwant
            e = self._dev.get(store)
            if e is not None and e.version == ver and want <= set(e.arrs):
                e.last_use = next(self._use)
                return e
            if e is not None and e.version == ver:
                # same version, new columns: stage only what is missing;
                # the staged tensors keep their addresses
                arrs = dict(e.arrs)
                arrs.update(self._stage_columns(
                    store, want - set(e.arrs), e.n, codec.padded_of(e.arrs)))
                n = e.n
            else:
                n = store.row_count()
                arrs = self._stage_columns(store, want, n,
                                           size_class(max(n, 1)))
            e = DevEntry(ver, arrs, n, next(self._use))
            self._dev[store] = e
            return e

    def shed_coldest(self, frac: float = 0.5) -> int:
        """Evict the least recently used single-node entries until at
        least `frac` of their bytes are freed; returns the bytes freed.
        An evicted table restages at its next read."""
        with self._lock:
            ents = sorted(self._dev.items(), key=lambda kv: kv[1].last_use)
            goal = frac * sum(e.nbytes for _s, e in ents)
            freed = 0
            for store, e in ents:
                if freed >= goal:
                    break
                freed += e.nbytes
                self._dev.pop(store, None)
        return freed

    def invalidate(self, store):
        """Drop the store's residency now (DROP TABLE)."""
        with self._lock:
            self._dev.pop(store, None)

    def upload(self, buf: np.ndarray) -> torch.Tensor:
        """One host array to the device, counted in uploaded_bytes."""
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
                arrs[name] = self.upload(buf)
                arrs[codec.aux_name(name, enc)] = self.upload(aux)
            else:
                buf = np.zeros((padded, *h.shape[1:]), dtype=h.dtype)
                buf[:n] = h[:n]
                arrs[name] = self.upload(buf)
        return arrs
