"""Cluster: N logical DataNodes + a GTM core + coordinator metadata.

The in-memory part of opentenbase_tpu/parallel/cluster.py.  Each
DataNode owns its table stores (host RAM) and a device buffer cache; the
Cluster holds the catalog with the default shard map, the GTM core, the
locator that places inserted rows, the GUCs, and the commit protocol:
one DataNode commits directly, several run the implicit two-phase
commit through the GTM's registry (reference: execRemote.c
pgxc_node_remote_prepare / pgxc_node_remote_commit).

All DataNodes of one Cluster live on one device: N logical DataNodes are
N partitions of one card (exec/mesh_exec.py).  `Cluster(n)` resolves to
CUDA and raises without it; `device="cpu"` runs the plain versions of
the kernels (the tests).

Not ported: the datadir (WAL, checkpoints, recovery, barriers), standbys
and failover, the in-doubt resolver, jobs, audit, statistics views,
resource queues, indexes and multi-coordinator catalog sync.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..catalog.catalog import Catalog
from ..catalog.schema import NodeDef, TableDef
from ..exec.dist import _bind_sources_host, _to_host
from ..exec.executor import ExecContext, Executor
from ..exec.session import resolve_device
from ..gtm.server import GtmCore
from ..parallel.locator import Locator
from ..storage.bufferpool import DeviceBufferPool
from ..storage.store import TableStore


class DataNode:
    """One DataNode: table stores + a device cache + the fragment
    executor service the coordinator calls."""

    def __init__(self, index: int, device):
        self.index = index
        self.stores: dict[str, TableStore] = {}
        self.cache = DeviceBufferPool(device)
        self.txn_spans: dict[int, list] = {}  # txid -> [(kind, table, spans)]
        # gid -> (txid, prepared_at): prepared txns awaiting their verdict
        self.prepared_gids: dict[str, tuple] = {}

    # ---- service surface ----
    def ddl_create(self, td: TableDef):
        if td.name not in self.stores:
            self.stores[td.name] = TableStore(td)

    def ddl_drop(self, name: str):
        st = self.stores.pop(name, None)
        if st is not None:
            self.cache.invalidate(st)

    def insert_raw(self, table: str, coldata: dict, n: int, txid: int,
                   shardids=None) -> int:
        """Insert raw (unencoded) values; encoding happens node-side where
        the dictionaries live.  Python None entries become NULLs."""
        st = self.stores[table]
        clean, masks = {}, {}
        for cn, vals in coldata.items():
            cv, m = st.split_nulls(cn, vals)
            clean[cn] = cv
            if m is not None:
                masks[cn] = m
        enc = {cn: st.encode_column(cn, vals) for cn, vals in clean.items()}
        spans = st.insert(enc, n, txid, shardids=shardids,
                          nulls=masks or None)
        self.txn_spans.setdefault(txid, []).append(("ins", table, spans))
        return n

    def exec_plan_device(self, plan, snapshot_ts: int, txid: int,
                         params: dict, sources: dict):
        """Run a fragment over this DataNode's stores and return the
        device batch (the fast-query-shipping path and the host tier)."""
        bound = _bind_sources_host(plan, sources, self.cache.device)
        ctx = ExecContext(self.stores, snapshot_ts, txid, self.cache,
                          params=dict(params))
        return Executor(ctx).exec_node(bound)

    def exec_plan(self, plan, snapshot_ts: int, txid: int,
                  params: dict, sources: dict):
        """Run a plan fragment against this node's stores; exchange inputs
        arrive as HostBatches keyed by exchange index."""
        return _to_host(self.exec_plan_device(plan, snapshot_ts, txid,
                                              params, sources))

    def prepare(self, gid: str, txid: int):
        self.prepared_gids[gid] = (txid, time.monotonic())

    def _forget_prepared(self, txid: int):
        for g, (t, _) in list(self.prepared_gids.items()):
            if t == txid:
                del self.prepared_gids[g]

    def commit(self, txid: int, ts: int):
        self._forget_prepared(txid)
        for kind, table, sp in self.txn_spans.pop(txid, []):
            st = self.stores.get(table)
            if st is not None and kind == "ins":
                st.backfill_insert(sp, np.int64(ts))

    def abort(self, txid: int):
        self._forget_prepared(txid)
        for kind, table, sp in self.txn_spans.pop(txid, []):
            st = self.stores.get(table)
            if st is not None and kind == "ins":
                st.abort_insert(sp)

    def wrote_in(self, txid: int) -> bool:
        return bool(self.txn_spans.get(txid))


class Cluster:
    """The whole deployment: catalog + shard map + GTM + DataNodes, all on
    one device."""

    def __init__(self, n_datanodes: int = 2, device=None):
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.gtm = GtmCore()
        for i in range(n_datanodes):
            self.catalog.register_node(
                NodeDef(f"dn{i}", "datanode", index=i))
        self.catalog.register_node(NodeDef("cn0", "coordinator"))
        self.catalog.register_node(NodeDef("gtm0", "gtm"))
        self.catalog.build_default_shard_map(n_datanodes)
        self.datanodes = [DataNode(i, self.device)
                          for i in range(n_datanodes)]
        self.locator = Locator(self.catalog)
        self.active_txns: set[int] = set()
        self.gucs: dict[str, str] = {"enable_fast_query_shipping": "on"}
        # the cluster tier's staged tables (ClusterEntry per table)
        self.pool = DeviceBufferPool(self.device)

    @property
    def ndn(self) -> int:
        return len(self.datanodes)

    # ---- DDL fan-out ----
    def create_table(self, td: TableDef, if_not_exists: bool = False):
        td = self.catalog.create_table(td, if_not_exists)
        for dn in self.datanodes:
            dn.ddl_create(td)
        return td

    def drop_table(self, name: str, if_exists: bool = False):
        self.catalog.drop_table(name, if_exists)
        for dn in self.datanodes:
            dn.ddl_drop(name)
        self.pool.cluster_invalidate(name)

    # ---- transactions ----
    def register_txn(self, txid: int):
        self.active_txns.add(txid)

    def commit_txn(self, txid: int, dns: Optional[list[int]] = None) -> int:
        """Commit on every DataNode the txn wrote to; the implicit 2PC
        when there are several.  Returns the commit timestamp."""
        if dns is None:
            dns = [dn.index for dn in self.datanodes if dn.wrote_in(txid)]
        if len(dns) <= 1:
            ts = int(self.gtm.next_gts())
            for i in dns:
                self.datanodes[i].commit(txid, ts)
            self.active_txns.discard(txid)
            return ts
        gid = f"gxid_{txid}"
        for i in dns:
            self.datanodes[i].prepare(gid, txid)
        self.gtm.prepare_txn(gid, [f"dn{i}" for i in dns], txid)
        ts = int(self.gtm.next_gts())
        self.gtm.commit_txn(gid, ts)
        for i in dns:
            self.datanodes[i].commit(txid, ts)
        self.gtm.forget_txn(gid)
        self.active_txns.discard(txid)
        return ts

    def abort_txn(self, txid: int, dns: Optional[set] = None):
        for dn in self.datanodes:
            if dns is None or dn.index in dns:
                dn.abort(txid)
        self.active_txns.discard(txid)
