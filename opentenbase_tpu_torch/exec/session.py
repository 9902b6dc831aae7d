"""Single-node engine + SQL session on one CUDA device.

The counterpart of opentenbase_tpu/exec/session.py for the statements of
this slice: CREATE TABLE, INSERT (VALUES, SELECT, and the bulk
`_insert_rows` path the TPC-H loader uses), and plain SELECT, each in an
implicit single-statement transaction.  A LocalNode owns the catalog,
the table stores (host RAM), a device buffer cache and a local timestamp
source standing in for the GTM.

SELECTs run through the executor's fused tier first (exec/fused.py: one
captured program per fragment), and `_plan_select` reuses plans through
the exact-statement plan cache (exec/plancache.py get_or_build).  The
serving tier (exec/scheduler.py Scheduler) drives these sessions from
many client threads; it reads `Session.resource_group` for admission.

The node runs on the card: `LocalNode()` resolves to CUDA and raises when
there is none.  A caller that wants the CPU (the tests) says so with
`device="cpu"`; nothing moves execution to the CPU on its own.

CREATE INDEX ... USING ivfflat builds the vector index (K15, ops/ann.py);
ORDER BY vec <-> q LIMIT k then probes it.

Statements outside the slice — explicit transactions, DELETE / UPDATE,
views, btree and hnsw indexes, partitions, triggers and WAL durability
among them — raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..catalog.catalog import Catalog
from ..catalog.schema import DistType, NodeDef, TableDef
from ..parallel.locator import Locator
from ..plan.planner import PlannedStmt, Planner
from ..sql import ast as A
from ..sql.analyze import Binder
from ..sql.ddl import table_def_from_ast
from ..sql.parser import parse_sql
from ..storage.bufferpool import DeviceBufferPool
from ..storage.store import TableStore
from .executor import ExecContext, ExecError, Executor, materialize


@dataclasses.dataclass
class Result:
    """One statement's result."""
    command: str
    names: list[str] = dataclasses.field(default_factory=list)
    rows: list[tuple] = dataclasses.field(default_factory=list)
    rowcount: int = 0


class TxnState:
    def __init__(self, txid: int, snapshot_ts: int):
        self.txid = txid
        self.snapshot_ts = snapshot_ts
        # per-store write sets for commit/abort backfill
        self.insert_spans: list[tuple[TableStore, list]] = []


class LocalGts:
    """Monotonic local timestamp source — the in-process stand-in for the
    GTM (reference: GetGlobalTimestampGTM, access/transam/gtm.c:1962)."""

    def __init__(self, start: int = 100):
        self._lock = threading.Lock()
        self._ts = start
        self._txid = 1

    def next_gts(self) -> int:
        with self._lock:
            self._ts += 1
            return self._ts

    def next_txid(self) -> int:
        with self._lock:
            self._txid += 1
            return self._txid


def resolve_device(device=None) -> torch.device:
    """The node's device: CUDA unless the caller names another one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "opentenbase_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels instead")
        return torch.device("cuda")
    return torch.device(device)


class LocalNode:
    def __init__(self, device=None, node_name: str = "dn0"):
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.catalog.register_node(NodeDef(node_name, "datanode", index=0))
        self.catalog.build_default_shard_map(1)
        self.stores: dict[str, TableStore] = {}
        self.gts = LocalGts()
        self.cache = DeviceBufferPool(self.device)
        self.ddl_gen = 0      # bumped by DDL: part of the plan cache key

    def serve(self, host: str = "127.0.0.1", port: int = 0, **knobs):
        """The reference serves this node over its network front end
        (exec/scheduler.py serve); the port has no network tier yet."""
        from .scheduler import serve
        return serve(self, host, port, **knobs)


_NOT_PORTED_STMTS = {
    A.TxnStmt: "explicit transactions",
    A.DeleteStmt: "DELETE",
    A.UpdateStmt: "UPDATE",
    A.ExplainStmt: "EXPLAIN",
}


def check_index_method(stmt: A.CreateIndexStmt) -> None:
    """Raise for the CREATE INDEX forms not ported: only ivfflat is."""
    if stmt.global_:
        raise NotImplementedError("global indexes are not yet ported")
    if stmt.method == "hnsw":
        raise NotImplementedError("hnsw indexes are not yet ported")
    if stmt.method != "ivfflat":
        raise NotImplementedError("btree indexes (and IndexScan) are not "
                                  "yet ported")


class Session:
    def __init__(self, node: LocalNode, resource_group: str = ""):
        self.node = node
        # the serving tier's admission group ("" = default)
        self.resource_group = resource_group

    def execute(self, sql: str) -> list[Result]:
        return [self._exec_stmt(s) for s in parse_sql(sql)]

    def query(self, sql: str) -> list[tuple]:
        """Convenience: single SELECT -> rows."""
        return self.execute(sql)[-1].rows

    # ------------------------------------------------------------------
    def _begin_implicit(self) -> TxnState:
        return TxnState(self.node.gts.next_txid(), self.node.gts.next_gts())

    def _commit(self, t: TxnState):
        ts = np.int64(self.node.gts.next_gts())
        for st, spans in t.insert_spans:
            st.backfill_insert(spans, ts)

    # ------------------------------------------------------------------
    def _exec_stmt(self, stmt: A.Node) -> Result:
        if isinstance(stmt, A.SelectStmt):
            return self._exec_select(stmt)
        if isinstance(stmt, A.CreateTableStmt):
            return self._exec_create_table(stmt)
        if isinstance(stmt, A.InsertStmt):
            return self._exec_insert(stmt)
        if isinstance(stmt, A.CreateIndexStmt):
            return self._exec_create_index(stmt)
        what = _NOT_PORTED_STMTS.get(type(stmt), type(stmt).__name__)
        raise NotImplementedError(f"{what} is not yet ported")

    def _exec_create_table(self, stmt: A.CreateTableStmt) -> Result:
        if stmt.partition_by:
            raise NotImplementedError("partitioned tables are not yet "
                                      "ported")
        if stmt.checks or stmt.foreign_keys:
            raise NotImplementedError("CHECK and FOREIGN KEY constraints "
                                      "are not yet ported")
        td = table_def_from_ast(stmt)
        self.node.catalog.create_table(td, stmt.if_not_exists)
        self.node.stores.setdefault(td.name, TableStore(td))
        self.node.ddl_gen += 1
        return Result("CREATE TABLE")

    def _exec_create_index(self, stmt: A.CreateIndexStmt) -> Result:
        """CREATE INDEX ... USING ivfflat (col) [WITH (lists, metric)]:
        the IVF coarse quantizer, built on the node's device."""
        check_index_method(stmt)
        # a schema change: cached plans of this node are rebuilt
        self.node.ddl_gen += 1
        try:
            self.node.stores[stmt.table].build_ann_index(
                stmt.columns[0], int(stmt.options.get("lists", 0)),
                str(stmt.options.get("metric", "l2")),
                device=self.node.device)
        except ValueError as e:
            raise ExecError(str(e)) from None
        return Result("CREATE INDEX")

    def _plan_select(self, stmt: A.SelectStmt) -> PlannedStmt:
        if stmt.for_update:
            raise NotImplementedError("SELECT ... FOR UPDATE is not yet "
                                      "ported")
        from .plancache import get_or_build
        node = self.node
        gen = (getattr(node, "ddl_gen", 0), len(node.catalog.tables))

        def build():
            bq = Binder(node.catalog).bind_select(stmt)
            return Planner(node.catalog).plan(bq)

        return get_or_build(node, "_plan_cache", stmt, gen, build)

    def _run_select(self, stmt: A.SelectStmt):
        planned = self._plan_select(stmt)
        t = self._begin_implicit()
        ctx = ExecContext(self.node.stores, t.snapshot_ts, t.txid,
                          self.node.cache)
        batch = Executor(ctx).run(planned)
        return materialize(batch, planned.output_names)

    def _exec_select(self, stmt: A.SelectStmt) -> Result:
        names, rows = self._run_select(stmt)
        return Result("SELECT", names=names, rows=rows, rowcount=len(rows))

    # ---- DML ----
    def _exec_insert(self, stmt: A.InsertStmt) -> Result:
        td = self.node.catalog.table(stmt.table)
        st = self.node.stores[stmt.table]
        cols = stmt.columns or td.column_names
        if stmt.select is not None:
            _, rows = self._run_select(stmt.select)
        else:
            rows = []
            for vr in stmt.values:
                row = []
                for v in vr:
                    if isinstance(v, A.Const):
                        row.append(v.value)
                    elif isinstance(v, A.TypedConst) and v.type_name == "date":
                        row.append(v.value)
                    elif isinstance(v, A.UnaryOp) and v.op == "-" \
                            and isinstance(v.arg, A.Const):
                        row.append(-float(v.arg.value)
                                   if "." in str(v.arg.value)
                                   else -int(v.arg.value))
                    else:
                        raise ExecError("INSERT values must be literals")
                rows.append(row)
        if not rows:
            return Result("INSERT", rowcount=0)
        if len(cols) != len(rows[0]):
            raise ExecError("INSERT column count mismatch")
        coldata = {c: [r[i] for r in rows] for i, c in enumerate(cols)}
        missing = [c for c in td.column_names if c not in coldata]
        if missing:
            raise ExecError(f"INSERT missing columns {missing} "
                            "(defaults unsupported)")
        return Result("INSERT",
                      rowcount=self._insert_rows(td, st, coldata, len(rows)))

    def _insert_rows(self, td: TableDef, st: TableStore,
                     coldata: dict, n: int) -> int:
        """Bulk insert of column data in one implicit transaction."""
        from .constraints import check_not_null
        check_not_null(td, coldata, n)
        t = self._begin_implicit()
        clean, masks = {}, {}
        for c, vals in coldata.items():
            cv, m = st.split_nulls(c, vals)
            clean[c] = cv
            if m is not None:
                masks[c] = m
        enc = {c: st.encode_column(c, vals) for c, vals in clean.items()}
        loc = Locator(self.node.catalog)
        raw_for_route = {c: np.asanyarray(clean[c])
                         for c in td.distribution.dist_cols} \
            if td.distribution.dist_type == DistType.SHARD else {}
        sid = loc.shard_ids_for_rows(td, raw_for_route) \
            if raw_for_route else None
        spans = st.insert(enc, n, t.txid, shardids=sid,
                          nulls=masks or None)
        t.insert_spans.append((st, spans))
        self._commit(t)
        return n
