"""ClusterSession: the coordinator-side SQL session of a Cluster.

The counterpart of opentenbase_tpu/exec/dist_session.py, cut to the
cluster slice of the port: a coordinator plans a statement into
fragments (plan/distribute.py) and drives them over the DataNodes
(exec/dist.py), with the implicit two-phase commit on multi-DataNode
writes.  Statements of the slice:

- CREATE TABLE ... DISTRIBUTE BY SHARD(k) | REPLICATION, DROP TABLE;
- INSERT ... VALUES / INSERT ... SELECT and the bulk `_insert_rows`
  path the TPC-H loader uses, rows routed by the locator;
- SELECT in an implicit transaction, on the device tier by default;
- SET / SHOW, among them `SET enable_mesh_exchange = off`, which runs
  SELECTs on the host tier instead (the reference's own parity arm).

Kept from the reference: query, execute, tier_counts (a device-tier
SELECT counts as "mesh"), fallbacks and last_tier.  Everything else
raises NotImplementedError: prepared statements, DML beyond INSERT,
explicit transactions, EXPLAIN, triggers, MERGE, COPY, resource groups,
indexes, views and the plan cache among them.
"""

from __future__ import annotations

import numpy as np

from ..catalog.schema import DistType, TableDef
from ..plan.distribute import DistPlan, Distributor
from ..plan.planner import Planner
from ..sql import ast as A
from ..sql.analyze import Binder
from ..sql.ddl import table_def_from_ast
from ..sql.parser import parse_sql
from .dist import DistExecutor
from .executor import ExecError, materialize
from .session import Result

_NOT_PORTED_STMTS = {
    A.TxnStmt: "explicit transactions",
    A.DeleteStmt: "DELETE",
    A.UpdateStmt: "UPDATE",
    A.ExplainStmt: "EXPLAIN",
    A.PrepareStmt: "prepared statements",
    A.ExecuteStmt: "prepared statements",
    A.CopyStmt: "COPY",
    A.MergeStmt: "MERGE",
}


class ClusterTxn:
    def __init__(self, txid: int, snapshot_ts: int):
        self.txid = txid
        self.snapshot_ts = snapshot_ts
        self.written_dns: set[int] = set()   # 2PC participant tracking


class ClusterSession:
    def __init__(self, cluster):
        self.cluster = cluster
        # data plane of the last SELECT: 'mesh' | 'fqs' | 'local' | 'host'
        self.last_tier = ""
        # cumulative tier usage, and the reasons the device tier fell
        # back to the host tier: none, ever (a plan it cannot carry
        # raises), so `fallbacks` stays empty
        self.tier_counts: dict[str, int] = {}
        self.fallbacks: list[str] = []

    # ------------------------------------------------------------------
    def execute(self, sql: str) -> list[Result]:
        return [self._exec_stmt(s) for s in parse_sql(sql)]

    def query(self, sql: str) -> list[tuple]:
        return self.execute(sql)[-1].rows

    # ---- txn helpers (every statement is its own transaction) ----
    def _begin_implicit(self) -> ClusterTxn:
        return ClusterTxn(self.cluster.gtm.next_txid(),
                          self.cluster.gtm.next_gts())

    # ------------------------------------------------------------------
    def _exec_stmt(self, stmt: A.Node) -> Result:
        c = self.cluster
        if isinstance(stmt, A.SelectStmt):
            return self._exec_select(stmt)
        if isinstance(stmt, A.CreateTableStmt):
            if stmt.partition_by:
                raise NotImplementedError("partitioned tables are not yet "
                                          "ported")
            if stmt.checks or stmt.foreign_keys:
                raise NotImplementedError("CHECK and FOREIGN KEY "
                                          "constraints are not yet ported")
            c.create_table(table_def_from_ast(stmt), stmt.if_not_exists)
            return Result("CREATE TABLE")
        if isinstance(stmt, A.DropTableStmt):
            c.drop_table(stmt.name, stmt.if_exists)
            return Result("DROP TABLE")
        if isinstance(stmt, A.InsertStmt):
            return self._exec_insert(stmt)
        if isinstance(stmt, A.SetStmt):
            c.gucs[stmt.name] = str(stmt.value)
            return Result("SET")
        if isinstance(stmt, A.ShowStmt):
            return Result("SHOW", names=[stmt.name],
                          rows=[(c.gucs.get(stmt.name, ""),)])
        what = _NOT_PORTED_STMTS.get(type(stmt), type(stmt).__name__)
        raise NotImplementedError(f"{what} is not yet ported")

    # ---- SELECT ----
    def _plan_distributed(self, stmt: A.SelectStmt) -> DistPlan:
        if stmt.for_update:
            raise NotImplementedError("SELECT ... FOR UPDATE is not yet "
                                      "ported")
        bq = Binder(self.cluster.catalog, apply_masks=True).bind_select(stmt)
        planned = Planner(self.cluster.catalog).plan(bq)
        fqs = self.cluster.gucs.get("enable_fast_query_shipping",
                                    "on") != "off"
        d = Distributor(self.cluster.catalog, self.cluster.ndn)
        return d.distribute(planned, bq if fqs else None)

    def _run_select_dp(self, dp: DistPlan, txn: ClusterTxn) -> Result:
        """Run a SELECT DistPlan and record which data plane ran it.  The
        device tier is the default; 'off' forces the host tier."""
        ex = DistExecutor(self.cluster, txn.snapshot_ts, txn.txid,
                          use_mesh=self.cluster.gucs.get(
                              "enable_mesh_exchange", "on") != "off")
        batch = ex.run(dp)
        names, rows = materialize(batch, dp.output_names)
        self.last_tier = ex.tier
        self.tier_counts[ex.tier] = self.tier_counts.get(ex.tier, 0) + 1
        return Result("SELECT", names=names, rows=rows, rowcount=len(rows))

    def _exec_select(self, stmt: A.SelectStmt) -> Result:
        return self._run_select_dp(self._plan_distributed(stmt),
                                   self._begin_implicit())

    # ---- INSERT ----
    def _exec_insert(self, stmt: A.InsertStmt) -> Result:
        if stmt.on_conflict is not None:
            raise NotImplementedError("INSERT ... ON CONFLICT is not yet "
                                      "ported")
        td = self.cluster.catalog.table(stmt.table)
        cols = stmt.columns or td.column_names
        if stmt.select is not None:
            rows = self._exec_select(stmt.select).rows
        else:
            rows = []
            for vr in stmt.values:
                row = []
                for v in vr:
                    if isinstance(v, A.Const):
                        row.append(v.value)
                    elif isinstance(v, A.TypedConst) and \
                            v.type_name == "date":
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
        coldata = {cname: [r[i] for r in rows]
                   for i, cname in enumerate(cols)}
        missing = [cn for cn in td.column_names if cn not in coldata]
        if missing:
            raise ExecError(f"INSERT missing columns {missing}")
        return Result("INSERT",
                      rowcount=self._insert_rows(td, coldata, len(rows)))

    def _insert_rows(self, td: TableDef, coldata: dict, n: int) -> int:
        """Bulk insert in one implicit transaction: the locator routes
        each row to its DataNode (every DataNode for a replicated table);
        the commit runs the implicit 2PC across the DataNodes written."""
        from .constraints import check_not_null
        check_not_null(td, coldata, n)
        c = self.cluster
        t = self._begin_implicit()
        c.register_txn(t.txid)
        try:
            if td.distribution.dist_type == DistType.REPLICATED:
                dests = {i: np.arange(n) for i in range(c.ndn)}
                sid = None
            else:
                route_cols = {}
                for cn in td.distribution.dist_cols:
                    vals = coldata[cn]
                    if not (isinstance(vals, np.ndarray)
                            and vals.dtype.kind != "O"):
                        # NULL dist keys route on a type-default fill
                        from ..catalog.types import TypeKind as _TK
                        fill = "" if td.column(cn).type.kind == _TK.TEXT \
                            else 0
                        vals = [fill if v is None else v for v in vals]
                    route_cols[cn] = np.asanyarray(vals)
                nodes = c.locator.route_rows(td, route_cols, n)
                sid = c.locator.shard_ids_for_rows(td, route_cols)
                dests = {i: np.nonzero(nodes == i)[0]
                         for i in set(nodes.tolist())}
            for dn_idx, idx in sorted(dests.items()):
                if len(idx) == 0:
                    continue
                sub = {cn: (coldata[cn][idx]
                            if isinstance(coldata[cn], np.ndarray)
                            else [coldata[cn][j] for j in idx])
                       for cn in coldata}
                sub_sid = sid[idx] if sid is not None else None
                c.datanodes[dn_idx].insert_raw(td.name, sub, len(idx),
                                               t.txid, sub_sid)
                t.written_dns.add(dn_idx)
        except Exception:
            c.abort_txn(t.txid, t.written_dns)
            raise
        c.commit_txn(t.txid, sorted(t.written_dns))
        return n
