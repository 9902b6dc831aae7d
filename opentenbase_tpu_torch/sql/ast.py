"""Raw (untyped) SQL AST.

Reference analog: the parse-tree nodes of src/include/nodes/parsenodes.h
produced by gram.y.  The analyzer (sql/analyze.py) binds these against the
catalog into typed query trees.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Node:
    pass


# ---- expressions ----------------------------------------------------------

@dataclasses.dataclass
class ColRef(Node):
    parts: tuple[str, ...]            # (col) or (tbl, col)


@dataclasses.dataclass
class Star(Node):
    table: Optional[str] = None       # t.* or *


@dataclasses.dataclass
class Const(Node):
    value: object                     # int | float-str | str | bool | None
    kind: str                         # 'int' | 'num' | 'str' | 'bool' | 'null'


@dataclasses.dataclass
class CreateFunctionStmt(Node):
    """CREATE FUNCTION name() RETURNS TRIGGER AS '<stmts>' LANGUAGE SQL"""
    name: str = ""
    body: str = ""
    returns: str = "trigger"
    or_replace: bool = False


@dataclasses.dataclass
class DropFunctionStmt(Node):
    name: str = ""
    if_exists: bool = False


@dataclasses.dataclass
class CreateTriggerStmt(Node):
    """CREATE TRIGGER t {BEFORE|AFTER} {INSERT|UPDATE|DELETE} ON tbl
    [FOR EACH ROW] [WHEN (cond)] EXECUTE FUNCTION f()"""
    name: str = ""
    timing: str = "after"        # 'before' | 'after'
    event: str = "insert"        # 'insert' | 'update' | 'delete'
    table: str = ""
    when: object = None          # expression over NEW./OLD.
    when_src: str = ""           # source text (catalog-persisted form)
    func: str = ""


@dataclasses.dataclass
class DropTriggerStmt(Node):
    name: str = ""
    table: str = ""
    if_exists: bool = False


@dataclasses.dataclass
class RaiseStmt(Node):
    """RAISE 'message' — the procedural error surface (plpgsql RAISE
    EXCEPTION, scoped to what trigger bodies need)."""
    message: str = ""


def rewrite(node, fn):
    """Generic bottom-up-free AST rewriter: fn(node) -> replacement or
    None to descend.  Preserves identity when nothing changes (callers
    rely on `is` checks to skip rebuilt trees).  The ONE walker behind
    mask qualification, trigger NEW/OLD substitution, and friends —
    keep edge-case handling (tuple reconstruction, identity
    short-circuit) here, not in per-feature copies."""
    hit = fn(node)
    if hit is not None:
        return hit
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changed = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = rewrite(v, fn)
            if nv is not v:
                changed[f.name] = nv
        return dataclasses.replace(node, **changed) if changed else node
    if isinstance(node, list):
        out = [rewrite(x, fn) for x in node]
        return out if any(a is not b for a, b in zip(out, node)) \
            else node
    if isinstance(node, tuple):
        out = tuple(rewrite(x, fn) for x in node)
        return out if any(a is not b for a, b in zip(out, node)) \
            else node
    return node


@dataclasses.dataclass
class CreateMaskStmt(Node):
    """CREATE MASK name ON table (col) AS 'expr' — transparent column
    masking (reference: utils/misc/datamask.c)."""
    name: str = ""
    table: str = ""
    column: str = ""
    expr_src: str = ""


@dataclasses.dataclass
class DropMaskStmt(Node):
    name: str = ""
    if_exists: bool = False


@dataclasses.dataclass
class CreateAuditPolicyStmt(Node):
    """CREATE AUDIT POLICY name ON table WHEN (pred) — fine-grained
    audit (reference: audit/audit_fga.c)."""
    name: str = ""
    table: str = ""
    pred_src: str = ""


@dataclasses.dataclass
class DropAuditPolicyStmt(Node):
    name: str = ""
    if_exists: bool = False


@dataclasses.dataclass
class CreateResourceGroupStmt(Node):
    """CREATE RESOURCE GROUP g WITH (concurrency = N,
    staging_budget_rows = M, device_time_share = K) — reference:
    commands/resgroupcmds.c + gtm_resqueue.c."""
    name: str = ""
    options: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DropResourceGroupStmt(Node):
    name: str = ""
    if_exists: bool = False


@dataclasses.dataclass
class CreateJobStmt(Node):
    """CREATE JOB name SCHEDULE <seconds> AS '<sql>' (reference:
    pg_dbms_job / job_scheduler.c)."""
    name: str = ""
    interval_s: float = 0.0
    sql: str = ""


@dataclasses.dataclass
class DropJobStmt(Node):
    name: str = ""
    if_exists: bool = False


@dataclasses.dataclass
class Param(Node):
    index: int                        # $n


@dataclasses.dataclass
class TypedConst(Node):
    """DATE 'x', INTERVAL 'n' unit."""
    type_name: str
    value: str
    unit: str = ""
    qty: int = 0


@dataclasses.dataclass
class BinOp(Node):
    op: str
    left: Node
    right: Node


@dataclasses.dataclass
class UnaryOp(Node):
    op: str                           # '-' | 'not'
    arg: Node


@dataclasses.dataclass
class BoolExpr(Node):
    op: str                           # 'and' | 'or'
    args: list[Node]


@dataclasses.dataclass
class FuncCall(Node):
    name: str
    args: list[Node]
    distinct: bool = False
    star: bool = False                # count(*)
    over: Optional["WindowDef"] = None  # window function call


@dataclasses.dataclass
class WindowDef(Node):
    partition_by: list[Node] = dataclasses.field(default_factory=list)
    order_by: list["SortItem"] = dataclasses.field(default_factory=list)
    # explicit frame clause: (mode, start, end) where mode is
    # 'rows' | 'range' and each bound is (kind, n) with kind in
    # unbounded_preceding|preceding|current|following|unbounded_following
    frame: Optional[tuple] = None


@dataclasses.dataclass
class CaseExpr(Node):
    whens: list[tuple[Node, Node]]
    else_: Optional[Node]


@dataclasses.dataclass
class InExpr(Node):
    arg: Node
    items: Optional[list[Node]]       # literal list
    subquery: Optional["SelectStmt"]  # or IN (select ...)
    negated: bool = False


@dataclasses.dataclass
class BetweenExpr(Node):
    arg: Node
    low: Node
    high: Node
    negated: bool = False


@dataclasses.dataclass
class LikeExpr(Node):
    arg: Node
    pattern: Node
    negated: bool = False


@dataclasses.dataclass
class NullTest(Node):
    arg: Node
    is_null: bool


@dataclasses.dataclass
class ExistsExpr(Node):
    subquery: "SelectStmt"
    negated: bool = False


@dataclasses.dataclass
class ScalarSubquery(Node):
    subquery: "SelectStmt"


@dataclasses.dataclass
class QuantifiedCmp(Node):
    """expr op ANY/ALL (subquery)."""
    op: str
    arg: Node
    quantifier: str                   # 'any' | 'all'
    subquery: "SelectStmt"


@dataclasses.dataclass
class CastExpr(Node):
    arg: Node
    type_name: str
    type_args: tuple[int, ...] = ()


@dataclasses.dataclass
class ExtractExpr(Node):
    field: str
    arg: Node


@dataclasses.dataclass
class SubstringExpr(Node):
    arg: Node
    start: Node
    length: Optional[Node]


# ---- select ---------------------------------------------------------------

@dataclasses.dataclass
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclasses.dataclass
class TableRef(Node):
    name: str
    alias: Optional[str] = None


@dataclasses.dataclass
class SubqueryRef(Node):
    subquery: "SelectStmt"
    alias: str


@dataclasses.dataclass
class JoinRef(Node):
    kind: str                         # inner|left|right|full|cross
    left: Node
    right: Node
    on: Optional[Node]


@dataclasses.dataclass
class SortItem(Node):
    expr: Node
    desc: bool = False
    nulls_first: Optional[bool] = None


@dataclasses.dataclass
class SelectStmt(Node):
    items: list[SelectItem]
    from_: list[Node]                 # TableRef | SubqueryRef | JoinRef
    where: Optional[Node] = None
    group_by: list[Node] = dataclasses.field(default_factory=list)
    having: Optional[Node] = None
    order_by: list[SortItem] = dataclasses.field(default_factory=list)
    limit: Optional[Node] = None
    offset: Optional[Node] = None
    distinct: bool = False
    setop: Optional[tuple[str, bool, "SelectStmt"]] = None  # (op, all, rhs)
    ctes: list = dataclasses.field(default_factory=list)
    # WITH clause: [(name, col_aliases|None, SelectStmt)]
    recursive: bool = False       # WITH RECURSIVE
    parenthesized: bool = False   # was written as (SELECT ...)
    # GROUPING SETS / ROLLUP / CUBE: list of grouping sets, each a list
    # of exprs; plain GROUP BY items (group_by) prepend to every set
    # (reference: gram.y group_by_list -> GroupingSet nodes)
    group_sets: Optional[list[list[Node]]] = None
    # SELECT ... FOR UPDATE row locking: None | 'wait' | 'nowait'
    # (reference: LockingClause -> RowMarkClause, nodeLockRows.c)
    for_update: Optional[str] = None


# ---- DML ------------------------------------------------------------------

@dataclasses.dataclass
class OnConflict(Node):
    """INSERT ... ON CONFLICT clause (reference: the UPSERT legs built by
    pgxc_build_upsert_statement, pgxc/plan/planner.c:1070)."""
    columns: list[str]                    # conflict target
    action: str                           # 'nothing' | 'update'
    assignments: list[tuple[str, Node]] = dataclasses.field(
        default_factory=list)             # DO UPDATE SET col = expr


@dataclasses.dataclass
class InsertStmt(Node):
    table: str
    columns: list[str]
    values: Optional[list[list[Node]]]    # VALUES rows
    select: Optional[SelectStmt] = None
    on_conflict: Optional[OnConflict] = None


@dataclasses.dataclass
class UpdateStmt(Node):
    table: str
    assignments: list[tuple[str, Node]]
    where: Optional[Node] = None


@dataclasses.dataclass
class DeleteStmt(Node):
    table: str
    where: Optional[Node] = None


@dataclasses.dataclass
class CopyStmt(Node):
    table: str
    columns: list[str]
    direction: str                    # 'from' | 'to'
    filename: str                     # '' => STDIN/STDOUT
    options: dict


# ---- DDL / utility --------------------------------------------------------

@dataclasses.dataclass
class ColumnDefAst(Node):
    name: str
    type_name: str
    type_args: tuple[int, ...]
    not_null: bool = False
    primary_key: bool = False
    # column CHECK (expr) — the expression's SQL text (bound at use)
    check_src: Optional[str] = None
    # column REFERENCES reftable (refcol)
    references: Optional[tuple[str, str]] = None


@dataclasses.dataclass
class CreateTableStmt(Node):
    name: str
    columns: list[ColumnDefAst]
    primary_key: list[str]
    dist_type: str = "shard"          # shard|replication|hash|modulo|roundrobin
    dist_cols: list[str] = dataclasses.field(default_factory=list)
    group: Optional[str] = None
    if_not_exists: bool = False
    # PARTITION BY RANGE|LIST (col) — reference: pg_partitioned_table
    partition_by: Optional[tuple[str, str]] = None   # (method, col)
    # table CHECK constraints (expression SQL text; reference:
    # pg_constraint contype 'c') and FOREIGN KEYs (contype 'f')
    checks: list[str] = dataclasses.field(default_factory=list)
    foreign_keys: list[tuple] = dataclasses.field(default_factory=list)
    # each: (fk_cols tuple, ref_table, ref_cols tuple)
    # DISTRIBUTE BY RANGE split-point literal expressions
    range_split: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CreateNodeGroupStmt(Node):
    """CREATE NODE GROUP name (dn, ...) — reference: pgxc_group.h
    + CREATE NODE GROUP in nodemgr.c."""
    name: str
    members: list


@dataclasses.dataclass
class TruncateStmt(Node):
    """TRUNCATE [TABLE] name — non-MVCC bulk clear (reference:
    ExecuteTruncate, commands/tablecmds.c)."""
    table: str


@dataclasses.dataclass
class SavepointStmt(Node):
    """SAVEPOINT / ROLLBACK TO / RELEASE — subtransactions
    (reference: DefineSavepoint / RollbackToSavepoint, xact.c)."""
    op: str                  # 'savepoint' | 'rollback_to' | 'release'
    name: str


@dataclasses.dataclass
class MergeStmt(Node):
    """MERGE INTO tgt USING src ON cond WHEN [NOT] MATCHED THEN ...
    (reference: ExecMerge, executor/execMerge.c)."""
    target: str
    source: str
    on: Node
    matched_set: Optional[list] = None      # [(col, expr)] for UPDATE
    matched_delete: bool = False            # WHEN MATCHED THEN DELETE
    insert_cols: Optional[list] = None
    insert_values: Optional[list] = None    # exprs over src columns


@dataclasses.dataclass
class CreatePartitionStmt(Node):
    """CREATE TABLE name PARTITION OF parent FOR VALUES
    FROM (lit) TO (lit) | IN (lit, ...)."""
    name: str
    parent: str
    from_value: Optional[Node] = None
    to_value: Optional[Node] = None
    in_values: Optional[list[Node]] = None


@dataclasses.dataclass
class DropTableStmt(Node):
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class CreateSequenceStmt(Node):
    name: str
    start: int = 1
    increment: int = 1


@dataclasses.dataclass
class CreateIndexStmt(Node):
    name: str
    table: str
    columns: list[str]
    unique: bool = False
    method: str = ""                      # 'ivfflat' etc.
    options: dict = dataclasses.field(default_factory=dict)
    global_: bool = False                 # CREATE GLOBAL INDEX


@dataclasses.dataclass
class DropIndexStmt(Node):
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class CreateViewStmt(Node):
    """CREATE [OR REPLACE] VIEW name AS select (reference:
    view.c DefineView; stored as SQL text, expanded at bind time)."""
    name: str
    select: "SelectStmt"          # parsed for validation
    text: str                     # original SELECT text (persisted)
    or_replace: bool = False


@dataclasses.dataclass
class DropViewStmt(Node):
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class AlterTableStmt(Node):
    """ALTER TABLE: add/drop/rename column, rename table (reference:
    tablecmds.c ATExecCmd subset)."""
    table: str
    action: str        # add_column | drop_column | rename_column | rename_table
    column: Optional[ColumnDefAst] = None
    name: str = ""
    new_name: str = ""


@dataclasses.dataclass
class CreatePublicationStmt(Node):
    """CREATE PUBLICATION name FOR TABLE t1, t2 (reference:
    contrib/opentenbase_subscription + publicationcmds.c)."""
    name: str
    tables: list[str]


@dataclasses.dataclass
class DropPublicationStmt(Node):
    name: str


@dataclasses.dataclass
class CreateSubscriptionStmt(Node):
    """CREATE SUBSCRIPTION name CONNECTION 'conninfo' PUBLICATION pub."""
    name: str
    conninfo: str
    publication: str


@dataclasses.dataclass
class DropSubscriptionStmt(Node):
    name: str


@dataclasses.dataclass
class TxnStmt(Node):
    op: str                           # begin|commit|rollback


@dataclasses.dataclass
class ExplainStmt(Node):
    stmt: Node
    analyze: bool = False
    verbose: bool = False


@dataclasses.dataclass
class SetStmt(Node):
    name: str
    value: object


@dataclasses.dataclass
class ShowStmt(Node):
    name: str


@dataclasses.dataclass
class VacuumStmt(Node):
    table: Optional[str]


@dataclasses.dataclass
class AnalyzeStmt(Node):
    table: Optional[str]


@dataclasses.dataclass
class BarrierStmt(Node):
    name: str


@dataclasses.dataclass
class ExecuteDirectStmt(Node):
    node: str
    sql: str


# ---- prepared statements (reference: PREPARE/EXECUTE + the extended-
# protocol plan cache, tcop/postgres.c:2411 CreateCachedPlan) ----

@dataclasses.dataclass
class PrepareStmt(Node):
    name: str
    types: list[tuple[str, tuple[int, ...]]]   # declared $n types (ordered)
    stmt: Node                                 # SELECT / INSERT / UPDATE / DELETE


@dataclasses.dataclass
class ExecuteStmt(Node):
    name: str
    args: list[Node]                           # literal argument exprs


@dataclasses.dataclass
class DeallocateStmt(Node):
    name: Optional[str]                        # None = ALL
