"""DDL AST -> catalog objects.

Reference analog: DefineRelation + pgxc distribution handling in
src/backend/commands/tablecmds.c and pgxc/locator (CREATE TABLE ...
DISTRIBUTE BY is the XC grammar addition).
"""

from __future__ import annotations

from ..catalog import types as T
from ..catalog.schema import (ColumnDef, Distribution, DistType, SequenceDef,
                              TableDef)
from . import ast as A

_DIST_MAP = {
    "shard": DistType.SHARD,
    "hash": DistType.HASH,
    "modulo": DistType.MODULO,
    "roundrobin": DistType.ROUNDROBIN,
    "range": DistType.RANGE,
    "replicated": DistType.REPLICATED,
    "replication": DistType.REPLICATED,
}


def _range_bound(col: ColumnDef, expr) -> int:
    """A RANGE split point in STORAGE representation (int64) — the
    same canonical form the locator routes on."""
    from ..catalog.types import TypeKind, date_to_days, decimal_to_int
    v = expr.value if isinstance(expr, (A.Const, A.TypedConst)) else None
    if isinstance(expr, A.UnaryOp) and expr.op == "-" and \
            isinstance(expr.arg, A.Const):
        v = -float(expr.arg.value) if "." in str(expr.arg.value) \
            else -int(expr.arg.value)
    if v is None:
        raise ValueError("RANGE split points must be literals")
    k = col.type.kind
    if k == TypeKind.DATE:
        return int(date_to_days(str(v)))
    if k == TypeKind.DECIMAL:
        return int(decimal_to_int(str(v), col.type.scale))
    return int(v)


def table_def_from_ast(stmt: A.CreateTableStmt) -> TableDef:
    cols = []
    pk = list(stmt.primary_key)
    for c in stmt.columns:
        cols.append(ColumnDef(c.name, T.type_from_name(c.type_name,
                                                       c.type_args),
                              nullable=not (c.not_null or c.primary_key)))
        if c.primary_key:
            pk.append(c.name)
    dist = Distribution(_DIST_MAP[stmt.dist_type], list(stmt.dist_cols),
                        stmt.group or "default_group")
    td = TableDef(stmt.name, cols, dist, checks=list(stmt.checks),
                  fks=[{"cols": list(fc), "ref_table": rt,
                        "ref_cols": list(rc)}
                       for fc, rt, rc in stmt.foreign_keys])
    if stmt.range_split:
        dcol = td.column(dist.dist_cols[0])
        bounds = [_range_bound(dcol, e) for e in stmt.range_split]
        if bounds != sorted(bounds):
            raise ValueError("RANGE split points must be ascending")
        dist.range_bounds = bounds
    return td


def sequence_def_from_ast(stmt: A.CreateSequenceStmt) -> SequenceDef:
    return SequenceDef(stmt.name, stmt.start, stmt.increment)
