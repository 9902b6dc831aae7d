"""Bound query trees (analyzer output, planner input).

Reference analog: the Query struct produced by parse analysis
(src/backend/parser/analyze.c, include/nodes/parsenodes.h Query) — range
table + jointree + targetlist of typed expressions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..catalog.schema import TableDef
from ..catalog.types import SqlType
from . import exprs as E


@dataclasses.dataclass
class RTE:
    """Range-table entry."""
    alias: str
    kind: str                             # 'table' | 'subquery'
    table: Optional[TableDef] = None
    subquery: Optional["BoundQuery"] = None
    # visible columns: plain name -> (qualified name, type)
    columns: dict[str, tuple[str, SqlType]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class JoinStep:
    """One step of a left-deep join sequence: join `rte_index` to the
    accumulated left side.  kind 'inner' quals live in BoundQuery.where;
    outer-join quals stay here."""
    rte_index: int
    kind: str                             # 'inner' | 'left' | 'right' | 'cross'
    on: Optional[E.Expr] = None


@dataclasses.dataclass(frozen=True)
class SubLink(E.Expr):
    """Bound subquery expression embedded in a scalar context.
    link_kind: 'scalar' | 'exists' | 'in' | 'any' | 'all'
    """
    link_kind: str
    query: "BoundQuery"
    test_expr: Optional[E.Expr] = None     # for in/any/all: outer-side expr
    cmp_op: str = "="
    negated: bool = False

    def __post_init__(self):
        from ..catalog.types import BOOL
        t = BOOL if self.link_kind != "scalar" \
            else self.query.targets[0][1].type
        object.__setattr__(self, "type", t)

    def children(self):
        return (self.test_expr,) if self.test_expr is not None else ()

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclasses.dataclass
class BoundSetOp:
    """UNION [ALL] chain (transformSetOperationStmt analog)."""
    op: str
    all: bool
    left: object                   # BoundQuery | BoundSetOp
    right: object
    target_names: list[str]
    target_types: list[SqlType]
    order_by: list[tuple[int, bool]] = dataclasses.field(
        default_factory=list)      # (output column index, desc)
    limit: Optional[int] = None
    offset: int = 0


@dataclasses.dataclass
class BoundQuery:
    rtable: list[RTE]
    join_order: list[JoinStep]            # left-deep sequence over rtable
    where: list[E.Expr]                   # conjunct list (inner-join quals in)
    targets: list[tuple[str, E.Expr]]     # output name -> expr (may hold Agg)
    group_by: list[E.Expr]
    having: list[E.Expr]
    order_by: list[tuple[E.Expr, bool]]   # (expr, desc)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    correlated_cols: list[str] = dataclasses.field(default_factory=list)
    # qualified outer-scope column names this (sub)query references

    @property
    def has_aggs(self) -> bool:
        return bool(self.group_by) or any(
            E.contains_agg(e) for _, e in self.targets) or bool(self.having)
