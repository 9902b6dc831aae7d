"""AST-level rewrites that run before binding.

Reference analogs:
- GROUPING SETS / ROLLUP / CUBE: the reference plans these natively
  (nodeAgg.c grouping-set phases over sorted replays,
  parser/parse_agg.c transformGroupingFunc).  A columnar-batch engine
  re-aggregates per set instead: the statement expands into a UNION ALL
  of one grouped branch per grouping set, with un-grouped columns
  replaced by NULL and grouping(...) calls folded to their literal
  bitmasks.  Each branch is a full XLA-fused aggregate over the (cached)
  scan, so the expansion costs one extra device pass per set rather
  than a host sort-replay.
- Table renames for WITH RECURSIVE (exec/recursive.py drives the
  iteration; reference: nodeRecursiveunion.c + nodeWorktablescan.c).

Caveat (documented deviation): window functions inside a grouping-sets
statement are computed per grouping set, not over the combined result.
This matches PG whenever every window's PARTITION BY separates the sets
(true of the TPC-DS ROLLUP+RANK templates, which partition by
grouping(...) expressions); a window spanning sets would differ.
"""

from __future__ import annotations

import copy
import dataclasses

from . import ast as A


def _transform(node, fn):
    """Generic bottom-up AST transform: fn(node) -> replacement | None.
    Rebuilds dataclass nodes; recurses into lists/tuples of nodes."""
    if isinstance(node, A.Node):
        r = fn(node)
        if r is not None:
            return r
        kw = {}
        for f in dataclasses.fields(node):
            kw[f.name] = _transform(getattr(node, f.name), fn)
        return type(node)(**kw)
    if isinstance(node, list):
        return [_transform(x, fn) for x in node]
    if isinstance(node, tuple):
        return tuple(_transform(x, fn) for x in node)
    return node


def rename_tables(node, mapping: dict[str, str]):
    """Rewrite TableRef names per `mapping` (a recursive CTE's
    self-references -> the working-table name)."""
    def fn(x):
        if isinstance(x, A.TableRef) and x.name in mapping:
            return A.TableRef(mapping[x.name], x.alias or x.name)
        return None
    return _transform(node, fn)


def references_table(node, name: str) -> bool:
    """Read-only walk (early exit, no rebuilding)."""
    if isinstance(node, A.TableRef):
        return node.name == name
    if isinstance(node, A.Node):
        return any(references_table(getattr(node, f.name), name)
                   for f in dataclasses.fields(node))
    if isinstance(node, (list, tuple)):
        return any(references_table(x, name) for x in node)
    return False


def _default_item_alias(expr: A.Node, i: int) -> str:
    if isinstance(expr, A.ColRef):
        return expr.parts[-1]
    if isinstance(expr, A.FuncCall):
        return expr.name
    return f"?column?{i}"


def expand_grouping_sets(stmt: A.SelectStmt) -> A.SelectStmt:
    """GROUP BY [plain,] GROUPING SETS/ROLLUP/CUBE -> UNION ALL of one
    grouped branch per set."""
    sets = [list(stmt.group_by) + list(s) for s in stmt.group_sets]
    # every expression that is a grouping column in at least one set;
    # occurrences outside a branch's set become NULL in that branch
    candidates: list[A.Node] = []
    for s in sets:
        for e in s:
            if not any(e == c for c in candidates):
                candidates.append(e)

    order_by, limit, offset = stmt.order_by, stmt.limit, stmt.offset
    ctes, recursive = stmt.ctes, stmt.recursive
    tail_setop = stmt.setop

    branches = []
    for s in sets:
        b = dataclasses.replace(
            copy.deepcopy(stmt), group_sets=None, group_by=list(s),
            order_by=[], limit=None, offset=None, ctes=[],
            recursive=False, setop=None, parenthesized=False)
        absent = [c for c in candidates if not any(c == e for e in s)]

        def fold(x, _s=s, _absent=absent):
            if isinstance(x, A.FuncCall) and x.name == "grouping" \
                    and x.over is None:
                bits = 0
                for a in x.args:
                    bits = (bits << 1) | (0 if any(a == e for e in _s)
                                          else 1)
                return A.Const(bits, "int")
            from ..plan.exprs import AGG_FUNCS
            if isinstance(x, A.FuncCall) and x.over is None \
                    and x.name in AGG_FUNCS:
                # aggregate arguments see INPUT rows, not the grouped
                # output: sum(x) in a subtotal row still sums x (PG);
                # only direct output references of absent grouping
                # columns become NULL — stop the descent here
                return x
            if any(x == c for c in _absent):
                return A.Const(None, "null")
            return None

        # stabilize output names across branches before NULL replacement
        for i, it in enumerate(b.items):
            if it.alias is None:
                it.alias = _default_item_alias(it.expr, i)
        b.items = [A.SelectItem(_transform(it.expr, fold), it.alias)
                   for it in b.items]
        if b.having is not None:
            b.having = _transform(b.having, fold)
        branches.append(b)

    out = branches[0]
    cur = out
    for b in branches[1:]:
        cur.setop = ("union", True, b)
        cur = b
    cur.setop = tail_setop
    out.ctes = ctes
    out.recursive = recursive
    if not order_by and limit is None and offset is None:
        return out

    # ORDER BY sum(v) etc.: fold any subexpression that structurally
    # matches a select item onto that item's output alias, so it can
    # bind against the union result (PG resolves these positionally in
    # transformSortClause)
    # aliases must match the binder's uniquified output names (a second
    # unaliased sum() becomes "sum_1" there — analyze.py uniq())
    item_map = []
    used = set()
    for i, it in enumerate(stmt.items):
        alias = it.alias or _default_item_alias(it.expr, i)
        if alias in used:
            k = 1
            while f"{alias}_{k}" in used:
                k += 1
            alias = f"{alias}_{k}"
        used.add(alias)
        item_map.append((it.expr, alias))

    def to_alias(x):
        for expr, alias in item_map:
            if x == expr:
                return A.ColRef((alias,))
        return None

    order_by = [A.SortItem(_transform(si.expr, to_alias), si.desc,
                           si.nulls_first) for si in order_by]

    simple = all(isinstance(si.expr, A.ColRef) and len(si.expr.parts) == 1
                 or isinstance(si.expr, A.Const)
                 for si in order_by)
    if simple:
        out.order_by, out.limit, out.offset = order_by, limit, offset
        return out
    # complex ORDER BY expressions can't bind on a set-op result: wrap
    # the union as a derived table and sort outside (exprs then resolve
    # against its output columns)
    inner = out
    wrapper = A.SelectStmt(
        items=[A.SelectItem(A.Star())],
        from_=[A.SubqueryRef(inner, "__gsets")],
        order_by=order_by, limit=limit, offset=offset,
        ctes=ctes, recursive=recursive)
    inner.ctes = []
    inner.recursive = False
    return wrapper
