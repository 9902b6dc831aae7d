"""Recursive-descent / Pratt SQL parser.

Reference analog: the bison grammar src/backend/parser/gram.y (the XC
extensions parsed here — DISTRIBUTE BY SHARD/REPLICATION/..., EXECUTE DIRECT
ON, CREATE BARRIER — come from the reference's pgxc grammar additions).
Covers the TPC-H/TPC-DS-style analytical subset plus DDL/DML/COPY/utility.
"""

from __future__ import annotations

from typing import Optional

from . import ast as A
from .lexer import RESERVED, SqlSyntaxError, Tok, Token, lex

_CMP_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}
_MULTIWORD_TYPES = {("double", "precision"): "double precision",
                    ("character", "varying"): "varchar"}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = lex(sql)
        self.i = 0

    # ---- token helpers ----
    @property
    def tok(self) -> Token:
        return self.toks[self.i]

    def peek(self, k: int = 1) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def advance(self) -> Token:
        t = self.tok
        self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.tok
        return t.kind == Tok.IDENT and t.value in words

    def accept_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.i += 1
            return True
        return False

    def expect_kw(self, word: str):
        if not self.accept_kw(word):
            raise SqlSyntaxError(f"expected {word.upper()}, got "
                                 f"{self.tok.value or 'end of input'!r}",
                                 self.sql, self.tok.pos)

    def at_op(self, *ops: str) -> bool:
        return self.tok.kind == Tok.OP and self.tok.value in ops

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.i += 1
            return True
        return False

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise SqlSyntaxError(f"expected {op!r}, got "
                                 f"{self.tok.value or 'end of input'!r}",
                                 self.sql, self.tok.pos)

    def ident(self) -> str:
        t = self.tok
        if t.kind != Tok.IDENT:
            raise SqlSyntaxError(f"expected identifier, got {t.value!r}",
                                 self.sql, t.pos)
        if t.is_keyword and t.value in RESERVED:
            raise SqlSyntaxError(
                f"reserved word {t.value!r} cannot be an identifier",
                self.sql, t.pos)
        self.i += 1
        return t.value

    def int_lit(self) -> int:
        t = self.tok
        if t.kind != Tok.NUM or not t.value.isdigit():
            raise SqlSyntaxError(f"expected an integer, got {t.value!r}",
                                 self.sql, t.pos)
        self.i += 1
        return int(t.value)

    # ------------------------------------------------------------------
    # statements
    # ------------------------------------------------------------------
    def parse(self) -> list[A.Node]:
        out = []
        try:
            while self.tok.kind != Tok.EOF:
                if self.accept_op(";"):
                    continue
                out.append(self.statement())
                while self.accept_op(";"):
                    pass
        except RecursionError:
            raise SqlSyntaxError("statement too deeply nested", self.sql,
                                 self.tok.pos) from None
        return out

    def statement(self) -> A.Node:
        t = self.tok
        if self.at_op("("):
            return self.select_stmt()
        if t.kind != Tok.IDENT:
            raise SqlSyntaxError(f"unexpected {t.value!r}", self.sql, t.pos)
        v = t.value
        if v == "select":
            return self.select_stmt()
        if v == "with":
            return self.select_stmt()
        if v == "insert":
            return self.insert_stmt()
        if v == "update":
            return self.update_stmt()
        if v == "delete":
            return self.delete_stmt()
        if v == "create":
            return self.create_stmt()
        if v == "alter":
            return self.alter_stmt()
        if v == "drop":
            return self.drop_stmt()
        if v == "copy":
            return self.copy_stmt()
        if v in ("begin", "start"):
            self.advance()
            self.accept_kw("transaction", "work")
            return A.TxnStmt("begin")
        if v == "commit":
            self.advance()
            self.accept_kw("transaction", "work")
            return A.TxnStmt("commit")
        if v in ("rollback", "abort"):
            self.advance()
            if self.accept_kw("to"):
                self.accept_kw("savepoint")
                return A.SavepointStmt("rollback_to", self.ident())
            self.accept_kw("transaction", "work")
            return A.TxnStmt("rollback")
        if v == "savepoint":
            self.advance()
            return A.SavepointStmt("savepoint", self.ident())
        if v == "raise":
            self.advance()
            m = self.advance()
            if m.kind != Tok.STR:
                raise SqlSyntaxError("RAISE requires a string message",
                                     self.sql, m.pos)
            return A.RaiseStmt(m.value)
        if v == "release":
            self.advance()
            self.accept_kw("savepoint")
            return A.SavepointStmt("release", self.ident())
        if v == "truncate":
            self.advance()
            self.accept_kw("table")
            return A.TruncateStmt(self.ident())
        if v == "merge":
            return self.merge_stmt()
        if v == "explain":
            self.advance()
            analyze = verbose = False
            while True:
                if self.accept_kw("analyze", "analyse"):
                    analyze = True
                elif self.accept_kw("verbose"):
                    verbose = True
                else:
                    break
            return A.ExplainStmt(self.statement(), analyze, verbose)
        if v == "set":
            self.advance()
            name = self.ident()
            if not self.accept_op("="):
                self.expect_kw("to")
            val = self.advance().value
            return A.SetStmt(name, val)
        if v == "show":
            self.advance()
            return A.ShowStmt(self.ident())
        if v == "vacuum":
            self.advance()
            tname = None
            if self.tok.kind == Tok.IDENT and not self.tok.is_keyword:
                tname = self.ident()
            return A.VacuumStmt(tname)
        if v in ("analyze", "analyse"):
            self.advance()
            tname = None
            if self.tok.kind == Tok.IDENT and not self.tok.is_keyword:
                tname = self.ident()
            return A.AnalyzeStmt(tname)
        if v == "execute":
            self.advance()
            if self.accept_kw("direct"):
                self.expect_kw("on")
                self.expect_op("(")
                node = self.ident()
                self.expect_op(")")
                sqltext = self.advance()
                if sqltext.kind != Tok.STR:
                    raise SqlSyntaxError("expected SQL string", self.sql,
                                         sqltext.pos)
                return A.ExecuteDirectStmt(node, sqltext.value)
            # EXECUTE name [(arg, ...)] — run a prepared statement
            name = self.ident()
            args = []
            if self.accept_op("("):
                args.append(self.expr())
                while self.accept_op(","):
                    args.append(self.expr())
                self.expect_op(")")
            return A.ExecuteStmt(name, args)
        if v == "prepare":
            return self.prepare_stmt()
        if v == "deallocate":
            self.advance()
            self.accept_kw("prepare")
            if self.accept_kw("all"):
                return A.DeallocateStmt(None)
            return A.DeallocateStmt(self.ident())
        raise SqlSyntaxError(f"unsupported statement {v!r}", self.sql, t.pos)

    def merge_stmt(self) -> A.MergeStmt:
        """MERGE INTO tgt USING src ON cond
        WHEN MATCHED THEN UPDATE SET c = e, ... | DELETE
        WHEN NOT MATCHED THEN INSERT [(cols)] VALUES (exprs)
        (reference: gram.y MergeStmt -> execMerge.c)."""
        self.expect_kw("merge")
        self.expect_kw("into")
        target = self.ident()
        self.expect_kw("using")
        source = self.ident()
        self.expect_kw("on")
        on = self.expr()
        matched_set = None
        matched_delete = False
        insert_cols = insert_values = None
        while self.accept_kw("when"):
            negated = self.accept_kw("not")
            self.expect_kw("matched")
            self.expect_kw("then")
            if negated:
                self.expect_kw("insert")
                if self.accept_op("("):
                    insert_cols = [self.ident()]
                    while self.accept_op(","):
                        insert_cols.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("values")
                self.expect_op("(")
                insert_values = [self.expr()]
                while self.accept_op(","):
                    insert_values.append(self.expr())
                self.expect_op(")")
            elif self.accept_kw("delete"):
                matched_delete = True
            else:
                self.expect_kw("update")
                self.expect_kw("set")
                matched_set = []
                while True:
                    col = self.ident()
                    self.expect_op("=")
                    matched_set.append((col, self.expr()))
                    if not self.accept_op(","):
                        break
        if matched_set is None and not matched_delete \
                and insert_values is None:
            raise SqlSyntaxError("MERGE needs at least one WHEN clause",
                                 self.sql, self.tok.pos)
        return A.MergeStmt(target, source, on, matched_set,
                           matched_delete, insert_cols, insert_values)

    def prepare_stmt(self) -> A.PrepareStmt:
        """PREPARE name [(type, ...)] AS statement (reference:
        commands/prepare.c + the extended-protocol named-statement path,
        tcop/postgres.c:2411)."""
        self.expect_kw("prepare")
        name = self.ident()
        types: list[tuple[str, tuple[int, ...]]] = []
        if self.accept_op("("):
            while True:
                tname = self.ident()
                nxt = (self.tok.value if self.tok.kind == Tok.IDENT
                       else None)
                if nxt and (tname, nxt) in _MULTIWORD_TYPES:
                    self.advance()
                    tname = _MULTIWORD_TYPES[(tname, nxt)]
                targs: tuple[int, ...] = ()
                if self.accept_op("("):
                    args = [self.int_lit()]
                    while self.accept_op(","):
                        args.append(self.int_lit())
                    self.expect_op(")")
                    targs = tuple(args)
                types.append((tname, targs))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        self.expect_kw("as")
        return A.PrepareStmt(name, types, self.statement())

    # ---- SELECT ----
    def select_stmt(self) -> A.SelectStmt:
        ctes = []
        recursive = False
        if self.accept_kw("with"):
            recursive = self.accept_kw("recursive")
            while True:
                name = self.ident()
                col_aliases = None
                if self.accept_op("("):
                    col_aliases = [self.ident()]
                    while self.accept_op(","):
                        col_aliases.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                sub = self.select_stmt()
                self.expect_op(")")
                ctes.append((name, col_aliases, sub))
                if not self.accept_op(","):
                    break
        stmt = self.select_core()
        if self.at_kw("union", "except", "intersect"):
            stmt = self._wrap_tailed_branch(stmt)
        # ctes attach to the outermost statement (after any branch wrap)
        # so every set-op branch sees them; a parenthesized inner WITH
        # keeps its own entries (declared after, so they may shadow)
        stmt.ctes = ctes + stmt.ctes
        stmt.recursive = stmt.recursive or recursive
        while self.at_kw("union", "except", "intersect"):
            op = self.advance().value
            all_ = self.accept_kw("all")
            if not all_:
                self.accept_kw("distinct")
            # operands must not swallow the trailing ORDER BY/LIMIT:
            # those bind to the whole set operation; a parenthesized
            # branch's own tails apply to that branch alone
            rhs = self._wrap_tailed_branch(
                self.select_core(consume_tails=False))
            stmt = self._attach_setop(stmt, op, all_, rhs)
        # trailing ORDER BY / LIMIT bind to the set operation result
        self._tail_clauses(stmt)
        return stmt

    _branch_n = 0

    def _wrap_tailed_branch(self, s: A.SelectStmt) -> A.SelectStmt:
        """A parenthesized set-op branch carrying its own ORDER BY/LIMIT
        becomes a subquery: (SELECT ... LIMIT 2) UNION ... applies the
        LIMIT to the branch, not to the whole set operation."""
        if s.parenthesized and (s.order_by or s.limit is not None
                                or s.offset is not None):
            Parser._branch_n += 1
            return A.SelectStmt(
                items=[A.SelectItem(A.Star())],
                from_=[A.SubqueryRef(s, f"__setop_b{Parser._branch_n}")])
        return s

    def _attach_setop(self, lhs, op, all_, rhs):
        cur = lhs
        while cur.setop is not None:
            cur = cur.setop[2]
        cur.setop = (op, all_, rhs)
        return lhs

    def select_core(self, consume_tails: bool = True) -> A.SelectStmt:
        if self.accept_op("("):
            s = self.select_stmt()
            self.expect_op(")")
            s.parenthesized = True
            return s
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        items = [self.select_item()]
        while self.accept_op(","):
            items.append(self.select_item())
        from_ = []
        if self.accept_kw("from"):
            from_ = [self.table_ref()]
            while self.accept_op(","):
                from_.append(self.table_ref())
        where = self.expr() if self.accept_kw("where") else None
        group_by: list[A.Node] = []
        group_sets: Optional[list[list[A.Node]]] = None
        if self.accept_kw("group"):
            self.expect_kw("by")
            while True:
                sets = self._group_sets_item()
                if sets is not None:
                    if group_sets is not None:
                        raise SqlSyntaxError(
                            "only one ROLLUP/CUBE/GROUPING SETS per "
                            "GROUP BY", self.sql, self.tok.pos)
                    group_sets = sets
                else:
                    group_by.append(self.expr())
                if not self.accept_op(","):
                    break
        having = self.expr() if self.accept_kw("having") else None
        stmt = A.SelectStmt(items=items, from_=from_, where=where,
                            group_by=group_by, having=having,
                            distinct=distinct, group_sets=group_sets)
        if consume_tails:
            self._tail_clauses(stmt)
        return stmt

    def _group_sets_item(self) -> Optional[list[list[A.Node]]]:
        """ROLLUP (..) | CUBE (..) | GROUPING SETS ((..), ..) -> list of
        grouping sets, or None when the next item is a plain expression
        (reference: gram.y group_by_item / transformGroupingSet)."""
        nxt_is_paren = (self.peek().kind == Tok.OP
                        and self.peek().value == "(")
        if self.at_kw("rollup") and nxt_is_paren:
            self.advance()
            exprs = self._paren_expr_list()
            return [exprs[:k] for k in range(len(exprs), -1, -1)]
        if self.at_kw("cube") and nxt_is_paren:
            self.advance()
            exprs = self._paren_expr_list()
            out = []
            for mask in range(1 << len(exprs)):
                out.append([e for i, e in enumerate(exprs)
                            if mask & (1 << i) == 0])
            return out
        if self.at_kw("grouping") and self.peek().kind == Tok.IDENT \
                and self.peek().value == "sets":
            self.advance()
            self.advance()
            self.expect_op("(")
            sets = []
            while True:
                if self.at_op("("):
                    # a parenthesized set — possibly empty: ()
                    self.advance()
                    if self.accept_op(")"):
                        sets.append([])
                    else:
                        es = [self.expr()]
                        while self.accept_op(","):
                            es.append(self.expr())
                        self.expect_op(")")
                        sets.append(es)
                else:
                    sets.append([self.expr()])
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return sets
        return None

    def _paren_expr_list(self) -> list[A.Node]:
        self.expect_op("(")
        out = [self.expr()]
        while self.accept_op(","):
            out.append(self.expr())
        self.expect_op(")")
        return out

    def _tail_clauses(self, stmt: A.SelectStmt):
        if self.accept_kw("order"):
            self.expect_kw("by")
            stmt.order_by = [self.sort_item()]
            while self.accept_op(","):
                stmt.order_by.append(self.sort_item())
        while True:
            if self.accept_kw("limit"):
                stmt.limit = (None if self.accept_kw("all")
                              else self.expr())
            elif self.accept_kw("offset"):
                stmt.offset = self.expr()
            elif self.accept_kw("for"):
                self.expect_kw("update")
                stmt.for_update = "nowait" if self.accept_kw("nowait") \
                    else "wait"
            else:
                break

    def sort_item(self) -> A.SortItem:
        e = self.expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        else:
            self.accept_kw("asc")
        nulls_first = None
        if self.accept_kw("nulls"):
            nulls_first = self.accept_kw("first")
            if not nulls_first:
                self.expect_kw("last")
                nulls_first = False
        return A.SortItem(e, desc, nulls_first)

    def select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.advance()
            return A.SelectItem(A.Star())
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.tok.kind == Tok.IDENT and not self.tok.is_keyword:
            alias = self.ident()
        return A.SelectItem(e, alias)

    def table_ref(self) -> A.Node:
        left = self.table_primary()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.table_primary()
                left = A.JoinRef("cross", left, right, None)
                continue
            kind = None
            if self.at_kw("inner", "join"):
                kind = "inner"
                self.accept_kw("inner")
                self.expect_kw("join")
            elif self.at_kw("left", "right", "full"):
                kind = self.advance().value
                self.accept_kw("outer")
                self.expect_kw("join")
            else:
                break
            right = self.table_primary()
            self.expect_kw("on")
            on = self.expr()
            left = A.JoinRef(kind, left, right, on)
        return left

    def table_primary(self) -> A.Node:
        if self.accept_op("("):
            if self.at_kw("select"):
                sub = self.select_stmt()
                self.expect_op(")")
                self.accept_kw("as")
                alias = self.ident()
                self._maybe_column_alias_list()
                return A.SubqueryRef(sub, alias)
            ref = self.table_ref()
            self.expect_op(")")
            return ref
        name = self.ident()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif (self.tok.kind == Tok.IDENT and not self.tok.is_keyword):
            alias = self.ident()
        return A.TableRef(name, alias)

    def _maybe_column_alias_list(self):
        if self.accept_op("("):
            self.ident()
            while self.accept_op(","):
                self.ident()
            self.expect_op(")")

    # ---- INSERT / UPDATE / DELETE / COPY ----
    def insert_stmt(self) -> A.InsertStmt:
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.ident()
        cols = []
        if self.accept_op("("):
            cols.append(self.ident())
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        if self.accept_kw("values"):
            rows = [self._value_row()]
            while self.accept_op(","):
                rows.append(self._value_row())
            return A.InsertStmt(table, cols, rows,
                                on_conflict=self._on_conflict())
        sel = self.select_stmt()
        return A.InsertStmt(table, cols, None, sel,
                            on_conflict=self._on_conflict())

    def _on_conflict(self) -> Optional[A.OnConflict]:
        """ON CONFLICT [(cols)] DO NOTHING | DO UPDATE SET col = expr..."""
        if not self.accept_kw("on"):
            return None
        self.expect_kw("conflict")
        cols: list[str] = []
        if self.accept_op("("):
            cols.append(self.ident())
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        self.expect_kw("do")
        if self.accept_kw("nothing"):
            return A.OnConflict(cols, "nothing")
        self.expect_kw("update")
        self.expect_kw("set")
        assigns = []
        while True:
            col = self.ident()
            self.expect_op("=")
            assigns.append((col, self.expr()))
            if not self.accept_op(","):
                break
        return A.OnConflict(cols, "update", assigns)

    def _value_row(self) -> list[A.Node]:
        self.expect_op("(")
        row = [self.expr()]
        while self.accept_op(","):
            row.append(self.expr())
        self.expect_op(")")
        return row

    def update_stmt(self) -> A.UpdateStmt:
        self.expect_kw("update")
        table = self.ident()
        self.expect_kw("set")
        assigns = []
        while True:
            col = self.ident()
            self.expect_op("=")
            assigns.append((col, self.expr()))
            if not self.accept_op(","):
                break
        where = self.expr() if self.accept_kw("where") else None
        return A.UpdateStmt(table, assigns, where)

    def delete_stmt(self) -> A.DeleteStmt:
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.ident()
        where = self.expr() if self.accept_kw("where") else None
        return A.DeleteStmt(table, where)

    def copy_stmt(self) -> A.CopyStmt:
        self.expect_kw("copy")
        table = self.ident()
        cols = []
        if self.accept_op("("):
            cols.append(self.ident())
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        direction = "from" if self.accept_kw("from") else \
            (self.expect_kw("to") or "to")
        fn_tok = self.tok
        filename = ""
        if fn_tok.kind == Tok.STR:
            filename = self.advance().value
        else:
            self.ident()  # STDIN / STDOUT
        options = {}
        if self.accept_kw("with"):
            if self.accept_op("("):
                while True:
                    k = self.ident()
                    if self.tok.kind in (Tok.STR, Tok.NUM) or \
                            (self.tok.kind == Tok.IDENT and
                             not self.at_op(",", ")")):
                        options[k] = self.advance().value
                    else:
                        options[k] = True
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            else:
                while self.tok.kind == Tok.IDENT:
                    k = self.ident()
                    if self.tok.kind == Tok.STR:
                        options[k] = self.advance().value
                    else:
                        options[k] = True
        return A.CopyStmt(table, cols, direction, filename, options)

    # ---- DDL ----
    def create_stmt(self) -> A.Node:
        self.expect_kw("create")
        if self.accept_kw("table"):
            return self.create_table_tail()
        if self.at_kw("node"):
            save = self.i
            self.advance()
            if self.accept_kw("group"):
                name = self.ident()
                self.expect_op("(")
                members = [self.ident()]
                while self.accept_op(","):
                    members.append(self.ident())
                self.expect_op(")")
                return A.CreateNodeGroupStmt(name, members)
            self.i = save
        or_replace = False
        if self.at_kw("or"):
            save = self.i
            self.advance()
            if self.accept_kw("replace"):
                or_replace = True
            else:
                self.i = save
        if self.at_kw("job"):
            self.advance()
            name = self.ident()
            self.expect_kw("schedule")
            iv = self.advance()
            try:
                interval_s = float(iv.value)
            except (TypeError, ValueError):
                raise SqlSyntaxError("SCHEDULE expects seconds",
                                     self.sql, iv.pos) from None
            self.expect_kw("as")
            body = self.advance()
            if body.kind != Tok.STR:
                raise SqlSyntaxError("job body must be a string "
                                     "literal", self.sql, body.pos)
            return A.CreateJobStmt(name, interval_s, body.value)
        if self.at_kw("resource"):
            self.advance()
            self.expect_kw("group")
            name = self.ident()
            opts = {}
            if self.accept_kw("with"):
                self.expect_op("(")
                while True:
                    k = self.ident()
                    self.expect_op("=")
                    v = self.advance()
                    opts[k] = v.value
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            return A.CreateResourceGroupStmt(name, opts)
        if self.accept_kw("mask"):
            name = self.ident()
            self.expect_kw("on")
            table = self.ident()
            self.expect_op("(")
            col = self.ident()
            self.expect_op(")")
            self.expect_kw("as")
            e = self.advance()
            if e.kind != Tok.STR:
                raise SqlSyntaxError("mask expression must be a "
                                     "string literal", self.sql, e.pos)
            return A.CreateMaskStmt(name, table, col, e.value)
        if self.accept_kw("audit"):
            self.expect_kw("policy")
            name = self.ident()
            self.expect_kw("on")
            table = self.ident()
            self.expect_kw("when")
            self.expect_op("(")
            wstart = self.tok.pos
            self.expr()
            pred_src = self.sql[wstart:self.tok.pos].strip()
            self.expect_op(")")
            return A.CreateAuditPolicyStmt(name, table, pred_src)
        if self.accept_kw("function"):
            name = self.ident()
            self.expect_op("(")
            self.expect_op(")")
            self.expect_kw("returns")
            returns = self.ident()
            self.expect_kw("as")
            body = self.advance()
            if body.kind != Tok.STR:
                raise SqlSyntaxError("function body must be a string "
                                     "literal", self.sql, body.pos)
            if self.accept_kw("language"):
                self.ident()
            return A.CreateFunctionStmt(name, body.value, returns,
                                        or_replace)
        if self.accept_kw("trigger"):
            name = self.ident()
            timing = self.advance().value
            if timing not in ("before", "after"):
                raise SqlSyntaxError("trigger timing must be BEFORE "
                                     "or AFTER", self.sql, self.tok.pos)
            event = self.advance().value    # insert/update/delete are
            if event not in ("insert", "update", "delete"):  # reserved
                raise SqlSyntaxError("trigger event must be INSERT/"
                                     "UPDATE/DELETE", self.sql,
                                     self.tok.pos)
            self.expect_kw("on")
            table = self.ident()
            if self.accept_kw("for"):
                self.accept_kw("each")
                self.accept_kw("row")
            when = None
            when_src = ""
            if self.accept_kw("when"):
                self.expect_op("(")
                wstart = self.tok.pos
                when = self.expr()
                when_src = self.sql[wstart:self.tok.pos].strip()
                self.expect_op(")")
            self.expect_kw("execute")
            if not (self.accept_kw("function")
                    or self.accept_kw("procedure")):
                raise SqlSyntaxError("expected EXECUTE FUNCTION",
                                     self.sql, self.tok.pos)
            func = self.ident()
            self.expect_op("(")
            self.expect_op(")")
            return A.CreateTriggerStmt(name, timing, event, table,
                                       when, when_src, func)
        if self.accept_kw("view"):
            name = self.ident()
            self.expect_kw("as")
            start = self.tok.pos
            sel = self.select_stmt()
            end = self.tok.pos if self.tok.kind != Tok.EOF \
                else len(self.sql)
            return A.CreateViewStmt(name, sel,
                                    self.sql[start:end].strip(),
                                    or_replace)
        if self.accept_kw("sequence"):
            name = self.ident()
            start, inc = 1, 1
            while self.tok.kind == Tok.IDENT:
                w = self.ident()
                if w == "start":
                    self.accept_kw("with")
                    start = int(self.advance().value)
                elif w == "increment":
                    self.accept_kw("by")
                    inc = int(self.advance().value)
                else:
                    break
            return A.CreateSequenceStmt(name, start, inc)
        unique = self.accept_kw("unique")
        global_ = self.accept_kw("global")
        if self.accept_kw("index"):
            name = self.ident()
            self.expect_kw("on")
            table = self.ident()
            method = ""
            if self.accept_kw("using"):
                method = self.ident()
            self.expect_op("(")
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            options = {}
            if self.accept_kw("with"):
                self.expect_op("(")
                while True:
                    k = self.ident()
                    self.expect_op("=")
                    options[k] = self.advance().value
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            return A.CreateIndexStmt(name, table, cols, unique, method,
                                     options, global_)
        if self.accept_kw("barrier"):
            t = self.advance()
            return A.BarrierStmt(t.value)
        if self.accept_kw("publication"):
            name = self.ident()
            self.expect_kw("for")
            self.expect_kw("table")
            tables = [self.ident()]
            while self.accept_op(","):
                tables.append(self.ident())
            return A.CreatePublicationStmt(name, tables)
        if self.accept_kw("subscription"):
            name = self.ident()
            self.expect_kw("connection")
            conn = self.advance()
            if conn.kind != Tok.STR:
                raise SqlSyntaxError("expected connection string",
                                     self.sql, conn.pos)
            self.expect_kw("publication")
            pub = self.ident()
            return A.CreateSubscriptionStmt(name, conn.value, pub)
        raise SqlSyntaxError("unsupported CREATE", self.sql, self.tok.pos)

    def create_table_tail(self) -> A.Node:
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.ident()
        if self.accept_kw("partition"):
            # CREATE TABLE name PARTITION OF parent FOR VALUES ...
            self.expect_kw("of")
            parent = self.ident()
            self.expect_kw("for")
            self.expect_kw("values")
            if self.accept_kw("from"):
                self.expect_op("(")
                fv = self.expr()
                self.expect_op(")")
                self.expect_kw("to")
                self.expect_op("(")
                tv = self.expr()
                self.expect_op(")")
                return A.CreatePartitionStmt(name, parent, fv, tv)
            self.expect_kw("in")
            self.expect_op("(")
            vals = [self.expr()]
            while self.accept_op(","):
                vals.append(self.expr())
            self.expect_op(")")
            return A.CreatePartitionStmt(name, parent,
                                         in_values=vals)
        self.expect_op("(")
        columns: list[A.ColumnDefAst] = []
        pk: list[str] = []
        checks: list[str] = []
        fks: list[tuple] = []
        while True:
            if self.accept_kw("primary"):
                self.expect_kw("key")
                self.expect_op("(")
                pk.append(self.ident())
                while self.accept_op(","):
                    pk.append(self.ident())
                self.expect_op(")")
            elif self.accept_kw("check"):
                checks.append(self._check_expr_src())
            elif self.accept_kw("foreign"):
                self.expect_kw("key")
                self.expect_op("(")
                fcols = [self.ident()]
                while self.accept_op(","):
                    fcols.append(self.ident())
                self.expect_op(")")
                self.expect_kw("references")
                rt = self.ident()
                self.expect_op("(")
                rcols = [self.ident()]
                while self.accept_op(","):
                    rcols.append(self.ident())
                self.expect_op(")")
                fks.append((tuple(fcols), rt, tuple(rcols)))
            else:
                columns.append(self.column_def())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        for c in columns:
            if c.check_src:
                checks.append(c.check_src)
            if c.references:
                fks.append(((c.name,), c.references[0],
                            (c.references[1],)))
        dist_type, dist_cols, group = "shard", [], None
        range_split: list = []
        if self.accept_kw("distribute"):
            self.expect_kw("by")
            w = self.ident()
            if w in ("replication", "replicated"):
                dist_type = "replicated"
            elif w == "roundrobin":
                dist_type = "roundrobin"
            elif w == "range":
                dist_type = "range"
                self.expect_op("(")
                dist_cols.append(self.ident())
                self.expect_op(")")
                # DISTRIBUTE BY RANGE (col) SPLIT (v1, v2, ...):
                # node i holds [v_{i-1}, v_i)
                if self.tok.kind == Tok.IDENT and \
                        self.tok.value == "split":
                    self.advance()
                    self.expect_op("(")
                    range_split.append(self.expr())
                    while self.accept_op(","):
                        range_split.append(self.expr())
                    self.expect_op(")")
            elif w in ("shard", "hash", "modulo"):
                dist_type = w
                self.expect_op("(")
                dist_cols.append(self.ident())
                while self.accept_op(","):
                    dist_cols.append(self.ident())
                self.expect_op(")")
            else:
                raise SqlSyntaxError(f"unknown distribution {w!r}",
                                     self.sql, self.tok.pos)
        if self.accept_kw("to"):
            self.expect_kw("group")
            group = self.ident()
        partition_by = None
        if self.accept_kw("partition"):
            self.expect_kw("by")
            method = self.ident()
            if method not in ("range", "list"):
                raise SqlSyntaxError(
                    f"unsupported partition method {method!r}",
                    self.sql, self.tok.pos)
            self.expect_op("(")
            pcol = self.ident()
            self.expect_op(")")
            partition_by = (method, pcol)
        if not pk:
            pk = [c.name for c in columns if c.primary_key]
        if not dist_cols and dist_type in ("shard", "hash", "modulo"):
            # default: first PK column, else first column (reference behavior:
            # locator picks a default dist key)
            dist_cols = [pk[0]] if pk else \
                ([columns[0].name] if columns else [])
        return A.CreateTableStmt(name, columns, pk, dist_type, dist_cols,
                                 group, if_not_exists, partition_by,
                                 checks, fks, range_split)

    def column_def(self) -> A.ColumnDefAst:
        name = self.ident()
        tname = self.ident()
        nxt = (self.tok.value if self.tok.kind == Tok.IDENT else None)
        if nxt and (tname, nxt) in _MULTIWORD_TYPES:
            self.advance()
            tname = _MULTIWORD_TYPES[(tname, nxt)]
        targs: tuple[int, ...] = ()
        if self.accept_op("("):
            args = [int(self.advance().value)]
            while self.accept_op(","):
                args.append(int(self.advance().value))
            self.expect_op(")")
            targs = tuple(args)
        not_null = primary = False
        check_src = references = None
        while True:
            if self.accept_kw("not"):
                self.expect_kw("null")
                not_null = True
            elif self.accept_kw("primary"):
                self.expect_kw("key")
                primary = True
            elif self.accept_kw("null"):
                pass
            elif self.accept_kw("check"):
                check_src = self._check_expr_src()
            elif self.accept_kw("references"):
                rt = self.ident()
                self.expect_op("(")
                rc = self.ident()
                self.expect_op(")")
                references = (rt, rc)
            else:
                break
        return A.ColumnDefAst(name, tname, targs, not_null, primary,
                              check_src, references)

    def _check_expr_src(self) -> str:
        """CHECK ( expr ) — capture the expression's SOURCE text (the
        catalog stores constraint text, like pg_constraint's conbin is
        deparsed back to text; binding happens at enforcement)."""
        self.expect_op("(")
        start = self.tok.pos
        depth = 0
        # skip a balanced token stream (the expr may contain parens)
        self.expr()
        end = self.tok.pos
        self.expect_op(")")
        return self.sql[start:end].strip()

    def alter_stmt(self) -> A.AlterTableStmt:
        self.expect_kw("alter")
        self.expect_kw("table")
        table = self.ident()
        if self.accept_kw("rename"):
            if self.accept_kw("to"):
                return A.AlterTableStmt(table, "rename_table",
                                        new_name=self.ident())
            self.accept_kw("column")
            old = self.ident()
            self.expect_kw("to")
            return A.AlterTableStmt(table, "rename_column", name=old,
                                    new_name=self.ident())
        if self.accept_kw("add"):
            self.accept_kw("column")
            return A.AlterTableStmt(table, "add_column",
                                    column=self.column_def())
        if self.accept_kw("drop"):
            self.accept_kw("column")
            return A.AlterTableStmt(table, "drop_column",
                                    name=self.ident())
        raise SqlSyntaxError("unsupported ALTER TABLE action", self.sql,
                             self.tok.pos)

    def drop_stmt(self) -> A.Node:
        self.expect_kw("drop")
        if self.at_kw("job"):
            self.advance()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropJobStmt(self.ident(), if_exists)
        if self.at_kw("resource"):
            self.advance()
            self.expect_kw("group")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropResourceGroupStmt(self.ident(), if_exists)
        if self.accept_kw("mask"):
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropMaskStmt(self.ident(), if_exists)
        if self.accept_kw("audit"):
            self.expect_kw("policy")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropAuditPolicyStmt(self.ident(), if_exists)
        if self.accept_kw("trigger"):
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            name = self.ident()
            self.expect_kw("on")
            return A.DropTriggerStmt(name, self.ident(), if_exists)
        if self.accept_kw("function"):
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropFunctionStmt(self.ident(), if_exists)
        if self.accept_kw("publication"):
            return A.DropPublicationStmt(self.ident())
        if self.accept_kw("subscription"):
            return A.DropSubscriptionStmt(self.ident())
        if self.accept_kw("view"):
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropViewStmt(self.ident(), if_exists)
        if self.accept_kw("index"):
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropIndexStmt(self.ident(), if_exists)
        self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return A.DropTableStmt(self.ident(), if_exists)

    # ------------------------------------------------------------------
    # expressions (Pratt)
    # ------------------------------------------------------------------
    def expr(self) -> A.Node:
        return self.or_expr()

    def or_expr(self) -> A.Node:
        left = self.and_expr()
        if not self.at_kw("or"):
            return left
        args = [left]
        while self.accept_kw("or"):
            args.append(self.and_expr())
        return A.BoolExpr("or", args)

    def and_expr(self) -> A.Node:
        left = self.not_expr()
        if not self.at_kw("and"):
            return left
        args = [left]
        while self.accept_kw("and"):
            args.append(self.not_expr())
        return A.BoolExpr("and", args)

    def not_expr(self) -> A.Node:
        if self.accept_kw("not"):
            return A.UnaryOp("not", self.not_expr())
        return self.predicate()

    def predicate(self) -> A.Node:
        left = self.additive()
        while True:
            negated = False
            save = self.i
            if self.accept_kw("not"):
                negated = True
            if self.accept_kw("between"):
                low = self.additive()
                self.expect_kw("and")
                high = self.additive()
                left = A.BetweenExpr(left, low, high, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select"):
                    sub = self.select_stmt()
                    self.expect_op(")")
                    left = A.InExpr(left, None, sub, negated)
                else:
                    items = [self.expr()]
                    while self.accept_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    left = A.InExpr(left, items, None, negated)
                continue
            if self.accept_kw("like"):
                left = A.LikeExpr(left, self.additive(), negated)
                continue
            if negated:
                self.i = save
                break
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                self.expect_kw("null")
                left = A.NullTest(left, not neg)
                continue
            if self.tok.kind == Tok.OP and self.tok.value in _CMP_OPS:
                op = self.advance().value
                if op == "!=":
                    op = "<>"
                if self.at_kw("any", "some", "all"):
                    quant = self.advance().value
                    if quant == "some":
                        quant = "any"
                    self.expect_op("(")
                    sub = self.select_stmt()
                    self.expect_op(")")
                    left = A.QuantifiedCmp(op, left, quant, sub)
                else:
                    left = A.BinOp(op, left, self.additive())
                continue
            break
        return left

    def additive(self) -> A.Node:
        left = self.multiplicative()
        while self.at_op("+", "-", "||", "<->", "<=>", "<#>"):
            op = self.advance().value
            left = A.BinOp(op, left, self.multiplicative())
        return left

    def multiplicative(self) -> A.Node:
        left = self.unary()
        while self.at_op("*", "/", "%"):
            op = self.advance().value
            left = A.BinOp(op, left, self.unary())
        return left

    def unary(self) -> A.Node:
        if self.accept_op("-"):
            return A.UnaryOp("-", self.unary())
        if self.accept_op("+"):
            return self.unary()
        return self.postfix()

    def postfix(self) -> A.Node:
        e = self.primary()
        while self.accept_op("::"):
            tname = self.ident()
            targs: tuple[int, ...] = ()
            if self.accept_op("("):
                args = [int(self.advance().value)]
                while self.accept_op(","):
                    args.append(int(self.advance().value))
                self.expect_op(")")
                targs = tuple(args)
            e = A.CastExpr(e, tname, targs)
        return e

    def primary(self) -> A.Node:
        t = self.tok
        if t.kind == Tok.NUM:
            self.advance()
            if "." in t.value or "e" in t.value.lower():
                return A.Const(t.value, "num")
            return A.Const(int(t.value), "int")
        if t.kind == Tok.STR:
            self.advance()
            return A.Const(t.value, "str")
        if t.kind == Tok.PARAM:
            self.advance()
            return A.Param(int(t.value))
        if self.accept_op("("):
            if self.at_kw("select"):
                sub = self.select_stmt()
                self.expect_op(")")
                return A.ScalarSubquery(sub)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind != Tok.IDENT:
            raise SqlSyntaxError(f"unexpected {t.value!r}", self.sql, t.pos)
        v = t.value
        if v in ("true", "false"):
            self.advance()
            return A.Const(v == "true", "bool")
        if v == "null":
            self.advance()
            return A.Const(None, "null")
        if v == "case":
            return self.case_expr()
        if v == "cast":
            self.advance()
            self.expect_op("(")
            e = self.expr()
            self.expect_kw("as")
            tname = self.ident()
            nxt = (self.tok.value if self.tok.kind == Tok.IDENT else None)
            if nxt and (tname, nxt) in _MULTIWORD_TYPES:
                self.advance()
                tname = _MULTIWORD_TYPES[(tname, nxt)]
            targs: tuple[int, ...] = ()
            if self.accept_op("("):
                args = [int(self.advance().value)]
                while self.accept_op(","):
                    args.append(int(self.advance().value))
                self.expect_op(")")
                targs = tuple(args)
            self.expect_op(")")
            return A.CastExpr(e, tname, targs)
        if v == "extract":
            self.advance()
            self.expect_op("(")
            field = self.ident()
            self.expect_kw("from")
            e = self.expr()
            self.expect_op(")")
            return A.ExtractExpr(field, e)
        if v == "substring":
            self.advance()
            self.expect_op("(")
            e = self.expr()
            if self.accept_kw("from"):
                start = self.expr()
                length = self.expr() if self.accept_kw("for") else None
            else:
                self.expect_op(",")
                start = self.expr()
                length = self.expr() if self.accept_op(",") else None
            self.expect_op(")")
            return A.SubstringExpr(e, start, length)
        if v == "exists":
            self.advance()
            self.expect_op("(")
            sub = self.select_stmt()
            self.expect_op(")")
            return A.ExistsExpr(sub)
        if v == "date" and self.peek().kind == Tok.STR:
            self.advance()
            return A.TypedConst("date", self.advance().value)
        if v == "interval" and self.peek().kind in (Tok.STR, Tok.NUM):
            self.advance()
            qty_tok = self.advance()
            unit = ""
            if self.tok.kind == Tok.IDENT and self.tok.value in (
                    "day", "month", "year", "days", "months", "years"):
                unit = self.ident().rstrip("s")
            val = qty_tok.value
            if unit == "" and qty_tok.kind == Tok.STR:
                # INTERVAL '3 month' style
                parts = val.split()
                if len(parts) == 2:
                    val, unit = parts[0], parts[1].rstrip("s")
            return A.TypedConst("interval", "", unit=unit or "day",
                                qty=int(str(val).strip("'")))
        # identifier chain / function call
        if self.peek().kind == Tok.OP and self.peek().value == "(":
            name = self.advance().value
            self.advance()  # (
            if self.accept_op("*"):
                self.expect_op(")")
                return self._maybe_over(A.FuncCall(name, [], star=True))
            if self.accept_op(")"):
                return self._maybe_over(A.FuncCall(name, []))
            distinct = self.accept_kw("distinct")
            args = [self.expr()]
            while self.accept_op(","):
                args.append(self.expr())
            self.expect_op(")")
            return self._maybe_over(
                A.FuncCall(name, args, distinct=distinct))
        parts = [self.ident()]
        while self.accept_op("."):
            if self.accept_op("*"):
                return A.Star(table=parts[0])
            parts.append(self.ident())
        return A.ColRef(tuple(parts))

    def _maybe_over(self, fc: A.FuncCall) -> A.Node:
        """Attach an OVER (...) window to a function call."""
        if not (self.tok.kind == Tok.IDENT and self.tok.value == "over"
                and self.peek().kind == Tok.OP
                and self.peek().value == "("):
            return fc
        self.advance()  # over
        self.advance()  # (
        wd = A.WindowDef()
        if self.accept_kw("partition"):
            self.expect_kw("by")
            wd.partition_by.append(self.expr())
            while self.accept_op(","):
                wd.partition_by.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            wd.order_by.append(self.sort_item())
            while self.accept_op(","):
                wd.order_by.append(self.sort_item())
        if self.at_kw("rows", "range"):
            mode = self.advance().value
            if self.accept_kw("between"):
                start = self._frame_bound()
                self.expect_kw("and")
                end = self._frame_bound()
            else:
                start = self._frame_bound()
                end = ("current", None)
            wd.frame = (mode, start, end)
        self.expect_op(")")
        fc.over = wd
        return fc

    def _frame_bound(self) -> tuple:
        """UNBOUNDED PRECEDING | n PRECEDING | CURRENT ROW |
        n FOLLOWING | UNBOUNDED FOLLOWING (gram.y frame_bound)."""
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                return ("unbounded_preceding", None)
            self.expect_kw("following")
            return ("unbounded_following", None)
        if self.accept_kw("current"):
            self.expect_kw("row")
            return ("current", None)
        n = self.int_lit()
        if self.accept_kw("preceding"):
            return ("preceding", n)
        self.expect_kw("following")
        return ("following", n)

    def case_expr(self) -> A.CaseExpr:
        self.expect_kw("case")
        whens = []
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        while self.accept_kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            val = self.expr()
            if operand is not None:
                cond = A.BinOp("=", operand, cond)
            whens.append((cond, val))
        else_ = self.expr() if self.accept_kw("else") else None
        self.expect_kw("end")
        return A.CaseExpr(whens, else_)


def parse_sql(sql: str) -> list[A.Node]:
    return Parser(sql).parse()


def parse_one(sql: str) -> A.Node:
    stmts = parse_sql(sql)
    if len(stmts) != 1:
        raise SqlSyntaxError(f"expected one statement, got {len(stmts)}")
    return stmts[0]
