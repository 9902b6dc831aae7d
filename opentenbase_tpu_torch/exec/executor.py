"""Fragment executor: runs a physical plan over one datanode's stores.

The counterpart of opentenbase_tpu/exec/executor.py, for the operators of
a single-node scan / filter / project / dense aggregate / sort / limit
plan (TPC-H Q1 and Q6).  Each operator consumes and produces a DBatch:
padded device tensors plus a validity mask.  Padding follows the buffer
cache's size classes; padded rows are masked by the scan's row-count
belt.

The scan stages table columns through the node's device cache once per
table version, decodes encoded columns with the codec kernel, computes
MVCC visibility with the visibility kernel, and evaluates `col <op>
literal` filters on the codes (cmp_on_codes).  NULLs are per-column
boolean masks (DBatch.nulls); expressions compile to (value, null-mask)
pairs (exec/expr_compile.py).

Operators outside the slice (joins, sort-based and distinct aggregates,
windows, set operations, index and vector scans) raise
NotImplementedError: nothing is done another way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..catalog import types as T
from ..catalog.types import SqlType, TypeKind
from ..ops import kernels as K
from ..plan import exprs as E
from ..plan import physical as P
from ..plan.planner import PlannedStmt, rewrite
from ..storage import codec
from ..storage.batch import next_pow2
from ..storage.store import ABORTED_TS, TableStore
from ..utils.dtypes import dev_dtype, device_float


class ExecError(Exception):
    pass


@dataclasses.dataclass
class DBatch:
    cols: dict[str, object]            # name -> tensor [P]
    valid: object                      # bool tensor [P]
    types: dict[str, SqlType]
    dicts: dict[str, list]             # TEXT col name -> code->str list
    nulls: dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def padded(self) -> int:
        return int(self.valid.shape[0])

    def names(self) -> list[str]:
        return list(self.cols)


@dataclasses.dataclass
class ExecContext:
    stores: dict[str, TableStore]
    snapshot_ts: int
    txid: int
    cache: object                       # storage.bufferpool.DeviceBufferPool
    params: dict[str, tuple] = dataclasses.field(default_factory=dict)
    # init-plan results: name -> (value, SqlType)

    @property
    def device(self) -> torch.device:
        return self.cache.device


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not yet ported")


class Executor:
    def __init__(self, ctx: ExecContext):
        self.ctx = ctx
        self.device = ctx.device

    # ------------------------------------------------------------------
    def run(self, planned: PlannedStmt):
        for ip in planned.init_plans:
            batch = self.exec_node(ip.plan)
            self.ctx.params[ip.name] = (scalar_from_batch(batch), ip.type)
        return self.exec_node(planned.plan)

    # ------------------------------------------------------------------
    def _prep(self, e: E.Expr) -> E.Expr:
        """Substitute init-plan results before compiling."""
        params = self.ctx.params

        def sub(x: E.Expr):
            if isinstance(x, E.Col) and x.name in params:
                v, t = params[x.name]
                return E.Lit(v, t)
            return None
        return rewrite(e, sub)

    @staticmethod
    def _dictviews(batch: DBatch):
        class _DictView:
            def __init__(self, values):
                self.values = values

            def codes_matching(self, pred):
                return np.asarray([i for i, v in enumerate(self.values)
                                   if pred(v)], dtype=np.int32)

        return {n: _DictView(v) for n, v in batch.dicts.items()}

    @staticmethod
    def _env(batch: DBatch):
        """Eval namespace: columns plus null masks under NULLKEY."""
        from .expr_compile import NULLKEY
        if not batch.nulls:
            return batch.cols
        env = dict(batch.cols)
        for n, m in batch.nulls.items():
            env[NULLKEY + n] = m
        return env

    def _eval_pair(self, e: E.Expr, batch: DBatch):
        """(value, null_mask|None) eval; the mask is broadcast to batch
        shape so downstream gathers can index it."""
        from .expr_compile import compile_pair
        vf, nf = compile_pair(self._prep(e), self._dictviews(batch),
                              frozenset(batch.nulls), self.device)
        env = self._env(batch)
        val = vf(env)
        if nf is None:
            return val, None
        mask = nf(env)
        if mask.dim() == 0:
            mask = mask.expand(batch.valid.shape)
        return val, mask

    def _eval_pred(self, e: E.Expr, batch: DBatch):
        """SQL 3VL predicate eval: True where definitely true."""
        from .expr_compile import compile_pred
        return compile_pred(self._prep(e), self._dictviews(batch),
                            frozenset(batch.nulls),
                            self.device)(self._env(batch))

    # ------------------------------------------------------------------
    def exec_node(self, node: P.PhysNode) -> DBatch:
        """Run one plan node; a node type of a later slice (joins, window,
        set operations, index and vector scans) is not yet ported."""
        m = getattr(self, f"_exec_{type(node).__name__.lower()}", None)
        if m is None:
            _not_ported(f"plan node {type(node).__name__}")
        return m(node)

    # ---- scan ----
    def _scan_base(self, table, alias: str, filters, outputs):
        """Stage the needed columns via the device cache, build the
        qualified-name eval namespace, and combine MVCC visibility with
        the filter quals into one mask."""
        store = self.ctx.stores.get(table.name)
        if store is None:
            raise ExecError(f"no store for table {table.name}")
        filters = [self._prep(f) for f in filters]
        outputs = [(n, self._prep(e)) for n, e in (outputs or [])]
        needed = set()
        for f in filters:
            needed |= {c.split(".", 1)[1] if "." in c else c
                       for c in _cols_of(f)}
        for _, oe in outputs:
            needed |= {c.split(".", 1)[1] if "." in c else c
                       for c in _cols_of(oe)}
        arrs, n = self.ctx.cache.get(store, sorted(needed))
        # the pad is whatever the cache staged (size_class): read it off
        # the tensors, never recompute
        padded = codec.padded_of(arrs) if arrs else next_pow2(max(n, 1))

        # codec decode (storage/codec.py): staged columns may be encoded
        # (pack/for/dict codes + aux tensors); predicates on encoded
        # columns compare in code space below instead
        encm = codec.enc_names(arrs)

        def _dcol(name):
            a = arrs[name]
            k = encm.get(name)
            if k is None:
                return a
            return K.decode_column(a, arrs[k], codec.family_of(k))

        qcols, types, dicts, qnulls = {}, {}, {}, {}
        for c in store.td.columns:
            qname = f"{alias}.{c.name}"
            if c.name in arrs:
                qcols[qname] = _dcol(c.name)
            if f"__null.{c.name}" in arrs:
                qnulls[qname] = arrs[f"__null.{c.name}"]
            types[qname] = c.type
            if c.type.kind == TypeKind.TEXT and c.name in store.dicts:
                dicts[qname] = store.dicts[c.name].values

        base = DBatch(qcols, torch.ones(padded, dtype=torch.bool,
                                        device=self.device),
                      types, dicts, qnulls)
        vis = K.visibility_mask(
            _dcol("__xmin_ts"), _dcol("__xmax_ts"), _dcol("__xmin_txid"),
            _dcol("__xmax_txid"), self.ctx.snapshot_ts, self.ctx.txid,
            int(ABORTED_TS))
        vis = vis & (torch.arange(padded, device=self.device) < n)
        for f in filters:
            m = self._pred_on_codes(f, arrs, encm)
            vis = vis & (m if m is not None else self._eval_pred(f, base))
        return base, vis, outputs, dicts

    def _pred_on_codes(self, f, arrs, encm: dict):
        """Predicate eval in code space: a bare `col <op> literal` over
        an encoded, null-free column compares codes against the literal
        (ops/kernels.py cmp_on_codes) — no padding select, no decode.
        Returns None when the shape doesn't qualify and the 3VL path
        must run."""
        if not encm or not isinstance(f, E.Cmp) \
                or f.op not in ("=", "<>", "<", "<=", ">", ">="):
            return None
        lhs, rhs, op = f.left, f.right, f.op
        if isinstance(rhs, E.Col) and isinstance(lhs, E.Lit):
            lhs, rhs = rhs, lhs
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if not (isinstance(lhs, E.Col) and isinstance(rhs, E.Lit)):
            return None
        # storage-representation alignment (expr_compile.py Cmp): a
        # DECIMAL column stores value * 10**scale, so an int / coarser-
        # scale literal must rescale UP to the column's scale (exact);
        # other shapes take the 3VL path
        lt, rt = lhs.type, rhs.type
        ik = (TypeKind.INT32, TypeKind.INT64, TypeKind.DATE)
        if lt.kind == TypeKind.DECIMAL:
            rs = rt.scale if rt.kind == TypeKind.DECIMAL else 0
            if (rt.kind != TypeKind.DECIMAL and rt.kind not in ik) \
                    or rs > lt.scale:
                return None
            mult = 10 ** (lt.scale - rs)
        elif lt.kind in ik and rt.kind in ik:
            mult = 1
        else:
            return None
        cname = lhs.name.split(".", 1)[1] if "." in lhs.name else lhs.name
        k = encm.get(cname)
        if k is None or f"__null.{cname}" in arrs:
            return None
        v = rhs.value
        if v is None:
            return None
        vdt = getattr(v, "dtype", None)
        if vdt is not None:
            if not np.issubdtype(vdt, np.integer):
                return None
        elif not isinstance(v, (int, np.integer)):
            return None
        if mult != 1:
            v = v * mult
        return K.cmp_on_codes(arrs[cname], arrs[k], codec.family_of(k),
                              op, v)

    def _exec_seqscan(self, node: P.SeqScan) -> DBatch:
        base, vis, outputs, dicts = self._scan_base(
            node.table, node.alias, node.filters, node.outputs)
        out_cols, out_types, out_dicts, out_nulls = {}, {}, {}, {}
        for name, oe in outputs:
            out_cols[name], nm = self._eval_pair(oe, base)
            if nm is not None:
                out_nulls[name] = nm
            out_types[name] = oe.type
            d = _dict_for_expr(oe, dicts)
            if d is not None:
                out_dicts[name] = d
        return DBatch(out_cols, vis, out_types, out_dicts, out_nulls)

    # ---- filter / project ----
    def _exec_filter(self, node: P.Filter) -> DBatch:
        b = self.exec_node(node.child)
        valid = b.valid
        for q in node.quals:
            valid = valid & self._eval_pred(q, b)
        return DBatch(b.cols, valid, b.types, b.dicts, b.nulls)

    def _exec_project(self, node: P.Project) -> DBatch:
        b = self.exec_node(node.child)
        cols, types, dicts, nulls = {}, {}, {}, {}
        for name, oe in node.outputs:
            arr, nm = self._eval_pair(oe, b)
            if arr.dim() == 0:   # constant: broadcast
                arr = arr.expand(b.padded).contiguous()
            cols[name] = arr
            types[name] = oe.type
            d = _dict_for_expr(oe, b.dicts)
            if d is not None:
                dicts[name] = d
            if nm is not None:
                nulls[name] = nm
        return DBatch(cols, b.valid, types, dicts, nulls)

    # ---- aggregate ----
    def _eval_group_keys(self, node: P.Agg, b: DBatch):
        """Group key tensors + per-key null masks.  NULL keys group
        together: the value is canonicalized to 0 and the null bit
        becomes an extra grouping column."""
        key_arrs, key_types, key_dicts, key_nulls = [], [], [], []
        for name, ke in node.group_keys:
            arr, nm = self._eval_pair(ke, b)
            arr = arr.to(torch.int64)
            if nm is not None:
                arr = torch.where(nm, torch.zeros((), dtype=torch.int64,
                                                  device=arr.device), arr)
            d = _dict_for_expr(ke, b.dicts)
            if d is not None and len(set(d)) < len(d):
                # a transformed dictionary (substring etc.) can map
                # several codes to one string: canonicalize codes
                # sharing a string BEFORE grouping, so groups never
                # over-split (canonical codes still decode correctly)
                canon: dict = {}
                lut = np.empty(max(len(d), 1), np.int64)
                for ci, v in enumerate(d):
                    lut[ci] = canon.setdefault(v, ci)
                arr = torch.from_numpy(lut).to(self.device)[
                    torch.clamp(arr, 0, len(d) - 1)]
            key_arrs.append(arr)
            key_nulls.append(nm)
            key_types.append(ke.type)
            key_dicts.append(d)
        return key_arrs, key_types, key_dicts, key_nulls

    def _assemble_agg_output(self, node: P.Agg, gkey_out, key_types,
                             key_dicts, outs, out_specs, out_valid):
        cols, types, dicts, nulls = {}, {}, {}, {}
        for (kname, _), karr, kt, kd in zip(node.group_keys, gkey_out,
                                             key_types, key_dicts):
            cols[kname] = karr.to(dev_dtype(kt))
            types[kname] = kt
            if kd is not None:
                dicts[kname] = kd
        oi = 0
        for name, t, special in out_specs:
            if special is not None and special[0] == "avg":
                s, c = outs[oi], outs[oi + 1]
                oi += 2
                cols[name] = torch.where(
                    c > 0, s.to(device_float()) / torch.clamp(c, min=1)
                    / (10 ** special[1]),
                    torch.zeros((), dtype=device_float(), device=c.device))
                nulls[name] = c == 0  # avg over zero non-null inputs
            elif special is not None and special[0] == "nullable":
                # value plus its non-null contribution count: the SQL
                # aggregate is NULL when every input in the group was NULL
                v, c = outs[oi], outs[oi + 1]
                oi += 2
                cols[name] = v
                nulls[name] = c == 0
            else:
                cols[name] = outs[oi]
                oi += 1
            types[name] = t
        return DBatch(cols, out_valid, types, dicts, nulls)

    def _agg_inputs(self, node: P.Agg, b: DBatch):
        """Kernel inputs for the agg list.  Aggregates over nullable
        inputs get a parallel non-null-count input so all-NULL groups
        yield SQL NULL (the ("nullable",) out_spec)."""
        kinds, inputs, out_specs = [], [], []
        for name, ac in node.aggs:
            if ac.arg is not None:
                arg_arr, null_mask = self._eval_pair(ac.arg, b)
                if arg_arr.dim() == 0:   # constant argument: broadcast
                    arg_arr = arg_arr.expand(b.padded).contiguous()
            else:
                arg_arr = null_mask = None

            def non_null(v, neutral):
                if null_mask is None:
                    return v
                return torch.where(null_mask, torch.tensor(
                    neutral, dtype=v.dtype, device=v.device), v)

            base = b.valid if null_mask is None else (b.valid & ~null_mask)
            if ac.func == "count":
                kinds.append("sum")
                inputs.append(base.to(torch.int64))
                out_specs.append((name, T.INT64, None))
            elif ac.func == "avg":
                scale = ac.arg.type.scale \
                    if ac.arg.type.kind == TypeKind.DECIMAL else 0
                kinds.append("sumf")
                inputs.append(non_null(arg_arr, 0))
                kinds.append("sum")
                inputs.append(base.to(torch.int64))
                if node.mode == "partial":
                    # components travel separately to the final agg
                    out_specs.append((name + "__s", T.FLOAT64, None))
                    out_specs.append((name + "__c", T.INT64, None))
                else:
                    out_specs.append((name, T.FLOAT64, ("avg", scale)))
            elif ac.func == "sum":
                if ac.arg.type.kind == TypeKind.FLOAT64:
                    kinds.append("sumf")
                    t = T.FLOAT64
                else:
                    kinds.append("sum")
                    t = ac.arg.type if ac.arg.type.kind == TypeKind.DECIMAL \
                        else T.INT64
                inputs.append(non_null(arg_arr, 0))
                if null_mask is not None:
                    kinds.append("sum")
                    inputs.append(base.to(torch.int64))
                    out_specs.append((name, t, ("nullable",)))
                else:
                    out_specs.append((name, t, None))
            elif ac.func in ("min", "max"):
                kinds.append(ac.func)
                if null_mask is not None:
                    if arg_arr.dtype.is_floating_point:
                        neutral = np.inf if ac.func == "min" else -np.inf
                    else:
                        info = torch.iinfo(arg_arr.dtype)
                        neutral = info.max if ac.func == "min" else info.min
                    arg_arr = non_null(arg_arr, neutral)
                inputs.append(arg_arr)
                if null_mask is not None:
                    kinds.append("sum")
                    inputs.append(base.to(torch.int64))
                    out_specs.append((name, ac.arg.type, ("nullable",)))
                else:
                    out_specs.append((name, ac.arg.type, None))
            else:
                raise ExecError(f"aggregate {ac.func} unsupported")
        return kinds, inputs, out_specs

    def _exec_agg(self, node: P.Agg) -> DBatch:
        if node.mode == "final":
            _not_ported("final (combine) aggregation")
        b = self.exec_node(node.child)
        if any(ac.distinct for _, ac in node.aggs):
            _not_ported("DISTINCT aggregates")
        key_arrs, key_types, key_dicts, key_nulls = \
            self._eval_group_keys(node, b)
        kinds, inputs, out_specs = self._agg_inputs(node, b)

        n = b.padded
        dev = self.device
        if not key_arrs:
            gid = torch.zeros(n, dtype=torch.int64, device=dev)
            outs, _present = K.grouped_agg_dense(
                gid, b.valid, tuple(inputs), 1, tuple(kinds))
            out_valid = torch.ones(1, dtype=torch.bool, device=dev)
            gkey_out = []
        else:
            dense_bound = _dense_bound(key_types, key_dicts) \
                if not any(nm is not None for nm in key_nulls) else None
            if dense_bound is None or dense_bound > 4096:
                _not_ported("sort-based GROUP BY")
            gid = torch.zeros(n, dtype=torch.int64, device=dev)
            mult = 1
            doms = [len(d) if d is not None else 2 for d in key_dicts]
            for arr, dom in zip(key_arrs, doms):
                gid = gid * dom + torch.clamp(arr, 0, dom - 1)
                mult *= dom
            outs, present = K.grouped_agg_dense(
                gid, b.valid, tuple(inputs), mult, tuple(kinds))
            out_valid = present > 0
            # decode group keys from the dense group id
            rem = torch.arange(mult, dtype=torch.int64, device=dev)
            gkey_out = []
            for i in reversed(range(len(key_arrs))):
                gkey_out.insert(0, rem % doms[i])
                rem = torch.div(rem, doms[i], rounding_mode="floor")
        return self._assemble_agg_output(node, gkey_out, key_types,
                                         key_dicts, outs, out_specs,
                                         out_valid)

    # ---- sort / limit ----
    def _exec_sort(self, node: P.Sort) -> DBatch:
        b = self.exec_node(node.child)
        key_arrs, descs = [], []
        for ke, desc in node.keys:
            arr, nm = self._eval_pair(ke, b)
            d = _dict_for_expr(ke, b.dicts)
            if d is not None:
                # dictionary codes are unordered: map code -> rank
                order = np.argsort(np.asarray(d, dtype=object))
                rank = np.empty(max(len(d), 1), dtype=np.int32)
                rank[order] = np.arange(len(d), dtype=np.int32)
                arr = torch.from_numpy(rank).to(self.device)[
                    torch.clamp(arr, 0, len(d) - 1).to(torch.int64)]
            if nm is not None:
                # NULLs sort as +infinity: last under ASC, first under
                # DESC — PostgreSQL's default NULLS LAST/FIRST pairing
                if arr.dtype == torch.bool:
                    big = True
                elif arr.dtype.is_floating_point:
                    big = float("inf")
                else:
                    big = torch.iinfo(arr.dtype).max
                arr = torch.where(nm, torch.tensor(big, dtype=arr.dtype,
                                                   device=arr.device), arr)
            if arr.dim() == 0:
                arr = arr.expand(b.padded)
            key_arrs.append(arr)
            descs.append(bool(desc))
        names = list(b.cols.keys())
        null_names = list(b.nulls.keys())
        payload = tuple(b.cols[n] for n in names) + \
            tuple(b.nulls[n] for n in null_names)
        sorted_payload, s_valid = K.sort_rows(
            tuple(key_arrs), b.valid, payload, tuple(descs),
            limit=node.limit)
        cols = dict(zip(names, sorted_payload[:len(names)]))
        nulls = dict(zip(null_names, sorted_payload[len(names):]))
        return DBatch(cols, s_valid, b.types, b.dicts, nulls)

    def _exec_limit(self, node: P.Limit) -> DBatch:
        b = self.exec_node(node.child)
        # valid rows are in order (post-sort); mask beyond count+offset
        idx = torch.cumsum(b.valid.to(torch.int32), 0)
        keep = b.valid
        if node.offset:
            keep = keep & (idx > node.offset)
        if node.count is not None:
            keep = keep & (idx <= (node.count + node.offset))
        return DBatch(b.cols, keep, b.types, b.dicts, b.nulls)

    def _exec_result(self, node: P.Result) -> DBatch:
        cols, types, nulls = {}, {}, {}
        one = torch.ones(1, dtype=torch.bool, device=self.device)
        base = DBatch({}, one, {}, {})
        for name, oe in node.outputs:
            arr, nm = self._eval_pair(oe, base)
            cols[name] = arr.reshape(1) if arr.dim() == 0 else arr
            if nm is not None:
                nulls[name] = nm
            types[name] = oe.type
        return DBatch(cols, one, types, {}, nulls)


# ---------------------------------------------------------------------------

def _cols_of(e: E.Expr) -> set[str]:
    return {x.name for x in E.walk(e) if isinstance(x, E.Col)}


def _dict_for_expr(e: E.Expr, dicts: dict):
    """Decode dictionary for a TEXT-valued expr output (transformed for
    TextExpr — many codes may map to one string downstream)."""
    if isinstance(e, E.Col) and e.name in dicts:
        return dicts[e.name]
    if isinstance(e, E.TextExpr):
        base = dicts.get(e.col.name)
        if base is None:
            return None
        return [e.apply(v) for v in base]
    if isinstance(e, E.Lit) and e.lit_type.kind == TypeKind.TEXT \
            and e.value is not None:
        # projected TEXT literal: every row decodes to the one value
        return [str(e.value)]
    if isinstance(e, E.Case) and e.type.kind == TypeKind.TEXT:
        from .expr_compile import case_text_dict
        return case_text_dict(e)
    return None


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def scalar_from_batch(b: DBatch):
    """One value or SQL NULL (None) from a scalar-subquery result — an
    empty subquery is NULL, not 0."""
    name = next(iter(b.cols))
    valid = _host(b.valid)
    vals = _host(b.cols[name])[valid]
    if len(vals) == 0:
        return None
    if len(vals) > 1:
        raise ExecError("scalar subquery returned more than one row")
    if name in b.nulls and bool(_host(b.nulls[name])[valid][0]):
        return None
    return vals[0].item()


def materialize(b: DBatch, names: Optional[list[str]] = None):
    """DBatch -> (column_names, list of python row tuples), decoded.
    The final-projection materialization point (host copy)."""
    if names is None:
        names = b.names()
    valid = _host(b.valid)
    rows_idx = np.nonzero(valid)[0]
    out_cols = []
    for n in names:
        arr = _host(b.cols[n])[rows_idx]
        t = b.types[n]
        nullm = _host(b.nulls[n])[rows_idx] if n in b.nulls else None
        if t.kind == TypeKind.TEXT:
            d = b.dicts.get(n, [])
            if d:
                table = np.asarray(list(d) + [None], dtype=object)
                codes = np.where((arr >= 0) & (arr < len(d)), arr, len(d))
                vals = table[codes].tolist()
            else:
                vals = [None] * len(arr)
        elif t.kind == TypeKind.DECIMAL:
            vals = (arr / 10 ** t.scale).tolist()
        elif t.kind == TypeKind.DATE:
            epoch = np.datetime64("1970-01-01", "D")
            vals = [str(v) for v in
                    (epoch + arr.astype("timedelta64[D]"))]
        elif t.kind == TypeKind.BOOL:
            vals = arr.astype(bool).tolist()
        elif t.kind == TypeKind.FLOAT64:
            vals = arr.astype(np.float64).tolist()
        elif t.kind == TypeKind.VECTOR:
            vals = [tuple(float(x) for x in v) for v in arr]
        else:
            vals = arr.astype(np.int64).tolist() \
                if arr.dtype.kind in "iu" else arr.tolist()
        if nullm is not None:
            vals = [None if m else v for v, m in zip(vals, nullm)]
        out_cols.append(vals)
    rows = list(zip(*out_cols)) if out_cols else []
    return names, rows


def _dense_bound(key_types: list[SqlType], key_dicts: list) -> Optional[int]:
    """Combined group-domain bound if all keys have small known domains."""
    bound = 1
    for t, d in zip(key_types, key_dicts):
        if t.kind == TypeKind.TEXT and d is not None:
            bound *= max(len(d), 1)
        elif t.kind == TypeKind.BOOL:
            bound *= 2
        else:
            return None
    return bound
