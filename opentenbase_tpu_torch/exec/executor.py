"""Fragment executor: runs a physical plan over one datanode's stores.

The counterpart of opentenbase_tpu/exec/executor.py's eager tier, for
single-node plans of scan / filter / project / hash join (inner, left,
full, semi, anti, cross) / grouped aggregate (dense and sort-based) /
sort / limit.  Each operator consumes and produces a DBatch: padded
device tensors plus a validity mask.  Padding follows the buffer cache's
size classes; padded rows are masked by the scan's row-count belt.

The scan stages table columns through the node's device cache once per
table version, decodes encoded columns with the codec kernel, computes
MVCC visibility with the visibility kernel, and evaluates `col <op>
literal` filters on the codes (cmp_on_codes).  NULLs are per-column
boolean masks (DBatch.nulls); expressions compile to (value, null-mask)
pairs (exec/expr_compile.py).

Joins move indices, not payloads (late materialization, the reference's
default): a join's output carries its inputs' columns as LazyCols behind
the fresh pair indices, earlier indirections compose (one index gather
per distinct index vector), and a column is gathered only when an
expression, an aggregate, a sort or the result reads it.  Each eager
join reads one value back to the host: its pair count, which sizes the
output.

On the cluster tier (exec/mesh_exec.py) the same executor runs each
DataNode fragment over one DataNode's row range of the cluster-staged
tables (ExecContext.staged: views of the staged tensors, the union
dictionaries in the scan's store view), with exchange inputs bound as
BatchSource leaves, and finishes partial aggregates in final (combine)
mode.

The fused tier (exec/fused.py) runs first: `exec_node` offers every
node to `fused.try_fused`, which runs a whole fragment as one program
(on the card, a captured CUDA graph) through this same executor in
traced mode (`_traced`).  There no operator reads a value back to the
host: a join sizes its output from the static class ladder
(max(64, max(left, right padded) // 4 * factor)) and reports the pairs it
needed in `join_required`; the sort-based aggregate sizes its groups for
the worst case (every row its own group) and runs K5's traced form; an
aggregate over a scan whose groups are dense or absent runs the fused
scan-aggregate kernel (ops/kernels.py fused_scan_agg) over every query
of the program's batch at once (ExecContext.batch).  `_fuse = False`
keeps a statement on the eager tier.

EXEC_STATS counts per tier (single = eager, fused = traced programs) the
joins and the host reads (`host_syncs`: one per eager join) and the
fused tier's program hits on join fragments (`fused_join_hits`).

AnnSearch (ORDER BY vec <-> q LIMIT k) runs exact or IVF top-k through
the K15 kernels of ops/ann.py, eagerly.

Window functions (K13) sort each (partition, order) spec with K10 and
run the ops/kernels.py window kernels over the sorted rows.

Still raising NotImplementedError: DISTINCT aggregates, set operations,
Append, btree index scans, HNSW search, and the reference's morsel /
spill / work-sharing tiers.  Nothing is done another way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
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
from ..utils import locks
from ..utils.dtypes import dev_dtype, device_float
from .expr_compile import device_const


class ExecError(Exception):
    pass


# ---------------------------------------------------------------------------
# executor telemetry (reference: exec/executor.py:53-110).  Per-tier
# counter bundles: "single" is the eager per-operator dispatch, "fused"
# counts the traced runs of fragment programs (a program's warm-up and
# capture; a replay runs no Python) plus program hits on join fragments.
# Increments go through bump_stat() under STATS_LOCK; the attribution
# tier is thread-local.
# ---------------------------------------------------------------------------
STAT_FIELDS = ("joins", "host_syncs", "fused_join_hits")
STATS_LOCK = locks.Lock("exec.executor.STATS_LOCK")
EXEC_STATS: dict = {t: {f: 0 for f in STAT_FIELDS}   # guarded_by: STATS_LOCK
                    for t in ("single", "fused")}
_TIER = threading.local()   # per-thread counter attribution


def _cur_tier() -> str:
    return getattr(_TIER, "value", "single")


def bump_stat(tier: str, field: str, n: int = 1):
    with STATS_LOCK:
        EXEC_STATS[tier][field] += n


def _bump(field: str, n: int = 1):
    """Thread-safe increment against the current attribution tier."""
    bump_stat(_cur_tier(), field, n)


@contextlib.contextmanager
def stats_tier(tier: str):
    """Attribute executor counters to `tier` for the duration."""
    prev = _cur_tier()
    _TIER.value = tier
    try:
        yield
    finally:
        _TIER.value = prev


def exec_stats_snapshot() -> dict:
    """Flat totals across tiers."""
    with STATS_LOCK:
        return {f: sum(EXEC_STATS[t][f] for t in EXEC_STATS)
                for f in STAT_FIELDS}


@dataclasses.dataclass
class LazyCol:
    """A deferred (late-materialized) column: `src` holds the payload in
    SOURCE row space and `idx` maps output positions to source rows.
    Joins compose `idx` instead of gathering `src`.

    `null_src` is the source-space null mask (gathered through `idx` at
    materialization); `null_out` is an OUTPUT-space mask OR'd on top:
    outer-join null extension, which exists only in the join's row
    space."""
    src: object
    idx: object
    null_src: object = None
    null_out: object = None

    def value(self):
        return self.src[self.idx]

    def null(self):
        m = None
        if self.null_src is not None:
            m = self.null_src[self.idx]
        if self.null_out is not None:
            m = self.null_out if m is None else (m | self.null_out)
        return m


@dataclasses.dataclass
class DBatch:
    cols: dict[str, object]            # name -> tensor [P]
    valid: object                      # bool tensor [P]
    types: dict[str, SqlType]
    dicts: dict[str, list]             # TEXT col name -> code->str list
    nulls: dict[str, object] = dataclasses.field(default_factory=dict)
    # late materialization: deferred columns behind an indirection (see
    # LazyCol).  `cols`/`nulls` hold only materialized columns;
    # `types`/`dicts` always cover every column.
    lazy: dict[str, LazyCol] = dataclasses.field(default_factory=dict)

    @property
    def padded(self) -> int:
        return int(self.valid.shape[0])

    def count(self) -> int:
        return int(self.valid.sum())

    # -- late-materialization surface ----------------------------------
    def names(self) -> list[str]:
        return list(self.cols) + [n for n in self.lazy
                                  if n not in self.cols]

    def has_col(self, name: str) -> bool:
        return name in self.cols or name in self.lazy

    def maybe_null(self, name: str) -> bool:
        """Whether the column can carry a null mask (no materialization)."""
        if name in self.nulls:
            return True
        lc = self.lazy.get(name)
        return lc is not None and (lc.null_src is not None
                                   or lc.null_out is not None)

    def _materialize_one(self, name: str):
        lc = self.lazy.pop(name)
        self.cols[name] = lc.value()
        m = lc.null()
        if m is not None:
            self.nulls[name] = m

    def ensure(self, names) -> "DBatch":
        """Materialize exactly the named columns (unknown names are
        fine: init-plan params are not batch columns)."""
        if self.lazy:
            for n in names:
                if n in self.lazy:
                    self._materialize_one(n)
        return self

    def ensure_all(self) -> "DBatch":
        """The single materialization pass of a width-consuming operator
        (Sort, the FULL join tail, a scalar subquery's result)."""
        if self.lazy:
            for n in list(self.lazy):
                self._materialize_one(n)
        return self

    def col(self, name: str):
        if name in self.lazy:
            self._materialize_one(name)
        return self.cols[name]

    def col_opt(self, name: str):
        if name in self.lazy:
            self._materialize_one(name)
        return self.cols.get(name)

    def gather_rows(self, take):
        """(cols, nulls) gathered at output positions `take`, composing
        straight through any indirection: a len(take)-row consumer never
        materializes the whole source row space."""
        cols, nulls = {}, {}
        composed: dict = {}
        for n, a in self.cols.items():
            cols[n] = a[take]
        for n, m in self.nulls.items():
            nulls[n] = m[take]
        for n, lc in self.lazy.items():
            key = id(lc.idx)
            src_idx = composed.get(key)
            if src_idx is None:
                src_idx = lc.idx[take]
                composed[key] = src_idx
            cols[n] = lc.src[src_idx]
            m = None
            if lc.null_src is not None:
                m = lc.null_src[src_idx]
            if lc.null_out is not None:
                no = lc.null_out[take]
                m = no if m is None else (m | no)
            if m is not None:
                nulls[n] = m
        return cols, nulls


@dataclasses.dataclass
class ExecContext:
    stores: dict[str, TableStore]
    snapshot_ts: int
    txid: int
    cache: object                       # storage.bufferpool.DeviceBufferPool
    params: dict[str, tuple] = dataclasses.field(default_factory=dict)
    # init-plan results: name -> (value, SqlType)
    staged: Optional[dict] = None
    # cluster tier: table -> (staged tensors of one DataNode's row range,
    # its live row count); the scan reads these instead of the cache.
    # fused tier: table -> (the staged tensors the program reads, n)
    join_size_factor: int = 1
    # traced joins cannot read their output size: out_size = max(64,
    # max(probe, build padded) // 4 * factor), per join id (fragment tag,
    # sequence in the fragment) from join_factors, join_size_factor else
    join_factors: Optional[dict] = None
    batch: Optional[object] = None
    # fused tier: the program's query batch (exec/fused.py BatchInputs):
    # the literal table, snapshots and txids of all its slots; `slot` is
    # the query this executor runs
    slot: int = 0

    @property
    def device(self) -> torch.device:
        return self.cache.device


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not yet ported")


class Executor:
    #: True inside a fragment program's traced run (exec/fused.py): host
    #: reads become static worst-case shapes
    _traced = False
    #: False keeps every node on the eager tier
    _fuse = True

    def __init__(self, ctx: ExecContext, frag_tag=None):
        self.ctx = ctx
        self.device = ctx.device
        # traced joins: (join id, required pairs (0-d tensor), out_size)
        # per join, checked by the fused tier after the program runs
        self.join_required: list = []
        self.frag_tag = frag_tag
        self._join_seq = 0

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

    def _ensure_expr(self, e: E.Expr, batch: DBatch) -> E.Expr:
        """Prep `e` and materialize exactly the deferred columns it
        touches.  Runs BEFORE compile: the null-awareness set
        (frozenset(batch.nulls)) is part of the compiled closure."""
        pe = self._prep(e)
        if batch.lazy:
            batch.ensure(_cols_of(pe))
        return pe

    def _eval(self, e: E.Expr, batch: DBatch):
        """Value-only eval (garbage at NULL positions)."""
        from .expr_compile import compile_expr
        pe = self._ensure_expr(e, batch)
        return compile_expr(pe, self._dictviews(batch),
                            frozenset(batch.nulls),
                            self.device)(self._env(batch))

    def _eval_pair(self, e: E.Expr, batch: DBatch):
        """(value, null_mask|None) eval; the mask is broadcast to batch
        shape so downstream gathers can index it."""
        from .expr_compile import compile_pair
        pe = self._ensure_expr(e, batch)
        vf, nf = compile_pair(pe, self._dictviews(batch),
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
        pe = self._ensure_expr(e, batch)
        return compile_pred(pe, self._dictviews(batch),
                            frozenset(batch.nulls),
                            self.device)(self._env(batch))

    # ------------------------------------------------------------------
    def exec_node(self, node: P.PhysNode) -> DBatch:
        """Run one plan node; a node type of a later slice (set
        operations, Append, index scans) is not yet ported."""
        if not self._traced and self._fuse:
            from .fused import try_fused
            out = try_fused(self, node)
            if out is not None:
                return out
        m = getattr(self, f"_exec_{type(node).__name__.lower()}", None)
        if m is None:
            _not_ported(f"plan node {type(node).__name__}")
        return m(node)

    # ---- scan ----
    def _scan_base(self, table, alias: str, filters, outputs,
                   extra_needed: set = frozenset()):
        """Shared scan scaffolding (SeqScan + AnnSearch): stage the needed
        columns via the device cache, build the qualified-name eval
        namespace, and combine MVCC visibility with the filter quals into
        one mask."""
        store = self.ctx.stores.get(table.name)
        if store is None:
            raise ExecError(f"no store for table {table.name}")
        filters = [self._prep(f) for f in filters]
        outputs = [(n, self._prep(e)) for n, e in (outputs or [])]
        needed = set(extra_needed)
        for f in filters:
            needed |= {c.split(".", 1)[1] if "." in c else c
                       for c in _cols_of(f)}
        for _, oe in outputs:
            needed |= {c.split(".", 1)[1] if "." in c else c
                       for c in _cols_of(oe)}
        staged = (self.ctx.staged or {}).get(table.name)
        if staged is not None:
            arrs, n = staged
        else:
            arrs, n = self.ctx.cache.get(store, sorted(needed))
        # the pad is whatever was staged (size_class): read it off the
        # tensors, never recompute
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
        if v is None or isinstance(v, torch.Tensor):
            # a masked literal (a 0-d tensor of the program's literal
            # buffer): compared in value space, so no literal is baked
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

    # ANN search is host-sized (one read of the rows found) and is
    # rejected by the fused screens: it runs eager.
    def _exec_annsearch(self, node: P.AnnSearch) -> DBatch:
        """Top-k vector search: visibility+filters mask, IVF probe when an
        index of the query's metric exists, exact distances otherwise,
        top-k, gather."""
        from ..ops import ann as ANN
        plain_vec = node.vec_col.split(".", 1)[1] if "." in node.vec_col \
            else node.vec_col
        base, valid, outputs, dicts = self._scan_base(
            node.table, node.alias, node.filters, node.outputs, {plain_vec})
        store = self.ctx.stores[node.table.name]
        vecs = base.cols[f"{node.alias}.{plain_vec}"]
        padded = valid.shape[0]
        q = device_const(np.asarray(node.query, dtype=np.float32),
                         self.device)
        k = min(node.k, padded)
        idx_info = store.ann_indexes.get(plain_vec)
        if idx_info is not None and idx_info.get("kind") == "hnsw":
            _not_ported("HNSW index search")
        if idx_info is not None and idx_info["metric"] == node.metric:
            assign, centroids = _ann_assignments(store, plain_vec, vecs)
            nprobe = min(idx_info["nprobe"], centroids.shape[0])
            idx, dist = ANN.ivf_search(vecs, assign, centroids, q, valid,
                                       nprobe, k, node.metric)
        else:
            d = ANN.distances(vecs, q, node.metric)
            idx, dist = ANN.topk_nearest(d, valid, k)
        # the one host read: how many of the k slots hold a row
        found = int(torch.isfinite(dist).sum())

        out_cols, out_types, out_dicts = {}, {}, {}
        for name, oe in outputs:
            if isinstance(oe, E.DistExpr):
                out_cols[name] = dist.to(device_float())
            else:
                out_cols[name] = self._eval(oe, base).index_select(0, idx)
            out_types[name] = oe.type
            dd = _dict_for_expr(oe, dicts)
            if dd is not None:
                out_dicts[name] = dd
        out_valid = torch.arange(k, device=self.device) < found
        return DBatch(out_cols, out_valid, out_types, out_dicts)

    # ---- filter / project ----
    def _exec_filter(self, node: P.Filter) -> DBatch:
        b = self.exec_node(node.child)
        valid = b.valid
        for q in node.quals:
            valid = valid & self._eval_pred(q, b)
        return DBatch(b.cols, valid, b.types, b.dicts, b.nulls, b.lazy)

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

    # ---- join ----
    def _join_key(self, keys: list[E.Expr], b: DBatch):
        """Combine join key exprs into one int64 key column.  A NULL key
        never matches: null positions take the kernels' reserved
        unmatchable sentinel INT64_MAX.  TEXT keys translate to stable
        string hashes so both sides share a key space (dictionary codes
        are column-local); text pairs are left out of the hash recheck,
        since the hash IS the equality.  More than one key hashes to one
        column (K11); the join then rechecks the keys by value.  Returns
        (key, hashed, recheckable) where recheckable[i] says key i can be
        re-verified by value."""
        from .expr_compile import _text_hash_fn
        for k in keys:
            self._ensure_expr(k, b)
        arrs, nulls, recheckable = [], None, []
        env = self._env(b)
        for k in keys:
            if k.type.kind == TypeKind.TEXT:
                a = _text_hash_fn(self._prep(k), self._dictviews(b),
                                  self.device)(env)
                _, nm = self._eval_pair(k, b)
                recheckable.append(False)
            else:
                a, nm = self._eval_pair(k, b)
                recheckable.append(True)
            arrs.append(a)
            if nm is not None:
                nulls = nm if nulls is None else (nulls | nm)
        if len(arrs) == 1:
            a = arrs[0].to(torch.int64)
            hashed = False
        else:
            a = K.hash_columns([x.to(torch.int64) for x in arrs])
            hashed = True
        if nulls is not None:
            a = torch.where(nulls, torch.full((), K.INT64_MAX,
                                              dtype=torch.int64,
                                              device=a.device), a)
        return a.contiguous(), hashed, recheckable

    @staticmethod
    def _defer_side(batch: DBatch, take, out: DBatch, extra_null=None):
        """Carry one join input's columns into the output batch as
        LazyCols behind `take` (output -> input row indices) instead of
        gathering payloads.  Existing indirections compose: ONE index
        gather (K9 compose_index) per distinct source index vector,
        shared by every column riding it.  `extra_null` is an
        output-space mask (outer-join null extension) OR'd onto every
        carried column's null."""
        composed: dict = {}
        for n_, a in batch.cols.items():
            out.lazy[n_] = LazyCol(a, take, batch.nulls.get(n_),
                                   extra_null)
            out.types[n_] = batch.types[n_]
            if n_ in batch.dicts:
                out.dicts[n_] = batch.dicts[n_]
        for n_, lc in batch.lazy.items():
            key = id(lc.idx)
            nidx = composed.get(key)
            if nidx is None:
                nidx = K.compose_index(lc.idx, take)
                composed[key] = nidx
            no = lc.null_out[take] if lc.null_out is not None else None
            if extra_null is not None:
                no = extra_null if no is None else (no | extra_null)
            out.lazy[n_] = LazyCol(lc.src, nidx, lc.null_src, no)
            out.types[n_] = batch.types[n_]
            if n_ in batch.dicts:
                out.dicts[n_] = batch.dicts[n_]

    @staticmethod
    def _or_null_out(out: DBatch, names, mask):
        """OR an output-space null mask onto the named columns (lazy or
        materialized): the outer-join revert path."""
        for n_ in names:
            lc = out.lazy.get(n_)
            if lc is not None:
                lc.null_out = mask if lc.null_out is None \
                    else (lc.null_out | mask)
            else:
                m = out.nulls.get(n_)
                out.nulls[n_] = mask if m is None else (m | mask)

    def _hits(self, seg, flag, num_segments: int):
        """Per-segment count of rows whose flag is set (segment ids in
        [0, num_segments)): K4's dense aggregation with no aggregate, its
        `present` row."""
        _outs, present = K.grouped_agg_dense(seg, flag, (), num_segments,
                                             ())
        return present

    def _exec_hashjoin(self, node: P.HashJoin) -> DBatch:
        left = self.exec_node(node.left)
        right = self.exec_node(node.right)

        if node.kind == "cross":
            return self._cross_join(left, right)

        if node.kind == "inner" and right.padded > left.padded:
            # build the SMALLER side (reference: nodeHash.c hashes the
            # cheaper input): inner joins are symmetric
            node = dataclasses.replace(node, left=node.right,
                                       right=node.left,
                                       left_keys=node.right_keys,
                                       right_keys=node.left_keys)
            left, right = right, left

        lkey, lhashed, lcheck = self._join_key(node.left_keys, left)
        rkey, rhashed, rcheck = self._join_key(node.right_keys, right)
        skeys, perm = K.join_build(rkey, right.valid)
        lo, counts = K.join_probe_counts(skeys, lkey, left.valid)

        hash_recheck = []
        if lhashed or rhashed:
            hash_recheck = [
                (lk, rk) for (lk, rk), lok, rok in
                zip(zip(node.left_keys, node.right_keys), lcheck, rcheck)
                if lok and rok]

        if node.kind in ("semi", "anti") and not node.residual \
                and not hash_recheck:
            mask = K.semi_mask(counts) if node.kind == "semi" \
                else K.anti_mask(counts, left.valid)
            return DBatch(left.cols, left.valid & mask, left.types,
                          left.dicts, left.nulls, left.lazy)

        _bump("joins")
        left_outer = node.kind in ("left", "full")
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        eff = torch.where(left.valid, torch.clamp(counts, min=1), zero) \
            if left_outer else counts
        if self._traced:
            # no host read inside a program: a static output class per
            # join id; the program reports the pairs it needed and the
            # fused tier grows exactly that join's factor on overflow
            jid = (self.frag_tag, self._join_seq)
            self._join_seq += 1
            factor = (self.ctx.join_factors or {}).get(
                jid, self.ctx.join_size_factor)
            out_size = max(64, (max(left.padded, right.padded) // 4)
                           * factor)
            total = eff.sum()
            self.join_required.append((jid, total, out_size))
        else:
            # the eager join's one host read: its pair count sizes the
            # output
            _bump("host_syncs")
            total = int(eff.sum())
            out_size = next_pow2(max(total, 1))
        pi, bi, _tot = K.join_expand(lo, counts, perm, out_size,
                                     left_outer=left_outer,
                                     probe_valid=left.valid)
        valid = torch.arange(out_size, device=self.device) < total
        null_right = (bi < 0) if left_outer else None
        bi_safe = torch.clamp(bi, min=0) if left_outer else bi

        # late materialization: the output carries both inputs' columns
        # behind the fresh pair indices (pi / bi)
        out = DBatch({}, valid, {}, {}, {})
        self._defer_side(left, pi, out)
        self._defer_side(right, bi_safe, out, extra_null=null_right)
        right_names = right.names()

        # residual quals (incl. hash recheck for multi-key joins)
        res_valid = out.valid
        for lk, rk in hash_recheck:
            res_valid = res_valid & (self._eval(lk, out) ==
                                     self._eval(rk, out))
        for q in node.residual:
            res_valid = res_valid & self._eval_pred(q, out)

        if node.kind in ("semi", "anti"):
            # per-probe-row any(): count surviving pairs per probe row
            hits = self._hits(pi, res_valid, left.padded)
            mask = hits > 0 if node.kind == "semi" else \
                (left.valid & (hits == 0))
            return DBatch(left.cols, left.valid & mask, left.types,
                          left.dicts, left.nulls, left.lazy)
        if left_outer:
            null_ext = null_right
            if hash_recheck or node.residual:
                # Null-extended pairs (bi<0) gathered build row 0's
                # columns, so the recheck/residual verdict on them is
                # garbage: they are judged by whether any REAL pair of
                # their probe row survived.  A probe row whose real pairs
                # were ALL killed reverts to null extension (reference:
                # ExecHashJoin emits the null-filled tuple when
                # HJ_FILL_OUTER and no match passed joinqual): its first
                # output pair becomes the null-extended one.
                real_surv = res_valid & ~null_ext & out.valid
                hits = self._hits(pi, real_surv, left.padded)
                need_null = left.valid & (hits == 0)
                idx = torch.arange(out_size, dtype=torch.int64,
                                   device=self.device)
                (first_idx,), _p = K.grouped_agg_dense(
                    pi, out.valid, (idx,), left.padded, ("min",))
                is_first = out.valid & (idx == first_idx[pi])
                to_null = is_first & need_null[pi]
                self._or_null_out(out, right_names, to_null)
                out.valid = real_surv | to_null
                null_ext = null_ext | to_null
            if node.kind != "full":
                return out
            # FULL: append the unmatched BUILD rows null-extended on the
            # left, computed AFTER recheck/revert so pairs killed there
            # count their build row as unmatched (reference: ExecHashJoin
            # HJ_FILL_INNER).  The tail concat is width-consuming:
            # materialize both row spaces.
            out.ensure_all()
            right.ensure_all()
            bhits = self._hits(bi_safe, out.valid & ~null_ext,
                               right.padded)
            r_unmatched = right.valid & (bhits == 0)
            cols2, nulls2 = {}, {}
            for n_, a in out.cols.items():
                if n_ in right.cols:
                    cols2[n_] = torch.cat([a, right.cols[n_]])
                    tail_m = right.nulls.get(
                        n_, torch.zeros(right.padded, dtype=torch.bool,
                                        device=self.device))
                else:  # left column: null-extended in the appended rows
                    pad = torch.zeros((right.padded, *a.shape[1:]),
                                      dtype=a.dtype, device=a.device)
                    cols2[n_] = torch.cat([a, pad])
                    tail_m = torch.ones(right.padded, dtype=torch.bool,
                                        device=self.device)
                base_m = out.nulls.get(
                    n_, torch.zeros(out.padded, dtype=torch.bool,
                                    device=self.device))
                nulls2[n_] = torch.cat([base_m, tail_m])
            valid2 = torch.cat([out.valid, r_unmatched])
            return DBatch(cols2, valid2, out.types, out.dicts, nulls2)
        out.valid = res_valid
        return out

    def _cross_join(self, left: DBatch, right: DBatch) -> DBatch:
        ln, rn = left.count(), right.count()
        if ln * rn > 1 << 22:
            raise ExecError("cross join too large")
        dev = self.device
        lidx = torch.arange(left.padded, device=dev).repeat_interleave(
            right.padded)
        ridx = torch.arange(right.padded, device=dev).repeat(left.padded)
        valid = left.valid[lidx] & right.valid[ridx]
        out = DBatch({}, valid, {}, {}, {})
        self._defer_side(left, lidx, out)
        self._defer_side(right, ridx, out)
        return out

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
                arr = device_const(lut, self.device)[
                    torch.clamp(arr, 0, len(d) - 1)]
            key_arrs.append(arr)
            key_nulls.append(nm)
            key_types.append(ke.type)
            key_dicts.append(d)
        return key_arrs, key_types, key_dicts, key_nulls

    @staticmethod
    def _grouping_arrays(key_arrs, key_nulls):
        """Key tuple for the sort-based aggregate: values plus
        null-indicator columns (so the NULL group is distinct from the
        value-0 group)."""
        extra = [nm.to(torch.int64) for nm in key_nulls if nm is not None]
        return tuple(key_arrs) + tuple(extra)

    def _assemble_agg_output(self, node: P.Agg, gkey_out, key_types,
                             key_dicts, outs, out_specs, out_valid,
                             gkey_nulls=None):
        cols, types, dicts, nulls = {}, {}, {}, {}
        for i, ((kname, _), karr, kt, kd) in enumerate(
                zip(node.group_keys, gkey_out, key_types, key_dicts)):
            cols[kname] = karr.to(dev_dtype(kt))
            types[kname] = kt
            if kd is not None:
                dicts[kname] = kd
            if gkey_nulls is not None and gkey_nulls[i] is not None:
                nulls[kname] = gkey_nulls[i]
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

    def _agg_inputs(self, node: P.Agg, b: DBatch, final: bool = False):
        """Kernel inputs for the agg list.  `final` combines partial
        columns (named inputs with exchange-carried null masks) instead of
        raw argument expressions.  Aggregates over nullable inputs get a
        parallel non-null-count input so all-NULL groups yield SQL NULL
        (the ("nullable",) out_spec)."""
        kinds, inputs, out_specs = [], [], []
        for name, ac in node.aggs:
            if final:
                if ac.func == "avg":
                    arg_arr = null_mask = None
                else:
                    arg_arr = b.col_opt(name)
                    null_mask = b.nulls.get(name)
            elif ac.arg is not None:
                arg_arr, null_mask = self._eval_pair(ac.arg, b)
                if arg_arr.dim() == 0:   # constant argument: broadcast
                    arg_arr = arg_arr.expand(b.padded).contiguous()
            else:
                arg_arr = null_mask = None

            def non_null(v, neutral):
                if null_mask is None:
                    return v
                return torch.where(null_mask, torch.full(
                    (), neutral, dtype=v.dtype, device=v.device), v)

            base = b.valid if null_mask is None else (b.valid & ~null_mask)
            if ac.func == "count":
                kinds.append("sum")
                inputs.append(non_null(arg_arr, 0) if final
                              else base.to(torch.int64))
                out_specs.append((name, T.INT64, None))
            elif ac.func == "avg":
                scale = ac.arg.type.scale \
                    if ac.arg.type.kind == TypeKind.DECIMAL else 0
                kinds.append("sumf")
                inputs.append(b.col(name + "__s") if final
                              else non_null(arg_arr, 0))
                kinds.append("sum")
                inputs.append(b.col(name + "__c") if final
                              else base.to(torch.int64))
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
        if self.ctx.batch is not None:
            out = self._scan_agg(node)
            if out is not None:
                return out
        b = self.exec_node(node.child)
        if node.mode == "final":
            return self._exec_agg_final(node, b)
        if any(ac.distinct for _, ac in node.aggs):
            _not_ported("DISTINCT aggregates")
        key_arrs, key_types, key_dicts, key_nulls = \
            self._eval_group_keys(node, b)
        kinds, inputs, out_specs = self._agg_inputs(node, b)

        n = b.padded
        dev = self.device
        gkey_nulls = [None] * len(key_arrs)
        if not key_arrs:
            gid = torch.zeros(n, dtype=torch.int64, device=dev)
            outs, _present = K.grouped_agg_dense(
                gid, b.valid, tuple(inputs), 1, tuple(kinds))
            out_valid = torch.ones(1, dtype=torch.bool, device=dev)
            gkey_out = []
        else:
            dense_bound = _dense_bound(key_types, key_dicts) \
                if not any(nm is not None for nm in key_nulls) else None
            if dense_bound is not None and dense_bound <= 4096:
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
            else:
                # traced: the worst case, every row its own group
                max_groups = b.padded if self._traced else \
                    next_pow2(max(b.count(), 1))
                gkeys, outs, ng = K.grouped_agg_sort(
                    self._grouping_arrays(key_arrs, key_nulls), b.valid,
                    tuple(inputs), max_groups, tuple(kinds),
                    traced=self._traced)
                out_valid = torch.arange(max_groups, device=dev) < (
                    ng if self._traced else int(ng))
                gkey_out = list(gkeys[:len(key_arrs)])
                extra = list(gkeys[len(key_arrs):])
                for i, nm in enumerate(key_nulls):
                    if nm is not None:
                        gkey_nulls[i] = extra.pop(0).to(torch.bool)
        return self._assemble_agg_output(node, gkey_out, key_types,
                                         key_dicts, outs, out_specs,
                                         out_valid, gkey_nulls)

    def _scan_agg(self, node: P.Agg) -> Optional[DBatch]:
        """A fragment program's aggregate over a scan whose groups are
        dense or absent: one fused_scan_agg launch answers every query of
        the program's batch (ExecContext.batch); slot 0 launches it and
        the other slots read their rows of its table.  None when the
        fragment is outside the kernel (the generic operators run)."""
        batch = self.ctx.batch
        hit = batch.agg_cache.get(id(node))
        if hit is None:
            prep = self._scan_agg_prep(node)
            hit = False
            if prep is not None:
                spec, cols, n, out_dtypes, key_info, out_specs = prep
                ws = K.fused_scan_agg(spec, cols, n, batch.lits, batch.snaps,
                                      batch.txids, int(ABORTED_TS))
                hit = (ws, out_dtypes, key_info, out_specs)
            batch.agg_cache[id(node)] = hit
        if hit is False:
            return None
        ws, out_dtypes, (key_types, key_dicts, doms), out_specs = hit
        table = ws[self.ctx.slot]
        outs = [row if dt == torch.int64 else row.to(dt)
                for row, dt in zip(table, out_dtypes)]
        present = table[len(out_dtypes)]
        dev = self.device
        if not doms:
            out_valid = torch.ones(1, dtype=torch.bool, device=dev)
            gkey_out = []
        else:
            out_valid = present > 0
            rem = torch.arange(math.prod(doms), dtype=torch.int64,
                               device=dev)
            gkey_out = []
            for i in reversed(range(len(doms))):
                gkey_out.insert(0, rem % doms[i])
                rem = torch.div(rem, doms[i], rounding_mode="floor")
        return self._assemble_agg_output(node, gkey_out, key_types,
                                         key_dicts, outs, out_specs,
                                         out_valid)

    def _scan_agg_prep(self, node: P.Agg):
        """The fused scan-aggregate program of `node` and its inputs, or
        None: the child must be a scan (under Filters) read from the
        program's staged tables, no column may carry NULLs, group keys
        must be dense (TEXT dictionary codes or BOOL, as the eager dense
        path takes them), aggregates sum / count / avg / min / max over
        integers or decimals, and the emitter must accept every
        expression."""
        from .expr_compile import emit_scan_agg
        if node.mode != "single" or any(ac.distinct for _, ac in node.aggs):
            return None
        child, quals = node.child, []
        while isinstance(child, P.Filter):
            quals.extend(child.quals)
            child = child.child
        if not isinstance(child, P.SeqScan):
            return None
        scan = child
        staged = (self.ctx.staged or {}).get(scan.table.name)
        store = self.ctx.stores.get(scan.table.name)
        if staged is None or store is None:
            return None
        arrs, n = staged
        encm = codec.enc_names(arrs)
        outputs = dict(scan.outputs) if scan.outputs else {}

        def resolve(e):
            return rewrite(e, lambda x: outputs.get(x.name)
                           if isinstance(x, E.Col) and x.name in outputs
                           else None)

        prefix = scan.alias + "."
        slots: dict = {}
        cols: list = []

        def slot_of(staged_name):
            if staged_name not in slots:
                if staged_name not in arrs:
                    return None
                k = encm.get(staged_name)
                cols.append((arrs[staged_name],
                             arrs[k] if k is not None else None,
                             codec.family_of(k) if k is not None else None))
                slots[staged_name] = len(cols) - 1
            return slots[staged_name]

        def col_slot(name):
            if not name.startswith(prefix):
                return None
            c = name[len(prefix):]
            if f"__null.{c}" in arrs:
                return None
            return slot_of(c)

        lit_index = self.ctx.batch.lit_index

        def lit_slot(name):
            return lit_index.get(name)

        dicts = {f"{prefix}{c}": d.values for c, d in store.dicts.items()}
        key_types, key_dicts, doms, groups = [], [], [], []
        for _kname, ke in node.group_keys:
            e = resolve(ke)
            if not isinstance(e, E.Col):
                return None
            if e.type.kind == TypeKind.TEXT:
                d = dicts.get(e.name)
                if not d:
                    return None
                dom = len(d)
            elif e.type.kind == TypeKind.BOOL:
                d, dom = None, 2
            else:
                return None
            key_types.append(ke.type)
            key_dicts.append(d)
            doms.append(dom)
            groups.append((e, dom))
        if math.prod(doms) > 4096:
            return None
        # the kernel's aggregates, the dtype of each output row, and the
        # eager _agg_inputs' out_specs
        aggs, out_dtypes, out_specs = [], [], []
        for name, ac in node.aggs:
            arg = resolve(ac.arg) if ac.arg is not None else None
            if arg is not None and (
                    arg.type.kind == TypeKind.FLOAT64
                    or any(isinstance(x, E.Col) and lit_slot(x.name) is None
                           and col_slot(x.name) is None
                           for x in E.walk(arg))):
                return None   # an f64 or possibly NULL argument
            if ac.func == "count":
                aggs.append((K.FUSED_COUNT, None))
                out_dtypes.append(torch.int64)
                out_specs.append((name, T.INT64, None))
            elif ac.func == "avg":
                scale = ac.arg.type.scale \
                    if ac.arg.type.kind == TypeKind.DECIMAL else 0
                aggs += [(K.FUSED_SUM, arg), (K.FUSED_COUNT, None)]
                # the eager sumf of integer values: an exact int64 sum,
                # converted once
                out_dtypes += [device_float(), torch.int64]
                out_specs.append((name, T.FLOAT64, ("avg", scale)))
            elif ac.func == "sum":
                aggs.append((K.FUSED_SUM, arg))
                out_dtypes.append(torch.int64)
                t = ac.arg.type if ac.arg.type.kind == TypeKind.DECIMAL \
                    else T.INT64
                out_specs.append((name, t, None))
            elif ac.func in ("min", "max"):
                aggs.append((K.FUSED_MIN if ac.func == "min"
                             else K.FUSED_MAX, arg))
                out_dtypes.append(dev_dtype(ac.arg.type))
                out_specs.append((name, ac.arg.type, None))
            else:
                return None
        mv = [slot_of(c) for c in ("__xmin_ts", "__xmax_ts", "__xmin_txid",
                                   "__xmax_txid")]
        if any(m is None for m in mv):
            return None
        all_quals = list(scan.filters) + [resolve(q) for q in quals]
        spec = emit_scan_agg(all_quals, aggs, groups, col_slot, lit_slot,
                             mv, self._dictviews(DBatch({}, None, {}, dicts)),
                             len(lit_index))
        lim = K.FUSED_LIMITS
        if spec is None or len(cols) > lim["cols"] \
                or len(spec.aggs) > lim["aggs"] \
                or len(lit_index) > lim["regs"]:
            return None
        return (spec, cols, n, out_dtypes, (key_types, key_dicts, doms),
                out_specs)

    def _exec_agg_final(self, node: P.Agg, b: DBatch) -> DBatch:
        """Finalise partial aggregates (reference: rq_finalise_aggs, the
        combine of the DataNodes' partials).  Input columns follow the
        partial naming convention; group keys are passthrough columns
        grouped by the sort-based aggregate.  Null masks on partial
        columns (a DataNode group whose inputs were all NULL) combine
        through the same skip-null rule as raw arguments."""
        key_arrs, key_types, key_dicts, key_nulls = \
            self._eval_group_keys(node, b)
        kinds, inputs, out_specs = self._agg_inputs(node, b, final=True)
        dev = self.device
        gkey_nulls = [None] * len(key_arrs)
        if not key_arrs:
            gid = torch.zeros(b.padded, dtype=torch.int64, device=dev)
            outs, _present = K.grouped_agg_dense(
                gid, b.valid, tuple(inputs), 1, tuple(kinds))
            out_valid = torch.ones(1, dtype=torch.bool, device=dev)
            gkey_out = []
        else:
            max_groups = b.padded if self._traced else \
                next_pow2(max(b.count(), 1))
            gkeys, outs, ng = K.grouped_agg_sort(
                self._grouping_arrays(key_arrs, key_nulls), b.valid,
                tuple(inputs), max_groups, tuple(kinds),
                traced=self._traced)
            out_valid = torch.arange(max_groups, device=dev) < (
                ng if self._traced else int(ng))
            gkey_out = list(gkeys[:len(key_arrs)])
            extra = list(gkeys[len(key_arrs):])
            for i, nm in enumerate(key_nulls):
                if nm is not None:
                    gkey_nulls[i] = extra.pop(0).to(torch.bool)
        return self._assemble_agg_output(node, gkey_out, key_types,
                                         key_dicts, outs, out_specs,
                                         out_valid, gkey_nulls)

    # ---- window functions (K13) ----
    def _win_key(self, e: E.Expr, b: DBatch, for_order: bool):
        """Sortable key + null mask for a window partition/order
        expression (reference: executor.py:1499).  The caller adds the
        null mask as its OWN sort/grouping key, so NULL never collides
        with +inf/INT64_MAX values (NULL is a distinct peer group)."""
        arr, nm = self._eval_pair(e, b)
        if arr.dim() == 0:   # constant key: broadcast
            arr = arr.expand(b.padded)
        d = _dict_for_expr(e, b.dicts)
        if d is not None and for_order:
            # dictionary codes are unordered: map code -> rank
            rank, _order = _text_ranks(d, self.device)
            arr = rank[torch.clamp(arr.to(torch.int64), 0, len(d) - 1)]
        if arr.dtype == torch.bool:
            arr = arr.to(torch.int32)
        if not arr.dtype.is_floating_point:
            arr = arr.to(torch.int64)
        if nm is not None:
            # canonicalize the value under NULL so grouping is stable
            arr = torch.where(nm, torch.zeros((), dtype=arr.dtype,
                                              device=arr.device), arr)
        return arr, nm

    def _win_arg(self, e: E.Expr, b: DBatch, s_iota):
        """(sorted argument as int64 / float64, its sorted null mask,
        the argument's own dtype)."""
        a, anm = self._eval_pair(e, b)
        if a.dim() == 0:
            a = a.expand(b.padded)
        dtype = a.dtype
        a_s = a.index_select(0, s_iota)
        a_s = a_s.to(torch.float64 if dtype.is_floating_point
                     else torch.int64)
        anm_s = anm.index_select(0, s_iota) if anm is not None else None
        return a_s, anm_s, dtype

    def _exec_window(self, node: P.Window) -> DBatch:
        """Sorted-partition window computation (reference: executor.py
        :1523; nodeWindowAgg.c): one K10 sort per distinct (partition,
        order) spec, K13a partition/peer bounds over the sorted rows,
        then one K13b launch per call (its frames, its function and the
        scatter back to input row order); min/max read K13c's sparse
        table."""
        b = self.exec_node(node.child).ensure_all()
        new_cols: dict = {}
        new_nulls: dict = {}
        new_dicts: dict = {}
        specs: dict = {}
        for name, wc in node.calls:
            specs.setdefault((wc.partition, wc.order), []).append(
                (name, wc))
        for (part, order), calls in specs.items():
            keys, descs = [], []
            for pe in part:
                arr, nm = self._win_key(pe, b, for_order=False)
                if nm is not None:
                    keys.append(nm.to(torch.int64))
                    descs.append(False)
                keys.append(arr)
                descs.append(False)
            n_part = len(keys)
            for oe, desc in order:
                arr, nm = self._win_key(oe, b, for_order=True)
                if nm is not None:
                    # NULLS LAST asc / FIRST desc, as a separate key so
                    # NULL stays a distinct peer group
                    keys.append(nm.to(torch.int64))
                    descs.append(bool(desc))
                keys.append(arr)
                descs.append(bool(desc))
            # K10: the input index is the last key (the sort is stable)
            words = K.order_words(tuple(keys), b.valid, tuple(descs))
            s_iota = K.sort_perm(words)
            s_valid = b.valid.index_select(0, s_iota)
            float_words = tuple(1 + j for j, k in enumerate(keys)
                                if k.dtype.is_floating_point)
            bounds = K.window_bounds(
                words.index_select(1, s_iota).contiguous(), n_part,
                float_words, s_valid)
            for name, wc in calls:
                val, nul, d = self._window_call(wc, b, bool(order), bounds,
                                                s_iota, s_valid)
                new_cols[name] = val
                if nul is not None:
                    new_nulls[name] = nul
                if d is not None:   # TEXT results keep their decode
                    new_dicts[name] = d
        cols = dict(b.cols)
        cols.update(new_cols)
        types = dict(b.types)
        for name, wc in node.calls:
            types[name] = wc.type
        nulls = dict(b.nulls)
        nulls.update(new_nulls)
        dicts = dict(b.dicts)
        dicts.update(new_dicts)
        return DBatch(cols, b.valid, types, dicts, nulls)

    def _window_call(self, wc: E.WindowCall, b: DBatch, has_order: bool,
                     bounds, s_iota, s_valid):
        """One window call over its spec's sorted rows: (values, null
        mask or None, TEXT dictionary or None), in input row order."""
        f = wc.func
        if f in ("row_number", "rank", "dense_rank"):
            val, _ = K.window_frame_reduce(f, bounds, None, s_iota, s_valid)
            return val, None, None
        a_s = anm_s = dtype = d = None
        if wc.arg is not None:
            a_s, anm_s, dtype = self._win_arg(wc.arg, b, s_iota)
            d = _dict_for_expr(wc.arg, b.dicts)
        if f in ("lag", "lead"):
            # ROW offset within the partition; the default fills only
            # out-of-partition offsets and evaluates in INPUT row order
            # (re-sorted here), a NULL source value stays NULL
            dflt_s = dnull_s = None
            if wc.default is not None:
                dv, dnm = self._eval_pair(wc.default, b)
                dv = dv.to(dtype).to(a_s.dtype)
                dflt_s = dv.expand(b.padded).index_select(0, s_iota) \
                    if dv.dim() == 0 else dv.index_select(0, s_iota)
                if dnm is not None:
                    dnull_s = dnm.index_select(0, s_iota)
            val, nul = K.window_frame_reduce(
                f, bounds, None, s_iota, s_valid, a_s, anm_s,
                offset=wc.offset, dflt_s=dflt_s, dnull_s=dnull_s,
                has_default=wc.default is not None)
            return val.to(dtype), nul, d
        frame = K.window_frame(wc.frame, has_order)
        if f in ("min", "max"):
            if d is not None:
                # dictionary codes are unordered: reduce over
                # lexicographic ranks, then map the winning rank back
                rank, order = _text_ranks(d, self.device)
                ranked = rank[torch.clamp(a_s, 0, len(d) - 1)]
                table = self._range_minmax(ranked, s_valid, anm_s, f)
                rr, nul = K.window_frame_reduce(
                    f, bounds, frame, s_iota, s_valid, ranked, anm_s,
                    table=table)
                return order[torch.clamp(rr, 0, len(d) - 1)].to(
                    torch.int32), nul, d
            table = self._range_minmax(a_s, s_valid, anm_s, f)
            val, nul = K.window_frame_reduce(f, bounds, frame, s_iota,
                                             s_valid, a_s, anm_s,
                                             table=table)
            return val.to(dtype), nul, None
        if f not in ("count", "sum", "avg", "first_value", "last_value"):
            raise ExecError(f"window function {f} unsupported")
        scale = wc.arg.type.scale if f == "avg" and \
            wc.arg.type.kind == TypeKind.DECIMAL else 0
        val, nul = K.window_frame_reduce(f, bounds, frame, s_iota, s_valid,
                                         a_s, anm_s, scale=scale)
        if f in ("first_value", "last_value"):
            return val.to(dtype), nul, d
        return val, nul, None

    @staticmethod
    def _range_minmax(a_s, s_valid, anm_s, func: str):
        """K13c: the min/max sparse table over the contributing rows
        (reference: executor.py:1765)."""
        contrib = s_valid if anm_s is None else (s_valid & ~anm_s)
        return K.range_minmax(a_s, contrib, func == "min")

    # ---- sort / limit ----
    def _exec_sort(self, node: P.Sort) -> DBatch:
        # width-consuming: every carried column rides the sort payload
        b = self.exec_node(node.child).ensure_all()
        key_arrs, descs = [], []
        for ke, desc in node.keys:
            arr, nm = self._eval_pair(ke, b)
            d = _dict_for_expr(ke, b.dicts)
            if d is not None:
                # dictionary codes are unordered: map code -> rank
                rank, _order = _text_ranks(d, self.device)
                arr = rank[torch.clamp(arr, 0, len(d) - 1).to(torch.int64)]
            if nm is not None:
                # NULLs sort as +infinity: last under ASC, first under
                # DESC — PostgreSQL's default NULLS LAST/FIRST pairing
                if arr.dtype == torch.bool:
                    big = True
                elif arr.dtype.is_floating_point:
                    big = float("inf")
                else:
                    big = torch.iinfo(arr.dtype).max
                arr = torch.where(nm, torch.full((), big, dtype=arr.dtype,
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
        return DBatch(b.cols, keep, b.types, b.dicts, b.nulls, b.lazy)

    def _exec_batchsource(self, node) -> DBatch:
        """An exchange input, bound in place of its ExchangeRef."""
        return node.batch

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


def _ann_assignments(store, col: str, vecs):
    """Cluster assignments of the staged rows for the IVF index, on the
    rows' device, recomputed when the store changed since they were made
    (rows inserted after the build go to the build's centroids; nothing
    is re-clustered).  Returns (assign, centroids)."""
    from ..ops import ann as ANN
    info = store.ann_indexes[col]
    dkey = str(vecs.device)
    dev_cents = info.setdefault("_dev_centroids", {})
    centroids = dev_cents.get(dkey)
    if centroids is None:
        centroids = torch.from_numpy(info["centroids"]).to(vecs.device)
        dev_cents[dkey] = centroids
    caches = info.setdefault("_assign_cache", {})
    cached = caches.get(dkey)
    if cached is not None and cached[0] == store.version \
            and cached[1].shape[0] == vecs.shape[0]:
        return cached[1], centroids
    assign = ANN.assign_clusters(vecs, centroids, info["metric"])
    caches[dkey] = (store.version, assign)
    return assign, centroids


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


#: TEXT dictionary -> (code -> lexicographic rank, rank -> code) for
#: ORDER BY and window keys, the port's own cache (the reference rebuilds
#: them per call); the entry holds its dictionary, so the id stays its
#: own while cached, and the length keys appends.
_RANKS: dict = {}           # guarded_by: _RANKS_LOCK
_RANKS_LOCK = threading.Lock()
_RANKS_MAX = 256


def _text_ranks(d: list, device):
    """(rank, order) int64 tensors on `device` of dictionary `d`: rank
    maps a code to its string's lexicographic rank, order a rank back
    to its code."""
    key = (id(d), len(d))
    with _RANKS_LOCK:
        hit = _RANKS.get(key)
    if hit is None or hit[0] is not d:
        order = np.argsort(np.asarray(d, dtype=object))
        rank = np.empty(max(len(d), 1), dtype=np.int64)
        rank[order] = np.arange(len(d), dtype=np.int64)
        hit = (d, rank, np.asarray(order, dtype=np.int64))
        with _RANKS_LOCK:
            _RANKS[key] = hit
            while len(_RANKS) > _RANKS_MAX:
                _RANKS.pop(next(iter(_RANKS)))
    return device_const(hit[1], device), device_const(hit[2], device)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def scalar_from_batch(b: DBatch):
    """One value or SQL NULL (None) from a scalar-subquery result — an
    empty subquery is NULL, not 0."""
    b.ensure_all()
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
    The final-projection materialization point (host copy): only the
    requested columns leave the indirection layer."""
    if names is None:
        names = b.names()
    b.ensure(names)
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
