"""The device tier of the cluster: N logical DataNodes on one card.

The counterpart of opentenbase_tpu/exec/mesh_exec.py.  The reference
compiles every DataNode fragment and its exchanges into one shard_map
program over an N-device mesh, one device per DataNode.  Here the "mesh"
is N logical DataNodes that share one CUDA device: every staged tensor
holds all DataNodes' rows, DataNode d owning rows [d * padded, (d + 1) *
padded), and each collective becomes a kernel on the card:

    hash-redistribute  ->  K11 route_dest per DataNode batch
                           (shard_map[hash % 4096], the locator's
                           placement) + the K12 exchange (count, scan,
                           stable scatter per destination), reading
                           every DataNode's batch in place
    broadcast          ->  the K12 exchange in its "every live row to
                           one shared batch" form, read by every DataNode
    gather-to-CN       ->  K3 compact per DataNode (after a per-DataNode
                           top-k, K10, where the gather has sort keys
                           and a limit), concatenated in DataNode order
    partial aggregates ->  computed per DataNode, finalised after the
                           exchange (exec/executor.py final mode)

By default the whole DataNode side of a plan runs as ONE program (K16,
reference :950 _execute and :1111-1117): MeshProgram runs the fragment
body once per DataNode through the traced executor (static output
classes, no host read), K12 in its fixed-capacity form and K3 at each
gather's class, and on the card captures it as one CUDA graph, so a warm
statement is one graph replay.  The program is cached in the MESH tier
of exec/plancache.py under the reference's key (literal-masked fragment
plans, exchanges, per-table padding, dictionaries and codecs, the
ladder values) plus the staged tables' versions.  Numeric literals of
the DataNode fragments (exec/fused.py _mask_node) and numeric init-plan
results ride one device input buffer with the snapshot and the txid, so
a statement with other dates replays the same program.  The reference's
size-class ladder: exchange buckets start at the sources' padding over
the DataNode count (multiplier 1), gathers at min(padding, 65536) rows,
traced joins at the executor's class; after every call the host reads
one small overflow vector (LADDER_READS), an overflowing class doubles
until it fits, the output is discarded and the plan runs again, and the
learned values persist per plan shape, so a warm call runs once.  Every
plan the tier carries runs as a program (no screen declines one; a
capture error raises).  With `MeshRunner._capture` False, the comparison
arm, plans run on the eager tier: each fragment op by op, once per
DataNode, every size exact (each exchange reads its count matrix on the
host).  Rows arrive in the reference's order on both: within a
destination, in source-DataNode order, then in source-row order.

Staging follows the reference's _stage_table: TEXT columns are remapped
into one union dictionary per column across all DataNodes (codes are
comparable across shards), codec descriptors are chosen once per column
over all shards, and the staged table is one entry of the cluster's
buffer pool keyed by the tuple of per-DataNode store versions (a warm
repeat stages nothing; any write on any DataNode restages it, and a
program key carries the versions).  Not ported: the append-only tail
path (_stage_incremental).

A plan the tier cannot carry raises NotImplementedError (MeshUnsupported)
instead of falling back to the host tier, in whole or in part.  Where
the reference runs a fragment over a gathered input on its host tier
and the rest on the mesh, the port runs that fragment once on the card
over the gathered rows when it reads no table and hands its rows back to
the DataNodes (K11 + K12); any other such plan raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..catalog.schema import NUM_SHARDS
from ..catalog.types import TypeKind
from ..ops import kernels as K
from ..plan import exprs as E
from ..plan import physical as P
from ..plan.distribute import BatchSource, DistPlan, ExchangeRef
from ..sql.fingerprint import struct_key
from ..storage import codec
from ..storage.batch import next_pow2, size_class
from ..storage.bufferpool import ClusterEntry
from ..utils import locks
from ..utils.hashing import hash_string
from . import plancache
from .executor import DBatch, ExecContext, Executor
from .expr_compile import device_const
from .fused import (CapturedProgram, _codec_class, _lit_view, _lit_word,
                    _MaskedHostRead, _mask_node)

# one lock for this module's counter and the runners' learned state
_STATE_LOCK = locks.Lock("exec.mesh_exec._STATE_LOCK")
_LADDER_MAX = 256

#: host reads the program tier made (the ladder check, one per run)
LADDER_READS = 0            # guarded_by: _STATE_LOCK


class MeshUnsupported(NotImplementedError):
    """This plan (or cluster) cannot run on the device tier: the port
    raises instead of dropping to the host tier."""

    def __init__(self, what: str):
        super().__init__(f"device tier: {what} is not yet ported")


class _DictView:
    def __init__(self, values):
        self.values = values


class _ClusterStoreView:
    """TableStore facade the staged scan reads: schema + UNION
    dictionaries (codes comparable across every DataNode)."""

    def __init__(self, td, union_dicts: dict):
        self.td = td
        self.dicts = {c: _DictView(v) for c, v in union_dicts.items()}


@dataclasses.dataclass
class _StagedTable:
    arrs: dict          # name -> [ndn * padded] tensor; __enc aux whole
    counts: list        # per-DataNode live row count
    padded: int         # rows each DataNode owns
    view: _ClusterStoreView
    vkey: tuple         # per-DataNode store versions at staging time

    def shard(self, d: int):
        """(tensors of DataNode d's row range, its live rows): views."""
        lo, hi = d * self.padded, (d + 1) * self.padded
        arrs = {n: (a if n.startswith(codec.ENC_PREFIX) else a[lo:hi])
                for n, a in self.arrs.items()}
        return arrs, self.counts[d]


_ALLOWED = (P.SeqScan, P.Filter, P.Project, P.HashJoin, P.Agg, P.Sort,
            P.Limit, P.Window, P.Append, ExchangeRef)


def _exchange_layout(parts: list[DBatch]):
    """The columns and null masks an exchange of the DataNodes' batches
    moves, each batch read in place: (column names, null-mask names,
    per-source tensors with None where a batch never set a null mask)."""
    for b in parts:
        b.ensure_all()   # exchange: rows physically move
    first = parts[0]
    for b in parts[1:]:
        if set(b.cols) != set(first.cols):
            raise MeshUnsupported("an exchange of DataNode batches with "
                                  "different columns")
        for n, d in first.dicts.items():
            if b.dicts.get(n) is not d and b.dicts.get(n) != d:
                raise MeshUnsupported("an exchange of TEXT columns with "
                                      "per-DataNode dictionaries")
    names = list(first.cols)
    nnames: list = []
    for b in parts:
        nnames += [n for n in b.nulls if n not in nnames]
    sources = [tuple(b.cols[n].contiguous() for n in names)
               + tuple(b.nulls[n].contiguous() if n in b.nulls else None
                       for n in nnames) for b in parts]
    return names, nnames, sources


class MeshRunner:
    #: False keeps every plan on the eager per-fragment tier
    _capture = True

    def __init__(self, cluster):
        self.cluster = cluster
        self.device = cluster.device
        self._smap = None
        # (exchange index, kind, ndn_src x ndn_dst row counts) of every
        # exchange of the last run: a numpy array from the eager tier, a
        # device tensor from a program (read it after the call)
        self.last_exchanges: list = []
        # learned ladder values per plan shape: (join factors, exchange
        # bucket multipliers, gather classes)
        self._ladder: dict = {}          # guarded_by: _STATE_LOCK
        # plan shapes whose literal-masked program read a masked literal
        # on the host: run with their literals baked
        self._mask_refused: dict = {}    # guarded_by: _STATE_LOCK

    # ------------------------------------------------------------------
    # plan screening
    # ------------------------------------------------------------------
    def _screen(self, dp: DistPlan) -> set:
        """Validate the plan: every fragment but the coordinator's runs
        on the DataNodes over device-resident inputs, or once over
        gathered rows (the indices returned)."""
        if dp.fqs_node is not None:
            raise MeshUnsupported("a fast-query-shipping plan")
        for ex in dp.exchanges:
            if ex.kind not in ("redistribute", "broadcast", "gather",
                               "gather_one"):
                raise MeshUnsupported(f"exchange {ex.kind}")
            for k in ex.keys or []:
                if not isinstance(k, (E.Col, E.TextExpr)):
                    raise MeshUnsupported("a non-column exchange key")
        once = self._check_fragments(dp)
        for frag in dp.fragments:
            if frag.index != dp.top_fragment:
                self._screen_node(frag.plan)
        return once

    def _check_fragments(self, dp) -> set:
        """The coordinator's fragment must consume gathers of DataNode
        fragments.  A fragment that consumes a gather and hands its rows
        back to the DataNodes (a window over all rows feeding a join,
        e.g. TPC-DS q44) runs ONCE, on the card, over the gathered rows,
        and K11 + K12 route its output on (the reference runs such
        fragments on its host tier, the rest on the mesh).  It reads
        gathers only and no table; any other fragment over a gather
        raises.  Returns the indices of the fragments that run once."""
        gathers = {ex.index for ex in dp.exchanges
                   if ex.kind in ("gather", "gather_one")}
        once: set = set()
        for frag in dp.fragments:
            refs = {n.index for n in self._walk(frag.plan)
                    if isinstance(n, ExchangeRef)}
            if frag.index == dp.top_fragment:
                if refs - gathers:
                    raise MeshUnsupported("a coordinator fragment over a "
                                          "DataNode-side exchange")
                continue
            fed = refs & gathers
            if not fed:
                continue
            routed = all(ex.kind in ("redistribute", "broadcast")
                         for ex in dp.exchanges
                         if ex.source_fragment == frag.index)
            if fed != refs or not routed or any(
                    isinstance(n, P.SeqScan) for n in self._walk(frag.plan)):
                raise MeshUnsupported("a DataNode fragment over a gathered "
                                      "input")
            once.add(frag.index)
        if not gathers:
            raise MeshUnsupported("a plan without a gather to the "
                                  "coordinator")
        return once

    @staticmethod
    def _walk(node):
        yield node
        for attr in ("child", "left", "right"):
            c = getattr(node, attr, None)
            if c is not None and hasattr(c, "__dataclass_fields__"):
                yield from MeshRunner._walk(c)
        for c in getattr(node, "inputs", None) or []:
            if hasattr(c, "__dataclass_fields__"):
                yield from MeshRunner._walk(c)

    def _screen_node(self, node):
        if not isinstance(node, _ALLOWED):
            raise MeshUnsupported(f"plan node {type(node).__name__}")
        if isinstance(node, P.HashJoin):
            if node.kind == "cross":
                raise MeshUnsupported("a cross join")
            self._screen_node(node.left)
            self._screen_node(node.right)
            return
        if isinstance(node, P.SeqScan) and node.table.name.startswith(
                "otb_"):
            raise MeshUnsupported("a statistics view scan")
        for attr in ("child", "left", "right"):
            c = getattr(node, attr, None)
            if isinstance(c, P.PhysNode):
                self._screen_node(c)
        for c in getattr(node, "inputs", None) or []:
            if isinstance(c, P.PhysNode):
                self._screen_node(c)

    # ------------------------------------------------------------------
    # staging: per-DataNode host columns -> one tensor per column
    # ------------------------------------------------------------------
    @staticmethod
    def _snapshot(dn, name: str) -> dict:
        """One DataNode's live columns + dictionaries at its current
        version."""
        st = dn.stores.get(name)
        if st is None:
            raise MeshUnsupported(f"table {name} missing on dn{dn.index}")
        cols = st.host_live_columns([c.name for c in st.td.columns])
        n = len(next(iter(cols.values()))) if cols else st.row_count()
        return {"version": st.version, "count": n, "cols": cols,
                "dicts": {c: list(d.values) for c, d in st.dicts.items()},
                "null_columns": set(st.null_columns)}

    def _stage_table(self, name: str) -> _StagedTable:
        pool = self.cluster.pool
        dns = self.cluster.datanodes
        for dn in dns:
            if name not in dn.stores:
                raise MeshUnsupported(f"table {name} missing on "
                                      f"dn{dn.index}")
        vkey = tuple(dn.stores[name].version for dn in dns)
        ent = pool.cluster_get(name, vkey)
        if ent is not None:
            return ent.staged
        snaps = [self._snapshot(dn, name) for dn in dns]
        vkey = tuple(s["version"] for s in snaps)
        td = self.cluster.catalog.table(name)
        ndn = len(snaps)

        # union dictionaries + per-DataNode code LUTs
        union_dicts: dict[str, list] = {}
        luts: dict[str, list[np.ndarray]] = {}
        for c in td.columns:
            if c.type.kind != TypeKind.TEXT:
                continue
            values: list[str] = []
            index: dict[str, int] = {}
            col_luts = []
            for s in snaps:
                vals = s["dicts"].get(c.name, [])
                lut = np.empty(max(len(vals), 1), dtype=np.int32)
                for i, v in enumerate(vals):
                    j = index.get(v)
                    if j is None:
                        j = len(values)
                        values.append(v)
                        index[v] = j
                    lut[i] = j
                col_luts.append(lut)
            union_dicts[c.name] = values
            luts[c.name] = col_luts

        null_columns = set()
        for s in snaps:
            null_columns |= s["null_columns"]
        per_dn: list[dict[str, np.ndarray]] = []
        counts = []
        for si, s in enumerate(snaps):
            # this DataNode's TEXT codes remapped into the union dictionary
            cols = dict(s["cols"])
            counts.append(s["count"])
            for c in td.columns:
                if c.type.kind == TypeKind.TEXT and len(cols[c.name]):
                    cols[c.name] = luts[c.name][si][cols[c.name]]
            for nc in null_columns:
                if f"__null.{nc}" not in cols:
                    cols[f"__null.{nc}"] = np.zeros(counts[-1], bool)
            per_dn.append(cols)

        padded = size_class(max(max(counts), 1))
        # codec: ONE descriptor per eligible column, proven against every
        # DataNode's values at once, so codes stay comparable across the
        # DataNodes like the TEXT union dictionary.  TEXT code columns
        # stay raw (union codes live in another value space than the
        # per-store codes the single-node ladder entry was proven on).
        text_names = {c.name for c in td.columns
                      if c.type.kind == TypeKind.TEXT}
        arrs = {}
        for colname, sample in per_dn[0].items():
            parts = [np.asarray(per_dn[si][colname]) for si in range(ndn)]
            r = None if colname in text_names else codec.encode_staged(
                name, colname, np.concatenate(parts) if ndn > 1 else parts[0])
            if r is not None:
                codes, enc, aux = r
                offs = np.cumsum([0] + [len(p) for p in parts])
                parts = [codes[offs[i]:offs[i + 1]] for i in range(ndn)]
                arrs[codec.aux_name(colname, enc)] = pool.upload(aux)
            buf = np.zeros((ndn, padded, *sample.shape[1:]),
                           dtype=parts[0].dtype)
            for si in range(ndn):
                buf[si, :len(parts[si])] = parts[si]
            arrs[colname] = pool.upload(
                buf.reshape(ndn * padded, *buf.shape[2:]))
        staged = _StagedTable(arrs, list(counts), padded,
                              _ClusterStoreView(td, union_dicts), vkey)
        pool.cluster_put(ClusterEntry(name, vkey, staged))
        return staged

    # ------------------------------------------------------------------
    # exchanges
    # ------------------------------------------------------------------
    def _shard_map(self) -> torch.Tensor:
        if self._smap is None:
            self._smap = torch.from_numpy(np.asarray(
                self.cluster.catalog.shard_map, np.int32)).to(self.device)
        return self._smap

    def _route_hash(self, parts: list[DBatch], keys) -> list:
        """Destination of every row of each DataNode's batch (K11, one
        launch a batch): the routing hash of the keys, bit-identical to
        the host tier's _route and the locator's placement, through the
        shard map.  A TEXT key hashes its value via a LUT of hash_string
        over the (shared) dictionary, a device constant cached by
        content (a program's warm-up run builds it, its capture reads
        it); a NULL non-TEXT key hashes as 0 (the reference's rule)."""
        first = parts[0]
        names, luts = [], []
        for k in keys:
            if isinstance(k, E.TextExpr) or (
                    isinstance(k, E.Col)
                    and first.types[k.name].kind == TypeKind.TEXT):
                col = k.col if isinstance(k, E.TextExpr) else k
                d = first.dicts.get(col.name, [])
                transform = k.apply if isinstance(k, E.TextExpr) \
                    else (lambda s: s)
                lut = np.asarray([hash_string(transform(v)) for v in d]
                                 or [0], dtype=np.uint64).view(np.int64)
                names.append((col.name, False))
                luts.append(device_const(lut, self.device))
            else:
                names.append((k.name, True))
                luts.append(None)
        return [K.route_dest([b.cols[n] for n, _ in names],
                             [b.nulls.get(n) if nullable else None
                              for n, nullable in names],
                             luts, b.valid, self._shard_map(),
                             self.cluster.ndn, NUM_SHARDS)
                for b in parts]

    def _exchange(self, run: "_Run", ex, parts: list[DBatch], dests,
                  ndst: int, region=None) -> list[DBatch]:
        """K12 over the DataNodes' batches, read in place: the
        destinations' shares of the output, as DBatches (views of one
        tensor per column).  Eager: the sized form (the count matrix read
        on the host sizes the region); traced: the fixed-capacity form
        at `region`, its overflow kept on the device."""
        names, nnames, sources = _exchange_layout(parts)
        valid = [b.valid.contiguous() for b in parts]
        if run.traced:
            outs, ovalid, counts, over = K.exchange_fixed(
                sources, dests, valid, ndst, region)
            run.note_exchange(ex, counts, over, len(parts),
                              max(b.padded for b in parts))
        else:
            outs, ovalid, counts, region = K.exchange(sources, dests, valid,
                                                      ndst)
            run.exchanges.append((ex.index, ex.kind, counts))
        first = parts[0]
        shares = []
        for d in range(ndst):
            sl = slice(d * region, (d + 1) * region)
            shares.append(DBatch(
                {n: outs[i][sl] for i, n in enumerate(names)}, ovalid[sl],
                dict(first.types), dict(first.dicts),
                {n: outs[len(names) + i][sl] for i, n in enumerate(nnames)}))
        return shares

    def _a2a_batch(self, run: "_Run", ex, parts: list[DBatch],
                   keys) -> list[DBatch]:
        """Hash-redistribute the DataNodes' batches: K11 gives every row
        its destination, K12 moves the rows (and drops dead ones, so the
        exchange also compacts).  One DataNode: the identity.  Traced,
        each destination's region is the reference's bucket (sized from
        the sources' static padding and the exchange's ladder
        multiplier) times the number of sources."""
        ndn = self.cluster.ndn
        if ndn == 1:
            return parts
        for b in parts:
            b.ensure_all()   # exchange: rows physically move
        region = None
        if run.traced:
            region = len(parts) * _bucket(
                max(b.padded for b in parts), ndn, run.mults[ex.index])
        return self._exchange(run, ex, parts, self._route_hash(parts, keys),
                              ndn, region)

    def _broadcast_batch(self, run: "_Run", ex,
                         parts: list[DBatch]) -> list[DBatch]:
        """Every DataNode reads the concatenation of all DataNodes' live
        rows in DataNode order: one shared batch (K12 with every live row
        bound for one destination), not ndn copies.  Traced, the region
        is the sum of the sources' padding (the reference's all_gather):
        it cannot overflow."""
        if self.cluster.ndn == 1:
            return parts
        region = sum(b.padded for b in parts) if run.traced else None
        (full,) = self._exchange(run, ex, parts, None, 1, region)
        return [DBatch(dict(full.cols), full.valid, dict(full.types),
                       dict(full.dicts), dict(full.nulls))
                for _ in range(self.cluster.ndn)]

    # ------------------------------------------------------------------
    # gathers
    # ------------------------------------------------------------------
    @staticmethod
    def _compact_local(b: DBatch, out_size: int):
        """One DataNode's gather output compacted to its live prefix
        (K3) in a buffer of `out_size` rows: (cols, valid, nulls, the
        live count on the device).  A count above out_size keeps the
        first out_size live rows.  Indirection-aware: a lazy column's
        index vector is compacted and its payload gathered through it,
        so a fragment ending in a join chain never materializes the full
        join output."""
        tensors = list(b.cols.values()) + list(b.nulls.values())
        slot: dict = {}
        for lc in b.lazy.values():
            for t in (lc.idx, lc.null_out):
                if t is not None and id(t) not in slot:
                    slot[id(t)] = len(tensors)
                    tensors.append(t)
        count, outs = K.compact(b.valid.contiguous(),
                                tuple(t.contiguous() for t in tensors),
                                out_size)
        cols = dict(zip(b.cols, outs))
        nulls = dict(zip(b.nulls, outs[len(b.cols):]))
        for n, lc in b.lazy.items():
            cidx = outs[slot[id(lc.idx)]]
            cols[n] = lc.src[cidx]
            m = lc.null_src[cidx] if lc.null_src is not None else None
            if lc.null_out is not None:
                no = outs[slot[id(lc.null_out)]]
                m = no if m is None else (m | no)
            if m is not None:
                nulls[n] = m
        valid = torch.arange(out_size, device=b.valid.device) < count
        return cols, valid, nulls, count

    @staticmethod
    def _topk_spec(ob: DBatch, ex):
        """(key names, descs, limit) when this gather can cut to a
        per-DataNode top-k: sort keys are plain non-TEXT columns without
        null masks (the ORDER BY agg/col LIMIT n tail, e.g. TPC-H Q3).
        None = ship the whole compacted gather."""
        if not ex.sort_keys or not ex.limit:
            return None
        names, descs = [], []
        for k, desc in ex.sort_keys:
            if not isinstance(k, E.Col) or not ob.has_col(k.name) \
                    or ob.maybe_null(k.name) \
                    or ob.types[k.name].kind == TypeKind.TEXT:
                return None
            names.append(k.name)
            descs.append(bool(desc))
        return names, tuple(descs), int(ex.limit)

    @staticmethod
    def _topk_local(cols, valid, nulls, spec):
        """Sort the compacted gather buffer by the sort keys and keep the
        first `limit` rows (K10; reference: SimpleSort on RemoteSubplan,
        each DataNode cuts before the coordinator merges)."""
        names, descs, limit = spec
        keys = tuple(cols[n] for n in names)
        pnames = sorted(cols)
        nnames = sorted(nulls)
        payload = tuple([cols[n] for n in pnames]
                        + [nulls[n] for n in nnames])
        out, s_valid = K.sort_rows(keys, valid, payload, descs, limit)
        new_cols = {n: out[i] for i, n in enumerate(pnames)}
        new_nulls = {n: out[len(pnames) + i] for i, n in enumerate(nnames)}
        return new_cols, s_valid, new_nulls

    def _gather(self, run: "_Run", ex, parts: list[DBatch]) -> DBatch:
        """The coordinator's input: every DataNode's compacted (and, with
        sort keys and a limit, cut) output, in DataNode order.  Eager,
        each DataNode compacts into its batch's padding; traced, into
        the gather's class, and the largest live count is checked
        against it after the call (reference :853)."""
        pieces, counts = [], []
        for ob in parts:
            spec = self._topk_spec(ob, ex)
            size = run.gathers[ex.index] if run.traced else ob.padded
            cols, valid, nulls, count = self._compact_local(ob, size)
            counts.append(count)
            if spec is not None:
                cols, valid, nulls = self._topk_local(cols, valid, nulls,
                                                      spec)
            pieces.append((cols, valid, nulls))
        if run.traced:
            run.gather_need.append((ex.index, torch.stack(counts).max()))
        first = parts[0]
        if len(pieces) == 1:
            cols, valid, nulls = pieces[0]
        else:
            cols = {n: torch.cat([p[0][n] for p in pieces])
                    for n in pieces[0][0]}
            valid = torch.cat([p[1] for p in pieces])
            null_names = []
            for p in pieces:
                null_names += [n for n in p[2] if n not in null_names]
            nulls = {n: torch.cat([
                p[2][n] if n in p[2] else torch.zeros(
                    p[1].shape[0], dtype=torch.bool, device=p[1].device)
                for p in pieces]) for n in null_names}
        return DBatch(cols, valid, dict(first.types), dict(first.dicts),
                      nulls)

    # ------------------------------------------------------------------
    @staticmethod
    def _bind(node, ex_batches: dict):
        if isinstance(node, ExchangeRef):
            batch = ex_batches.get(node.index)
            if batch is None:
                raise MeshUnsupported(f"exchange {node.index} consumed "
                                      "before it ran")
            return BatchSource(batch)
        clone = dataclasses.replace(node)
        for attr in ("child", "left", "right"):
            c = getattr(clone, attr, None)
            if isinstance(c, P.PhysNode):
                setattr(clone, attr, MeshRunner._bind(c, ex_batches))
        if getattr(clone, "inputs", None):
            clone.inputs = [MeshRunner._bind(c, ex_batches)
                            for c in clone.inputs]
        return clone

    def _run_fragments(self, run: "_Run", dp: DistPlan, plans: dict,
                       once: set, make_ctx) -> dict:
        """Every DataNode fragment of `dp` (plans[index] is the plan it
        runs) once per DataNode, or once on the card, and the exchanges
        its output feeds; returns {gather exchange index: the
        coordinator's input}.  `make_ctx(d)` is DataNode d's
        ExecContext.  The one body of both tiers: eager (`run.traced`
        False) every size is exact, traced it is the program's."""
        ndn = self.cluster.ndn
        ex_batches: dict = {}      # exchange index -> per-DataNode batches
        gathered: dict = {}
        for frag in dp.fragments:
            if frag.index == dp.top_fragment:
                continue
            consumers = [ex for ex in dp.exchanges
                         if ex.source_fragment == frag.index]
            only_one = consumers and all(ex.kind == "gather_one"
                                         for ex in consumers)
            outs = []
            for d in ([0] if only_one or frag.index in once
                      else range(ndn)):
                plan = self._bind(plans[frag.index],
                                  {i: bs[d] for i, bs in ex_batches.items()}
                                  if frag.index not in once else gathered)
                exe = Executor(make_ctx(d), frag_tag=frag.index)
                exe._traced = run.traced
                outs.append(exe.exec_node(plan))
                run.joins.extend(exe.join_required)
            for ex in consumers:
                if ex.kind == "redistribute":
                    ex_batches[ex.index] = self._a2a_batch(run, ex, outs,
                                                           ex.keys)
                elif ex.kind == "broadcast":
                    ex_batches[ex.index] = self._broadcast_batch(run, ex,
                                                                 outs)
                else:   # gather / gather_one: the coordinator's input
                    gathered[ex.index] = self._gather(
                        run, ex, outs[:1] if ex.kind == "gather_one"
                        else outs)
        missing = [ex.index for ex in dp.exchanges
                   if ex.kind in ("gather", "gather_one")
                   and ex.index not in gathered]
        if missing:
            raise MeshUnsupported(f"gather {missing}")
        return gathered

    def _stage_plan(self, dp: DistPlan) -> dict:
        tables = set()
        for frag in dp.fragments:
            if frag.index != dp.top_fragment:
                for nd in self._walk(frag.plan):
                    if isinstance(nd, P.SeqScan):
                        tables.add(nd.table.name)
        staged = {t: self._stage_table(t) for t in sorted(tables)}
        if not staged:
            raise MeshUnsupported("a plan without stageable scans")
        return staged

    def run(self, dp: DistPlan, snapshot_ts: int, txid: int,
            params: dict) -> dict:
        """Execute every DataNode fragment of `dp` and its exchanges;
        returns {gather exchange index: the coordinator's input}.  The
        whole DataNode side runs as one program (MeshProgram); with
        `_capture` off each fragment runs eagerly."""
        once = self._screen(dp)
        staged = self._stage_plan(dp)
        if self._capture:
            return self._run_program(dp, staged, once, snapshot_ts, txid,
                                     params)
        return self._run_eager(dp, staged, once, snapshot_ts, txid, params)

    def _shards(self, staged: dict):
        views = {t: s.view for t, s in staged.items()}
        return views, [{t: s.shard(d) for t, s in staged.items()}
                       for d in range(self.cluster.ndn)]

    def _run_eager(self, dp, staged, once, snapshot_ts, txid,
                   params) -> dict:
        """The eager device tier: each fragment runs op by op once per
        DataNode, every size exact (each exchange reads its count
        matrix on the host)."""
        views, shards = self._shards(staged)
        run = _Run(traced=False)

        def make_ctx(d):
            return ExecContext(views, snapshot_ts, txid, self.cluster.pool,
                               params=dict(params), staged=shards[d])
        gathered = self._run_fragments(
            run, dp, {f.index: f.plan for f in dp.fragments}, once,
            make_ctx)
        self.last_exchanges = run.exchanges
        return gathered

    # ------------------------------------------------------------------
    # the whole DataNode side as one program (K16)
    # ------------------------------------------------------------------
    @staticmethod
    def _plan_key(node):
        """Structural key of a fragment plan (reference mesh_exec.py
        _plan_key)."""
        t = type(node).__name__
        if isinstance(node, ExchangeRef):
            return (t, node.index)
        if isinstance(node, P.SeqScan):
            return (t, node.table.name, node.alias, tuple(node.filters),
                    tuple(node.outputs or ()))
        if isinstance(node, P.HashJoin):
            return (t, node.kind, tuple(node.left_keys),
                    tuple(node.right_keys), tuple(node.residual or ()),
                    MeshRunner._plan_key(node.left),
                    MeshRunner._plan_key(node.right))
        if isinstance(node, P.Filter):
            return (t, tuple(node.quals), MeshRunner._plan_key(node.child))
        if isinstance(node, P.Project):
            return (t, tuple(node.outputs), MeshRunner._plan_key(node.child))
        if isinstance(node, P.Agg):
            return (t, node.mode, tuple(node.group_keys), tuple(node.aggs),
                    MeshRunner._plan_key(node.child))
        if isinstance(node, P.Sort):
            return (t, tuple((k, bool(d)) for k, d in node.keys),
                    node.limit, MeshRunner._plan_key(node.child))
        if isinstance(node, P.Limit):
            return (t, node.count, node.offset,
                    MeshRunner._plan_key(node.child))
        if isinstance(node, P.Window):
            return (t, tuple(node.calls), MeshRunner._plan_key(node.child))
        if isinstance(node, P.Append):
            return (t, tuple(MeshRunner._plan_key(c) for c in node.inputs))
        raise MeshUnsupported(f"plan node {t}")

    def _shape_key(self, dp: DistPlan, plans: dict, staged: dict) -> tuple:
        """The plan shape and the data scale (reference _ladder_key): the
        fragments' literal-masked plan keys, the exchanges, and per table
        its padding, staged columns and codec classes."""
        return (
            tuple((i, self._plan_key(p)) for i, p in sorted(plans.items())),
            tuple((ex.index, ex.kind, tuple(ex.keys or ()),
                   ex.source_fragment, tuple(ex.sort_keys or ()), ex.limit)
                  for ex in dp.exchanges),
            tuple((t, s.padded, tuple(sorted(s.arrs)), _codec_class(s.arrs))
                  for t, s in sorted(staged.items())))

    def _run_program(self, dp: DistPlan, staged: dict, once: set,
                     snapshot_ts: int, txid: int, params: dict,
                     allow_mask: bool = True) -> dict:
        """The DataNode side as one program: look it up in the MESH tier
        (or build it), run it (a replay once captured), read the
        overflow vector once, grow the ladder and rerun on overflow, and
        capture a program whose classes fit."""
        lits: list = []
        plans = {}
        for frag in dp.fragments:
            if frag.index == dp.top_fragment:
                continue
            n0 = len(lits)
            masked = _mask_node(frag.plan, lits) if allow_mask \
                else frag.plan
            plans[frag.index] = masked if len(lits) > n0 else frag.plan
        traced_names = tuple(sorted(
            k for k, (v, _t) in params.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)))
        baked = {k: params[k] for k in params if k not in traced_names}
        shape = self._shape_key(dp, plans, staged)
        base = struct_key((
            shape,
            tuple(sorted((k, v) for k, (v, _t) in baked.items())),
            tuple((k, params[k][1]) for k in traced_names),
            tuple(t for _n, _v, t in lits),
            tuple((t, tuple(sorted((c, len(d.values))
                                   for c, d in s.view.dicts.items())))
                  for t, s in sorted(staged.items()))))
        if lits and base in self._mask_refused:
            return self._run_program(dp, staged, once, snapshot_ts, txid,
                                     params, allow_mask=False)
        lkey = struct_key(shape)
        ladder = self._ladder.get(lkey)
        base_pad = max(s.padded for s in staged.values())
        if ladder is None:
            ladder = ({}, {}, {})
        factors, mults, gathers = (dict(x) for x in ladder)
        for ex in dp.exchanges:
            if ex.kind == "redistribute":
                mults.setdefault(ex.index, 1)
            elif ex.kind in ("gather", "gather_one"):
                gathers.setdefault(ex.index, min(base_pad, 1 << 16))
        names = list(traced_names) + [nm for nm, _v, _t in lits]
        types = [params[k][1] for k in traced_names] \
            + [t for _n, _v, t in lits]
        values = [params[k][0] for k in traced_names] \
            + [v for _n, v, _t in lits]
        versions = tuple((t, s.vkey) for t, s in sorted(staged.items()))
        for _attempt in range(24):
            key = (id(self), base, tuple(sorted(factors.items())),
                   tuple(sorted(mults.items())),
                   tuple(sorted(gathers.items())), versions)
            prog = plancache.MESH.get(key)
            if prog is None:
                prog = plancache.MESH.put(key, MeshProgram(
                    self, dp, plans, staged, once, baked, names, types,
                    (factors, mults, gathers)))
            gathered, vec, counts = prog.run(snapshot_ts, txid, values)
            grew = _grow(prog.meta, vec, factors, mults, gathers)
            self._ladder_remember(lkey, (factors, mults, gathers))
            if grew:
                continue
            try:
                prog.capture_if_new()
            except _MaskedHostRead:
                plancache.MESH.pop(key)
                if lits:
                    self._mask_refused_add(base)
                    return self._run_program(dp, staged, once, snapshot_ts,
                                             txid, params, allow_mask=False)
                raise
            self.last_exchanges = prog.exchange_counts(counts)
            return gathered
        raise MeshUnsupported("the size-class ladder exhausted")

    def _ladder_remember(self, lkey, ladder):
        with _STATE_LOCK:
            self._ladder[lkey] = tuple(dict(x) for x in ladder)
            while len(self._ladder) > _LADDER_MAX:
                self._ladder.pop(next(iter(self._ladder)))

    def _mask_refused_add(self, base):
        with _STATE_LOCK:
            self._mask_refused[base] = True
            while len(self._mask_refused) > _LADDER_MAX:
                self._mask_refused.pop(next(iter(self._mask_refused)))


def _bucket(src_pad: int, ndn: int, mult: int) -> int:
    """Rows one source may send one destination (reference
    mesh_exec.py:610 _a2a_batch): sized from the source batch's static
    padding, `mult` its ladder multiplier; next_pow2(src_pad) can never
    overflow."""
    return min(next_pow2(src_pad),
               max(64, next_pow2(-(-src_pad // ndn)) * mult))


class _Run:
    """What one run of the fragment body collects: each exchange's
    (index, kind, counts); traced, the ladder classes it read and the
    values checked after the call (per redistribute its largest
    destination overflow, per traced join its required pairs, per
    gather its largest DataNode live count)."""

    def __init__(self, traced: bool, mults=None, gathers=None):
        self.traced = traced
        self.mults = mults            # exchange index -> multiplier
        self.gathers = gathers        # gather index -> class
        self.exchanges: list = []
        self.a2a: list = []          # (exchange index, nsrc, src_pad, over)
        self.joins: list = []        # (join id, required, out_size)
        self.gather_need: list = []  # (gather index, max live count)

    def note_exchange(self, ex, counts, over, nsrc: int, src_pad: int):
        self.exchanges.append((ex.index, ex.kind, counts))
        if ex.kind == "redistribute":
            self.a2a.append((ex.index, nsrc, src_pad, over.max()))


def _grow(meta: dict, vec, factors: dict, mults: dict,
          gathers: dict) -> bool:
    """The ladder check, the tier's one host read: `vec` holds every
    redistribute's largest overflow, every traced join's required pairs
    and every gather's largest live count (meta["checks"] says which is
    which).  Each class that overflowed doubles until it fits what the
    read says.  Returns True when a class grew."""
    global LADDER_READS
    checks = meta["checks"]
    if not checks:
        return False
    with _STATE_LOCK:
        LADDER_READS += 1
    need = vec.cpu().tolist()
    grew = False
    join_need: dict = {}
    for (kind, key, info), v in zip(checks, need):
        if kind == "a2a":
            if v <= 0:
                continue
            nsrc, src_pad, ndn, region = info
            want = region + v
            while nsrc * _bucket(src_pad, ndn, mults[key]) < want:
                mults[key] *= 2
            grew = True
        elif kind == "join":
            cap = info
            join_need[key] = max(join_need.get(key, (0, cap))[0], v), cap
        else:
            while gathers[key] < v:
                gathers[key] *= 2
                grew = True
    for jid, (v, cap) in join_need.items():
        if v <= cap:
            continue
        mult = 1
        while cap * mult < v:
            mult *= 2
        factors[jid] = factors.get(jid, 1) * mult
        if factors[jid] > 4096:
            raise MeshUnsupported("the join size ladder exhausted")
        grew = True
    return grew


class MeshProgram(CapturedProgram):
    """The DataNode side of one plan at one key (reference
    mesh_exec.py:950 _execute, :1111-1117): every DataNode fragment with
    its exchanges, ladder checks and gathers, through the traced
    executor (Executor._traced: static output classes, no host read),
    reading the snapshot, the txid and the masked numeric values from
    one device input buffer; on the card its captured CUDA graph (the
    capture, the replay and the output copies: fused.CapturedProgram).

    run(snapshot_ts, txid, values) returns ({gather index: DBatch},
    the overflow vector, the exchanges' count matrices as one int64
    tensor), all on the device."""

    tier = plancache.MESH
    replay_tag = "mesh_program"

    def __init__(self, runner, dp, plans: dict, staged: dict, once: set,
                 baked: dict, names: list, types: list, ladder):
        super().__init__(runner.device, 2 + len(names))
        self.runner = runner
        self.dp = dp
        self.plans = dict(plans)
        # the program reads these staged tensors in place and keeps them
        # alive for as long as it may replay
        self.staged = dict(staged)
        self.once = set(once)
        self.baked = dict(baked)
        self.names = list(names)
        self.types = list(types)
        self.ladder = tuple(dict(x) for x in ladder)
        self.meta: dict = {}

    def _traced_run(self):
        from .executor import stats_tier
        snap, txid = self.inputs[0], self.inputs[1]
        lits = self.inputs[2:].view(1, len(self.names))
        params = dict(self.baked)
        for j, (nm, t) in enumerate(zip(self.names, self.types)):
            params[nm] = (_lit_view(lits, 0, j, t), t)
        views, shards = self.runner._shards(self.staged)
        factors = self.ladder[0]
        pool = self.runner.cluster.pool

        def make_ctx(d):
            return ExecContext(views, snap, txid, pool, params=dict(params),
                               staged=shards[d], join_factors=factors)
        run = _Run(traced=True, mults=self.ladder[1],
                   gathers=self.ladder[2])
        with stats_tier("mesh"):
            gathered = self.runner._run_fragments(run, self.dp, self.plans,
                                                  self.once, make_ctx)
        ndn = self.runner.cluster.ndn
        checks, vals = [], []
        for ei, nsrc, src_pad, over in run.a2a:
            checks.append(("a2a", ei, (nsrc, src_pad, ndn, nsrc * _bucket(
                src_pad, ndn, self.ladder[1][ei]))))
            vals.append(over)
        for jid, req, cap in run.joins:
            checks.append(("join", jid, cap))
            vals.append(req.reshape(()).to(torch.int64))
        for gi, cnt in run.gather_need:
            checks.append(("gather", gi, None))
            vals.append(cnt.reshape(()).to(torch.int64))
        vec = torch.stack(vals) if vals else torch.zeros(
            0, dtype=torch.int64, device=self.device)
        self.meta["checks"] = tuple(checks)
        self.meta["gathers"] = {gi: (b.types, b.dicts)
                                for gi, b in gathered.items()}
        self.meta["exchanges"] = tuple(
            (i, kind, tuple(c.shape)) for i, kind, c in run.exchanges)
        counts = torch.cat([c.reshape(-1) for _i, _k, c in run.exchanges]) \
            if run.exchanges else torch.zeros(0, dtype=torch.int64,
                                              device=self.device)
        outs = {gi: (dict(b.cols), b.valid, dict(b.nulls))
                for gi, b in gathered.items()}
        return outs, vec, counts

    def run(self, snapshot_ts, txid, values):
        outs, vec, counts = self._call(self._host_words(
            [int(snapshot_ts), int(txid)]
            + [_lit_word(v, t) for v, t in zip(values, self.types)]))
        meta = self.meta["gathers"]
        return ({gi: DBatch(dict(cols), valid, dict(meta[gi][0]),
                            dict(meta[gi][1]), dict(nulls))
                 for gi, (cols, valid, nulls) in outs.items()}, vec, counts)

    def exchange_counts(self, counts) -> list:
        """(exchange index, kind, its [nsrc, ndst] count matrix as a
        device tensor) of every exchange of the last run."""
        out, off = [], 0
        for i, kind, shape in self.meta.get("exchanges", ()):
            n = shape[0] * shape[1]
            out.append((i, kind, counts[off:off + n].view(shape)))
            off += n
        return out


def mesh_runner_for(cluster) -> MeshRunner:
    """The cluster's device-tier runner (built on first use)."""
    r = getattr(cluster, "_mesh_runner", None)
    if r is None:
        r = cluster._mesh_runner = MeshRunner(cluster)
    return r
