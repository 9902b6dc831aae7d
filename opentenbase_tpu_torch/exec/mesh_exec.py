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

Execution is eager: each fragment runs once per DataNode through the
ordinary Executor over that DataNode's row range of the cluster-staged
tables (views, no copies), with its exchange inputs bound as BatchSource
leaves, so every size is exact and the reference's size-class ladder,
overflow psums and program cache have nothing to do here.  Rows arrive
in the reference's order: within a destination, in source-DataNode
order, then in source-row order.

Staging follows the reference's _stage_table: TEXT columns are remapped
into one union dictionary per column across all DataNodes (codes are
comparable across shards), codec descriptors are chosen once per column
over all shards, and the staged table is one entry of the cluster's
buffer pool keyed by the tuple of per-DataNode store versions (a warm
repeat stages nothing; any write on any DataNode restages it).  Not
ported: the append-only tail path (_stage_incremental).

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
from ..storage import codec
from ..storage.batch import size_class
from ..storage.bufferpool import ClusterEntry
from ..utils.hashing import hash_string
from .executor import DBatch, ExecContext, Executor


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
    def __init__(self, cluster):
        self.cluster = cluster
        self.device = cluster.device
        self._smap = None
        # (exchange index, kind, ndn_src x ndn_dst row counts) of every
        # exchange of the last run
        self.last_exchanges: list = []

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
                              _ClusterStoreView(td, union_dicts))
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
        over the (shared) dictionary; a NULL non-TEXT key hashes as 0
        (the reference's rule)."""
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
                luts.append(torch.from_numpy(lut).to(self.device))
            else:
                names.append((k.name, True))
                luts.append(None)
        return [K.route_dest([b.cols[n] for n, _ in names],
                             [b.nulls.get(n) if nullable else None
                              for n, nullable in names],
                             luts, b.valid, self._shard_map(),
                             self.cluster.ndn, NUM_SHARDS)
                for b in parts]

    def _exchange(self, ex, parts: list[DBatch], dests,
                  ndst: int) -> list[DBatch]:
        """K12 over the DataNodes' batches, read in place: the
        destinations' shares of the output, as DBatches (views of one
        tensor per column)."""
        names, nnames, sources = _exchange_layout(parts)
        outs, ovalid, counts, region = K.exchange(
            sources, dests, [b.valid.contiguous() for b in parts], ndst)
        self.last_exchanges.append((ex.index, ex.kind, counts))
        first = parts[0]
        shares = []
        for d in range(ndst):
            sl = slice(d * region, (d + 1) * region)
            shares.append(DBatch(
                {n: outs[i][sl] for i, n in enumerate(names)}, ovalid[sl],
                dict(first.types), dict(first.dicts),
                {n: outs[len(names) + i][sl] for i, n in enumerate(nnames)}))
        return shares

    def _a2a_batch(self, ex, parts: list[DBatch], keys) -> list[DBatch]:
        """Hash-redistribute the DataNodes' batches: K11 gives every row
        its destination, K12 moves the rows (and drops dead ones, so the
        exchange also compacts).  One DataNode: the identity."""
        if self.cluster.ndn == 1:
            return parts
        for b in parts:
            b.ensure_all()   # exchange: rows physically move
        return self._exchange(ex, parts, self._route_hash(parts, keys),
                              self.cluster.ndn)

    def _broadcast_batch(self, ex, parts: list[DBatch]) -> list[DBatch]:
        """Every DataNode reads the concatenation of all DataNodes' live
        rows in DataNode order: one shared batch (K12 with every live row
        bound for one destination), not ndn copies."""
        if self.cluster.ndn == 1:
            return parts
        (full,) = self._exchange(ex, parts, None, 1)
        return [DBatch(dict(full.cols), full.valid, dict(full.types),
                       dict(full.dicts), dict(full.nulls))
                for _ in range(self.cluster.ndn)]

    # ------------------------------------------------------------------
    # gathers
    # ------------------------------------------------------------------
    @staticmethod
    def _compact_local(b: DBatch):
        """One DataNode's gather output compacted to its live prefix
        (K3) in a buffer of its own padded size: (cols, valid, nulls).
        Indirection-aware: a lazy column's index vector is compacted and
        its payload gathered through it, so a fragment ending in a join
        chain never materializes the full join output."""
        tensors = list(b.cols.values()) + list(b.nulls.values())
        slot: dict = {}
        for lc in b.lazy.values():
            for t in (lc.idx, lc.null_out):
                if t is not None and id(t) not in slot:
                    slot[id(t)] = len(tensors)
                    tensors.append(t)
        count, outs = K.compact(b.valid.contiguous(),
                                tuple(t.contiguous() for t in tensors),
                                b.padded)
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
        valid = torch.arange(b.padded, device=b.valid.device) < count
        return cols, valid, nulls

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

    def _gather(self, ex, parts: list[DBatch]) -> DBatch:
        """The coordinator's input: every DataNode's compacted (and, with
        sort keys and a limit, cut) output, in DataNode order."""
        pieces = []
        for ob in parts:
            spec = self._topk_spec(ob, ex)
            cols, valid, nulls = self._compact_local(ob)
            if spec is not None:
                cols, valid, nulls = self._topk_local(cols, valid, nulls,
                                                      spec)
            pieces.append((cols, valid, nulls))
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

    def run(self, dp: DistPlan, snapshot_ts: int, txid: int,
            params: dict) -> dict:
        """Execute every DataNode fragment of `dp` and its exchanges;
        returns {gather exchange index: the coordinator's input}."""
        once = self._screen(dp)
        tables = set()
        for frag in dp.fragments:
            if frag.index != dp.top_fragment:
                for nd in self._walk(frag.plan):
                    if isinstance(nd, P.SeqScan):
                        tables.add(nd.table.name)
        staged = {t: self._stage_table(t) for t in sorted(tables)}
        if not staged:
            raise MeshUnsupported("a plan without stageable scans")
        ndn = self.cluster.ndn
        views = {t: s.view for t, s in staged.items()}
        shards = [{t: s.shard(d) for t, s in staged.items()}
                  for d in range(ndn)]
        self.last_exchanges = []
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
                plan = self._bind(frag.plan, {i: bs[d] for i, bs
                                              in ex_batches.items()}
                                  if frag.index not in once else gathered)
                ctx = ExecContext(views, snapshot_ts, txid,
                                  self.cluster.pool, params=dict(params),
                                  staged=shards[d])
                outs.append(Executor(ctx).exec_node(plan))
            for ex in consumers:
                if ex.kind == "redistribute":
                    ex_batches[ex.index] = self._a2a_batch(ex, outs,
                                                           ex.keys)
                elif ex.kind == "broadcast":
                    ex_batches[ex.index] = self._broadcast_batch(ex, outs)
                else:   # gather / gather_one: the coordinator's input
                    gathered[ex.index] = self._gather(
                        ex, outs[:1] if ex.kind == "gather_one" else outs)
        missing = [ex.index for ex in dp.exchanges
                   if ex.kind in ("gather", "gather_one")
                   and ex.index not in gathered]
        if missing:
            raise MeshUnsupported(f"gather {missing}")
        return gathered


def mesh_runner_for(cluster) -> MeshRunner:
    """The cluster's device-tier runner (built on first use)."""
    r = getattr(cluster, "_mesh_runner", None)
    if r is None:
        r = cluster._mesh_runner = MeshRunner(cluster)
    return r
