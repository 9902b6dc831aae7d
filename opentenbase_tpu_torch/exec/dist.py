"""Distributed executor: runs a DistPlan's fragment DAG over the cluster.

The counterpart of opentenbase_tpu/exec/dist.py.  A statement runs on
one of these tiers:

- local: the plan scans no table, it runs at the coordinator;
- fqs: the whole plan ships to one DataNode (dist-key equality pinned
  every sharded table to it) and runs there;
- mesh, the device tier (exec/mesh_exec.py): every DataNode fragment
  runs on its DataNode's share of the cluster-staged tables, and the
  exchanges run as hand-written kernels on the card (K11 routing, K12
  exchange, K3 gather compaction), by default all of it as one
  captured program whose gathered outputs arrive here as copies; the
  coordinator's fragment then runs over them;
- host, the host-mediated exchange tier, only when the session says
  `SET enable_mesh_exchange = off`: each fragment runs per DataNode, its
  output comes to the host (TEXT decoded to strings), is hash-routed
  there with numpy (the reference's per-tuple GetDataRouting loop,
  vectorized) and re-uploaded for its consumers.

There is no silent fallback: a plan the device tier cannot carry raises
NotImplementedError ("... not yet ported"); it does not drop to the
host tier.  Not ported: replicas and failover, the spill tier
(work_mem_rows), resource groups and per-fragment instrumentation.
"""

from __future__ import annotations

import copy as _copy
import dataclasses

import numpy as np
import torch

from ..catalog.schema import NUM_SHARDS
from ..catalog.types import SqlType, TypeKind
from ..plan import exprs as E
from ..plan import physical as P
from ..plan.distribute import (BatchSource, DistPlan, Distributor,
                               ExchangeRef, Fragment)
from ..plan.planner import PlannedStmt
from ..storage.batch import next_pow2
from ..utils.hashing import hash_columns_np, hash_string
from .executor import (DBatch, ExecContext, ExecError, Executor, _host,
                       scalar_from_batch)
from .mesh_exec import mesh_runner_for


def _walk_plan(node):
    yield node
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None and hasattr(c, "__dataclass_fields__"):
            yield from _walk_plan(c)
    for c in getattr(node, "inputs", None) or []:
        if hasattr(c, "__dataclass_fields__"):
            yield from _walk_plan(c)


@dataclasses.dataclass
class HostBatch:
    """Exchange wire format of the host tier: host numpy columns, TEXT
    as decoded values, NULL masks carried alongside (outer-join null
    extension survives exchange boundaries)."""
    cols: dict[str, np.ndarray]       # TEXT columns: object arrays of str
    types: dict[str, SqlType]
    nrows: int
    nulls: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


def _to_host(b: DBatch) -> HostBatch:
    b.ensure_all()   # exchange boundary: rows physically move
    valid = _host(b.valid)
    idx = np.nonzero(valid)[0]
    cols = {}
    nulls = {}
    for n, arr in b.cols.items():
        a = _host(arr)[idx]
        t = b.types[n]
        if t.kind == TypeKind.TEXT:
            d = np.asarray(b.dicts.get(n, []) or [""], dtype=object)
            a = d[np.clip(a, 0, len(d) - 1)]
        if n in b.nulls:
            m = _host(b.nulls[n])[idx]
            if m.any():
                nulls[n] = m
        cols[n] = a
    return HostBatch(cols, dict(b.types), len(idx), nulls)


def _concat_host(parts: list[HostBatch]) -> HostBatch:
    parts = [p for p in parts if p is not None]
    first = parts[0]
    cols = {n: np.concatenate([p.cols[n] for p in parts])
            for n in first.cols}
    nulls = {}
    null_names = set()
    for p in parts:
        null_names |= set(p.nulls)
    for n in null_names:
        nulls[n] = np.concatenate(
            [p.nulls.get(n, np.zeros(p.nrows, dtype=bool)) for p in parts])
    return HostBatch(cols, first.types, sum(p.nrows for p in parts), nulls)


def _to_device(hb: HostBatch, device) -> DBatch:
    padded = next_pow2(max(hb.nrows, 1))
    cols, dicts, nulls = {}, {}, {}

    def up(buf):
        return torch.from_numpy(buf).to(device)
    for n, arr in hb.cols.items():
        t = hb.types[n]
        if t.kind == TypeKind.TEXT:
            # re-encode under a fresh local dictionary (vectorized
            # factorize: np.unique at C speed, not a per-row dict loop)
            if len(arr):
                uniq, inv = np.unique(np.asarray(arr, dtype=object),
                                      return_inverse=True)
                values = [str(u) for u in uniq]
                codes = inv.astype(np.int32).reshape(-1)
            else:
                values, codes = [], np.empty(0, dtype=np.int32)
            buf = np.zeros(padded, dtype=np.int32)
            buf[:len(codes)] = codes
            cols[n] = up(buf)
            dicts[n] = values
        else:
            arr = np.asarray(arr)
            buf = np.zeros((padded, *np.shape(arr)[1:]), dtype=arr.dtype)
            buf[:len(arr)] = arr
            cols[n] = up(buf)
    for n, m in hb.nulls.items():
        buf = np.zeros(padded, dtype=bool)
        buf[:len(m)] = m
        nulls[n] = up(buf)
    valid = up(np.arange(padded) < hb.nrows)
    return DBatch(cols, valid, dict(hb.types), dicts, nulls)


class DistExecutor:
    def __init__(self, cluster, snapshot_ts: int, txid: int,
                 use_mesh: bool = True):
        self.cluster = cluster
        self.snapshot_ts = snapshot_ts
        self.txid = txid
        self.params: dict[str, tuple] = {}
        self.use_mesh = use_mesh
        # which data plane ran the main plan: 'mesh' (the device tier),
        # 'fqs' (whole query on one DataNode), 'local' or 'host'
        self.tier: str = ""

    # ------------------------------------------------------------------
    def run(self, dp: DistPlan) -> DBatch:
        for ip in dp.init_plans:
            # init plans are whole little queries: distribute + run them
            # (distribution mutates the plan tree, so on a fresh copy)
            d = Distributor(self.cluster.catalog, self.cluster.ndn)
            sub = d.distribute(
                PlannedStmt(_copy.deepcopy(ip.plan), [], []), None)
            batch = self._run_distplan(sub)
            self.params[ip.name] = (scalar_from_batch(batch), ip.type)
        return self._run_distplan(dp)

    def _run_distplan(self, dp: DistPlan) -> DBatch:
        if dp.fqs_node is None and len(dp.fragments) == 1 \
                and not dp.exchanges:
            # CN-local statement: the main plan scans no tables
            self.tier = "local"
            return self._exec_fragment_on(dp.fragments[dp.top_fragment],
                                          dp, "cn", {})
        if self.use_mesh and dp.fqs_node is None:
            gathered = mesh_runner_for(self.cluster).run(
                dp, self.snapshot_ts, self.txid, self.params)
            self.tier = "mesh"
            return self._exec_fragment_on(
                dp.fragments[dp.top_fragment], dp, "cn",
                {(gi, "cn"): b for gi, b in gathered.items()})
        if dp.fqs_node is not None:
            # whole query shipped to one DataNode (FQS); the in-process
            # DataNode returns the device batch directly
            self.tier = "fqs"
            dn = self.cluster.datanodes[dp.fqs_node]
            frag = dp.fragments[dp.top_fragment]
            return dn.exec_plan_device(frag.plan, self.snapshot_ts,
                                       self.txid, self.params, {})
        # the host tier: exchange outputs keyed (exchange index, dest)
        # where dest is a DataNode index or 'cn'
        self.tier = "host"
        ex_out: dict = {}
        for frag in dp.fragments:   # appended children-first
            if frag.index == dp.top_fragment:
                continue
            self._feed_exchanges(frag, dp, ex_out)
        return self._exec_fragment_on(dp.fragments[dp.top_fragment], dp,
                                      "cn", ex_out)

    # ------------------------------------------------------------------
    def _feed_exchanges(self, frag: Fragment, dp: DistPlan, ex_out: dict):
        """Run `frag` on every DataNode and route its output through the
        exchange(s) that consume it."""
        consumers = [ex for ex in dp.exchanges
                     if ex.source_fragment == frag.index]
        only_one = consumers and all(ex.kind == "gather_one"
                                     for ex in consumers)
        needed = {n.index for n in _walk_plan(frag.plan)
                  if isinstance(n, ExchangeRef)}
        ndn = self.cluster.ndn
        cn_only = {i for i in needed
                   if (i, "cn") in ex_out
                   and not any((i, d) in ex_out for d in range(ndn))}
        scans_tables = any(isinstance(n, P.SeqScan)
                           for n in _walk_plan(frag.plan))
        if cn_only and scans_tables:
            # the fragment scans shards but an input was gathered to the
            # CN: replicate that input to every DataNode
            for i in cn_only:
                for d in range(ndn):
                    ex_out[(i, d)] = ex_out[(i, "cn")]
            cn_only = set()
        cn_fed = needed and not scans_tables and (
            all((i, "cn") in ex_out for i in needed) or cn_only)
        if cn_fed:
            # a fragment over gathered inputs runs once at the CN and
            # fans its output back out
            kinds = {ex.index: ex.kind for ex in dp.exchanges}
            for i in needed:
                if (i, "cn") in ex_out:
                    continue
                parts = [ex_out[(i, d)] for d in range(ndn)
                         if (i, d) in ex_out]
                ex_out[(i, "cn")] = parts[0] \
                    if kinds.get(i) == "broadcast" \
                    else _concat_host(parts)
            batch = self._exec_fragment_on(frag, dp, "cn", ex_out)
            hb = _to_host(batch)
            for ex in consumers:
                if ex.kind in ("gather", "gather_one"):
                    ex_out[(ex.index, "cn")] = hb
                elif ex.kind == "broadcast":
                    ex_out[(ex.index, "cn")] = hb
                    for d in range(ndn):
                        ex_out[(ex.index, d)] = hb
                elif ex.kind == "redistribute":
                    routed = self._route([hb], ex.keys)
                    for d in range(ndn):
                        ex_out[(ex.index, d)] = routed[d]
                else:
                    raise ExecError(f"unknown exchange kind {ex.kind}")
            return
        dn_range = [0] if only_one else list(range(ndn))
        per_dn = [self._exec_fragment_on(frag, dp, d, ex_out)
                  for d in dn_range]
        for ex in consumers:
            if ex.kind == "gather_one":
                ex_out[(ex.index, "cn")] = per_dn[0]
            elif ex.kind == "gather":
                ex_out[(ex.index, "cn")] = _concat_host(per_dn)
            elif ex.kind == "broadcast":
                full = _concat_host(per_dn)
                ex_out[(ex.index, "cn")] = full
                for d in range(ndn):
                    ex_out[(ex.index, d)] = full
            elif ex.kind == "redistribute":
                routed = self._route(per_dn, ex.keys)
                for d in range(ndn):
                    ex_out[(ex.index, d)] = routed[d]
            else:
                raise ExecError(f"unknown exchange kind {ex.kind}")

    def _route(self, per_dn: list[HostBatch],
               keys: list[E.Expr]) -> list[HostBatch]:
        """Hash-route rows to their owner DataNode (the reference's
        per-tuple GetDataRouting loop, execFragment.c:2360, vectorized)."""
        ndn = self.cluster.ndn
        shard_map = self.cluster.catalog.shard_map
        outs: list[list[HostBatch]] = [[] for _ in range(ndn)]
        for hb in per_dn:
            if hb.nrows == 0:
                continue
            karrs = []
            for k in keys:
                arr = self._eval_host_key(k, hb)
                # NULL keys canonicalize to 0 so the NULL group lands on
                # ONE node (joins never match them; group-by must not
                # split them across nodes)
                kname = k.col.name if isinstance(k, E.TextExpr) else \
                    getattr(k, "name", None)
                nm = hb.nulls.get(kname) if kname else None
                if nm is not None:
                    arr = np.where(nm, np.uint64(0), arr)
                karrs.append(arr)
            h = hash_columns_np(karrs)
            # route exactly like storage placement: hash -> 4096-entry
            # shard map -> node (NOT mod ndn: the two coincide only for
            # power-of-two node counts)
            sid = (h % np.uint64(NUM_SHARDS)).astype(np.int64)
            dest = shard_map[sid]
            for d in range(ndn):
                m = dest == d
                if m.any():
                    outs[d].append(HostBatch(
                        {n: a[m] for n, a in hb.cols.items()},
                        hb.types, int(m.sum()),
                        {n: a[m] for n, a in hb.nulls.items()}))
        return [
            _concat_host(o) if o else
            HostBatch({n: np.empty(0, dtype=(object
                                             if per_dn[0].types[n].kind
                                             == TypeKind.TEXT
                                             else per_dn[0].types[n].np_dtype))
                       for n in per_dn[0].cols},
                      per_dn[0].types, 0)
            for o in outs]

    @staticmethod
    def _hash_strings(arr: np.ndarray, transform=None) -> np.ndarray:
        """Hash a string column via its uniques (python hashing runs once
        per distinct value, the C-speed inverse maps rows)."""
        if not len(arr):
            return np.empty(0, dtype=np.uint64)
        uniq, inv = np.unique(np.asarray(arr, dtype=object),
                              return_inverse=True)
        hu = np.asarray([hash_string(transform(str(s)) if transform
                                     else str(s)) for s in uniq],
                        dtype=np.uint64)
        return hu[inv.reshape(-1)]

    def _eval_host_key(self, k: E.Expr, hb: HostBatch) -> np.ndarray:
        """Evaluate a routing key over a host batch -> uint64 hash input."""
        if isinstance(k, E.TextExpr):
            return self._hash_strings(hb.cols[k.col.name], k.apply)
        if isinstance(k, E.Col):
            arr = hb.cols[k.name]
            if hb.types[k.name].kind == TypeKind.TEXT:
                return self._hash_strings(arr)
            return arr.astype(np.int64).view(np.uint64)
        raise ExecError("redistribution keys must be simple columns "
                        f"(got {type(k).__name__})")

    # ------------------------------------------------------------------
    def _exec_fragment_on(self, frag: Fragment, dp: DistPlan, where,
                          ex_out: dict):
        """Run one fragment at `where` ('cn' or a DataNode index).
        Returns a DBatch for 'cn', a HostBatch from a DataNode."""
        sources = {ex_idx: hb for (ex_idx, dest), hb in ex_out.items()
                   if dest == where}
        if where == "cn":
            plan = _bind_sources_host(frag.plan, sources,
                                      self.cluster.device)
            ctx = ExecContext({}, self.snapshot_ts, self.txid,
                              self.cluster.pool, params=dict(self.params))
            return Executor(ctx).exec_node(plan)
        dn = self.cluster.datanodes[where]
        return dn.exec_plan(frag.plan, self.snapshot_ts, self.txid,
                            self.params, sources)


def _bind_sources_host(node: P.PhysNode, sources: dict, device):
    """Copy the fragment plan with ExchangeRef leaves replaced by
    BatchSource over the exchange input (a HostBatch from the host tier,
    uploaded here, or a device DBatch from the device tier)."""
    if isinstance(node, ExchangeRef):
        hb = sources.get(node.index)
        if hb is None:
            raise ExecError(f"exchange {node.index} has no input here")
        if isinstance(hb, DBatch):
            return BatchSource(hb)
        return BatchSource(_to_device(hb, device))
    clone = dataclasses.replace(node)
    for attr in ("child", "left", "right"):
        c = getattr(clone, attr, None)
        if isinstance(c, P.PhysNode):
            setattr(clone, attr, _bind_sources_host(c, sources, device))
    if isinstance(clone, (P.Append, P.SetOp)):
        clone.inputs = [_bind_sources_host(c, sources, device)
                        for c in clone.inputs]
    return clone
