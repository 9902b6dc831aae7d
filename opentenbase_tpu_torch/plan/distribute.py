"""Distributed planning: annotate a physical plan with row distributions,
insert exchange operators where they mismatch, split into fragments.

Reference analog: every Path carries a Distribution
(include/nodes/relation.h:33-46); joins pick colocated/redistributed/
replicated strategies (optimizer/util/pathnode.c:4575
set_joinpath_distribution); redistribute_path/create_remotesubplan_path
insert exchanges (pathnode.c:2449,1851); aggregates split partial/final
(RemoteQuery.rq_finalise_aggs, include/pgxc/planner.h:135); the executor
cuts the tree at exchange boundaries into fragments
(execFragment.c:558 ExecInitFragmentTree).

FQS (fast query shipping) lives in fqs_target_node(): whole-query
single-node shipping when dist-key equality pins every sharded table to one
datanode (pgxc_FQS_planner, pgxc/plan/planner.c:390 +
pgxc_is_query_shippable, pgxcship.c:2431).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..catalog.catalog import Catalog
from ..catalog.schema import DistType
from ..parallel.locator import Locator
from . import exprs as E
from . import physical as P
from .planner import PlannedStmt, expr_cols
from .query import BoundQuery, SubLink


@dataclasses.dataclass
class Dist:
    kind: str                    # 'sharded' | 'replicated' | 'cn'
    keys: tuple[str, ...] = ()   # qualified cols rows are hash-placed by
    # () with kind='sharded' = partitioned by unknown key
    # node group owning the placement: alignment optimizations only
    # apply within one group's shard map (reference: pgxc_group)
    group: str = "default_group"


@dataclasses.dataclass
class ExchangeRef(P.PhysNode):
    """Fragment-input leaf: the output of exchange `index` for this node."""
    index: int = 0
    types: dict = dataclasses.field(default_factory=dict)

    def title(self):
        return f"ExchangeRef #{self.index}"


@dataclasses.dataclass
class BatchSource(P.PhysNode):
    """Executor-injected leaf holding a ready batch."""
    batch: object = None

    def title(self):
        return "BatchSource"


@dataclasses.dataclass
class Fragment:
    index: int
    plan: P.PhysNode
    location: str                 # 'dn' | 'cn'
    # exchange feeding this fragment's parent: set on edges below


@dataclasses.dataclass
class Exchange:
    index: int
    kind: str                     # 'redistribute' | 'broadcast' | 'gather'
    keys: list[E.Expr]
    source_fragment: int
    sort_keys: list = dataclasses.field(default_factory=list)
    limit: object = None          # per-DN top-k cut (gather only)


@dataclasses.dataclass
class DistPlan:
    fragments: list[Fragment]
    exchanges: list[Exchange]
    top_fragment: int
    init_plans: list
    output_names: list[str]
    fqs_node: Optional[int] = None     # set => whole plan runs on one DN
    via_gidx: str = ""                 # global index(es) that pinned it


def _subtree_est(node) -> Optional[float]:
    """Worst-case row estimate of a fragment subtree from its scan
    estimates (set by the planner from ANALYZE stats); None = unknown."""
    ests = []
    stack = [node]
    while stack:
        nd = stack.pop()
        if isinstance(nd, (P.SeqScan, P.IndexScan)):
            e = getattr(nd, "est_rows", None)
            if e is None:
                return None
            ests.append(float(e))
        for attr in ("child", "left", "right"):
            c = getattr(nd, attr, None)
            if isinstance(c, P.PhysNode):
                stack.append(c)
    if not ests:
        return None
    out = 1.0
    for e in ests:
        out *= max(e, 1.0)
    return out


# ---------------------------------------------------------------------------
# FQS analysis
# ---------------------------------------------------------------------------

def _has_sublinks(bq: BoundQuery) -> bool:
    for _, e in bq.targets:
        if any(isinstance(x, SubLink) for x in E.walk(e)):
            return True
    for q in bq.where:
        if any(isinstance(x, SubLink) for x in E.walk(q)):
            return True
    return False


def dist_key_pins(rte, where, allow_params: bool = False):
    """The `dist col = <pin>` conjuncts for one range-table entry, or
    None when not every dist col is pinned.  A pin is an E.Lit (point
    routing canonicalizes it to the representation bulk routing used),
    or — with allow_params — a '__bindparam' column name resolved at
    EXECUTE time.  Shared by plain FQS, prepared-statement FQS, and
    global-index routing so the three can never disagree."""
    dist_cols = [f"{rte.alias}.{c}"
                 for c in rte.table.distribution.dist_cols]
    values = {}
    for q in where:
        if isinstance(q, E.Cmp) and q.op == "=" \
                and isinstance(q.left, E.Col) \
                and q.left.name in dist_cols:
            if isinstance(q.right, E.Lit):
                values[q.left.name] = q.right
            elif allow_params and isinstance(q.right, E.Col) \
                    and q.right.name.startswith("__bindparam"):
                values[q.left.name] = q.right.name
    if set(values) != set(dist_cols):
        return None
    return [values[c] for c in dist_cols]


def fqs_target_node(bq: BoundQuery, catalog: Catalog) -> Optional[int]:
    """Single datanode that can answer the whole query, or None.

    Shippable when every sharded table is pinned by a dist-key = literal
    conjunct to the same node and replicated tables fill the rest.  Any
    subquery/sublink disables FQS here (the reference walks deeper;
    pgxcship.c handles many more cases — future widening).
    """
    if not isinstance(bq, BoundQuery):
        return None   # set operations: no single-node shipping yet
    loc = Locator(catalog)
    target: Optional[int] = None
    if _has_sublinks(bq):
        return None
    for rte in bq.rtable:
        if rte.kind != "table":
            return None
        dt = rte.table.distribution.dist_type
        if dt == DistType.REPLICATED:
            continue
        if dt not in (DistType.SHARD, DistType.HASH, DistType.MODULO):
            return None
        pins = dist_key_pins(rte, bq.where)
        if pins is None:
            return None
        node = loc.node_for_values(rte.table, pins)
        if node is None:
            return None
        if target is None:
            target = node
        elif target != node:
            return None
    return target


def fqs_param_router(bq: BoundQuery, catalog: Catalog):
    """FQS for PREPAREd statements: like fqs_target_node, but dist keys
    may be pinned by `= $n` parameters whose values arrive at EXECUTE.
    Returns a route(params: {name: (value, type)}) -> Optional[int]
    closure, or None when the statement can never ship whole (reference:
    the light-coordinator single-node resolution, execLight.c:34-59).
    """
    if not isinstance(bq, BoundQuery):
        return None
    loc = Locator(catalog)
    if _has_sublinks(bq):
        return None
    # per sharded table: the pin expr (Lit or __bindparam name) per col
    pinned: list[tuple] = []   # (TableDef, [E.Lit | param name])
    for rte in bq.rtable:
        if rte.kind != "table":
            return None
        dt = rte.table.distribution.dist_type
        if dt == DistType.REPLICATED:
            continue
        if dt not in (DistType.SHARD, DistType.HASH, DistType.MODULO):
            return None
        pins = dist_key_pins(rte, bq.where, allow_params=True)
        if pins is None:
            return None
        pinned.append((rte.table, pins))

    def route(params: dict):
        target = None
        for td, specs in pinned:
            vals = []
            for s in specs:
                if isinstance(s, str):
                    if s not in params:
                        return None
                    v, vt = params[s]
                    # wrap as a typed literal so point routing applies
                    # the literal-scale canonicalization (a raw scaled
                    # DECIMAL int would be re-scaled -> wrong node)
                    vals.append(E.Lit(v, vt))
                else:
                    vals.append(s)
            node = loc.node_for_values(td, vals)
            if node is None or (target is not None and node != target):
                return None
            if target is None:
                target = node
        return target

    return route


# ---------------------------------------------------------------------------
# distribution annotation + exchange insertion
# ---------------------------------------------------------------------------

class Distributor:
    def __init__(self, catalog: Catalog, n_datanodes: int):
        self.catalog = catalog
        self.ndn = n_datanodes
        self.exchanges: list[Exchange] = []
        self.fragments: list[Fragment] = []

    # -- main entry --
    def distribute(self, planned: PlannedStmt,
                   bq: BoundQuery) -> DistPlan:
        fqs = fqs_target_node(bq, self.catalog) if bq is not None else None
        if fqs is not None:
            frag = Fragment(0, planned.plan, "dn")
            return DistPlan([frag], [], 0, planned.init_plans,
                            planned.output_names, fqs_node=fqs)

        # distribute init plans too (each becomes its own DistPlan run by
        # the executor before the main plan)
        plan, dist = self._walk(planned.plan)
        if dist.kind != "cn":
            plan = self._add_gather(plan, one=(dist.kind == "replicated"))
        top = self._fragmentize(plan, "cn")
        return DistPlan(self.fragments, self.exchanges, top,
                        planned.init_plans, planned.output_names)

    # -- annotation walk: returns (new_plan, Dist) --
    def _walk(self, node: P.PhysNode):
        if isinstance(node, (P.SeqScan, P.IndexScan)):
            dt = node.table.distribution
            if dt.dist_type == DistType.REPLICATED:
                return node, Dist("replicated")
            keys = tuple(f"{node.alias}.{c}" for c in dt.dist_cols) \
                if dt.dist_type == DistType.SHARD else ()
            return node, Dist("sharded", keys, dt.group)

        if isinstance(node, P.AnnSearch):
            dt = node.table.distribution
            if dt.dist_type == DistType.REPLICATED:
                return node, Dist("replicated")
            # per-DN top-k, merge by distance at CN (pgvector on XC does
            # exactly this shape: DN IVFFlat scans under a CN merge)
            from ..catalog import types as T
            gathered = self._add_gather(node)
            cn_sort = P.Sort(gathered,
                             [(E.Col(node.dist_name, T.FLOAT64), False)],
                             node.k)
            return cn_sort, Dist("cn")

        if isinstance(node, P.Filter):
            node.child, d = self._walk(node.child)
            return node, d

        if isinstance(node, P.Project):
            node.child, d = self._walk(node.child)
            # track dist keys through renames
            if d.kind == "sharded" and d.keys:
                out = []
                for k in d.keys:
                    hit = [n for n, e in node.outputs
                           if isinstance(e, E.Col) and e.name == k]
                    if not hit:
                        return node, Dist("sharded", ())
                    out.append(hit[0])
                return node, Dist("sharded", tuple(out))
            return node, d

        if isinstance(node, P.Window):
            node.child, d = self._walk(node.child)
            if d.kind != "sharded":
                return node, d
            # local only when every call partitions by (at least) the
            # distribution keys — partitions then never span nodes
            # (reference: window paths keep Distribution when partition
            # clause covers the distribution key)
            common = None
            for _, wc in node.calls:
                this = {k.name for k in wc.partition
                        if isinstance(k, E.Col)}
                common = this if common is None else (common & this)
            if d.keys and common and set(d.keys) <= common:
                return node, d
            node.child = self._add_gather(node.child)
            return node, Dist("cn")

        if isinstance(node, P.HashJoin):
            return self._walk_join(node)

        if isinstance(node, P.Agg):
            return self._walk_agg(node)

        if isinstance(node, P.Sort):
            node.child, d = self._walk(node.child)
            if d.kind == "sharded":
                # per-DN top-k, merge at CN, re-limit there.  With a
                # limit the DN side sorts AND cuts to limit(+offset)
                # first, so the gather ships ndn*limit rows instead of
                # every group (reference: SimpleSort on RemoteSubplan,
                # planner.h:38-47 — the DN pre-sorts, the combiner
                # merges; the top-k union provably contains the global
                # top-k under the same total order)
                gathered = self._add_gather(node.child,
                                            sort_keys=node.keys,
                                            limit=node.limit)
                cn_sort = P.Sort(gathered, node.keys, node.limit)
                return cn_sort, Dist("cn")
            return node, d

        if isinstance(node, P.Limit):
            node.child, d = self._walk(node.child)
            if d.kind == "sharded":
                node.child = self._add_gather(node.child)
                d = Dist("cn")
            return node, d

        if isinstance(node, P.Append):
            # UNION ALL / partition-parent expansion: when every branch
            # is sharded the append runs PER-SHARD on the datanodes
            # (partitioned by unknown key — downstream joins/aggs add
            # their own redistribution), which keeps the device data
            # plane for union-fed joins.  All-replicated appends stay
            # replicated.  Mixed shapes gather to the CN (correct
            # everywhere, slower).
            walked = [self._walk(c) for c in node.inputs]
            kinds = {cd.kind for _cp, cd in walked}
            if kinds == {"sharded"}:
                node.inputs = [cp for cp, _cd in walked]
                return node, Dist("sharded", ())
            if kinds == {"replicated"}:
                node.inputs = [cp for cp, _cd in walked]
                return node, Dist("replicated")
            new_inputs = []
            for cp, cd in walked:
                if cd.kind != "cn":
                    cp = self._add_gather(cp,
                                          one=(cd.kind == "replicated"))
                new_inputs.append(cp)
            node.inputs = new_inputs
            return node, Dist("cn")

        if isinstance(node, P.SetOp):
            # INTERSECT/EXCEPT dedupe semantics: combine at the CN
            new_inputs = []
            for c in node.inputs:
                cp, cd = self._walk(c)
                if cd.kind != "cn":
                    cp = self._add_gather(cp,
                                          one=(cd.kind == "replicated"))
                new_inputs.append(cp)
            node.inputs = new_inputs
            return node, Dist("cn")

        if isinstance(node, P.Result):
            return node, Dist("cn")

        raise ValueError(f"cannot distribute {type(node).__name__}")

    # -- joins --
    def _join_pairs(self, node: P.HashJoin):
        return list(zip(node.left_keys, node.right_keys))

    def _walk_join(self, node: P.HashJoin):
        node.left, ld = self._walk(node.left)
        node.right, rd = self._walk(node.right)
        # one datanode: every placement is trivially colocated — skip
        # exchanges entirely (reference: single-node plans carry no
        # RemoteSubplan; also the single-chip TPU bench shape)
        if self.ndn == 1 and ld.kind in ("sharded", "replicated") \
                and rd.kind in ("sharded", "replicated"):
            return node, (ld if ld.kind == "sharded" else rd)
        pairs = self._join_pairs(node)

        def sharded_on_join_key(d: Dist, side: int):
            """Ordered join-pair indexes covering ALL of d.keys, or
            None.  Multi-column distribution keys align only when every
            key column appears as a join key, in distribution-key order
            (the hash is order-sensitive)."""
            if d.kind != "sharded" or not d.keys:
                return None
            idxs = []
            for key in d.keys:
                hit = None
                for i, pr in enumerate(pairs):
                    k = pr[side]
                    if isinstance(k, E.Col) and k.name == key:
                        hit = i
                        break
                if hit is None:
                    return None
                idxs.append(hit)
            return tuple(idxs)

        li = sharded_on_join_key(ld, 0)
        ri = sharded_on_join_key(rd, 1)

        if node.kind == "cross":
            if rd.kind != "replicated":
                node.right = self._add_broadcast(node.right)
            return node, (ld if ld.kind != "replicated"
                          else Dist("replicated"))

        if node.kind == "full":
            # FULL JOIN emits unmatched rows from BOTH sides: broadcast
            # would duplicate them per node.  Colocated/replicated pairs
            # stay local; otherwise join at the coordinator.
            if (li is not None and ri is not None and li == ri) or \
                    (ld.kind == "replicated" and rd.kind == "replicated"):
                return node, (ld if ld.kind != "replicated" else rd)
            if ld.kind != "cn":
                node.left = self._add_gather(
                    node.left, one=(ld.kind == "replicated"))
            if rd.kind != "cn":
                node.right = self._add_gather(
                    node.right, one=(rd.kind == "replicated"))
            return node, Dist("cn")

        # colocated: both sharded on the same join pairs (same order)
        # within the SAME node group's shard map
        if li is not None and ri is not None and li == ri \
                and ld.group == rd.group:
            return node, ld
        if ld.kind == "replicated" and rd.kind == "replicated":
            return node, Dist("replicated")
        if rd.kind == "replicated" and ld.kind == "sharded":
            return node, ld
        if ld.kind == "replicated" and rd.kind == "sharded":
            if node.kind == "inner":
                return node, rd
            # left/semi/anti with replicated probe side: broadcast build
            node.right = self._add_broadcast(node.right)
            return node, ld

        # need movement.  Prefer keeping the already-aligned side —
        # only when its placement rides the DEFAULT shard map, which is
        # what exchanges route by (a group table's alignment cannot be
        # matched by a default-map redistribute)
        if li is not None and ld.group == "default_group":
            node.right = self._add_redistribute(
                node.right, [pairs[i][1] for i in li])
            return node, ld
        if ri is not None and rd.group == "default_group":
            node.left = self._add_redistribute(
                node.left, [pairs[i][0] for i in ri])
            return node, rd
        if not pairs:
            # no equi keys (pure residual join): broadcast build side
            node.right = self._add_broadcast(node.right)
            return node, ld
        # cost choice (reference: create_remotesubplan_path weighing
        # replication vs redistribution): a SMALL build side broadcasts
        # once instead of moving both sides — needs ANALYZE estimates
        if node.kind == "inner":
            rest = _subtree_est(node.right)
            lest = _subtree_est(node.left)
            if rest is not None and rest <= 4096 and \
                    (lest is None or lest > 8 * rest):
                node.right = self._add_broadcast(node.right)
                return node, ld
        # redistribute both by the full key set
        node.left = self._add_redistribute(node.left,
                                           [p[0] for p in pairs])
        node.right = self._add_redistribute(node.right,
                                            [p[1] for p in pairs])
        lk = pairs[0][0]
        return node, Dist("sharded",
                          (lk.name,) if isinstance(lk, E.Col) and
                          len(pairs) == 1 else ())

    # -- aggregation --
    def _walk_agg(self, node: P.Agg):
        node.child, d = self._walk(node.child)
        if d.kind in ("replicated", "cn"):
            return node, d
        if self.ndn == 1:
            return node, d      # one DN: groups are whole already
        key_names = set()
        for _, ke in node.group_keys:
            if isinstance(ke, E.Col):
                key_names.add(ke.name)
        if d.kind == "sharded" and d.keys and set(d.keys) <= key_names:
            return node, d          # groups are node-local

        distinct = any(ac.distinct for _, ac in node.aggs)
        if node.group_keys and not distinct:
            # partial per DN -> redistribute by group keys -> final
            partial = P.Agg(node.child, node.group_keys, node.aggs,
                            "partial")
            red = self._add_redistribute(
                partial, [E.Col(n, ke.type)
                          for (n, ke) in node.group_keys])
            final = P.Agg(red, [(n, E.Col(n, ke.type))
                                for (n, ke) in node.group_keys],
                          node.aggs, "final")
            return final, Dist("sharded",
                               (node.group_keys[0][0],)
                               if len(node.group_keys) == 1 else ())
        if node.group_keys:
            # distinct aggs: move whole groups to their owner node first
            red = self._add_redistribute(
                node.child, [ke for (_, ke) in node.group_keys])
            node.child = red
            return node, Dist("sharded", ())
        if distinct:
            # global count(DISTINCT): per-DN distinct counts cannot be
            # summed (values straddle nodes) — gather the rows, dedupe at CN
            node.child = self._add_gather(node.child)
            return node, Dist("cn")
        # global aggregate: partial per DN -> gather -> final at CN
        partial = P.Agg(node.child, [], node.aggs, "partial")
        gathered = self._add_gather(partial)
        final = P.Agg(gathered, [], node.aggs, "final")
        return final, Dist("cn")

    # -- exchange insertion --
    def _add_redistribute(self, child: P.PhysNode,
                          keys: list[E.Expr]) -> P.PhysNode:
        return P.Redistribute(child, keys)

    def _add_broadcast(self, child: P.PhysNode) -> P.PhysNode:
        return P.Broadcast(child)

    def _add_gather(self, child: P.PhysNode, sort_keys=None,
                    one: bool = False, limit=None) -> P.PhysNode:
        return P.Gather(child, sort_keys or [], one, limit)

    # -- fragmentation at exchange boundaries --
    def _fragmentize(self, plan: P.PhysNode, location: str) -> int:
        """Cut at exchange nodes; returns the index of the fragment whose
        plan is `plan` with exchange children replaced by ExchangeRef."""

        def cut(node: P.PhysNode) -> P.PhysNode:
            if isinstance(node, (P.Redistribute, P.Broadcast, P.Gather)):
                child_loc = "dn"
                src = self._fragmentize(node.child, child_loc)
                kind = {"Redistribute": "redistribute",
                        "Broadcast": "broadcast",
                        "Gather": "gather"}[type(node).__name__]
                if kind == "gather" and getattr(node, "one", False):
                    kind = "gather_one"
                ex = Exchange(len(self.exchanges), kind,
                              getattr(node, "keys", []), src,
                              sort_keys=getattr(node, "sort_keys", []),
                              limit=getattr(node, "limit", None))
                self.exchanges.append(ex)
                return ExchangeRef(ex.index)
            for attr in ("child", "left", "right"):
                c = getattr(node, attr, None)
                if isinstance(c, P.PhysNode):
                    setattr(node, attr, cut(c))
            if isinstance(node, (P.Append, P.SetOp)):
                node.inputs = [cut(c) for c in node.inputs]
            return node

        body = cut(plan)
        frag = Fragment(len(self.fragments), body, location)
        self.fragments.append(frag)
        return frag.index
