"""Whole-fragment programs: one captured program per plan subtree (K14).

The counterpart of opentenbase_tpu/exec/fused.py.  The reference runs a
SeqScan -> Filter/Project -> [HashJoin...] -> Agg -> Sort/Limit fragment
as ONE jitted XLA program; here the same fragment runs as one CUDA graph:

- `try_fused` screens the subtree exactly as the reference does
  (`_screen_fragment`, `_key_of`, the join row floor FUSE_JOIN_MIN_ROWS),
  masks numeric literals of scan filters, quals and join residuals out of
  the plan (`_mask_node`: `__fraglitN` parameter columns), stages every
  leaf table once through the node's buffer cache, and looks the program
  up in the FUSED tier of exec/plancache.py under the reference's key
  (literal-masked plan + per-table components + dtypes), plus the join
  factors, the batch class and the staged entries' versions: a graph
  bakes the staged tensors' addresses, so a restage recaptures.
- A program (`FusedProgram`) is the regular Executor run over the plan in
  traced mode (`Executor._traced`: static output classes, no host read)
  reading the snapshot, the txid and the masked literals from one device
  input buffer.  On the card its first call runs that traced executor
  eagerly (the warm-up: it fills the constant cache, loads every kernel,
  and its rows are the call's answer); once that call's join totals fit,
  the program is captured on a side stream under `torch.cuda.graph`, and
  every later call writes the input buffer and replays the graph.  A
  replay overwrites the graph's outputs, so a call's outputs leave as
  copies made under the program's lock.  On the CPU there is no graph:
  every call is the traced run.  `CapturedProgram` holds that machinery
  for the cluster program too (exec/mesh_exec.py MeshProgram).
- The join-size ladder: after a call the host reads the per-join required
  totals once (the tier's one host read); on overflow the factor of that
  join grows to the class that fits, the overflowed output is discarded
  and the fragment runs again under the new key.  Learned factors persist
  per literal-masked shape in _JOIN_LADDER.
- The batch API (`batch_signature`, `stage_fused_batch`,
  `launch_fused_batch`, `finish_fused_batch`, `run_fused_batch`) serves
  the scheduler (exec/scheduler.py): K same-signature queries run as one
  program of batch class `_batch_class(K)` (powers of two up to 16).  An
  aggregate over a scan whose groups are dense or absent (Q1, Q6) is ONE
  fused_scan_agg launch over all K queries (Executor._scan_agg); any
  other fragment (Q3 with varying dates) runs K copies of the traced
  fragment in the one program, copy i reading slot i: lax.map's
  sequential semantics.

A capture error on a fragment the screens accepted is a port bug and
raises, except where the reference retries: a masked literal that fed a
host read reruns the fragment with its literals baked (_MASK_REFUSED).
Declines the reference's screens make run eagerly and are counted per
reason in DECLINES.

The morsel tier's per-chunk FragmentProgram is not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..catalog.types import TypeKind
from ..ops import kernels as K
from ..plan import exprs as E
from ..plan import physical as P
from ..plan.planner import rewrite as rewrite_expr
from ..sql.fingerprint import struct_key
from ..storage import codec
from ..utils import locks
from . import plancache
from .expr_compile import retain_consts

#: row floor (summed over the fragment's leaf tables) below which join
#: fragments stay on the eager tier (reference: OTB_FUSE_JOIN_MIN_ROWS)
FUSE_JOIN_MIN_ROWS = 8192

# one lock for this module's learned-state dicts
_STATE_LOCK = locks.Lock("exec.fused._STATE_LOCK")
# one capture at a time in the process
_CAPTURE_LOCK = locks.Lock("exec.fused._CAPTURE_LOCK")

# plan shapes whose literal-masked program read a masked literal on the
# host: rerun and cached baked.  Bounded FIFO.
_MASK_REFUSED: dict = {}    # guarded_by: _STATE_LOCK
_MASK_REFUSED_MAX = 512

# learned join-size ladder: literal-masked fragment shape -> {join id:
# factor}
_JOIN_LADDER: dict = {}     # guarded_by: _STATE_LOCK
_JOIN_LADDER_MAX = 512

#: fragments the reference's screens declined, by reason
DECLINES: dict = {}         # guarded_by: _STATE_LOCK
#: host reads the tier made (the join-ladder check, one per program run
#: with joins)
LADDER_READS = 0            # guarded_by: _STATE_LOCK


def _decline(reason: str):
    with _STATE_LOCK:
        DECLINES[reason] = DECLINES.get(reason, 0) + 1
    return None


def declines_snapshot() -> dict:
    with _STATE_LOCK:
        return dict(DECLINES)


def _mask_refused_add(k):
    with _STATE_LOCK:
        _MASK_REFUSED[k] = True
        while len(_MASK_REFUSED) > _MASK_REFUSED_MAX:
            _MASK_REFUSED.pop(next(iter(_MASK_REFUSED)))


def _mask_key(base_key):
    """Codec-free fingerprint of a fragment key: the batching signature
    and the _MASK_REFUSED ledger must be stable across the staging
    boundary (codec classes are chosen at stage time)."""
    plan_key, tsig, baked_key, types_key, lit_types = base_key
    return struct_key((plan_key, tuple(e[:3] for e in tsig),
                       baked_key, types_key, lit_types))


def _key_of(node) -> Optional[tuple]:
    """Structural key for a physical subtree (None = unsupported)."""
    t = type(node).__name__
    if isinstance(node, P.SeqScan):
        return (t, node.table.name, node.alias,
                tuple(node.filters), tuple(node.outputs or ()))
    if isinstance(node, P.Filter):
        c = _key_of(node.child)
        return None if c is None else (t, tuple(node.quals), c)
    if isinstance(node, P.Project):
        c = _key_of(node.child)
        return None if c is None else (t, tuple(node.outputs), c)
    if isinstance(node, P.Agg):
        c = _key_of(node.child)
        return None if c is None else (
            t, node.mode, tuple(node.group_keys), tuple(node.aggs), c)
    if isinstance(node, P.Sort):
        c = _key_of(node.child)
        return None if c is None else (
            t, tuple((k, bool(d)) for k, d in node.keys), node.limit, c)
    if isinstance(node, P.Limit):
        c = _key_of(node.child)
        return None if c is None else (t, node.count, node.offset, c)
    if isinstance(node, P.HashJoin):
        lk, rk = _key_of(node.left), _key_of(node.right)
        if lk is None or rk is None:
            return None
        return (t, node.kind, tuple(node.left_keys),
                tuple(node.right_keys), tuple(node.residual or ()),
                lk, rk)
    return None


def _find_scans(node) -> Optional[list]:
    """The SeqScan leaves of a fusable subtree, or None: every leaf
    bottoms out in a SeqScan through Filter/Project/Sort/Limit chains;
    one non-distinct Agg is allowed above the joins (Q3/Q5)."""
    scans: list = []
    state = {"agg": False}

    def chain(nd, under_join: bool) -> bool:
        while True:
            if isinstance(nd, P.SeqScan):
                scans.append(nd)
                return True
            if isinstance(nd, (P.Filter, P.Project, P.Sort, P.Limit)):
                nd = nd.child
                continue
            if isinstance(nd, P.Agg):
                if nd.mode == "final":
                    return False  # operates on exchange input
                if state["agg"] or under_join:
                    return False
                if any(ac.distinct for _, ac in nd.aggs):
                    return False
                state["agg"] = True
                nd = nd.child
                continue
            if isinstance(nd, P.HashJoin):
                if nd.kind == "cross":
                    return False  # output sized by a host count
                return chain(nd.left, True) and chain(nd.right, True)
            return False

    return scans if chain(node, False) else None


def _plan_has_join(node) -> bool:
    if isinstance(node, P.HashJoin):
        return True
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if isinstance(c, P.PhysNode) and _plan_has_join(c):
            return True
    return False


def _walk_plan_exprs(node):
    for attr in ("filters", "quals"):
        for q in getattr(node, attr, None) or []:
            yield from E.walk(q)
    for _name, e in getattr(node, "outputs", None) or []:
        yield from E.walk(e)
    if isinstance(node, P.Agg):
        for _, ke in node.group_keys:
            yield from E.walk(ke)
        for _, ac in node.aggs:
            yield from E.walk(ac)
    if isinstance(node, P.Sort):
        for ke, _ in node.keys:
            yield from E.walk(ke)
    if isinstance(node, P.HashJoin):
        for e in (list(node.left_keys) + list(node.right_keys)
                  + list(node.residual or [])):
            yield from E.walk(e)
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if isinstance(c, P.PhysNode):
            yield from _walk_plan_exprs(c)


def _has_transformed_dup_dict(node, store) -> bool:
    """A group key whose transformed dictionary maps several codes to one
    string builds a host LUT per batch: decline, as the reference does."""
    for x in _walk_plan_exprs(node):
        if isinstance(x, E.TextExpr):
            base = store.dicts.get(x.col.name.split(".", 1)[-1])
            if base is not None:
                vals = [x.apply(v) for v in base.values]
                if len(set(vals)) < len(vals):
                    return True
    return False


def _needed_columns(node, alias: str) -> set:
    need = set()
    for x in _walk_plan_exprs(node):
        if isinstance(x, E.Col) and x.name.startswith(alias + "."):
            need.add(x.name.split(".", 1)[1])
    return need


# literal kinds that mask out of the fragment signature and ride as
# program inputs (TEXT/BOOL/NULL literals change program structure and
# stay baked)
_LIFT_KINDS = (TypeKind.INT32, TypeKind.INT64, TypeKind.FLOAT64,
               TypeKind.DECIMAL, TypeKind.DATE)


def _mask_expr(e, lits: list):
    def sub(x):
        if isinstance(x, E.Lit) and x.value is not None \
                and not isinstance(x.value, bool) \
                and isinstance(x.value, (int, float)) \
                and x.type.kind in _LIFT_KINDS:
            name = f"__fraglit{len(lits)}"
            lits.append((name, x.value, x.type))
            return E.Col(name, x.type)
        return None
    return rewrite_expr(e, sub)


def _mask_node(node, lits: list):
    """Canonical fragment form: the subtree with numeric predicate
    literals replaced by __fraglitN parameter columns (walk order is the
    positional identity, so equal-shaped fragments bind their literals to
    the same slots)."""
    if isinstance(node, P.SeqScan):
        if not node.filters:
            return node
        return dataclasses.replace(
            node, filters=[_mask_expr(f, lits) for f in node.filters])
    if isinstance(node, P.Filter):
        return dataclasses.replace(
            node, quals=[_mask_expr(q, lits) for q in node.quals],
            child=_mask_node(node.child, lits))
    if isinstance(node, P.HashJoin):
        return dataclasses.replace(
            node,
            residual=[_mask_expr(q, lits) for q in (node.residual or [])],
            left=_mask_node(node.left, lits),
            right=_mask_node(node.right, lits))
    if isinstance(node, (P.Project, P.Agg, P.Sort, P.Limit)):
        return dataclasses.replace(node,
                                   child=_mask_node(node.child, lits))
    return node


def _has_window(node) -> bool:
    if isinstance(node, P.Window):
        return True
    if isinstance(node, (P.Filter, P.Project, P.Sort, P.Limit, P.Agg)):
        return _has_window(node.child)
    if isinstance(node, P.HashJoin):
        return _has_window(node.left) or _has_window(node.right)
    return False


def _screen_fragment(ctx, node):
    """(scans, stores) when `node` is a fragment over live SeqScan leaves
    that can run as one program, else None (the reason counted)."""
    if isinstance(node, P.AnnSearch):
        # the reference's screens take no AnnSearch (_key_of has no case)
        return _decline("ann_search")
    if _has_window(node):
        # nor a Window: the subtree below it is offered on its own
        return _decline("window")
    if not isinstance(node, (P.Agg, P.Project, P.Filter, P.Sort,
                             P.Limit, P.HashJoin)):
        return None   # a bare SeqScan gains nothing
    scans = _find_scans(node)
    if not scans:
        return _decline("shape")
    stores: dict = {}
    for scan in scans:
        store = ctx.stores.get(scan.table.name)
        if store is None or \
                (ctx.staged and scan.table.name in ctx.staged):
            return _decline("staged")
        stores[scan.table.name] = store
    if _key_of(node) is None:
        return _decline("key")
    for store in stores.values():
        if _has_transformed_dup_dict(node, store):
            return _decline("dup_dict")
    return scans, stores


def _codec_class(arrs: dict) -> tuple:
    """The staged codec layout of a table: (column, family, code dtype)
    per staged column (the port's codec_class; an encoding change alters
    what the program reads, so it is key-visible)."""
    encm = codec.enc_names(arrs)
    return tuple(sorted(
        (c, codec.family_of(encm[c]) if c in encm else None,
         str(a.dtype)) for c, a in arrs.items()
        if not c.startswith(codec.ENC_PREFIX)))


def _table_sig(stores: dict, entries: Optional[dict] = None) -> tuple:
    """Per-table signature components: store identity + TEXT dictionary
    lengths (dictionaries are baked into the program) + the staged codec
    classes (absent before staging: _mask_key strips them)."""
    return tuple(
        (t, id(st), tuple(sorted((c, len(d.values))
                                 for c, d in st.dicts.items())),
         _codec_class(entries[t].arrs) if entries and t in entries else ())
        for t, st in sorted(stores.items()))


def _stage(cache, stores: dict, need_by_table: dict):
    """Stage every leaf table once: table -> DevEntry (arrs, n, version)."""
    return {t: cache.get_entry(stores[t], sorted(need))
            for t, need in sorted(need_by_table.items())}


def _staging_key(cache, entries: dict) -> tuple:
    """The buffer cache and the staged versions a program reads: two
    nodes sharing a store stage it apart (on their own devices)."""
    return (id(cache),) + tuple((t, e.version)
                                for t, e in sorted(entries.items()))


def try_fused(executor, node) -> Optional[object]:
    """Execute `node` as one program, or None if the screens decline."""
    return _try_fused(executor, node, allow_mask=True)


def _try_fused(executor, node, allow_mask: bool) -> Optional[object]:
    ctx = executor.ctx
    screened = _screen_fragment(ctx, node)
    if screened is None:
        return None
    scans, stores = screened

    lits: list = []
    exec_plan = _mask_node(node, lits) if allow_mask else node
    key = _key_of(exec_plan)
    if key is None:
        return _decline("key")

    need_by_table: dict = {}
    for scan in scans:
        need_by_table.setdefault(scan.table.name, set()).update(
            _needed_columns(node, scan.alias))
    # stage before keying: the codec classes ride the key
    entries = _stage(ctx.cache, stores, need_by_table)

    table_sig = _table_sig(stores, entries)
    traced_names = tuple(sorted(
        k for k, (v, _t) in ctx.params.items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)))
    baked = {k: ctx.params[k] for k in ctx.params if k not in traced_names}
    baked_key = tuple(sorted(
        (k, v) for k, (v, _t) in baked.items()
        if isinstance(v, (str, bool, type(None)))))
    if len(baked_key) != len(baked):
        return _decline("params")  # non-scalar param
    types_key = tuple((k, ctx.params[k][1]) for k in traced_names)
    lit_types = tuple(t for _n, _v, t in lits)
    base_key = (key, table_sig, baked_key, types_key, lit_types)
    try:
        hash(base_key)
    except TypeError:
        return _decline("unhashable")
    if lits:
        with _STATE_LOCK:
            refused = _mask_key(base_key) in _MASK_REFUSED
        if refused:
            return _try_fused(executor, node, allow_mask=False)

    has_join = _plan_has_join(exec_plan)
    if has_join and sum(st.row_count() for st in stores.values()) \
            < FUSE_JOIN_MIN_ROWS:
        # tiny join fragments: the eager path's per-join host read costs
        # microseconds, a capture milliseconds
        return _decline("row_floor")

    lkey = struct_key(base_key)
    with _STATE_LOCK:
        factors = dict(_JOIN_LADDER.get(lkey, {})) if has_join else {}
    all_names = list(traced_names) + [nm for nm, _v, _t in lits]
    all_types = [ctx.params[k][1] for k in traced_names] \
        + [t for _n, _v, t in lits]
    values = [ctx.params[k][0] for k in traced_names] \
        + [v for _n, v, _t in lits]
    from .executor import DBatch, bump_stat

    for _attempt in range(24):
        full_key = base_key + (tuple(sorted(factors.items())),
                               ("__batch", 1),
                               _staging_key(ctx.cache, entries))
        prog = plancache.FUSED.get(full_key)
        if prog is None:
            prog = plancache.FUSED.put(full_key, FusedProgram(
                ctx, exec_plan, baked, all_names, all_types, factors, 1,
                entries))
        elif has_join:
            bump_stat("fused", "fused_join_hits")
        try:
            outs, req = prog.run([(ctx.snapshot_ts, ctx.txid, values)])
        except _MaskedHostRead:
            plancache.FUSED.pop(full_key)
            if lits:
                _mask_refused_add(_mask_key(base_key))
                return _try_fused(executor, node, allow_mask=False)
            raise
        grew = _grow(prog.meta["join_caps"], req, factors)
        if grew is None:
            return _decline("ladder")
        if grew:
            _ladder_remember(lkey, factors)
            continue
        if has_join:
            _ladder_remember(lkey, factors)
        prog.capture_if_new()
        cols, valid, nulls = outs[0]
        return DBatch(dict(cols), valid, dict(prog.meta["types"]),
                      dict(prog.meta["dicts"]), dict(nulls))
    return _decline("ladder")


def _grow(caps, req, factors: dict) -> Optional[bool]:
    """The ladder check, the tier's one host read: `req` holds each
    traced join's required pairs ([slots, joins]); every join whose
    class overflowed grows its factor to the class that fits.  Returns
    True when a factor grew, False when every join fit, None when the
    ladder is exhausted."""
    global LADDER_READS
    if not caps:
        return False
    with _STATE_LOCK:
        LADDER_READS += 1
    need = req.cpu().numpy().reshape(-1, len(caps)).max(axis=0)
    grew = False
    for (jid, cap), r in zip(caps, need):
        if r <= cap:
            continue
        mult = 1
        while cap * mult < r:
            mult *= 2
        factors[jid] = factors.get(jid, 1) * mult
        if factors[jid] > 4096:
            return None
        grew = True
    return grew


def _ladder_remember(lkey, factors: dict):
    with _STATE_LOCK:
        _JOIN_LADDER[lkey] = dict(factors)
        while len(_JOIN_LADDER) > _JOIN_LADDER_MAX:
            _JOIN_LADDER.pop(next(iter(_JOIN_LADDER)))


class _MaskedHostRead(RuntimeError):
    """A program's capture failed on a host read."""


@dataclasses.dataclass
class BatchInputs:
    """What every slot of one program run shares: the [K, L] int64
    literal table (f64 literals as their bits), the [K] snapshots and
    txids, the literal names' columns, and the fused scan-aggregate
    results (Executor._scan_agg: slot 0 launches, the others read)."""
    lits: torch.Tensor
    snaps: torch.Tensor
    txids: torch.Tensor
    lit_index: dict
    agg_cache: dict = dataclasses.field(default_factory=dict)


def _lit_word(v, t) -> int:
    if t.kind == TypeKind.FLOAT64:
        return int(np.asarray([float(v)], np.float64).view(np.int64)[0])
    return int(v)


def _lit_view(lits: torch.Tensor, i: int, j: int, t):
    """Slot i's literal j as a 0-d tensor of its storage kind."""
    v = lits[i, j]
    return v.view(torch.float64) if t.kind == TypeKind.FLOAT64 else v


def _clone_tree(x):
    """Copies of the tensors of a nested tuple / list / dict of outputs."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_clone_tree(v) for v in x)
    return x


class CapturedProgram:
    """A traced run (`_traced_run`, defined by the subclass) that reads
    its per-call values from one int64 device input buffer, and on the
    card its captured CUDA graph.  The first call on the card runs the
    traced body eagerly (the warm-up: it fills the constant cache, loads
    every kernel, and its outputs are the call's answer); after
    capture_if_new() every call writes the input buffer and replays the
    graph, and its outputs leave as copies made under the program's lock
    (a replay overwrites the graph's outputs).  On the CPU there is no
    graph: every call is the traced run.  `tier` is the plancache tier
    that counts the captures and bounds the pools; `replay_tag`, where
    set, is the LAUNCHES entry one replay adds besides the kernels it
    replays."""

    tier: "plancache.ProgramCache"
    replay_tag: Optional[str] = None

    def __init__(self, device, n_inputs: int):
        self.captured = False
        self.pool_bytes = 0
        self.device = device
        self._lock = threading.Lock()
        self.graph = None
        self.graph_launches: dict = {}
        # the one input buffer
        self.inputs = torch.zeros(n_inputs, dtype=torch.int64,
                                  device=device)
        self._done = None
        self._static = None
        # the device constants the captured graph reads in place
        self._consts: list = []

    def _traced_run(self):
        raise NotImplementedError

    def _host_words(self, words: list) -> torch.Tensor:
        host = torch.tensor(words, dtype=torch.int64)
        return host.pin_memory() if self.device.type == "cuda" else host

    def _call(self, host: torch.Tensor):
        """One call with the input buffer set to `host`: the traced run,
        or a replay and copies of its outputs."""
        if self.device.type != "cuda":
            with self._lock:
                self.inputs.copy_(host)
                return self._traced_run()
        with self._lock:
            cur = torch.cuda.current_stream(self.device)
            if self._done is not None:
                cur.wait_event(self._done)
            self.inputs.copy_(host, non_blocking=True)
            if self.graph is None:
                out = self._traced_run()
            else:
                self.graph.replay()
                K.add_launches(self.graph_launches)
                out = _clone_tree(self._static)
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(cur)
        return out

    def capture_if_new(self) -> None:
        """Capture the program (on the card, once): called after a run
        whose classes fit, so an overflowing class is never captured.
        On the CPU there is no graph; the program counts as captured at
        the same point, so the tier's counters read the same there."""
        if self.captured:
            return
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            with self._lock:
                if self.captured:
                    return
                self.captured = True
            self.tier.record_capture(t0)
            return
        with self._lock, _CAPTURE_LOCK:
            if self.graph is not None:
                return
            graph = torch.cuda.CUDAGraph()
            # torch.cuda.graph empties the allocator's cache on entry:
            # empty it first, so the pool's new segments are the delta
            torch.cuda.empty_cache()
            r0 = torch.cuda.memory_reserved(self.device)
            try:
                with K.capture_launches() as tally, \
                        retain_consts() as consts:
                    with torch.cuda.graph(graph,
                                          capture_error_mode="thread_local"):
                        static = self._traced_run()
            except RuntimeError as e:
                if "capture" in str(e).lower() or \
                        "not permitted" in str(e).lower():
                    raise _MaskedHostRead(str(e)) from e
                raise
            self.pool_bytes = max(
                torch.cuda.memory_reserved(self.device) - r0, 0)
            self.graph_launches = dict(tally)
            if self.replay_tag is not None:
                self.graph_launches[self.replay_tag] = 1
            self._consts = consts
            self._static = static
            self.graph = graph
            self.captured = True
        self.tier.record_capture(t0)

    def release(self) -> None:
        """Drop the graph and its pool (eviction from its tier).  A
        caller still holding the program runs it eagerly from then on."""
        with self._lock:
            self.graph = None
            self._static = None
            self._consts = []
            self.captured = False
            self.pool_bytes = 0


class FusedProgram(CapturedProgram):
    """One fragment at one key: the traced executor over a batch of
    `kclass` query slots, and on the card its captured CUDA graph.

    run(queries) takes [(snapshot, txid, [literal values])] (at most
    kclass; the tail pads with the last query) and returns (per-slot
    (cols, valid, nulls), required join totals [kclass, joins])."""

    tier = plancache.FUSED

    def __init__(self, ctx, plan, baked: dict, names: list, types: list,
                 factors: dict, kclass: int, entries: dict):
        # the input buffer: snapshots, txids, literal rows
        super().__init__(ctx.device, kclass * (2 + len(names)))
        self.plan = plan
        self.baked = dict(baked)
        self.names = list(names)
        self.types = list(types)
        self.factors = dict(factors)
        self.kclass = kclass
        self.stores = ctx.stores
        self.cache = ctx.cache
        # the program reads these staged tensors in place (and keeps
        # them alive for as long as it may replay)
        self.staged = {t: (e.arrs, e.n) for t, e in entries.items()}
        self.meta: dict = {}

    # -- the traced run ---------------------------------------------------
    def _views(self):
        k, n_l = self.kclass, len(self.names)
        snaps = self.inputs[:k]
        txids = self.inputs[k:2 * k]
        lits = self.inputs[2 * k:].view(k, n_l)
        return snaps, txids, lits

    def _traced_run(self):
        from .executor import ExecContext, Executor, stats_tier
        snaps, txids, lits = self._views()
        batch = BatchInputs(lits, snaps, txids,
                            {nm: j for j, nm in enumerate(self.names)})
        outs, reqs = [], []
        with stats_tier("fused"):
            for i in range(self.kclass):
                params = dict(self.baked)
                for j, (nm, t) in enumerate(zip(self.names, self.types)):
                    params[nm] = (_lit_view(lits, i, j, t), t)
                sub_ctx = ExecContext(
                    self.stores, snaps[i], txids[i], self.cache,
                    params=params, staged=dict(self.staged),
                    join_factors=self.factors, batch=batch, slot=i)
                sub = Executor(sub_ctx, frag_tag="__fused")
                sub._traced = True
                b = sub.exec_node(self.plan)
                b.ensure_all()
                self.meta["types"] = b.types
                self.meta["dicts"] = b.dicts
                self.meta["join_caps"] = tuple(
                    (jid, cap) for jid, _r, cap in sub.join_required)
                outs.append((dict(b.cols), b.valid, dict(b.nulls)))
                reqs.append(torch.stack(
                    [r.reshape(()).to(torch.int64)
                     for _j, r, _c in sub.join_required])
                    if sub.join_required else
                    torch.zeros(0, dtype=torch.int64, device=self.device))
        return outs, torch.stack(reqs)

    def _pack(self, queries: list) -> torch.Tensor:
        k = self.kclass
        padded = list(queries) + [queries[-1]] * (k - len(queries))
        words = [int(q[0]) for q in padded] + [int(q[1]) for q in padded]
        for q in padded:
            words += [_lit_word(v, t) for v, t in zip(q[2], self.types)]
        return self._host_words(words)

    def run(self, queries: list):
        return self._call(self._pack(queries))


# ---------------------------------------------------------------------------
# serving-tier batch entry points (exec/scheduler.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FragSig:
    """One query's literal-masked fragment signature plus what a
    coalesced dispatch needs.  Queries with equal `sig` run the same
    program and differ only in their (snapshot, txid, literal) values."""
    sig: object            # hashable canonical signature
    plan: object           # literal-masked physical plan
    lits: list             # this query's [(name, value, type)]
    stores: dict           # table name -> TableStore
    cache: object          # the node's DeviceBufferPool
    need_by_table: dict    # table name -> needed column set
    has_join: bool
    plan_key: tuple        # _key_of(masked plan)
    lit_types: tuple


def batch_signature(ctx, node) -> Optional[FragSig]:
    """The fragment signature the serial path would key on, or None when
    the fragment cannot ride a batched dispatch (not fusable, prepared
    parameters, mask refused, or a join under the row floor)."""
    if ctx.params:
        return None
    screened = _screen_fragment(ctx, node)
    if screened is None:
        return None
    scans, stores = screened
    lits: list = []
    masked = _mask_node(node, lits)
    plan_key = _key_of(masked)
    if plan_key is None:
        return None
    lit_types = tuple(t for _n, _v, t in lits)
    base_key = (plan_key, _table_sig(stores), (), (), lit_types)
    try:
        hash(base_key)
    except TypeError:
        return None
    sig = _mask_key(base_key)   # codec-free: stable across staging
    with _STATE_LOCK:
        refused = sig in _MASK_REFUSED
    if refused:
        return None
    has_join = _plan_has_join(masked)
    if has_join and sum(st.row_count() for st in stores.values()) \
            < FUSE_JOIN_MIN_ROWS:
        return None
    need_by_table: dict = {}
    for scan in scans:
        need_by_table.setdefault(scan.table.name, set()).update(
            _needed_columns(node, scan.alias))
    return FragSig(sig=sig, plan=masked, lits=lits, stores=stores,
                   cache=ctx.cache, need_by_table=need_by_table,
                   has_join=has_join, plan_key=plan_key,
                   lit_types=lit_types)


def _batch_class(k: int) -> int:
    """Pad the batch size to a power of two: a bounded set of programs."""
    c = 1
    while c < k:
        c *= 2
    return c


class StagedBatch:
    """A coalesced batch after the STAGE phase: tables resident, key
    computed, queries packed; no program run yet."""

    __slots__ = ("info", "k", "kclass", "base_key", "lkey", "queries",
                 "entries", "factors", "ctx")


class FusedFlight:
    """One launched coalesced batch: its outputs are copies of the
    program's outputs, enqueued on the device."""

    __slots__ = ("sb", "prog", "key", "outs", "req", "attempt")


def stage_fused_batch(info: FragSig, queries: list) \
        -> Optional[StagedBatch]:
    """STAGE: upload every needed table through the buffer cache, then
    recompute the key (a DML between classification and dispatch can
    grow a TEXT dictionary).  None when this group cannot batch."""
    from .executor import ExecContext
    if not queries:
        return None
    entries = _stage(info.cache, info.stores, info.need_by_table)
    base_key = (info.plan_key, _table_sig(info.stores, entries), (), (),
                info.lit_types)
    with _STATE_LOCK:
        refused = _mask_key(base_key) in _MASK_REFUSED
    if refused:
        return None
    sb = StagedBatch()
    sb.info = info
    sb.base_key = base_key
    sb.lkey = struct_key(base_key)
    sb.k = len(queries)
    sb.kclass = _batch_class(sb.k)
    sb.queries = list(queries)
    sb.entries = entries
    with _STATE_LOCK:
        sb.factors = dict(_JOIN_LADDER.get(sb.lkey, {})) \
            if info.has_join else {}
    sb.ctx = ExecContext(info.stores, 0, 0, info.cache)
    return sb


def launch_fused_batch(sb: StagedBatch, attempt: int = 0) \
        -> Optional[FusedFlight]:
    """LAUNCH: program lookup (or build) and one run over all K queries,
    enqueued on the device; no host read.  None when the program
    declined this shape (the caller runs the queries serially); a device
    OOM propagates to the scheduler's pressure ladder."""
    full_key = sb.base_key + (tuple(sorted(sb.factors.items())),
                              ("__batch", sb.kclass),
                              _staging_key(sb.info.cache, sb.entries))
    prog = plancache.FUSED.get(full_key)
    if prog is None:
        prog = plancache.FUSED.put(full_key, FusedProgram(
            sb.ctx, sb.info.plan, {}, [nm for nm, _v, _t in sb.info.lits],
            list(sb.info.lit_types), sb.factors, sb.kclass, sb.entries))
    try:
        outs, req = prog.run(sb.queries)
    except Exception as e:
        from . import shield
        plancache.FUSED.pop(full_key)
        if shield.is_oom(e):
            raise
        return None
    fl = FusedFlight()
    fl.sb, fl.prog, fl.key = sb, prog, full_key
    fl.outs, fl.req = outs, req
    fl.attempt = attempt
    return fl


def finish_fused_batch(flight: FusedFlight) -> Optional[list]:
    """FINISH: the one host read of a coalesced dispatch, the join-ladder
    check (which also surfaces a deferred device error), growing factors
    and relaunching until the batch fits; then the program is captured if
    new, and the per-query DBatches come back (slot i is query i; the
    padded tail is dropped).  None when the batched path gave up."""
    from .executor import DBatch
    while True:
        sb = flight.sb
        grew = _grow(flight.prog.meta.get("join_caps") or (), flight.req,
                     sb.factors)
        if grew is None:
            return None
        if grew:
            _ladder_remember(sb.lkey, sb.factors)
            if flight.attempt + 1 >= 24:
                return None
            flight = launch_fused_batch(sb, attempt=flight.attempt + 1)
            if flight is None:
                return None
            continue
        if sb.info.has_join:
            _ladder_remember(sb.lkey, sb.factors)
        try:
            flight.prog.capture_if_new()
        except _MaskedHostRead:
            plancache.FUSED.pop(flight.key)
            _mask_refused_add(_mask_key(sb.base_key))
        meta = flight.prog.meta
        return [DBatch(dict(cols), valid, dict(meta["types"]),
                       dict(meta["dicts"]), dict(nulls))
                for cols, valid, nulls in flight.outs[:sb.k]]


def run_fused_batch(info: FragSig, queries: list) -> Optional[list]:
    """K same-signature queries as ONE program run: `queries` is
    [(snapshot_ts, txid, [literal values])], literal order as in
    info.lits.  Per-query DBatches, or None (the caller runs them
    serially).  The synchronous composition of stage, launch, finish."""
    sb = stage_fused_batch(info, queries)
    if sb is None:
        return None
    flight = launch_fused_batch(sb)
    if flight is None:
        return None
    return finish_fused_batch(flight)
