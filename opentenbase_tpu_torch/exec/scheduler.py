"""Concurrent serving tier: admission + same-program batching.

The counterpart of opentenbase_tpu/exec/scheduler.py.  Client threads call
`Scheduler.run(session, sql)`; a dispatcher thread drains the arrival
queue and coalesces SELECTs that share a literal-masked fragment
signature (exec/fused.py batch_signature) arriving within the window
(window_ms, 2 by default; at most max_batch, 16) into ONE dispatch of one
fragment program: their literals, snapshots and txids fill the program's
input buffer, one program run answers all of them (one fused_scan_agg
launch for Q1/Q6-shaped fragments, K copies of the traced fragment in one
captured graph otherwise), and each query's result comes back as its own
device batch, materialized on its client's thread.

Pipelining: the dispatcher only classifies, coalesces, stages and
launches; the one host read of a coalesced dispatch (the join-ladder
check, fused.finish_fused_batch) runs on a drainer thread fed by a
bounded queue, so the dispatcher stages batch i+1 while the card computes
batch i.  The admission slot of a pipelined dispatch passes to the
drainer with the flight, and the drainer releases it.  `pipeline=False`
runs the synchronous path, with identical results.

Admission: GTM resource-group slots (owner + lease, gtm/server.py) cap
concurrent dispatches per group: a coalesced batch holds one slot (it is
one dispatch), a serial statement one.  Over-admission sheds: a full
per-group queue rejects at submit, and a query that cannot get a slot
before its shed deadline fails, holding nothing.  Everything that cannot
batch (DML, DDL, several statements, init-plan SELECTs) runs on a worker
pool under the same admission; writes serialize on one lane.

The reference's OTB_SCHED_* environment knobs are constructor arguments
here with the same defaults; the port reads no environment variable.
Not ported: the result cache of exec/share.py (`result_cache=True`
raises), `serve()` over the network front end, and the snapshot-check
and tracing hooks.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..sql import ast as A
from ..sql.parser import parse_sql
from ..utils import locks
from . import shield
from .executor import ExecContext, ExecError, materialize
from .fused import (batch_signature, finish_fused_batch, launch_fused_batch,
                    run_fused_batch, stage_fused_batch)
from .session import Result

# ---------------------------------------------------------------------------
# serving-tier telemetry, process-global across Scheduler instances
# ---------------------------------------------------------------------------
_STATS_LOCK = locks.Lock("exec.scheduler._STATS_LOCK")
_STATS: dict = {          # guarded_by: _STATS_LOCK
    "admitted": 0,        # queries that passed admission and executed
    "batched": 0,         # queries served by a multi-query dispatch
    "shed": 0,            # rejected: queue full or shed deadline passed
    "dispatches": 0,      # device dispatches (a batch counts once)
    "batch_dispatches": 0,
    # every successful slot acquire is matched by exactly one release
    "slots_acquired": 0,
    "slots_released": 0,
    "pipelined_dispatches": 0,   # finished on the drainer thread
    "drained": 0,         # flights the drainer completed
    "stage_work_ms": 0.0,     # total staging wall time
    "stage_overlap_ms": 0.0,  # staging wall time behind a running flight
}
_HIST: dict = {}          # guarded_by: _STATS_LOCK — batch size -> count
_WAITS: collections.deque = collections.deque(  # guarded_by: _STATS_LOCK
    maxlen=4096)          # recent queue waits (ms), submit -> execution
_SCHEDULERS: list = []    # guarded_by: _STATS_LOCK — live instances


def _pct(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])


def stats_snapshot() -> dict:
    """Aggregate serving-tier counters."""
    with _STATS_LOCK:
        d = dict(_STATS)
        waits = sorted(_WAITS)
        hist = dict(sorted(_HIST.items()))
        scheds = list(_SCHEDULERS)
    d["queued"] = sum(s.queue_depth() for s in scheds)
    d["queue_wait_p50_ms"] = _pct(waits, 0.50)
    d["queue_wait_p99_ms"] = _pct(waits, 0.99)
    d["batch_hist"] = " ".join(f"{k}:{v}" for k, v in hist.items())
    d["hist"] = hist
    d["drain_queue_depth"] = sum(s.drain_depth() for s in scheds)
    work = float(d.get("stage_work_ms", 0.0))
    d["pipeline_overlap_ratio"] = \
        (float(d.get("stage_overlap_ms", 0.0)) / work) if work > 0 else 0.0
    return d


def stats_rows() -> list:
    """One row: (admitted, queued, batched, shed, dispatches,
    batch_dispatches, queue_wait_p50_ms, queue_wait_p99_ms, batch_hist)."""
    d = stats_snapshot()
    return [(d["admitted"], d["queued"], d["batched"], d["shed"],
             d["dispatches"], d["batch_dispatches"],
             d["queue_wait_p50_ms"], d["queue_wait_p99_ms"],
             d["batch_hist"])]


def reset_stats():
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0
        _HIST.clear()
        _WAITS.clear()


def _bump(field: str, n: int = 1):
    with _STATS_LOCK:
        _STATS[field] += n


def _note_dispatch(items, t_start: float):
    k = len(items)
    with _STATS_LOCK:
        _STATS["admitted"] += k
        _STATS["dispatches"] += 1
        if k > 1:
            _STATS["batched"] += k
            _STATS["batch_dispatches"] += 1
        _HIST[k] = _HIST.get(k, 0) + 1
        for it in items:
            _WAITS.append((t_start - it.t_submit) * 1e3)


def _note_stage(ms: float, overlapped: bool):
    with _STATS_LOCK:
        _STATS["stage_work_ms"] += ms
        if overlapped:
            _STATS["stage_overlap_ms"] += ms


def slot_balance() -> tuple:
    """(acquired, released) across every scheduler in the process: equal
    once all submitted work has drained."""
    with _STATS_LOCK:
        return _STATS["slots_acquired"], _STATS["slots_released"]


class _Shed(Exception):
    pass


class _Gone(Exception):
    """Admission abandoned: the waiter left while the item waited for a
    slot; it is finished and holds no slot."""


class _Flight:
    """One launched coalesced dispatch crossing the dispatcher -> drainer
    boundary; it owns the admission slot of its dispatch."""

    __slots__ = ("items", "flight", "sb", "group", "t_start")

    def __init__(self, items, flight, sb, group, t_start):
        self.items = items
        self.flight = flight
        self.sb = sb
        self.group = group
        self.t_start = t_start


_STOP = object()


class _Item:
    """One submitted statement moving through the scheduler."""
    __slots__ = ("session", "sql", "planned", "info", "group", "t_submit",
                 "ev", "error", "results", "batch", "out_names", "is_write",
                 "lk", "cv", "detached", "lits")

    def __init__(self, session, sql):
        self.session = session
        self.sql = sql
        self.planned = None
        self.info = None          # FragSig when batchable, else None
        self.group = "default"
        self.t_submit = time.monotonic()
        self.ev = threading.Event()
        self.error: Optional[BaseException] = None
        self.results: Optional[list] = None   # serial path (materialized)
        self.batch = None         # batched path: the query's DBatch
        self.out_names = None
        self.is_write = False
        self.lk = threading.Lock()
        self.cv = threading.Condition(self.lk)
        self.detached = False     # guarded_by: lk
        self.lits = None

    @property
    def sig(self):
        return None if self.info is None else self.info.sig


class Scheduler:
    """Admission + coalescing front end over single-node sessions."""

    def __init__(self, node=None, gtm=None, window_ms: float = 2.0,
                 max_batch: int = 16, queue_depth: int = 128,
                 shed_timeout_ms: float = 5000.0, slots: int = 8,
                 workers: int = 8, lease_s: float = 30.0,
                 pipeline: bool = True, drain_depth: int = 4,
                 result_cache: bool = False):
        if result_cache:
            raise NotImplementedError("the serving tier's result cache "
                                      "(exec/share.py) is not yet ported")
        self.node = node
        if gtm is None:
            # in-process GTM core: the slot and lease semantics a cluster
            # gets from the GTM
            from ..gtm.server import GtmCore
            gtm = GtmCore()
        self.gtm = gtm
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self.max_queue = queue_depth
        self.shed_s = shed_timeout_ms / 1e3
        self.slots = slots
        self.workers = workers
        self.lease_s = lease_s
        self.pipeline = pipeline
        self._owner = f"sched{os.getpid()}-{id(self):x}"
        self._q: queue.Queue = queue.Queue()
        self._deferred: collections.deque = collections.deque()
        self._depth: dict = {}          # group -> queued count
        self._lock = locks.Lock("exec.scheduler.Scheduler._lock")
        self._write_lock = locks.Lock(
            "exec.scheduler.Scheduler._write_lock")   # one write lane
        self._pool: Optional[ThreadPoolExecutor] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # launched flights awaiting their finish phase; bounded, so a
        # slow drainer back-pressures the dispatcher
        self._drainq: queue.Queue = queue.Queue(maxsize=max(1, drain_depth))
        self._drain_thread: Optional[threading.Thread] = None
        self._pipe_lock = locks.Lock("exec.scheduler.Scheduler._pipe_lock")
        self._inflight = 0              # guarded_by: _pipe_lock
        self._slot_cv = locks.Condition(
            name="exec.scheduler.Scheduler._slot_cv")
        with _STATS_LOCK:
            _SCHEDULERS.append(self)

    # -- lifecycle --------------------------------------------------------
    def _ensure_started(self):
        with self._lock:
            if self._thread is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(1, self.workers),
                    thread_name_prefix="otbt-sched")
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="otbt-sched-disp")
                self._thread.start()

    def _ensure_drainer(self):
        with self._lock:
            if self._drain_thread is None:
                self._drain_thread = threading.Thread(
                    target=self._drain_loop, daemon=True,
                    name="otbt-sched-drain")
                self._drain_thread.start()

    def stop(self):
        with self._lock:
            self._stopped = True
            started = self._thread is not None
            drainer = self._drain_thread
        if started:
            self._q.put(_STOP)
            self._thread.join(timeout=30)
            if drainer is not None:
                # FIFO: every enqueued flight drains before the sentinel
                self._drainq.put(_STOP)
                drainer.join(timeout=30)
            self._pool.shutdown(wait=True)
        try:
            self.gtm.resq_disconnect(self._owner)
        except Exception:
            pass
        with _STATS_LOCK:
            if self in _SCHEDULERS:
                _SCHEDULERS.remove(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def queue_depth(self) -> int:
        with self._lock:
            return sum(self._depth.values())

    def drain_depth(self) -> int:
        return self._drainq.qsize()

    # -- client API -------------------------------------------------------
    def run(self, session, sql: str) -> list:
        """Submit and wait: the serving tier's `session.execute`."""
        return self.wait(self.submit(session, sql))

    def submit(self, session, sql: str) -> _Item:
        if self._stopped:
            raise ExecError("scheduler is stopped")
        self._ensure_started()
        item = _Item(session, sql)
        self._classify(item)
        with self._lock:
            depth = self._depth.get(item.group, 0)
            over = self.max_queue > 0 and depth >= self.max_queue
            if not over:
                self._depth[item.group] = depth + 1
        if over:
            _bump("shed")
            raise ExecError(
                f"resource group '{item.group}' queue is full "
                f"({self.max_queue} queued): query shed")
        self._q.put(item)
        return item

    def wait(self, item: _Item, timeout: float = 600.0) -> list:
        """Wait for completion.  At the timeout the item detaches: it
        fails here, its batch-mates are untouched, and a later completion
        of it is a no-op."""
        end = time.monotonic() + timeout
        with item.cv:
            while not item.ev.is_set():
                rem = end - time.monotonic()
                if rem <= 0:
                    item.detached = True
                    raise ExecError("scheduler: query timed out awaiting "
                                    "dispatch")
                item.cv.wait(rem)
        if item.error is not None:
            raise item.error
        if item.results is not None:
            return item.results
        # batched path: materialize here, on the client thread, while the
        # dispatcher already stages the next batch
        try:
            names, rows = materialize(item.batch, item.out_names)
        except BaseException as e:
            return self._recover_member(item, e)
        return [Result("SELECT", names=names, rows=rows, rowcount=len(rows))]

    # -- completion handshake ---------------------------------------------
    def _complete(self, item: _Item, error=None, results=None,
                  batch=None, out_names=None) -> bool:
        """Deliver a result or error unless the waiter already left."""
        with item.lk:
            if item.detached or item.ev.is_set():
                return False
            item.error = error
            if results is not None:
                item.results = results
            if batch is not None:
                item.batch = batch
                item.out_names = out_names
            item.ev.set()
            item.cv.notify_all()
            return True

    def _expire_if_dead(self, item: _Item) -> bool:
        """Dispatcher-side reap: True when the waiter already left (a
        queued item holds no slot)."""
        with item.lk:
            return item.detached

    def _recover_member(self, item: _Item, exc: BaseException) -> list:
        """A batched member failed at materialization: count the batch
        failure and re-run this one member serially, inline."""
        shield.note_batch_failure(item.sig)
        shield.bump("isolated")
        try:
            self._admit(item.group, time.monotonic() + self.shed_s,
                        item=item)
        except (_Shed, _Gone):
            raise exc
        try:
            return item.session.execute(item.sql)
        finally:
            self._release(item.group)

    # -- classification ---------------------------------------------------
    def _classify(self, item: _Item):
        """Attach the literal-masked fragment signature when the statement
        can ride a coalesced dispatch; else it takes the serial lane (the
        write lane for writes)."""
        session, sql = item.session, item.sql
        item.group = getattr(session, "resource_group", "") or "default"
        stmts = parse_sql(sql)
        item.is_write = any(not isinstance(s, (A.SelectStmt, A.ShowStmt,
                                               A.ExplainStmt))
                            for s in stmts)
        node = getattr(session, "node", None)
        if (len(stmts) != 1 or not isinstance(stmts[0], A.SelectStmt)
                or stmts[0].for_update
                or node is None or not hasattr(node, "stores")):
            return
        try:
            planned = session._plan_select(stmts[0])
        except Exception:
            return    # the serial path reports the planning error
        if planned.init_plans:
            return
        info = batch_signature(ExecContext(node.stores, 0, 0, node.cache),
                               planned.plan)
        if info is None:
            return
        item.planned = planned
        item.lits = info.lits
        if shield.quarantined(info.sig):
            return    # a repeat offender runs alone for the cooldown
        item.info = info

    # -- admission --------------------------------------------------------
    def _cap(self, group: str) -> int:
        cfg = None
        if self.node is not None:
            cfg = getattr(self.node.catalog, "resource_groups", {}).get(group)
        if cfg:
            try:
                return int(cfg.get("concurrency", 0)) or self.slots
            except (TypeError, ValueError):
                pass
        return self.slots

    def _admit(self, group: str, deadline: float,
               item: Optional[_Item] = None):
        """Acquire one GTM slot or shed at the deadline.  slots_acquired
        counts only a successful acquire, so every way out of here holds
        nothing; callers reach _release in a finally once this returns."""
        delay = 0.0005
        while not self.gtm.resq_acquire(group, self._cap(group),
                                        owner=self._owner,
                                        lease_s=self.lease_s):
            if item is not None and self._expire_if_dead(item):
                raise _Gone()
            if time.monotonic() >= deadline:
                raise _Shed(f"resource group '{group}' queue wait timeout: "
                            "query shed")
            # a local _release notifies at once; the timeout catches
            # frees this condition cannot see (other owners, lease reaps)
            with self._slot_cv:
                self._slot_cv.wait(timeout=delay)
            delay = min(delay * 2, 0.05)
        _bump("slots_acquired")

    def _release(self, group: str):
        _bump("slots_released")
        try:
            self.gtm.resq_release(group, owner=self._owner)
        except Exception:
            pass
        with self._slot_cv:
            self._slot_cv.notify_all()

    def _shed_item(self, item: _Item, exc: _Shed):
        if self._complete(item, error=ExecError(str(exc))):
            _bump("shed")

    # -- dispatcher -------------------------------------------------------
    def _next(self, timeout: Optional[float]):
        if self._deferred:
            return self._deferred.popleft()
        try:
            if timeout is None:
                return self._q.get()
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _depth_dec(self, item: _Item):
        with self._lock:
            d = self._depth.get(item.group, 0)
            if d > 0:
                self._depth[item.group] = d - 1

    def _loop(self):
        while True:
            head = self._next(None)
            if head is _STOP:
                self._drain_on_stop()
                return
            batch = [head]
            if head.info is not None and self.max_batch > 1 \
                    and self.window_s > 0:
                # the coalescing window: wait a beat for same-signature
                # arrivals; others defer, in order
                deadline = time.monotonic() + self.window_s
                skipped = []
                while len(batch) < self.max_batch:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    nxt = self._next(rem)
                    if nxt is None:
                        break
                    if nxt is _STOP:
                        self._deferred.appendleft(_STOP)
                        break
                    if nxt.info is not None and nxt.sig == head.sig:
                        batch.append(nxt)
                    else:
                        skipped.append(nxt)
                self._deferred.extend(skipped)
            for it in batch:
                self._depth_dec(it)
            if len(batch) > 1:
                self._dispatch_batch(batch)
            else:
                self._pool.submit(self._run_serial, head)

    def _drain_on_stop(self):
        while True:
            it = self._next(0)
            if it is None:
                return
            if it is _STOP:
                continue
            self._complete(it, error=ExecError("scheduler stopped"))

    # -- execution paths --------------------------------------------------
    def _queries(self, items: list):
        """Per-query MVCC, drawn after admission (when a serial run would
        begin): [(snapshot, txid, [literal values])]."""
        node = items[0].session.node
        queries = []
        for it in items:
            txid = node.gts.next_txid()
            snap = node.gts.next_gts()
            queries.append((snap, txid, [v for _n, v, _t in it.info.lits]))
        return queries

    def _dispatch_batch(self, items: list):
        """Coalesced dispatch: reap dead members, cut the batch to the
        card's free memory, dispatch each chunk."""
        live = [it for it in items if not self._expire_if_dead(it)]
        if not live:
            return
        if len(live) == 1:
            self._pool.submit(self._run_serial, live[0])
            return
        cap = shield.batch_cap(live[0].session.node, live[0].info,
                               self.max_batch)
        for i in range(0, len(live), cap):
            chunk = live[i:i + cap]
            if len(chunk) == 1:
                self._pool.submit(self._run_serial, chunk[0])
            elif self.pipeline:
                self._dispatch_pipelined(chunk)
            else:
                self._dispatch_one(chunk)

    def _dispatch_one(self, items: list, isolating: bool = False):
        group = items[0].group
        deadline = min(it.t_submit for it in items) + self.shed_s
        try:
            self._admit(group, deadline)
        except _Shed as e:
            for it in items:
                self._shed_item(it, e)
            return
        except BaseException as e:
            for it in items:
                self._complete(it, error=e)
            return
        out = err = None
        t_start = time.monotonic()
        try:
            queries = self._queries(items)
            for attempt in (0, 1):
                try:
                    shield.pre_dispatch(items[0].info, queries)
                    out = run_fused_batch(items[0].info, queries)
                    err = None
                    break
                except BaseException as e:
                    err = e
                    if shield.is_oom(e) and attempt == 0:
                        # memory pressure: evict the coldest entries and
                        # retry once
                        shield.bump("oom_dispatches")
                        shield.relieve(items[0].session.node)
                        continue
                    break
        finally:
            self._release(group)
        if err is not None:
            if shield.is_oom(err):
                # relief did not help: the degraded lane
                for it in items:
                    self._pool.submit(self._serve_degraded, it)
                return
            if not isolating:
                shield.note_batch_failure(items[0].sig)
            self._isolate(items)
            return
        if out is None:
            # the batched path declined: serial runs reproduce each result
            for it in items:
                self._pool.submit(self._run_serial, it)
            return
        _note_dispatch(items, t_start)
        for it, b in zip(items, out):
            self._complete(it, batch=b, out_names=it.planned.output_names)

    def _dispatch_pipelined(self, items: list):
        """admit -> stage -> launch -> enqueue the flight for the drainer.
        The slot passes to the _Flight at the enqueue; every error path
        before it releases here."""
        group = items[0].group
        deadline = min(it.t_submit for it in items) + self.shed_s
        try:
            self._admit(group, deadline)
        except _Shed as e:
            for it in items:
                self._shed_item(it, e)
            return
        except BaseException as e:
            for it in items:
                self._complete(it, error=e)
            return
        t_start = time.monotonic()
        flight = sb = None
        try:
            queries = self._queries(items)
            with self._pipe_lock:
                overlapped = self._inflight > 0
            for attempt in (0, 1):
                try:
                    shield.pre_dispatch(items[0].info, queries)
                    if sb is None:
                        t0 = time.perf_counter()
                        sb = stage_fused_batch(items[0].info, queries)
                        _note_stage((time.perf_counter() - t0) * 1e3,
                                    overlapped)
                    if sb is not None:
                        flight = launch_fused_batch(sb)
                    break
                except BaseException as e:
                    if shield.is_oom(e) and attempt == 0:
                        shield.bump("oom_dispatches")
                        shield.relieve(items[0].session.node)
                        continue
                    raise
        except BaseException as e:
            self._release(group)
            self._flight_error(items, e)
            return
        if flight is None:
            self._release(group)
            for it in items:
                self._pool.submit(self._run_serial, it)
            return
        self._ensure_drainer()
        with self._pipe_lock:
            self._inflight += 1
        _bump("pipelined_dispatches")
        self._drainq.put(_Flight(items, flight, sb, group, t_start))

    def _drain_loop(self):
        """The finish phase (the join-ladder read, where a deferred device
        error also surfaces) of every launched flight, then completion.
        The flight's slot is released here, in the finally."""
        while True:
            fl = self._drainq.get()
            if fl is _STOP:
                return
            self._drain_one(fl)

    def _drain_one(self, fl: _Flight):
        out = err = None
        try:
            try:
                out = finish_fused_batch(fl.flight)
            except BaseException as e:
                if shield.is_oom(e):
                    shield.bump("oom_dispatches")
                    shield.relieve(fl.items[0].session.node)
                    try:
                        f2 = launch_fused_batch(fl.sb)
                        out = finish_fused_batch(f2) \
                            if f2 is not None else None
                    except BaseException as e2:
                        err = e2
                else:
                    err = e
        finally:
            with self._pipe_lock:
                self._inflight -= 1
            self._release(fl.group)
            _bump("drained")
        items = fl.items
        if err is not None:
            if shield.is_oom(err):
                for it in items:
                    self._pool.submit(self._serve_degraded, it)
                return
            shield.note_batch_failure(items[0].sig)
            # bisection runs synchronously here, never back into _drainq
            self._isolate(items)
            return
        if out is None:
            for it in items:
                self._pool.submit(self._run_serial, it)
            return
        _note_dispatch(items, fl.t_start)
        for it, b in zip(items, out):
            self._complete(it, batch=b, out_names=it.planned.output_names)

    def _flight_error(self, items: list, err: BaseException):
        """A pipelined dispatch failed before its enqueue (its slot is
        already released): the synchronous path's error ladder."""
        if shield.is_oom(err):
            for it in items:
                self._pool.submit(self._serve_degraded, it)
            return
        shield.note_batch_failure(items[0].sig)
        self._isolate(items)

    def _isolate(self, items: list):
        """Quarantine by bisection: re-dispatch a failed batch in halves,
        so innocents complete batched and the offender fails alone on the
        serial lane."""
        live = [it for it in items if not self._expire_if_dead(it)]
        if not live:
            return
        if len(live) == 1:
            shield.bump("isolated")
            self._pool.submit(self._run_serial, live[0])
            return
        mid = len(live) // 2
        for half in (live[:mid], live[mid:]):
            if len(half) == 1:
                shield.bump("isolated")
                self._pool.submit(self._run_serial, half[0])
            else:
                self._dispatch_one(half, isolating=True)

    def _serve_degraded(self, item: _Item):
        """The brownout lane after dispatch-level memory pressure
        (shield.run_degraded: the morsel and spill tiers, not ported
        yet, so the member fails with that error)."""
        if self._expire_if_dead(item):
            return
        try:
            self._admit(item.group, time.monotonic() + self.shed_s,
                        item=item)
        except _Gone:
            return
        except _Shed as e:
            self._shed_item(item, e)
            return
        except BaseException as e:
            self._complete(item, error=e)
            return
        try:
            _note_dispatch([item], time.monotonic())
            try:
                self._complete(item, results=shield.run_degraded(item))
            except BaseException as e:
                self._complete(item, error=e)
        finally:
            self._release(item.group)

    def _run_serial(self, item: _Item):
        if self._expire_if_dead(item):
            return    # died queued: no slot was ever acquired
        try:
            self._admit(item.group, item.t_submit + self.shed_s, item=item)
        except _Gone:
            return
        except _Shed as e:
            self._shed_item(item, e)
            return
        except BaseException as e:
            self._complete(item, error=e)
            return
        try:
            _note_dispatch([item], time.monotonic())
            try:
                shield.serial_guard(item.lits)
                if item.is_write:
                    with self._write_lock:
                        res = item.session.execute(item.sql)
                else:
                    res = item.session.execute(item.sql)
                self._complete(item, results=res)
            except BaseException as e:
                self._complete(item, error=e)
        finally:
            self._release(item.group)


def serve(node, host: str = "127.0.0.1", port: int = 0, **knobs):
    """The reference starts a network front end whose sessions all route
    through one Scheduler; the port has no network tier yet."""
    raise NotImplementedError("serve() needs the network tier (net/), which "
                              "is not yet ported")
