"""The port's serving tier (opentenbase_tpu_torch/exec/scheduler.py) on the
CPU: same-signature statements coalesce into one program run and return
exactly the rows serial execution returns, mixed batches split by
signature, the serial lane serves what cannot batch, the queue-depth and
shed-deadline sheds leak no GTM slot, the pipelined and synchronous
dispatch paths agree and keep the slot ledger balanced across the
drainer thread, and a poisoned member is bisected out of its batch.
Mirrors tests/test_scheduler.py and tests/test_pipeline.py:90-160; one
case runs the same concurrent SQL through the JAX package's Scheduler
and the port's and compares the rows.
"""

import threading
import time

import pytest

from opentenbase_tpu.exec import scheduler as rsm
from opentenbase_tpu.exec.session import LocalNode as RNode
from opentenbase_tpu.exec.session import Session as RSession
from opentenbase_tpu_torch.exec import fused, shield
from opentenbase_tpu_torch.exec import scheduler as sm
from opentenbase_tpu_torch.exec.executor import ExecError
from opentenbase_tpu_torch.exec.session import LocalNode, Session
from opentenbase_tpu_torch.gtm.server import GtmCore


@pytest.fixture(autouse=True)
def _fresh_stats():
    sm.reset_stats()
    shield.reset_stats()
    yield
    sm.reset_stats()
    shield.reset_stats()
    shield.POISON_LITERALS.clear()


T_ROWS = [(i, i * 0.5, i % 3) for i in range(200)]
KV_ROWS = [(i, i * 7) for i in range(50)]


def _fill(s):
    s.execute("create table t (a bigint, b double precision, g bigint)")
    s.execute("insert into t values " + ", ".join(
        f"({a}, {b}, {g})" for a, b, g in T_ROWS))
    s.execute("create table kv (k bigint, v bigint)")
    s.execute("insert into kv values " + ", ".join(
        f"({k}, {v})" for k, v in KV_ROWS))


def _mk_node():
    node = LocalNode(device="cpu")
    _fill(Session(node))
    return node


AGG_Q = ("select g, sum(b) as sb, count(*) as c from t where a < {} "
         "group by g order by g")


def _run_concurrent(sched, make_session, sqls):
    """Every statement from its own client thread (each with its own
    Session); the row lists in submit order."""
    res = [None] * len(sqls)
    errs = [None] * len(sqls)

    def go(i):
        try:
            res[i] = sched.run(make_session(), sqls[i])[-1].rows
        except Exception as e:   # noqa: BLE001 — re-raised below
            errs[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(sqls))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for e in errs:
        if e is not None:
            raise e
    return res


class TestBatchedCorrectness:
    def test_agg_sort_shape_bit_identical(self):
        node = _mk_node()
        sqls = [AGG_Q.format(n) for n in (50, 80, 120, 199)]
        ref = [Session(node).execute(q)[-1].rows for q in sqls]
        with sm.Scheduler(node=node, window_ms=150.0) as sched:
            got = _run_concurrent(sched, lambda: Session(node), sqls)
        assert got == ref
        st = sm.stats_snapshot()
        assert st["batched"] >= 2 and st["batch_dispatches"] >= 1
        assert any(k > 1 for k in st["hist"])

    def test_point_shape_bit_identical(self):
        node = _mk_node()
        sqls = [f"select v from kv where k = {i}" for i in (3, 11, 29, 42)]
        ref = [Session(node).execute(q)[-1].rows for q in sqls]
        with sm.Scheduler(node=node, window_ms=150.0) as sched:
            got = _run_concurrent(sched, lambda: Session(node), sqls)
        assert got == ref
        assert sm.stats_snapshot()["batched"] >= 2

    def test_join_shape_bit_identical(self, monkeypatch):
        monkeypatch.setattr(fused, "FUSE_JOIN_MIN_ROWS", 0)
        node = LocalNode(device="cpu")
        s = Session(node)
        s.execute("create table c (ck bigint, seg text)")
        s.execute("create table o (ok bigint, ck bigint, "
                  "price double precision)")
        segs = ["A", "B", "C"]
        s.execute("insert into c values " + ", ".join(
            f"({i}, '{segs[i % 3]}')" for i in range(30)))
        s.execute("insert into o values " + ", ".join(
            f"({i}, {i % 30}, {i * 1.5})" for i in range(120)))
        q = ("select seg, count(*) as n, sum(price) as sp "
             "from c, o where c.ck = o.ck and ok < {} "
             "group by seg order by seg")
        sqls = [q.format(n) for n in (40, 70, 100, 119)]
        ref = [Session(node).execute(x)[-1].rows for x in sqls]
        with sm.Scheduler(node=node, window_ms=200.0) as sched:
            got = _run_concurrent(sched, lambda: Session(node), sqls)
        assert got == ref
        assert sm.stats_snapshot()["batched"] >= 2

    def test_mixed_batch_splits_by_signature(self):
        node = _mk_node()
        sqls = []
        for i, n in enumerate((50, 80, 120, 199)):
            sqls.append(AGG_Q.format(n))
            sqls.append(f"select v from kv where k = {i * 9 + 1}")
        ref = [Session(node).execute(q)[-1].rows for q in sqls]
        with sm.Scheduler(node=node, window_ms=150.0) as sched:
            got = _run_concurrent(sched, lambda: Session(node), sqls)
        assert got == ref
        st = sm.stats_snapshot()
        assert st["dispatches"] >= 2 and st["batched"] >= 2

    def test_serial_lane_still_works(self):
        node = _mk_node()
        with sm.Scheduler(node=node, window_ms=50.0) as sched:
            s = Session(node)
            sched.run(s, "insert into kv values (990, 6930)")
            rows = sched.run(s, "select v from kv where k = 990")[-1].rows
        assert rows == [(6930,)]


class TestAdmissionAndShed:
    def test_queue_depth_shed(self):
        """The dispatcher parked in a long window: the per-group queue
        fills and the next submit is shed at once."""
        node = _mk_node()
        sched = sm.Scheduler(node=node, window_ms=1500.0, queue_depth=3)
        try:
            items = [sched.submit(Session(node), AGG_Q.format(50))]
            time.sleep(0.1)   # the dispatcher takes the head, opens window
            items.append(sched.submit(Session(node), "select v from kv "
                                      "where k = 1"))
            items.append(sched.submit(Session(node), "select v from kv "
                                      "where k = 2"))
            with pytest.raises(ExecError, match="queue is full"):
                sched.submit(Session(node), "select v from kv where k = 3")
            for it in items:
                sched.wait(it)
        finally:
            sched.stop()
        assert sm.stats_snapshot()["shed"] == 1
        acq, rel = sm.slot_balance()
        assert acq == rel

    def test_shed_timeout_releases_no_lease(self):
        node = _mk_node()
        gtm = GtmCore()
        assert gtm.resq_acquire("default", 1, owner="hog", lease_s=60)
        sched = sm.Scheduler(node=node, gtm=gtm, slots=1,
                             shed_timeout_ms=150.0)
        try:
            with pytest.raises(ExecError, match="queue wait timeout"):
                sched.run(Session(node), "select v from kv where k = 1")
            assert gtm.resq_counts()["default"] == 1   # the hog only
            gtm.resq_release("default", owner="hog")
            rows = sched.run(Session(node),
                             "select v from kv where k = 1")[-1].rows
            assert rows == [(7,)]
            assert gtm.resq_counts()["default"] == 0   # lease released
        finally:
            sched.stop()
        assert sm.stats_snapshot()["shed"] == 1
        assert gtm.resq_stats()["live"] == 0


class TestPipeline:
    def test_pipeline_on_off_bit_identical(self):
        node = _mk_node()
        sqls = [AGG_Q.format(n) for n in (50, 80, 120, 199)] + \
            [f"select v from kv where k = {i}" for i in (3, 11, 29)]
        ref = [Session(node).execute(q)[-1].rows for q in sqls]
        with sm.Scheduler(node=node, window_ms=150.0,
                          pipeline=False) as sched:
            got_off = _run_concurrent(sched, lambda: Session(node), sqls)
        assert sm.stats_snapshot()["pipelined_dispatches"] == 0
        sm.reset_stats()
        with sm.Scheduler(node=node, window_ms=150.0) as sched:
            got_on = _run_concurrent(sched, lambda: Session(node), sqls)
        st = sm.stats_snapshot()
        assert st["pipelined_dispatches"] >= 1
        assert st["drained"] == st["pipelined_dispatches"]
        assert st["drain_queue_depth"] == 0
        assert got_off == ref and got_on == ref

    def test_slot_balance_across_drainer(self):
        node = _mk_node()
        sqls = [AGG_Q.format(n) for n in (50, 100, 150, 199)]
        with sm.Scheduler(node=node, window_ms=60.0) as sched:
            _run_concurrent(sched, lambda: Session(node), sqls)
        st = sm.stats_snapshot()
        assert st["slots_acquired"] == st["slots_released"], st
        assert st["stage_work_ms"] > 0
        assert 0.0 <= st["pipeline_overlap_ratio"] <= 1.0


class TestIsolation:
    def test_poisoned_member_is_bisected_out(self):
        """A poisoned literal fails its whole batch; bisection re-runs the
        halves, the innocents complete with their serial rows and only
        the offender fails."""
        node = _mk_node()
        shield.POISON_LITERALS.add(80)
        sqls = [AGG_Q.format(n) for n in (50, 80, 120, 199)]
        ref = {q: Session(node).execute(q)[-1].rows for q in sqls
               if "80" not in q}
        res, errs = {}, {}
        with sm.Scheduler(node=node, window_ms=150.0,
                          pipeline=False) as sched:
            def go(q):
                try:
                    res[q] = sched.run(Session(node), q)[-1].rows
                except Exception as e:   # noqa: BLE001
                    errs[q] = e
            threads = [threading.Thread(target=go, args=(q,)) for q in sqls]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        assert set(errs) == {AGG_Q.format(80)}
        assert isinstance(errs[AGG_Q.format(80)], shield.InjectedFault)
        assert res == ref
        assert shield.stats_snapshot()["batch_failures"] >= 1
        acq, rel = sm.slot_balance()
        assert acq == rel


class TestStats:
    def test_stats_rows_shape(self):
        node = _mk_node()
        with sm.Scheduler(node=node, window_ms=100.0) as sched:
            _run_concurrent(sched, lambda: Session(node),
                            [AGG_Q.format(n) for n in (50, 80)])
        (admitted, queued, batched, shed, dispatches, batch_dispatches,
         p50, p99, hist), = sm.stats_rows()
        assert admitted == 2 and shed == 0 and queued == 0
        assert dispatches >= 1
        assert isinstance(p50, float) and isinstance(p99, float)
        assert isinstance(hist, str)

    def test_reset(self):
        sm._bump("admitted")
        assert sm.stats_snapshot()["admitted"] == 1
        sm.reset_stats()
        assert sm.stats_snapshot()["admitted"] == 0

    def test_not_ported_pieces_raise(self):
        with pytest.raises(NotImplementedError):
            sm.Scheduler(node=None, result_cache=True)
        with pytest.raises(NotImplementedError):
            LocalNode(device="cpu").serve()


def test_same_rows_as_the_reference_scheduler():
    """The same concurrent SQL through the JAX package's Scheduler and the
    port's: equal rows, statement by statement."""
    rnode = RNode()
    _fill(RSession(rnode))
    tnode = _mk_node()
    sqls = [AGG_Q.format(n) for n in (50, 80, 120, 199)] + \
        [f"select v from kv where k = {i}" for i in (3, 11, 29)]
    with rsm.Scheduler(node=rnode, window_ms=150.0) as rs:
        want = _run_concurrent(rs, lambda: RSession(rnode), sqls)
    with sm.Scheduler(node=tnode, window_ms=150.0) as ts:
        got = _run_concurrent(ts, lambda: Session(tnode), sqls)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for gr, wr in zip(g, w):
            assert gr == pytest.approx(wr, rel=1e-12, abs=0)
