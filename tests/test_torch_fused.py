"""The port's fused tier (opentenbase_tpu_torch/exec/fused.py, K14) on the
CPU, against its eager tier and against the JAX package.

On the CPU there is no CUDA graph: a fragment program is the traced
executor run directly over the plain kernel versions, with the same
static shapes, keys, join ladder and counters as on the card.  The first
cases mirror tests/test_plancache.py and tests/test_fusedjoin.py: a
changed literal reuses the program, a changed structure builds another,
a Q3-shaped join fragment is one program with no per-join host read, and
a join whose output overflows its class grows its factor and returns
exact rows.  Then TPC-H Q1, Q6, Q3 and Q5 at sf 0.01 (fused = eager =
the reference), the fused scan-aggregate kernel's plain version against
the JAX package's fused Q1 fragment (__graft_entry__'s q1_step) and the
eager dense aggregate, K5's traced form against its eager form, and the
register-program emitter.

Exact for keys, counts, ints and decimals; f64 averages within relative
1e-10 of the reference (the order of its f64 sums), 1e-12 of the JAX
fragment.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opentenbase_tpu.exec.session import LocalNode as RNode
from opentenbase_tpu.exec.session import Session as RSession
from opentenbase_tpu.ops import kernels as RK
from opentenbase_tpu.tpch import datagen as rdatagen
from opentenbase_tpu.tpch.queries import Q
from opentenbase_tpu.tpch.schema import SCHEMA
from opentenbase_tpu_torch.catalog import types as TT
from opentenbase_tpu_torch.exec import executor as X
from opentenbase_tpu_torch.exec import expr_compile as EC
from opentenbase_tpu_torch.exec import fused, plancache
from opentenbase_tpu_torch.exec.session import LocalNode as TNode
from opentenbase_tpu_torch.exec.session import Session as TSession
from opentenbase_tpu_torch.ops import kernels as K
from opentenbase_tpu_torch.plan import exprs as E
from opentenbase_tpu_torch.sql.parser import parse_sql
from opentenbase_tpu_torch.tpch import datagen as tdatagen

SF = 0.01
F64_RTOL = 1e-10


@pytest.fixture
def fuse_small(monkeypatch):
    """Tiny fixtures: lift the row floor that keeps small joins eager."""
    monkeypatch.setattr(fused, "FUSE_JOIN_MIN_ROWS", 0)


def _node():
    return TNode(device="cpu")


def eager(s, sql):
    """The same statement on the eager tier."""
    X.Executor._fuse = False
    try:
        return s.query(sql)
    finally:
        X.Executor._fuse = True


# ---------------------------------------------------------------------------
# program reuse (tests/test_plancache.py:31-86)
# ---------------------------------------------------------------------------

def test_literal_change_is_a_hit_not_a_capture():
    s = TSession(_node())
    s.execute("create table lit_t (k bigint, v bigint)")
    s.execute("insert into lit_t values "
              + ", ".join(f"({i}, {i * 3})" for i in range(40)))
    assert s.query("select sum(v) from lit_t where k <= 9")[0][0] \
        == sum(i * 3 for i in range(10))
    c0, h0 = plancache.FUSED.compiles, plancache.FUSED.hits
    assert s.query("select sum(v) from lit_t where k <= 19")[0][0] \
        == sum(i * 3 for i in range(20))
    assert plancache.FUSED.compiles == c0, \
        "a literal change must not capture another program"
    assert plancache.FUSED.hits > h0


def test_structure_change_builds_another_program():
    s = TSession(_node())
    s.execute("create table lit_u (k bigint, v bigint)")
    s.execute("insert into lit_u values (1, 2), (3, 4)")
    s.query("select sum(v) from lit_u where k <= 9")
    c0 = plancache.FUSED.compiles + plancache.FUSED.misses
    assert s.query("select sum(v + k) from lit_u where k <= 9") == [(10,)]
    assert plancache.FUSED.compiles + plancache.FUSED.misses > c0


def test_dates_and_decimals_mask_too():
    s = TSession(_node())
    s.execute("create table lit_d (d date, p decimal(10,2))")
    s.execute("insert into lit_d values (date '1995-01-01', 3.50), "
              "(date '1997-06-15', 8.25)")
    r1 = s.query("select count(*) from lit_d "
                 "where d < date '1996-01-01' and p < 5.00")
    c0 = plancache.FUSED.compiles
    r2 = s.query("select count(*) from lit_d "
                 "where d < date '1998-01-01' and p < 9.00")
    assert (r1[0][0], r2[0][0]) == (1, 2)
    assert plancache.FUSED.compiles == c0


def test_write_restages_and_recaptures():
    """A program reads the staged tensors in place: a write restages the
    table, and the next statement runs another program over the new
    version (never a stale one)."""
    s = TSession(_node())
    s.execute("create table w (k bigint, v bigint)")
    s.execute("insert into w values (1, 10), (2, 20)")
    assert s.query("select sum(v) from w where k >= 1") == [(30,)]
    c0 = plancache.FUSED.compiles
    s.execute("insert into w values (3, 30)")
    assert s.query("select sum(v) from w where k >= 1") == [(60,)]
    assert plancache.FUSED.compiles == c0 + 1


# ---------------------------------------------------------------------------
# join fragments (tests/test_fusedjoin.py:69-183)
# ---------------------------------------------------------------------------

def _q3_sess(n_cust=30, n_orders=120, n_items=360):
    """A miniature Q3 world: customer / orders / lineitem."""
    rng = np.random.default_rng(7)
    node = _node()
    s = TSession(node)
    s.execute("create table customer (c_custkey bigint, "
              "c_mktsegment text)")
    s.execute("create table orders (o_orderkey bigint, "
              "o_custkey bigint, o_orderdate bigint, "
              "o_shippriority bigint)")
    s.execute("create table lineitem (l_orderkey bigint, "
              "l_extendedprice bigint, l_shipdate bigint)")
    segs = ["BUILDING", "MACHINERY", "AUTOMOBILE"]
    s._insert_rows(node.catalog.table("customer"), node.stores["customer"],
                   {"c_custkey": np.arange(n_cust),
                    "c_mktsegment": [segs[i % 3] for i in range(n_cust)]},
                   n_cust)
    s._insert_rows(node.catalog.table("orders"), node.stores["orders"],
                   {"o_orderkey": np.arange(n_orders),
                    "o_custkey": rng.integers(0, n_cust, n_orders),
                    "o_orderdate": rng.integers(0, 1000, n_orders),
                    "o_shippriority": rng.integers(0, 2, n_orders)},
                   n_orders)
    s._insert_rows(node.catalog.table("lineitem"), node.stores["lineitem"],
                   {"l_orderkey": rng.integers(0, n_orders, n_items),
                    "l_extendedprice": rng.integers(1, 5000, n_items),
                    "l_shipdate": rng.integers(0, 1000, n_items)},
                   n_items)
    return s


Q3ISH = ("select lineitem.l_orderkey, "
         "sum(lineitem.l_extendedprice) as revenue, "
         "orders.o_orderdate, orders.o_shippriority "
         "from customer, orders, lineitem "
         "where customer.c_mktsegment = 'BUILDING' "
         "and customer.c_custkey = orders.o_custkey "
         "and lineitem.l_orderkey = orders.o_orderkey "
         "and orders.o_orderdate < {d} and lineitem.l_shipdate > {d} "
         "group by lineitem.l_orderkey, orders.o_orderdate, "
         "orders.o_shippriority "
         "order by revenue desc, orders.o_orderdate limit 10")


def test_q3_shape_is_one_program_with_only_the_ladder_read(fuse_small):
    s = _q3_sess()
    q = Q3ISH.format(d=500)
    want = eager(s, q)
    m0, h0 = plancache.FUSED.misses, plancache.FUSED.hits
    x0 = X.exec_stats_snapshot()
    r0 = fused.LADDER_READS
    assert s.query(q) == want
    # the whole two-join fragment is one program...
    assert plancache.FUSED.misses > m0
    # ...with no per-join host read, only the ladder's one a run
    assert X.exec_stats_snapshot()["host_syncs"] == x0["host_syncs"]
    assert fused.LADDER_READS - r0 >= 1
    j0 = X.EXEC_STATS["fused"]["fused_join_hits"]
    r1 = fused.LADDER_READS
    assert s.query(q) == want
    assert plancache.FUSED.hits > h0
    assert X.exec_stats_snapshot()["host_syncs"] == x0["host_syncs"]
    assert fused.LADDER_READS - r1 == 1
    assert X.EXEC_STATS["fused"]["fused_join_hits"] > j0
    # a new constant reuses the program, and matches the eager tier
    c0 = plancache.FUSED.compiles
    got = s.query(Q3ISH.format(d=700))
    assert plancache.FUSED.compiles == c0
    assert got == eager(s, Q3ISH.format(d=700))


def test_ladder_overflow_grows_the_factor_and_rows_are_exact(fuse_small):
    """Every probe row matches every build row: the quarter-size class
    overflows, the factor grows to the class that fits, and the answer
    is exact; the learned factor then serves the next statement."""
    node = _node()
    s = TSession(node)
    s.execute("create table pa (k bigint, v bigint)")
    s.execute("create table pb (k bigint, w bigint)")
    n = 200
    s._insert_rows(node.catalog.table("pa"), node.stores["pa"],
                   {"k": np.ones(n, np.int64), "v": np.arange(n)}, n)
    s._insert_rows(node.catalog.table("pb"), node.stores["pb"],
                   {"k": np.ones(n, np.int64), "w": np.arange(n)}, n)
    lad0 = dict(fused._JOIN_LADDER)
    sql = "select count(*) as c from pa, pb where pa.k = pb.k"
    assert s.query(sql) == [(n * n,)]
    learned = [v for k, v in fused._JOIN_LADDER.items() if k not in lad0]
    assert learned and any(f > 1 for d in learned for f in d.values())
    c0 = plancache.FUSED.compiles + plancache.FUSED.misses
    assert s.query(sql) == [(n * n,)]
    assert plancache.FUSED.compiles + plancache.FUSED.misses == c0


def test_join_under_the_row_floor_stays_eager():
    s = _q3_sess()
    d0 = fused.declines_snapshot().get("row_floor", 0)
    q = Q3ISH.format(d=500)
    assert s.query(q) == eager(s, q)
    assert fused.declines_snapshot().get("row_floor", 0) > d0


# ---------------------------------------------------------------------------
# TPC-H at sf 0.01: fused = eager = the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch():
    data = rdatagen.generate(sf=SF)
    t = TSession(TNode(device="cpu"))
    t.execute(SCHEMA)
    tdatagen.load_into(t, data)
    return data, t


@pytest.fixture(scope="module")
def ref(tpch):
    data, _t = tpch
    r = RSession(RNode())
    r.execute(SCHEMA)
    rdatagen.load_into(r, data)
    return r


def rows_match(got, want, rtol=F64_RTOL):
    assert len(got) == len(want), f"{len(got)} rows != {len(want)}"
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float) \
                    and not (math.isnan(a) and math.isnan(b)):
                assert a == pytest.approx(b, rel=rtol, abs=0), (g, w)
            else:
                assert a == b, (g, w)


def _fused_once(t, sql):
    """Run `sql`, asserting the whole statement went through one fused
    program (no screen declined anything on the way)."""
    d0 = fused.declines_snapshot()
    m0 = plancache.FUSED.misses + plancache.FUSED.hits
    rows = t.query(sql)
    assert fused.declines_snapshot() == d0
    assert plancache.FUSED.misses + plancache.FUSED.hits == m0 + 1
    return rows


@pytest.mark.parametrize("q", [1, 6, 3, 5])
def test_tpch_fused_equals_eager(tpch, q):
    _data, t = tpch
    got = _fused_once(t, Q[q])
    assert got == eager(t, Q[q])
    assert got and _fused_once(t, Q[q]) == got


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_fused_equals_reference(tpch, ref, q):
    _data, t = tpch
    rows_match(_fused_once(t, Q[q]), ref.query(Q[q]))


@pytest.mark.slow   # the reference's own fused-tier tests cover Q3, Q5
@pytest.mark.parametrize("q", [3, 5])
def test_tpch_join_fused_equals_reference(tpch, ref, q):
    _data, t = tpch
    rows_match(_fused_once(t, Q[q]), ref.query(Q[q]))


def test_q1_q6_go_through_the_fused_scan_aggregate(tpch, monkeypatch):
    _data, t = tpch
    seen = []
    real = K.fused_scan_agg

    def spy(*a, **kw):
        seen.append(a[0])
        return real(*a, **kw)
    monkeypatch.setattr(K, "fused_scan_agg", spy)
    t.query(Q[1])
    t.query(Q[6])
    assert len(seen) == 2
    q1, q6 = seen
    assert q1.n_groups == 6 and len(q1.aggs) == 11 and q1.n_lits == 1
    assert q6.n_groups == 1 and len(q6.aggs) == 1 and q6.qual_reg >= 0


# ---------------------------------------------------------------------------
# fused_scan_agg's plain version against the JAX package's fused Q1
# fragment (__graft_entry__ q1_step) and the eager dense aggregate
# ---------------------------------------------------------------------------

def _q1_arrays(n=8192, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "qty": rng.integers(100, 5100, n).astype(np.int64),
        "price": rng.integers(90000, 110000, n).astype(np.int64),
        "disc": rng.integers(0, 11, n).astype(np.int64),
        "tax": rng.integers(0, 9, n).astype(np.int64),
        "ship": rng.integers(9000, 10600, n).astype(np.int32),
        "rf": rng.integers(0, 3, n).astype(np.int32),
        "ls": rng.integers(0, 2, n).astype(np.int32),
    }


def _jax_q1_step(cols, ship_max):
    """__graft_entry__.entry()'s q1_step, its ship date bound a
    parameter (the JAX package's K4 kernel)."""
    c = {k: jnp.asarray(v) for k, v in cols.items()}
    valid = c["ship"] <= jnp.int32(ship_max)
    disc_price = c["price"] * (100 - c["disc"])
    charge = disc_price * (100 + c["tax"])
    gid = c["rf"].astype(jnp.int64) * 2 + c["ls"].astype(jnp.int64)
    outs, present = RK.grouped_agg_dense(
        gid, valid,
        (c["qty"], c["price"], disc_price, charge, c["qty"], c["disc"],
         c["qty"]),
        6, ("sum", "sum", "sum", "sum", "sumf", "sumf", "count"))
    return [np.asarray(o) for o in outs], np.asarray(present)


def _q1_program(cols):
    """q1_step as a register program of the fused kernel."""
    i64, i32 = TT.INT64, TT.INT32
    c = {n: E.Col(f"t.{n}", i32 if n in ("ship", "rf", "ls") else i64)
         for n in cols}
    names = list(cols) + ["__xmin_ts", "__xmax_ts", "__xmin_txid",
                          "__xmax_txid"]
    slot = {f"t.{n}": j for j, n in enumerate(names)}
    disc_price = E.Arith("*", c["price"],
                         E.Arith("-", E.Lit(100, i64), c["disc"]))
    charge = E.Arith("*", disc_price,
                     E.Arith("+", E.Lit(100, i64), c["tax"]))
    aggs = [(K.FUSED_SUM, c["qty"]), (K.FUSED_SUM, c["price"]),
            (K.FUSED_SUM, disc_price), (K.FUSED_SUM, charge),
            (K.FUSED_SUM, c["qty"]), (K.FUSED_SUM, c["disc"]),
            (K.FUSED_COUNT, None)]
    qual = E.Cmp("<=", c["ship"], E.Col("__fraglit0", i32))
    spec = EC.emit_scan_agg(
        [qual], aggs, [(c["rf"], 3), (c["ls"], 2)], slot.get,
        {"__fraglit0": 0}.get, [slot[f"t.{n}"] for n in names[-4:]], {}, 1)
    assert spec is not None
    n = len(cols["qty"])
    mvcc = [torch.zeros(n, dtype=torch.int64),
            torch.full((n,), K.INT64_MAX, dtype=torch.int64),
            torch.zeros(n, dtype=torch.int64),
            torch.zeros(n, dtype=torch.int64)]
    tcols = [(torch.from_numpy(cols[k]), None, None) for k in cols] \
        + [(m, None, None) for m in mvcc]
    return spec, tcols


@pytest.mark.parametrize("bounds", [(10471,), (10471, 9000, 9500, 10600)])
def test_fused_scan_agg_plain_equals_the_jax_q1_fragment(bounds):
    cols = _q1_arrays()
    spec, tcols = _q1_program(cols)
    k = len(bounds)
    lits = torch.tensor([[b] for b in bounds], dtype=torch.int64)
    snaps = torch.ones(k, dtype=torch.int64)
    txids = torch.full((k,), 99, dtype=torch.int64)
    ws = K.fused_scan_agg(spec, tcols, len(cols["qty"]), lits, snaps,
                          txids, -1)
    assert tuple(ws.shape) == (k, 8, 6)
    for slot, b in enumerate(bounds):
        outs, present = _jax_q1_step(cols, b)
        tab = ws[slot].numpy()
        for a in range(4):
            np.testing.assert_array_equal(tab[a], outs[a])
        for a in (4, 5):      # the f64 sums: an exact int64 sum, converted
            np.testing.assert_allclose(tab[a].astype(np.float64), outs[a],
                                       rtol=1e-12, atol=0)
        np.testing.assert_array_equal(tab[6], outs[6])
        np.testing.assert_array_equal(tab[7], present)
        # and the port's eager dense aggregate (K4's plain version)
        t = {n: torch.from_numpy(v) for n, v in cols.items()}
        valid = t["ship"] <= b
        dp = t["price"] * (100 - t["disc"])
        gid = t["rf"].to(torch.int64) * 2 + t["ls"].to(torch.int64)
        eo, ep = K.grouped_agg_dense_plain(
            gid, valid, (t["qty"], t["price"], dp, dp * (100 + t["tax"]),
                         t["qty"], t["disc"], valid.to(torch.int64)), 6,
            ("sum", "sum", "sum", "sum", "sumf", "sumf", "sum"))
        for a in range(7):
            assert torch.equal(ws[slot, a].to(eo[a].dtype), eo[a])
        assert torch.equal(ws[slot, 7], ep)


# ---------------------------------------------------------------------------
# K5's traced form, the emitter
# ---------------------------------------------------------------------------

def _group_cases(rng, n):
    imax = np.iinfo(np.int64)
    valid = rng.random(n) < 0.85
    a = rng.integers(imax.min, imax.max, 40, dtype=np.int64)
    f = rng.choice([-1.5, -0.0, 0.0, 2.0, np.nan, np.inf], n)
    return [
        ((rng.integers(0, 40, n), rng.integers(8000, 8030, n)
          .astype(np.int32), rng.integers(0, 2, n)), valid),
        ((rng.choice(a, n), rng.choice(a[:5], n)), valid),
        ((rng.integers(imax.min, imax.max, n, dtype=np.int64) | 1,), valid),
        ((f, rng.integers(0, 4, n)), valid),
        ((rng.integers(0, 4, n),), np.zeros(n, bool)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_k5_traced_form_equals_the_eager_form(case):
    rng = np.random.default_rng(11 + case)
    n = 3000
    keys, valid = _group_cases(rng, n)[case]
    tk = tuple(torch.from_numpy(np.ascontiguousarray(k)) for k in keys)
    ins = (torch.from_numpy(rng.integers(-9, 9, n)),
           torch.from_numpy(rng.normal(0, 1, n)))
    args = (tk, torch.from_numpy(valid), ins, 4096, ("sum", "max"))
    gk, go, gn = K.grouped_agg_sort(*args, traced=True)
    wk, wo, wn = K.grouped_agg_sort(*args)
    assert int(gn) == int(wn)
    m = int(wn)
    for g, w in zip(gk, wk):      # group order included
        assert torch.equal(g[:m], w[:m]) or (
            g.dtype.is_floating_point
            and torch.equal(torch.isnan(g[:m]), torch.isnan(w[:m])))
    for g, w in zip(go, wo):
        assert torch.equal(g[:m], w[:m])


def _plan(t, sql):
    return t._plan_select(parse_sql(sql)[0]).plan


def test_emitter_accepts_q1_and_q6_and_declines_the_rest(tpch, monkeypatch):
    _data, t = tpch
    specs, launches = [], []
    real_emit, real_kernel = EC.emit_scan_agg, K.fused_scan_agg

    def spy_emit(*a, **kw):
        specs.append(real_emit(*a, **kw))
        return specs[-1]

    def spy_kernel(*a, **kw):
        launches.append(a[0])
        return real_kernel(*a, **kw)
    monkeypatch.setattr(EC, "emit_scan_agg", spy_emit)
    monkeypatch.setattr(K, "fused_scan_agg", spy_kernel)
    t.query(Q[1])
    t.query(Q[6])
    assert len(specs) == 2 and all(sp is not None for sp in specs)
    assert len(launches) == 2
    # an EXTRACT and a CASE reach the emitter and are declined there; an
    # f64 aggregate input is declined before it.  Each statement still
    # answers through the fused tier's generic program, as eagerly.
    s = TSession(_node())
    s.execute("create table em (d date, q decimal(15,2), p double "
              "precision)")
    s.execute("insert into em values (date '1995-02-01', 5.00, 1.5), "
              "(date '1996-03-01', 12.00, 2.5), "
              "(date '1995-07-04', 30.00, 4.0)")
    for sql, emitted in (
            ("select count(*) from em where extract(year from d) = 1995",
             [None]),
            ("select sum(case when q < 10 then 1 else 0 end) from em "
             "where q < 20", [None]),
            ("select sum(p * 1.5e0) from em where q < 20", [])):
        specs.clear()
        launches.clear()
        assert s.query(sql) == eager(s, sql)
        assert specs == emitted and launches == []


@pytest.mark.parametrize("sql", [
    "select count(v), count(*), sum(k) from nt where k > 0",
    "select t, count(v), avg(k), min(k), max(k) from nt where k >= 1 "
    "group by t order by t",
    "select t, sum(v) from nt where k < 9 group by t order by t"])
def test_nullable_columns_answer_as_eagerly(sql):
    """A column with NULLs keeps the fragment off the fused scan-aggregate
    kernel (which has no NULL masks); the fused tier's generic program
    answers, equal to the eager tier."""
    s = TSession(_node())
    s.execute("create table nt (k bigint, v bigint, t text)")
    s.execute("insert into nt values (1, 10, 'a'), (2, null, 'b'), "
              "(3, 30, 'a'), (4, null, 'a')")
    assert s.query(sql) == eager(s, sql)


@pytest.mark.parametrize("sql, want", [
    ("select min(x), max(x) from e", (2147483647, -2147483648)),
    ("select count(*), sum(x), min(x) from w where k > 100",
     (0, 0, 2147483647)),
    ("select min(x), max(x), min(d), max(d), count(*) from w where k > 100",
     None),
    ("select min(x), max(x), count(*) from w where k > 1", (-7, 9, 2))])
def test_int32_min_max_over_no_rows_on_the_fused_tier(sql, want,
                                                       monkeypatch):
    """K14 keeps an INT / DATE min or max in int64 with the int64
    identities; over no rows the port gives the output dtype's own
    identities (2147483647, -2147483648), as the reference does, not the
    low words of the int64 ones (-1, 0)."""
    launches = []
    real = K.fused_scan_agg

    def spy(*a, **kw):
        launches.append(a[0])
        return real(*a, **kw)
    monkeypatch.setattr(K, "fused_scan_agg", spy)
    ddl = ["create table e (k bigint, x int)",
           "create table w (k bigint, x int, d date)",
           "insert into w values (1, 5, date '1995-01-01'), "
           "(2, -7, date '1996-01-01'), (3, 9, date '1997-01-01')"]
    r, t = RSession(RNode()), TSession(_node())
    for stmt in ddl:
        r.execute(stmt)
        t.execute(stmt)
    got = t.query(sql)
    assert len(launches) == 1
    assert got == r.query(sql) == eager(t, sql)
    if want is not None:
        assert got == [want]
