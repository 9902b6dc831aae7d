"""Slice parity: TPC-H Q1 and Q6 (and smaller SELECTs of the same
operators) through the reference Session and the port's Session on the
same generated data.

The port runs with device="cpu" here, so its kernels take their plain
PyTorch versions.  Group keys, counts, integer and decimal outputs must
be equal exactly; f64 outputs (averages) within relative 1e-10, the only
reason being the order of the f64 summation.
"""

import math

import numpy as np
import pytest

import tpch_oracle as O
from opentenbase_tpu.exec.session import LocalNode as RNode
from opentenbase_tpu.exec.session import Session as RSession
from opentenbase_tpu.storage import codec as rcodec
from opentenbase_tpu.tpch import datagen as rdatagen
from opentenbase_tpu.tpch.queries import Q
from opentenbase_tpu.tpch.schema import SCHEMA
from opentenbase_tpu_torch.exec.session import LocalNode as TNode
from opentenbase_tpu_torch.exec.session import Session as TSession
from opentenbase_tpu_torch.storage import codec as tcodec
from opentenbase_tpu_torch.tpch import datagen as tdatagen
from opentenbase_tpu_torch.tpch.queries import Q as TQ
from opentenbase_tpu_torch.tpch.schema import SCHEMA as TSCHEMA

SF = 0.01
F64_RTOL = 1e-10


@pytest.fixture(scope="module")
def data():
    return rdatagen.generate(sf=SF)


@pytest.fixture(scope="module")
def sessions(data):
    r = RSession(RNode())
    r.execute(SCHEMA)
    rdatagen.load_into(r, data)
    t = TSession(TNode(device="cpu"))
    t.execute(TSCHEMA)
    tdatagen.load_into(t, data)
    return r, t


def rows_match(got, want):
    assert len(got) == len(want), f"{len(got)} rows != {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"row {i}: arity"
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float) \
                    and not (math.isnan(a) and math.isnan(b)):
                assert a == pytest.approx(b, rel=F64_RTOL, abs=0), \
                    f"row {i}: {a} != {b} ({g} vs {w})"
            else:
                assert a == b or (a != a and b != b), \
                    f"row {i}: {a!r} != {b!r} ({g} vs {w})"


def test_datagen_equal_array_by_array(data):
    port = tdatagen.generate(sf=SF)
    assert list(port) == list(data)
    for tname, cols in data.items():
        assert list(port[tname]) == list(cols), tname
        for c, ref in cols.items():
            a, b = np.asarray(port[tname][c]), np.asarray(ref)
            # string columns may differ in numpy width, never in values
            assert a.shape == b.shape, (tname, c)
            assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind == "U"

            np.testing.assert_array_equal(a, b, err_msg=f"{tname}.{c}")


def test_queries_are_the_same_text():
    assert TQ == Q and TSCHEMA == SCHEMA


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_query_matches_reference(sessions, q):
    r, t = sessions
    want = r.query(Q[q])
    got = t.query(TQ[q])
    rows_match(got, want)
    # keys, counts and decimal sums are exact, not merely close
    if q == 1:
        for g, w in zip(got, want):
            assert g[:6] == w[:6] and g[9] == w[9]
    else:
        assert got == want


def test_q1_matches_pandas_oracle(sessions, data):
    _, t = sessions
    dfs = rdatagen.as_dataframes(data)
    o = O.q1(dfs)
    want = [(r.l_returnflag, r.l_linestatus, r.sum_qty, r.sum_base_price,
             r.sum_disc_price, r.sum_charge, r.avg_qty, r.avg_price,
             r.avg_disc, r.count_order) for r in o.itertuples()]
    got = t.query(TQ[1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[9] == w[9]
        for a, b in zip(g[2:9], w[2:9]):
            assert a == pytest.approx(b, abs=1e-2, rel=1e-6)


def test_q6_matches_pandas_oracle(sessions, data):
    _, t = sessions
    dfs = rdatagen.as_dataframes(data)
    want = float(O.q6(dfs))
    got = t.query(TQ[6])
    assert got[0][0] == pytest.approx(want, abs=1e-2, rel=1e-6)


def test_codec_class_parity(sessions):
    """The port's codec picks the same family, width and codes as the
    reference for every column a Q1 scan stages (sys columns included)."""
    _, t = sessions
    st = t.node.stores["lineitem"]
    host = st.host_live_columns(st.td.column_names)
    table = "parity_lineitem"
    rcodec.invalidate_ladder(table)
    tcodec.invalidate_ladder(table)
    staged = 0
    for name in sorted(host):
        h = host[name]
        r = rcodec.encode_staged(table, name, h)
        p = tcodec.encode_staged(table, name, h)
        assert (r is None) == (p is None), name
        if r is None:
            continue
        staged += 1
        assert tcodec.codec_class(p[1]) == rcodec.codec_class(r[1]), name
        np.testing.assert_array_equal(p[0], r[0])
        np.testing.assert_array_equal(p[2], r[2])
    assert staged >= 16


# ---------------------------------------------------------------------------
# smaller SELECTs over the same operators: filters with NULLs (3VL),
# decimal arithmetic, dense GROUP BY on text / bool keys, global
# aggregates, ORDER BY with DESC and LIMIT
# ---------------------------------------------------------------------------

T_DDL = ("create table t (k bigint primary key, g varchar(4), h varchar(4), "
         "b boolean, i integer, d decimal(10,2), f double precision, "
         "dt date) distribute by shard(k)")


def _t_rows():
    rng = np.random.default_rng(11)
    rows = []
    for k in range(200):
        g = ["x", "y", "zz", None][int(rng.integers(0, 4))]
        h = ["p", "q", "r"][int(rng.integers(0, 3))]
        b = bool(rng.integers(0, 2))
        i = None if rng.random() < 0.1 else int(rng.integers(-50, 50))
        d = None if rng.random() < 0.1 else \
            round(float(rng.uniform(-100, 100)), 2)
        f = float(rng.normal(0, 10))
        dt = f"199{int(rng.integers(0, 10))}-0{int(rng.integers(1, 10))}-1" \
             f"{int(rng.integers(0, 10))}"
        rows.append((k, g, h, b, i, d, f, dt))
    return rows


def _lit(v):
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f"'{v}'" if not v.startswith("199") else f"date '{v}'"
    return str(v)


@pytest.fixture(scope="module")
def small_sessions():
    r = RSession(RNode())
    t = TSession(TNode(device="cpu"))
    ins = "insert into t values " + ", ".join(
        "(" + ", ".join(_lit(v) for v in row) + ")" for row in _t_rows())
    for s in (r, t):
        s.execute(T_DDL)
        s.execute(ins)
    return r, t


SMALL_QUERIES = [
    "select count(*), sum(d), min(i), max(i), avg(d), sum(f) from t",
    "select h, count(*), sum(i), avg(i), min(d), max(d) from t "
    "group by h order by h",
    "select b, count(*), sum(d * 2 - 1), max(f) from t group by b order by b",
    "select h, b, count(i), count(g) from t where i > 0 or d < 0 "
    "group by h, b order by h desc, b",
    "select g, k from t where k < 30 order by g, k desc",
    "select k, d, i from t where d is not null and i is null order by k",
    "select k, d + i, d * i, i % 7, -i from t where k < 40 order by k",
    "select k, f from t order by f desc, k limit 7",
    "select k, case when i > 10 then 'big' when i < -10 then 'neg' "
    "else 'mid' end from t where k between 10 and 30 order by k",
    "select k, coalesce(i, -1), nullif(i, 3), extract(year from dt) "
    "from t where k < 25 order by k",
    "select count(*) from t where g like 'z%' and dt >= date '1995-01-01'",
    "select k from t where g in ('x', 'zz') and not b order by k limit 5",
    "select sum(cast(d as double precision)), max(cast(i as bigint)) "
    "from t where i <> 0",
    "select k, row_number() over (order by k) from t",
    "select k from t union select k from t",
]


@pytest.mark.parametrize("sql", SMALL_QUERIES)
def test_small_select_matches_reference(small_sessions, sql):
    r, t = small_sessions
    rows_match(t.query(sql), r.query(sql))


@pytest.mark.parametrize("sql", [
    "select count(distinct i) from t",               # DISTINCT aggregate
    "update t set i = 1 where k = 1",
    "begin",                                         # explicit txn
    "delete from t where k = 1",
])
def test_unported_statements_raise(small_sessions, sql):
    _, t = small_sessions
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t.execute(sql)


def test_inserts_after_a_query_restage_and_stay_visible():
    """The buffer cache is keyed by store version: rows inserted after a
    query (VALUES and INSERT ... SELECT) are staged and visible to the
    next snapshot, in both packages alike."""
    r, t = RSession(RNode()), TSession(TNode(device="cpu"))
    steps = [
        "create table u (k bigint primary key, v decimal(8,2), s varchar(3))"
        " distribute by shard(k)",
        "insert into u values (1, 1.50, 'a'), (2, -2.25, 'b')",
        "select s, count(*), sum(v) from u group by s order by s",
        "insert into u values (3, 4.00, 'a'), (4, 0.75, 'c')",
        "select s, count(*), sum(v) from u group by s order by s",
        "insert into u select k + 10, v * 2, s from u where v > 0",
        "select k, v, s from u order by k",
        "select count(*), sum(v), max(k) from u",
    ]
    for sql in steps:
        want, got = r.execute(sql)[-1], t.execute(sql)[-1]
        assert (got.command, got.rowcount) == (want.command, want.rowcount)
        rows_match(got.rows, want.rows)
    assert t.query("select count(*) from u") == [(7,)]
