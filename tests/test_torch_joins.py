"""Join-slice parity: TPC-H queries with hash joins (inner, semi, anti,
left outer with a residual) and sort-based GROUP BY, plus small SELECTs
for the join kinds TPC-H leaves out, through the reference Session and
the port's Session on the same data.

The port runs with device="cpu" here, so its kernels take their plain
PyTorch versions.  None of these queries has an f64 average, so every
output (keys, counts, integers, decimals computed from exact scaled
int64 sums) must be equal exactly.
"""

import numpy as np
import pytest

import tpch_oracle as O
from opentenbase_tpu.exec.session import LocalNode as RNode
from opentenbase_tpu.exec.session import Session as RSession
from opentenbase_tpu.tpch import datagen as rdatagen
from opentenbase_tpu.tpch.queries import Q
from opentenbase_tpu.tpch.schema import SCHEMA
from opentenbase_tpu_torch.exec.session import LocalNode as TNode
from opentenbase_tpu_torch.exec.session import Session as TSession
from opentenbase_tpu_torch.ops import kernels as TK
from opentenbase_tpu_torch.tpch import datagen as tdatagen

SF = 0.01


@pytest.fixture(scope="module")
def data():
    return rdatagen.generate(sf=SF)


@pytest.fixture(scope="module")
def sessions(data):
    r = RSession(RNode())
    r.execute(SCHEMA)
    rdatagen.load_into(r, data)
    t = TSession(TNode(device="cpu"))
    t.execute(SCHEMA)
    tdatagen.load_into(t, data)
    return r, t


def _iso(days):
    return str(np.datetime64("1970-01-01", "D")
               + np.timedelta64(int(days), "D"))


def rows_close(got, want, float_tol=1e-2):
    """tests/test_tpch.py's oracle comparison (pandas sums floats)."""
    assert len(got) == len(want), f"{len(got)} rows != {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"row {i}: arity"
        for a, b in zip(g, w):
            if isinstance(b, float) or isinstance(a, float):
                assert a == pytest.approx(b, abs=float_tol, rel=1e-6), \
                    f"row {i}: {a} != {b} (got={g}, want={w})"
            else:
                assert a == b, f"row {i}: {a!r} != {b!r}"


JOIN_QUERIES = [3, 4, 5, 10, 12, 13, 22]


@pytest.mark.parametrize("q", JOIN_QUERIES)
def test_tpch_join_query_matches_reference(sessions, q):
    r, t = sessions
    want = r.query(Q[q])
    got = t.query(Q[q])
    assert len(want) > 0
    assert got == want


def _oracle_rows(q, dfs):
    if q == 3:
        return [(r.l_orderkey, r.rev, _iso(r.o_orderdate), r.o_shippriority)
                for r in O.q3(dfs).itertuples()]
    if q == 4:
        return [(r.o_orderpriority, r.n) for r in O.q4(dfs).itertuples()]
    if q == 5:
        return [(r.n_name, r.rev) for r in O.q5(dfs).itertuples()]
    if q == 12:
        return [(r.l_shipmode, r.high, r.low)
                for r in O.q12(dfs).itertuples()]
    if q == 13:
        return [(r.c_count, r.custdist) for r in O.q13(dfs).itertuples()]
    raise KeyError(q)


@pytest.mark.parametrize("q", [3, 4, 5, 12, 13])
def test_tpch_join_query_matches_pandas_oracle(sessions, data, q):
    _, t = sessions
    dfs = rdatagen.as_dataframes(data)
    rows_close(t.query(Q[q]), _oracle_rows(q, dfs))


def test_q10_matches_pandas_oracle(sessions, data):
    _, t = sessions
    dfs = rdatagen.as_dataframes(data)
    got = [(r[0], r[1], round(r[2], 2)) for r in t.query(Q[10])]
    want = [(r.c_custkey, r.c_name, round(r.rev, 2))
            for r in O.q10(dfs).itertuples()]
    rows_close(got, want)


def test_q16_still_raises(sessions):
    """Q16 needs count(DISTINCT ...), which is not yet ported."""
    _, t = sessions
    with pytest.raises(NotImplementedError, match="DISTINCT aggregates"):
        t.query(Q[16])


# every other TPC-H query the port answers now (Q16 still raises)
OTHER_QUERIES = [1, 2, 6, 7, 8, 9, 11, 14, 15, 17, 18, 19, 20, 21]


@pytest.mark.slow
@pytest.mark.parametrize("q", OTHER_QUERIES)
def test_other_tpch_query_matches_reference(sessions, q):
    r, t = sessions
    want = r.query(Q[q])
    got = t.query(Q[q])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-10, abs=0)
            else:
                assert a == b


# ---------------------------------------------------------------------------
# join kinds and shapes TPC-H leaves out
# ---------------------------------------------------------------------------

SMALL_DDL = [
    "create table ta (k bigint, k2 bigint, av bigint, at text)",
    "create table tb (k bigint, k2 bigint, bv bigint, bt text)",
    # duplicate keys (expansion), NULL keys (never match), NULL payloads,
    # disjoint tails (outer-join extension on both sides), shared text
    "insert into ta values (1, 10, 100, 'a1'), (1, 11, 101, 'a2'), "
    "(2, 20, 200, 'a3'), (3, 30, null, 'a4'), (null, 40, 400, 'a5'), "
    "(7, 70, 700, 'b9'), (2, 21, 201, null)",
    "insert into tb values (1, 10, 1000, 'b1'), (1, 10, 1001, 'b2'), "
    "(2, 21, 2000, 'a3'), (4, 40, null, 'b4'), (null, 50, 5000, 'b5'), "
    "(9, 90, 9000, 'b9'), (2, 22, -5, 'a1')",
]
for _t in ("j1", "j2", "j3", "j4"):
    SMALL_DDL.append(f"create table {_t} (k bigint, {_t}a bigint, "
                     f"{_t}b bigint, {_t}c text)")
    SMALL_DDL.append(f"insert into {_t} values " + ", ".join(
        f"({i}, {i * 2 + len(_t)}, {i * 3}, 'v{i % 5}')"
        for i in range(0, 40, 1 + int(_t[1]) % 3)))

SMALL_JOINS = [
    # inner, single key, text payloads
    "select ta.av, tb.bv, ta.at, tb.bt from ta, tb "
    "where ta.k = tb.k order by ta.av, tb.bv",
    # inner, two keys: hashed (K11) then rechecked by value
    "select ta.av, tb.bv from ta, tb "
    "where ta.k = tb.k and ta.k2 = tb.k2 order by ta.av, tb.bv",
    # inner + residual
    "select ta.av, tb.bv from ta, tb "
    "where ta.k = tb.k and ta.av < tb.bv order by ta.av, tb.bv",
    # join on TEXT keys (stable string hashes of two dictionaries)
    "select ta.av, tb.bv, ta.at from ta, tb "
    "where ta.at = tb.bt order by ta.av, tb.bv",
    # left outer: NULL keys never match, unmatched rows null-extend
    "select ta.av, tb.bv, tb.bt from ta left join tb on ta.k = tb.k "
    "order by ta.av, tb.bv",
    # left outer, two keys: rows whose pairs the recheck kills revert
    "select ta.av, tb.bv from ta left join tb "
    "on ta.k = tb.k and ta.k2 = tb.k2 order by ta.av, tb.bv",
    # left outer whose residual kills every real pair
    "select ta.av, tb.bv from ta left join tb "
    "on ta.k = tb.k and tb.bv < -100 order by ta.av, tb.bv",
    # full outer: unmatched build rows append null-extended
    "select ta.av, tb.bv from ta full join tb on ta.k = tb.k "
    "order by ta.av, tb.bv",
    # full outer, two keys: pairs the recheck kills count as unmatched
    "select ta.av, tb.bv from ta full join tb "
    "on ta.k = tb.k and ta.k2 = tb.k2 order by ta.av, tb.bv",
    # semi / anti (EXISTS / NOT EXISTS)
    "select ta.av from ta where exists "
    "(select 1 from tb where tb.k = ta.k) order by ta.av",
    "select ta.av from ta where not exists "
    "(select 1 from tb where tb.k = ta.k) order by ta.av",
    # semi / anti with a correlated residual (per-probe-row any())
    "select ta.av from ta where exists "
    "(select 1 from tb where tb.k = ta.k and tb.bv > ta.av) "
    "order by ta.av",
    "select ta.av from ta where not exists "
    "(select 1 from tb where tb.k = ta.k and tb.bv > ta.av) "
    "order by ta.av",
    # cross join
    "select ta.av, tb.bv from ta, tb where ta.av > 300 and tb.bv > 4000 "
    "order by ta.av, tb.bv",
    # a three-join chain whose lazy columns compose, sort-based GROUP BY
    # with a nullable key above it
    "select j1.j1a, j4.j4c, j2.j2b from j1, j2, j3, j4 "
    "where j1.k = j2.k and j2.k = j3.k and j3.k = j4.k order by j1.j1a",
    "select tb.bt, ta.av, count(*), sum(tb.bv) from ta left join tb "
    "on ta.k = tb.k group by tb.bt, ta.av order by ta.av, tb.bt",
    "select j4.j4c, count(*), min(j1.j1a), max(j2.j2b) from j1, j2, j3, j4 "
    "where j1.k = j2.k and j2.k = j3.k and j3.k = j4.k group by j4.j4c "
    "order by j4.j4c",
]


@pytest.fixture(scope="module")
def small_sessions():
    r, t = RSession(RNode()), TSession(TNode(device="cpu"))
    for s in (r, t):
        for sql in SMALL_DDL:
            s.execute(sql)
    return r, t


@pytest.mark.parametrize("sql", SMALL_JOINS)
def test_small_join_matches_reference(small_sessions, sql):
    r, t = small_sessions
    want = r.query(sql)
    assert len(want) > 0
    assert t.query(sql) == want


def test_join_chain_moves_indices_not_payloads(small_sessions, monkeypatch):
    """Late materialization: the joins of a chain compose index vectors
    (compose_indices) instead of gathering every carried column, one
    call for each join side whatever the number of priors it carries."""
    r, t = small_sessions
    composed = []
    real = TK.compose_indices

    def counting(priors, take, masks=()):
        composed.append(len(priors))
        return real(priors, take, masks)
    monkeypatch.setattr(TK, "compose_indices", counting)
    sql = SMALL_JOINS[14]
    assert t.query(sql) == r.query(sql)
    assert sum(composed) >= 2
    assert len(composed) < sum(composed)


def test_lazy_batch_surface_matches_reference():
    """DBatch's late-materialization surface (the mesh tier and the
    final aggregate read it through has_col / maybe_null / col /
    col_opt / gather_rows) against the reference's, on one batch with a
    materialized column, a lazy one with a source null mask and a lazy
    one with an output-space (outer-join) null mask."""
    import jax.numpy as jnp
    import torch
    from opentenbase_tpu.exec import executor as RX
    from opentenbase_tpu_torch.exec import executor as TX
    rng = np.random.default_rng(80)
    src = rng.integers(0, 100, 50)
    idx = rng.integers(0, 50, 30)
    nsrc = rng.random(50) < 0.3
    nout = rng.random(30) < 0.2
    valid = rng.random(30) < 0.8
    mat = rng.integers(-5, 5, 30)
    take = rng.integers(0, 30, 12)

    def build(X, arr):
        return X.DBatch({"m": arr(mat)}, arr(valid), {}, {}, {}, {
            "a": X.LazyCol(arr(src), arr(idx), arr(nsrc)),
            "b": X.LazyCol(arr(src * 2), arr(idx), None, arr(nout))})
    r = build(RX, jnp.asarray)
    t = build(TX, lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    assert t.names() == r.names() == ["m", "a", "b"]
    assert t.count() == r.count() == int(valid.sum())
    for n in ("m", "a", "b", "zz"):
        assert t.has_col(n) == r.has_col(n)
        assert t.maybe_null(n) == r.maybe_null(n)
    tc, tn = t.gather_rows(torch.from_numpy(take))
    rc, rn = r.gather_rows(jnp.asarray(take))
    assert sorted(tc) == sorted(rc) and sorted(tn) == sorted(rn)
    for n in rc:
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(rc[n]))
    for n in rn:
        np.testing.assert_array_equal(tn[n].numpy(), np.asarray(rn[n]))
    assert t.col_opt("zz") is None and r.col_opt("zz") is None
    np.testing.assert_array_equal(t.col("a").numpy(), np.asarray(r.col("a")))
    assert "a" not in t.lazy and "b" in t.lazy
    t.ensure(["b", "zz"]).ensure_all()
    r.ensure_all()
    assert not t.lazy
    for n in ("a", "b"):
        np.testing.assert_array_equal(t.nulls[n].numpy(),
                                      np.asarray(r.nulls[n]))
