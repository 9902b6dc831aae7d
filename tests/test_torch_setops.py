"""Append and set operations through the port against the JAX package:
UNION [ALL], INTERSECT / EXCEPT [ALL], and ROLLUP / CUBE / GROUPING SETS
(which sql/rewrite.py expands into a UNION ALL of grouped branches).

The statements are the set-operation and grouping-set cases of
tests/test_sql_surface.py and the UNION cases of tests/test_distributed.py,
on the same small tables, plus TEXT branches with different dictionaries,
NULL, -0.0 / +0.0 and NaN keys, and branches that keep no rows.  The
port's Session and its ClusterSession(Cluster(2)) (the cluster program,
and the host tier with enable_mesh_exchange off) answer each against the
reference's Session; the test_distributed.py cases run on the port's
Cluster(2) and Cluster(3) against the reference's ClusterSession.  NaN
keys are held to a numpy oracle: the port groups a FLOAT64 key by its
canonical order word (ROADMAP queue 3, recorded divergence 1).  Then the
device concat and the SetOp expand at odd lengths, on the plain kernel
versions, against numpy.

Exact for keys, counts, ints and decimals; f64 within relative 1e-12.
"""

import math

import numpy as np
import pytest
import torch

from opentenbase_tpu.exec.dist_session import ClusterSession as RCluster
from opentenbase_tpu.exec.session import LocalNode as RNode
from opentenbase_tpu.exec.session import Session as RSession
from opentenbase_tpu.parallel.cluster import Cluster as RClusterNodes
from opentenbase_tpu_torch.catalog import types as TT
from opentenbase_tpu_torch.exec import executor as X
from opentenbase_tpu_torch.exec.dist_session import ClusterSession
from opentenbase_tpu_torch.exec.session import LocalNode as TNode
from opentenbase_tpu_torch.exec.session import Session as TSession
from opentenbase_tpu_torch.ops import kernels as K
from opentenbase_tpu_torch.parallel.cluster import Cluster
from opentenbase_tpu_torch.sql.analyze import BindError

F64_RTOL = 1e-12

#: tests/test_sql_surface.py's tables (t, its `sess` fixture; u, its
#: `cs` fixture, there on 3 DataNodes), tn = t plus the all-NULL row of
#: test_setop_nulls_equal, fz / fz2 of test_setop_float_zero_sign; a / b
#: are TEXT branches with different dictionaries, fa / fb float keys
SETUP = [
    "create table t (g varchar(2), x bigint, v decimal(6,1))",
    "insert into t values ('a',1,10.0),('a',2,20.0),('a',2,30.0),"
    "('b',5,1.5),('b',7,2.5)",
    "create table tn (g varchar(2), x bigint, v decimal(6,1))",
    "insert into tn values ('a',1,10.0),('a',2,20.0),('a',2,30.0),"
    "('b',5,1.5),('b',7,2.5),(null, null, null)",
    "create table fz (f float)",
    "insert into fz values (0.0)",
    "create table fz2 (f float)",
    "insert into fz2 values (-0.0)",
    "create table u (k bigint primary key, g varchar(2), x bigint, "
    "v decimal(6,1)) distribute by shard(k)",
    "insert into u values " + ", ".join(
        f"({i}, 'g{i % 3}', {i % 7}, {i}.5)" for i in range(30)),
    "create table a (k bigint, s varchar(4), n int)",
    "insert into a values (1, 'p', 10), (2, 'q', 20), (3, 'zz', null), "
    "(4, 'p', 40)",
    "create table b (k bigint, s varchar(4), n int)",
    "insert into b values (5, 'a', 1), (6, 'q', 2), (7, null, 3), "
    "(8, 'mm', null)",
]

#: the set-operation and grouping-set statements of test_sql_surface.py
#: (:162-235, :459-484, and its CTE with a UNION body), each with
#: whether its rows come in a defined order
SURFACE = [
    ("select x from t where g = 'a' intersect select x from t order by x",
     True),
    ("select x from t intersect all select x from t order by x", True),
    ("select x from t except select x from t where g = 'a' order by x",
     True),
    ("select x from t except all select x from t where x = 2 order by x",
     True),
    ("select x from t except all select x from t where g = 'b' and x = 5 "
     "union all select x from t where x = 99 order by x", True),
    ("select x from t except select x from t where x = 2 order by x", True),
    ("select g from tn intersect select g from tn where g is null", False),
    ("select x from t where x = 1 union select x from t where x = 2 "
     "intersect select x from t where x = 2 order by x", True),
    ("(select x from t order by x desc limit 1) union select x from t "
     "where x = 1 order by x", True),
    ("select f from fz intersect select f from fz2", False),
    ("select k from u where k < 10 except select k from u where k < 5 "
     "order by k", True),
    ("with c as (select x from t where g = 'a' union select x from t "
     "where g = 'b') select count(*) from c", True),
    ("select g, x, sum(v) as s from t group by rollup (g, x) "
     "order by g nulls last, x nulls last", True),
    ("select g, x, count(*) as n from t group by cube (g, x)", False),
    ("select g, grouping(g) as gg, sum(v) as s from t "
     "group by grouping sets ((g), ()) order by g nulls last", True),
    ("select g, count(*) as n from u group by rollup (g) "
     "order by g nulls last", True),
]

#: TEXT branches with different dictionaries (ORDER BY, comparisons,
#: GROUP BY, DISTINCT, min / max), NULL keys, and branches with no rows
EXTRA = [
    ("select s from a union all select s from b order by s nulls first",
     True),
    ("select s from a union select s from b", False),
    ("select s from a union select s from b order by 1 desc", True),
    ("select s, count(*), sum(n) from (select s, n from a union all "
     "select s, n from b) z group by s order by s", True),
    ("select s from (select s from a union all select s from b) z "
     "where s > 'mm' order by s", True),
    ("select min(s), max(s), min(n), max(n) from (select s, n from a "
     "union all select s, n from b) z", True),
    ("select s, n from a intersect select s, n from b", False),
    ("select s from a intersect select s from b order by s", True),
    ("select s from a except all select s from b order by s", True),
    ("select n from a except select n from b order by n nulls first", True),
    ("select n from a intersect select n from a where n is null", True),
    ("select s, 'x' as c from a union all select 'lit', 'y' from b "
     "order by 1, 2", True),
    ("select x from t where x > 100 union all select x from t order by x",
     True),
    ("select x from t where x > 100 union select x from t where x < 0",
     True),
    ("select x from t intersect select x from t where x > 100", True),
    ("select x from t where x > 100 except select x from t", True),
    ("select x from t except all select x from t where x > 100 "
     "order by x", True),
    ("select g, count(*) from (select g from t where x > 100 union all "
     "select g from t where g = 'b') z group by g order by g", True),
]


def rows_match(got, want, ordered=True):
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want), f"{len(got)} rows != {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"row {i}: arity"
        for p, q in zip(g, w):
            if isinstance(q, float) and isinstance(p, float) \
                    and not (math.isnan(p) and math.isnan(q)):
                assert p == pytest.approx(q, rel=F64_RTOL, abs=0), \
                    f"row {i}: {p} != {q} ({g} vs {w})"
            else:
                assert p == q or (p != p and q != q), \
                    f"row {i}: {p!r} != {q!r} ({g} vs {w})"


def _key(row):
    return tuple((v is None, str(type(v)),
                  v if v is not None and v == v else 0) for v in row)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def sessions():
    """(the reference's Session, the port's Session, the port's
    ClusterSession(Cluster(2)))."""
    r, t = RSession(RNode()), TSession(TNode(device="cpu"))
    c = ClusterSession(Cluster(2, device="cpu"))
    for stmt in SETUP:
        r.execute(stmt)
        t.execute(stmt)
        c.execute(stmt)
    return r, t, c


@pytest.mark.parametrize("sql, ordered", SURFACE + EXTRA)
def test_single_node_matches_reference(sessions, sql, ordered):
    r, t, _c = sessions
    rows_match(t.query(sql), r.query(sql), ordered)


@pytest.mark.parametrize("sql, ordered", SURFACE + EXTRA)
def test_eager_tier_matches_reference(sessions, sql, ordered):
    """Every node on the eager tier: the Append's K3 compaction (the
    default tier fuses branches and aggregates, never the Append)."""
    r, t, _c = sessions
    X.Executor._fuse = False
    try:
        got = t.query(sql)
    finally:
        X.Executor._fuse = True
    rows_match(got, r.query(sql), ordered)


@pytest.mark.parametrize("sql, ordered", SURFACE + EXTRA)
def test_cluster_matches_reference(sessions, sql, ordered):
    """Cluster(2): the cluster program (a UNION ALL of sharded branches
    runs per DataNode inside it; INTERSECT / EXCEPT gather to the
    coordinator) and the host tier."""
    r, _t, c = sessions
    want = r.query(sql)
    rows_match(c.query(sql), want, ordered)
    assert c.fallbacks == []
    c.execute("set enable_mesh_exchange = off")
    try:
        rows_match(c.query(sql), want, ordered)
        assert c.last_tier != "mesh"
    finally:
        c.execute("set enable_mesh_exchange = on")


def _spy(monkeypatch, names):
    """Count the calls of the named kernel wrappers (on the CPU a wrapper
    takes its plain version and launches nothing)."""
    calls = dict.fromkeys(names, 0)
    for n in names:
        real = getattr(K, n)

        def spy(*a, _n=n, _real=real, **kw):
            calls[_n] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(K, n, spy)
    return calls


SETOP_WRAPPERS = ("grouped_agg_sort", "join_expand", "compose_indices",
                  "compact")


def test_sharded_union_all_runs_in_the_cluster_program(sessions,
                                                       monkeypatch):
    """A UNION ALL of sharded branches runs per DataNode inside the
    program (the traced Append): one K9 gather a DataNode remaps its TEXT
    codes, and nothing compacts it."""
    r, _t, c = sessions
    sql = ("select g, count(*), sum(v) from (select g, v from u where k < 20 "
           "union all select case when x > 3 then 'hi' else 'lo' end, v "
           "from u where k >= 10) z group by g order by g")
    want = r.query(sql)
    calls = _spy(monkeypatch, ("compose_indices", "compact"))
    from opentenbase_tpu_torch.exec import mesh_exec as ME
    traced = []
    real = X.Executor._exec_append

    def append(self, node):
        traced.append(self._traced)
        return real(self, node)
    monkeypatch.setattr(X.Executor, "_exec_append", append)
    rows_match(c.query(sql), want)
    assert c.last_tier == "mesh" and c.fallbacks == []
    assert traced == [True, True] and ME.MeshRunner._capture
    assert calls["compose_indices"] >= 2


def test_set_operations_run_on_k5_k8_k9(sessions, monkeypatch):
    """SetOp: K5 counts each group's rows per side, K8 expands the
    copies, K9 gathers the keys (one call) after the TEXT remap (one
    call); the eager Append remaps TEXT with K9 and compacts with K3."""
    _r, t, _c = sessions
    calls = _spy(monkeypatch, SETOP_WRAPPERS)
    t.query("select s from a except all select s from b")
    assert calls == {"grouped_agg_sort": 1, "join_expand": 1,
                     "compose_indices": 2, "compact": 0}
    calls.update(dict.fromkeys(calls, 0))
    t.query("select s, k from a union all select s, k from b")
    assert calls == {"grouped_agg_sort": 0, "join_expand": 0,
                     "compose_indices": 1, "compact": 1}
    calls.update(dict.fromkeys(calls, 0))
    t.query("select k from a union all select k from b")
    assert calls["compose_indices"] == 0 and calls["compact"] == 1


# ---------------------------------------------------------------------------
# tests/test_distributed.py:322-372 on Cluster(2) and Cluster(3)
# ---------------------------------------------------------------------------

DIST_SETUP = [
    "create table t (k bigint primary key, v decimal(10,2), "
    "name varchar(16)) distribute by shard(k)",
    "create table d (id int primary key, label varchar(16)) "
    "distribute by replication",
    "insert into d values (1, 'one'), (2, 'two')",
    "insert into t values " + ", ".join(f"({i}, {i}.50, 'n{i}')"
                                        for i in range(40)),
]

DIST_UNIONS = [
    ("select k from t where k < 3 union all select k from t where k < 2 "
     "order by k", True),
    ("select k from t where k < 3 union select k from t where k < 5 "
     "order by k", True),
    ("select name from t where k = 1 union all select name from t "
     "where k = 2 order by 1", True),
    ("select k from t union all select k from t order by k limit 3", True),
    ("select k from t union all select k from t order by k limit 3 "
     "offset 2", True),
    ("select 0 from d union all select 0 from d union select 0 from d",
     True),
    ("select k from t where k = 0 union all select k from t where k = 1 "
     "union all select k from t where k = 2 order by k", True),
    ("select v from t where k = 1 union all select cast(v as "
     "decimal(10,4)) from t where k = 1", False),
    ("select name from t where k < 4 union all select label from d "
     "order by 1", True),
]


@pytest.fixture(scope="module")
def dist_sessions():
    """The reference's ClusterSession on 3 DataNodes, the port's on 2 and
    on 3."""
    out = [RCluster(RClusterNodes(n_datanodes=3)),
           ClusterSession(Cluster(2, device="cpu")),
           ClusterSession(Cluster(3, device="cpu"))]
    for s in out:
        for stmt in DIST_SETUP:
            s.execute(stmt)
    return out


@pytest.mark.parametrize("sql, ordered", DIST_UNIONS)
def test_distributed_unions_match_reference_cluster(dist_sessions, sql,
                                                    ordered):
    ref, c2, c3 = dist_sessions
    want = ref.query(sql)
    for c in (c2, c3):
        rows_match(c.query(sql), want, ordered)
        assert c.fallbacks == []


@pytest.mark.parametrize("sql, match", [
    ("select k, v from t union select k from t", "column counts"),
    ("select k from t union all select k from t order by 5", "out of range"),
])
def test_distributed_union_bind_errors(dist_sessions, sql, match):
    for c in dist_sessions[1:]:
        with pytest.raises(BindError, match=match):
            c.query(sql)


# ---------------------------------------------------------------------------
# float keys: NULL, -0.0 / +0.0, NaN, +-inf against a numpy oracle
# ---------------------------------------------------------------------------

FA = [0.0, -0.0, float("nan"), 1.5, None, float("nan"), float("-inf"), 1.5]
FB = [-0.0, float("nan"), None, 2.0, float("inf"), 1.5]


def _canon(v):
    """A float key as the port groups it: -0.0 = +0.0, NaN = NaN, NULL =
    NULL (float_word's classes)."""
    if v is None:
        return ("null",)
    if v != v:
        return ("nan",)
    return ("num", v + 0.0)


def _setop_oracle(op, all_, left, right):
    """The multiset of canonical keys a set operation returns."""
    from collections import Counter
    cl, cr = Counter(map(_canon, left)), Counter(map(_canon, right))
    out = Counter()
    for k in set(cl) | set(cr):
        c1, c2 = cl[k], cr[k]
        if op == "union":
            n = c1 + c2 if all_ else 1
        elif op == "intersect":
            n = min(c1, c2) if all_ else min(c1, c2, 1)
        else:
            n = max(c1 - c2, 0) if all_ else int(c1 > 0 and c2 == 0)
        if n:
            out[k] = n
    return out


@pytest.fixture(scope="module")
def float_sessions():
    t = TSession(TNode(device="cpu"))
    c = ClusterSession(Cluster(2, device="cpu"))
    for name, vals in (("fa", FA), ("fb", FB)):
        cols = {"k": np.arange(len(vals), dtype=np.int64), "f": list(vals)}
        ddl = f"create table {name} (k bigint, f double precision)"
        t.execute(ddl)
        t._insert_rows(t.node.catalog.table(name), t.node.stores[name],
                       cols, len(vals))
        c.execute(ddl + " distribute by shard(k)")
        c._insert_rows(c.cluster.catalog.table(name), cols, len(vals))
    return t, c


@pytest.mark.parametrize("op, all_", [
    ("union", False), ("union", True), ("intersect", False),
    ("intersect", True), ("except", False), ("except", True)])
def test_float_keys_match_numpy_oracle(float_sessions, op, all_):
    sql = f"select f from fa {op}{' all' if all_ else ''} select f from fb"
    from collections import Counter
    want = _setop_oracle(op, all_, FA, FB)
    for s in float_sessions:
        got = s.query(sql)
        assert Counter(_canon(v) for (v,) in got) == want, (sql, got)


def test_float_keys_ordered(float_sessions):
    """INTERSECT ALL of a table with itself, ordered: the table's own
    ordered rows, every -0.0 given back as +0.0 (its group's key)."""
    sql = "select f from fa intersect all select f from fa order by f"
    for s in float_sessions:
        got = [v for (v,) in s.query(sql)]
        want = [v if v is None else v + 0.0
                for (v,) in s.query("select f from fa order by f")]
        assert [_canon(v) for v in got] == [_canon(v) for v in want]
        assert not any(v == 0 and math.copysign(1.0, v) < 0 for v in got
                       if v is not None)


# ---------------------------------------------------------------------------
# the device concat and the SetOp expand at odd lengths (plain versions)
# ---------------------------------------------------------------------------

def _batch(rng, n, live, dict_, nulls):
    codes = rng.integers(0, max(len(dict_), 1), n).astype(np.int32)
    valid = np.zeros(n, bool)
    valid[:live] = True
    cols = {"s": torch.from_numpy(codes),
            "x": torch.from_numpy(rng.integers(-9, 9, n)),
            "f": torch.from_numpy(rng.standard_normal(n))}
    nm = {"x": torch.from_numpy(rng.random(n) < 0.3)} if nulls else {}
    return X.DBatch(cols, torch.from_numpy(valid),
                    {"s": TT.TEXT, "x": TT.INT64, "f": TT.FLOAT64},
                    {"s": list(dict_)}, nm)


def _ctx_executor():
    node = TNode(device="cpu")
    ctx = X.ExecContext(node.stores, 0, 0, node.cache)
    return X.Executor(ctx)


@pytest.mark.parametrize("lens", [(1, 1), (3, 5), (7, 1, 9), (5, 0, 3)])
def test_concat_plain_at_odd_lengths(lens):
    rng = np.random.default_rng(sum(lens))
    dicts = [["q", "b", "zz"], [], ["b", "c", "a", "q"], ["zz"]]
    parts = [_batch(rng, max(n, 1), n, dicts[i % 4], nulls=i % 2 == 1)
             for i, n in enumerate(lens)]
    host = [(p.cols["s"].numpy().copy(), p.dicts["s"]) for p in parts]
    ex = _ctx_executor()
    for traced in (True, False):
        ex._traced = traced
        out = ex._concat(parts)
        values = out.dicts["s"]
        assert values == sorted(set().union(*(d for _c, d in host)))
        want = []
        for (c, d) in host:
            dd = d or [values[0] if values else ""]
            want += [values.index(dd[min(max(int(v), 0), len(dd) - 1)])
                     if d else 0 for v in c]
        np.testing.assert_array_equal(out.cols["s"].numpy(), want)
        assert out.cols["s"].dtype == torch.int32
        for name in ("x", "f"):
            np.testing.assert_array_equal(
                out.cols[name].numpy(),
                np.concatenate([p.cols[name].numpy() for p in parts]))
        np.testing.assert_array_equal(
            out.valid.numpy(),
            np.concatenate([p.valid.numpy() for p in parts]))
        want_nm = np.concatenate([
            p.nulls["x"].numpy() if "x" in p.nulls
            else np.zeros(p.padded, bool) for p in parts])
        np.testing.assert_array_equal(out.nulls["x"].numpy(), want_nm)
    ex._traced = False


@pytest.mark.parametrize("n, out_size", [(1, 1), (3, 4), (7, 16),
                                         (33, 64), (4097, 8192)])
def test_setop_expand_plain_at_odd_lengths(n, out_size):
    """K8 as SetOp calls it: copies as the counts, zeros of the input's
    length as lo and perm: each group's index repeated copies times, in
    group order, (0, 0) past the total."""
    rng = np.random.default_rng(n)
    copies = rng.integers(0, 4, n)
    copies[rng.random(n) < 0.5] = 0
    total = int(copies.sum())
    if total > out_size:
        copies[:] = 0
        copies[: out_size // 2] = 1
        total = int(copies.sum())
    lo = torch.zeros(n, dtype=torch.int64)
    group, build, tot = K.join_expand(lo, torch.from_numpy(copies), lo,
                                      out_size)
    want = np.zeros(out_size, np.int64)
    want[:total] = np.repeat(np.arange(n), copies)
    assert int(tot) == total
    np.testing.assert_array_equal(group.numpy(), want)
    np.testing.assert_array_equal(build.numpy(), np.zeros(out_size))


def test_union_dictionary_is_sorted_and_cached():
    d1, d2 = ["q", "b", "q2"], ["a", "q"]
    values, luts = X._union_dict((d1, d2, ()))
    assert values == ["a", "b", "q", "q2"]
    assert [lut.tolist() for lut in luts] == [[2, 1, 3], [0, 2], [0]]
    assert X._union_dict((d1, d2, ()))[0] is values
    d1.append("c")   # a dictionary that grew is another entry
    assert X._union_dict((d1, d2, ()))[0] == ["a", "b", "c", "q", "q2"]
