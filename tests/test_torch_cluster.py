"""Cluster-tier parity: the port's ClusterSession over Cluster(n,
device="cpu") against the JAX package's ClusterSession over Cluster(n),
on the same generated data.

The port's device tier (exec/mesh_exec.py: N logical DataNodes on one
device, K11 routing, K12 exchange, K3 gather compaction) runs its plain
PyTorch kernel versions here.  Keys, counts, integers and scaled
decimals must be equal exactly; f64 values (averages, quotients) within
relative 1e-10, the only difference being the order of summation.
"""

import numpy as np
import pytest

from opentenbase_tpu.exec.dist_session import ClusterSession as RSession
from opentenbase_tpu.parallel.cluster import Cluster as RCluster
from opentenbase_tpu.tpch import datagen as rdatagen
from opentenbase_tpu.tpch.queries import Q
from opentenbase_tpu.tpch.schema import SCHEMA
from opentenbase_tpu_torch.exec.dist_session import ClusterSession
from opentenbase_tpu_torch.ops import kernels as TK
from opentenbase_tpu_torch.parallel.cluster import Cluster
from opentenbase_tpu_torch.tpch import datagen as tdatagen

SF = 0.01
TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")


def rows_match(got, want):
    assert len(got) == len(want), f"{len(got)} rows != {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"row {i}: arity"
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-10, abs=0), \
                    f"row {i}: {a} != {b}"
            else:
                assert a == b, f"row {i}: {a!r} != {b!r}"


@pytest.fixture(scope="module")
def data():
    return rdatagen.generate(sf=SF)


def _clusters(data, n):
    r = RSession(RCluster(n_datanodes=n))
    r.execute(SCHEMA)
    for tname in TABLES:
        tbl = data[tname]
        r._insert_rows(r.cluster.catalog.table(tname), tbl,
                       len(next(iter(tbl.values()))))
    t = ClusterSession(Cluster(n, device="cpu"))
    t.execute(SCHEMA)
    tdatagen.load_into_cluster(t, data)
    return r, t


@pytest.fixture(scope="module")
def tpch2(data):
    return _clusters(data, 2)


@pytest.fixture(scope="module")
def tpch3(data):
    return _clusters(data, 3)


@pytest.fixture(scope="module")
def envs(tpch2, tpch3):
    return {2: tpch2, 3: tpch3}


# ---------------------------------------------------------------------------
# TPC-H Q1, Q3, Q5 through the device tier
# ---------------------------------------------------------------------------

def _count_calls(monkeypatch, names):
    """Count the calls of the named kernel wrappers (on the CPU the
    launch counters stay 0: a wrapper counts launches of its kernel)."""
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(TK, n)

        def rec(*a, _n=n, _fn=fn, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(TK, n, rec)
    return calls


def _watch_exchanges(monkeypatch):
    """(kernel calls, exchange kinds of every run of the DataNode side of
    every plan the device tier ran, init plans and size-class ladder
    reruns included)."""
    from opentenbase_tpu_torch.exec import mesh_exec
    calls = _count_calls(monkeypatch, ("route_dest", "exchange",
                                       "exchange_fixed", "compact"))
    kinds: list = []
    body = mesh_exec.MeshRunner._run_fragments

    def rec(self, run, dp, *a, **kw):
        kinds.extend(ex.kind for ex in dp.exchanges)
        return body(self, run, dp, *a, **kw)
    monkeypatch.setattr(mesh_exec.MeshRunner, "_run_fragments", rec)
    return calls, kinds


def _assert_exchanges_on_kernels(calls, kinds, ndn):
    """Every redistribute went through K11 (one launch a source
    DataNode) and K12 (either form), every broadcast through K12, every
    gather through K3 (once a DataNode; once for gather_one): nothing
    moved rows another way."""
    red = kinds.count("redistribute")
    assert kinds, "no plan ran on the device tier"
    assert calls["route_dest"] == ndn * red
    assert calls["exchange"] + calls["exchange_fixed"] \
        == red + kinds.count("broadcast")
    assert calls["compact"] == ndn * kinds.count("gather") \
        + kinds.count("gather_one")


@pytest.mark.parametrize("q", [1, 3, 5])
@pytest.mark.parametrize("n", [2, 3])
def test_tpch_query_matches_reference_cluster(envs, n, q, monkeypatch):
    r, t = envs[n]
    want = r.query(Q[q])
    assert r.last_tier == "mesh"
    calls, kinds = _watch_exchanges(monkeypatch)
    got = t.query(Q[q])
    assert len(want) > 0
    rows_match(got, want)
    assert t.last_tier == "mesh" and t.fallbacks == []
    assert kinds.count("redistribute") == {1: 1, 3: 2, 5: 4}[q]
    _assert_exchanges_on_kernels(calls, kinds, n)


def test_device_tier_counts_every_query_as_mesh(tpch2):
    _r, t = tpch2
    before = dict(t.tier_counts)
    for q in (1, 3, 5):
        t.query(Q[q])
    assert t.tier_counts.get("mesh", 0) == before.get("mesh", 0) + 3
    assert t.tier_counts.get("host", 0) == before.get("host", 0)
    assert t.fallbacks == []


@pytest.mark.parametrize("q", [1, 3, 5])
def test_host_tier_equals_device_tier(tpch2, q):
    _r, t = tpch2
    t.execute("set enable_mesh_exchange = off")
    try:
        host = t.query(Q[q])
        assert t.last_tier == "host"
    finally:
        t.execute("set enable_mesh_exchange = on")
    rows_match(t.query(Q[q]), host)


def test_exchange_row_counts_cover_every_row(tpch2):
    """The K12 count matrices of Q5: every live row of each source lands
    on exactly one destination, and a warm repeat stages nothing."""
    from opentenbase_tpu_torch.exec.mesh_exec import mesh_runner_for
    _r, t = tpch2
    t.query(Q[5])
    runner = mesh_runner_for(t.cluster)
    kinds = [k for _i, k, _c in runner.last_exchanges]
    assert kinds == ["redistribute"] * 4
    for _i, _k, counts in runner.last_exchanges:
        assert counts.shape == (2, 2) and counts.sum() > 0
    pool = t.cluster.pool
    up, misses = pool.uploaded_bytes, pool.cluster_misses
    t.query(Q[5])
    assert pool.uploaded_bytes == up and pool.cluster_misses == misses


# ---------------------------------------------------------------------------
# placement: the port's Cluster(n) stores what the reference's stores
# ---------------------------------------------------------------------------

def _live(store, names):
    cols = store.host_live_columns(names)
    out = {}
    for n in names:
        a = cols[n]
        if n in store.dicts:
            a = np.asarray(store.dicts[n].values, dtype=object)[a] \
                if len(a) else np.asarray([], dtype=object)
        out[n] = a
    for n in store.null_columns:
        out["__null." + n] = cols.get("__null." + n)
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_rows_placed_on_the_reference_datanodes(envs, data, n):
    r, t = envs[n]
    for tname in TABLES:
        names = [c.name for c in
                 t.cluster.catalog.table(tname).columns]
        total = 0
        for rdn, tdn in zip(r.cluster.datanodes, t.cluster.datanodes):
            rs, ts = rdn.stores[tname], tdn.stores[tname]
            assert ts.row_count() == rs.row_count(), (tname, tdn.index)
            got, want = _live(ts, names), _live(rs, names)
            assert set(got) == set(want)
            for c in want:
                np.testing.assert_array_equal(got[c], want[c],
                                              err_msg=f"{tname}.{c}")
            total += ts.row_count()
        rows = len(next(iter(data[tname].values())))
        if tname in ("region", "nation"):
            assert total == n * rows          # replicated everywhere
        else:
            assert total == rows


# ---------------------------------------------------------------------------
# tests/test_mesh_sql.py's cases inside the slice
# ---------------------------------------------------------------------------

_DDL = [
    "create table t (k bigint primary key, grp int, v decimal(10,2), "
    "nm varchar(8)) distribute by shard(k)",
    "create table u (uk bigint primary key, tk bigint, w decimal(10,2)) "
    "distribute by shard(uk)",
    "create table d (id int primary key, label varchar(8)) "
    "distribute by replication",
    "insert into t values " + ", ".join(
        f"({i}, {i % 3}, {i}.25, 'g{i % 3}')" for i in range(40)),
    "insert into u values " + ", ".join(
        f"({100 + i}, {i % 40}, {i}.5)" for i in range(60)),
    "insert into d values (0, 'zero'), (1, 'one'), (2, 'two')",
    "create table s (name varchar(8), x int) distribute by shard(name)",
    "insert into s values ('g0', 10), ('g1', 11), ('g2', 12), ('zz', 99)",
]


@pytest.fixture()
def small():
    r = RSession(RCluster(n_datanodes=4))
    t = ClusterSession(Cluster(4, device="cpu"))
    for sql in _DDL:
        r.execute(sql)
        t.execute(sql)
    return r, t


def both(r, t, sql):
    """The port's device tier, the port's host tier and the reference's
    host tier (which the reference's own suite holds equal to its
    device tier) give the same rows; the device tier moved every row
    through the kernels."""
    r.execute("set enable_mesh_exchange = off")
    want = r.query(sql)
    t.execute("set enable_mesh_exchange = off")
    host = t.query(sql)
    assert t.last_tier == "host"
    t.execute("set enable_mesh_exchange = on")
    with pytest.MonkeyPatch.context() as mp:
        calls, kinds = _watch_exchanges(mp)
        got = t.query(sql)
    assert t.last_tier == "mesh" and t.fallbacks == []
    _assert_exchanges_on_kernels(calls, kinds, t.cluster.ndn)
    rows_match(got, want)
    rows_match(host, want)
    return got


MESH_SQL = {
    "global_agg": "select count(*), sum(v), min(v), max(v) from t",
    "group_by_text": "select nm, count(*), sum(v) from t group by nm "
                     "order by nm",
    "redistribute_join": "select nm, count(*), sum(w) from t, u "
                         "where k = tk group by nm order by nm",
    "replicated_dim_join": "select label, count(*) from t, d "
                           "where grp = id group by label order by label",
    "left_join": "select k, w from t left join u on k = tk and w > 25 "
                 "where k < 6 order by k, w",
    "filter_sort_limit": "select k, v from t where v > 10 "
                         "order by v desc limit 5",
    "q5_shape": "select label, sum(v * w) as rev from t, u, d "
                "where k = tk and grp = id group by label order by rev desc",
    # beyond test_mesh_sql.py: a broadcast (left join, replicated probe
    # side), a replicated-only gather (gather_one), an init plan, and a
    # TEXT distribution key (t moves by nm to where s's rows live)
    "broadcast_left_join": "select label, count(k) from d left join t "
                           "on id = grp group by label order by label",
    "replicated_only": "select * from d order by id",
    "init_plan": "select nm, count(*) from t where v > "
                 "(select avg(v) from t) group by nm order by nm",
    "text_dist_key_join": "select nm, x, count(*) from t, s "
                          "where nm = name group by nm, x order by nm",
}


@pytest.mark.parametrize("case", sorted(MESH_SQL))
def test_mesh_sql_case(small, case):
    r, t = small
    got = both(r, t, MESH_SQL[case])
    if case == "global_agg":
        assert got[0][0] == 40
    if case == "group_by_text":
        assert [row[0] for row in got] == ["g0", "g1", "g2"]
    if case == "filter_sort_limit":
        assert len(got) == 5
    if case == "text_dist_key_join":
        assert [row[:2] for row in got] == [("g0", 10), ("g1", 11),
                                            ("g2", 12)]


def test_broadcast_exchange_runs_on_the_device_tier(small):
    from opentenbase_tpu_torch.exec.mesh_exec import mesh_runner_for
    _r, t = small
    t.query(MESH_SQL["broadcast_left_join"])
    kinds = [k for _i, k, _c in mesh_runner_for(t.cluster).last_exchanges]
    assert kinds == ["broadcast"]


def test_nulls_through_the_exchange(small):
    r, t = small
    for s in (r, t):
        s.execute("insert into t values (900, 0, null, null)")
    both(r, t, "select nm, count(v), count(*) from t group by nm "
               "order by nm")
    assert both(r, t, "select k from t where v is null") == [(900,)]


def test_device_tier_sees_new_rows(small):
    _r, t = small
    before = t.query("select count(*) from t")[0][0]
    up = t.cluster.pool.uploaded_bytes
    t.execute("insert into t values (901, 0, 1.00, 'g0')")
    assert t.query("select count(*) from t")[0][0] == before + 1
    assert t.cluster.pool.uploaded_bytes > up     # restaged after the write


def test_q5_shape_on_three_datanodes():
    """__graft_entry__.dryrun_multichip's SQL (sharded ⋈ sharded on a
    non-distribution key, ⋈ a replicated table, grouped and ordered) on
    3 DataNodes, where the shard map is not hash % 3: device tier = host
    tier = the reference's device tier."""
    ddl = [
        "create table t (k bigint primary key, grp int, v decimal(10,2)) "
        "distribute by shard(k)",
        "create table u (uk bigint primary key, tk bigint, "
        "w decimal(10,2)) distribute by shard(uk)",
        "create table d (id int primary key, label varchar(8)) "
        "distribute by replication",
        "insert into t values " + ", ".join(
            f"({i}, {i % 3}, {i}.25)" for i in range(64)),
        "insert into u values " + ", ".join(
            f"({100 + i}, {i % 64}, {i}.5)" for i in range(96)),
        "insert into d values (0, 'zero'), (1, 'one'), (2, 'two')",
    ]
    sql = ("select label, count(*) as n, sum(v * w) as rev "
           "from t, u, d where k = tk and grp = id "
           "group by label order by rev desc")
    r = RSession(RCluster(n_datanodes=3))
    t = ClusterSession(Cluster(3, device="cpu"))
    for s in ddl:
        r.execute(s)
        t.execute(s)
    want = r.query(sql)
    assert r.last_tier == "mesh"
    t.execute("set enable_mesh_exchange = off")
    host = t.query(sql)
    t.execute("set enable_mesh_exchange = on")
    with pytest.MonkeyPatch.context() as mp:
        calls, kinds = _watch_exchanges(mp)
        got = t.query(sql)
    assert t.last_tier == "mesh" and t.fallbacks == []
    _assert_exchanges_on_kernels(calls, kinds, 3)
    rows_match(got, want)
    rows_match(host, want)


def test_cluster_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        assert Cluster(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Cluster(2)


def test_unported_statements_raise(small):
    _r, t = small
    for sql in ("begin", "delete from t where k = 1",
                "update t set v = 1 where k = 1",
                "explain select * from t"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            t.execute(sql)


def test_device_tier_refuses_a_datanode_fragment_over_a_gather():
    """A plan whose DataNode fragment consumes a gathered input (the
    reference runs that part on its host tier) raises on the device
    tier instead of leaving it; so does a coordinator fragment that
    reads a DataNode-side exchange."""
    from opentenbase_tpu_torch.exec.mesh_exec import (MeshUnsupported,
                                                       mesh_runner_for)
    from opentenbase_tpu_torch.plan.distribute import (
        BatchSource, DistPlan, Exchange, ExchangeRef, Fragment)
    runner = mesh_runner_for(Cluster(2, device="cpu"))
    over_gather = DistPlan(
        [Fragment(0, BatchSource(), "dn"),
         Fragment(1, ExchangeRef(index=0), "dn"),
         Fragment(2, ExchangeRef(index=1), "cn")],
        [Exchange(0, "gather", [], 0), Exchange(1, "gather", [], 1)],
        2, [], [])
    cn_over_redistribute = DistPlan(
        [Fragment(0, BatchSource(), "dn"),
         Fragment(1, ExchangeRef(index=0), "cn")],
        [Exchange(0, "redistribute", [], 0)], 1, [], [])
    for dp, what in ((over_gather, "over a gathered input"),
                     (cn_over_redistribute, "DataNode-side exchange")):
        with pytest.raises(MeshUnsupported, match=what):
            runner.run(dp, 0, 0, {})
    assert issubclass(MeshUnsupported, NotImplementedError)


# ---------------------------------------------------------------------------
# the other TPC-H queries
# ---------------------------------------------------------------------------

OTHER_QUERIES = [2, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 17, 18, 19, 20,
                 21, 22]


@pytest.mark.slow
@pytest.mark.parametrize("q", OTHER_QUERIES)
def test_other_tpch_query_matches_reference_cluster(tpch2, q,
                                                    monkeypatch):
    r, t = tpch2
    want = r.query(Q[q])
    calls, kinds = _watch_exchanges(monkeypatch)
    got = t.query(Q[q])
    rows_match(got, want)
    assert t.last_tier == r.last_tier == "mesh" and t.fallbacks == []
    _assert_exchanges_on_kernels(calls, kinds, 2)


@pytest.mark.slow
def test_q16_still_raises(tpch2):
    _r, t = tpch2
    with pytest.raises(NotImplementedError, match="DISTINCT aggregates"):
        t.query(Q[16])
