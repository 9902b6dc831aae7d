"""Window functions (K13): the port against the JAX package, through SQL,
and the K13 kernels' plain versions against a direct numpy oracle.

The SQL cases run on small tables (at most 240 rows) through the
reference's Session(LocalNode()) and the port's
Session(LocalNode(device="cpu")), where the K13 wrappers take their
plain PyTorch versions.  Tolerances: ranks, counts, integers, decimals
and TEXT exactly; f64 sums and averages of a double precision argument
within relative 1e-12 (the order of the f64 additions differs; the
prefix-sum difference of the reference loses no more than that at
these sizes).  Decimal averages are exact: the f64 prefix sums of
scaled integers are exact below 2^53, and the quotient is the
reference's (sum / count / 10**scale) in the same order.

The same statements run on the port's ClusterSession over
Cluster(2, device="cpu"), against the port's single node: one window
partitions by the distribution key (it runs in each DataNode's
fragment), the others do not (they run after the gather).
"""

import math

import numpy as np
import pytest
import torch

from opentenbase_tpu.exec.session import LocalNode as RNode
from opentenbase_tpu.exec.session import Session as RSession
from opentenbase_tpu_torch.exec import fused as TF
from opentenbase_tpu_torch.exec.dist_session import ClusterSession
from opentenbase_tpu_torch.exec.session import LocalNode as TNode
from opentenbase_tpu_torch.exec.session import Session as TSession
from opentenbase_tpu_torch.ops import kernels as TK
from opentenbase_tpu_torch.parallel.cluster import Cluster

F64_RTOL = 1e-12
N_ROWS = 240


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


T_DDL = "create table t (g varchar(2), x bigint, v decimal(6,1))"
T_ROWS = ("insert into t values ('a',1,10.0),('a',2,20.0),('a',2,30.0),"
          "('b',5,1.5),('b',7,2.5)")
R_DDL = ("create table r (k bigint primary key, g varchar(4), h int, "
         "x bigint, v decimal(8,2), f double precision, s varchar(6))")


def _r_data(seed: int = 13) -> dict:
    """Seeded rows with NULL partition and order keys, ties, -0.0 and
    +0.0, NaN and TEXT in every position."""
    rng = np.random.default_rng(seed)
    n = N_ROWS
    g = [None if m else str(v) for m, v in zip(
        rng.random(n) < 0.1, rng.choice(["aa", "b", "cc", "d", "ee"], n))]
    h = [None if m else int(v) for m, v in zip(
        rng.random(n) < 0.1, rng.integers(0, 6, n))]
    v = [None if m else round(float(x), 2) for m, x in zip(
        rng.random(n) < 0.15, rng.uniform(-500, 500, n))]
    f = rng.choice([-1.5, -0.0, 0.0, 0.25, 2.0, 7.5, np.nan], n).tolist()
    f = [float(x) + (0.0 if i % 3 else float(rng.integers(0, 4)))
         for i, x in enumerate(f)]
    words = ["ab", "abc", "b", "ba", "zz", "m", "mm", "a"]
    s = [None if m else str(x) for m, x in zip(
        rng.random(n) < 0.1, rng.choice(words, n))]
    return {"k": np.arange(n, dtype=np.int64),
            "g": g, "h": h, "x": rng.integers(0, 30, n).astype(np.int64),
            "v": v, "f": f, "s": s}


def _load(session, table: str, data: dict):
    td = session.node.catalog.table(table)
    st = session.node.stores[table]
    session._insert_rows(td, st, data, len(data["k"]))


@pytest.fixture(scope="module")
def data():
    return _r_data()


@pytest.fixture(scope="module")
def sessions(data):
    r = RSession(RNode())
    t = TSession(TNode(device="cpu"))
    for s in (r, t):
        s.execute(T_DDL)
        s.execute(T_ROWS)
        s.execute("create table w (v decimal(5,1))")
        s.execute("insert into w values (5.0), (null), (7.0)")
        s.execute(R_DDL)
        s.execute(R_DDL.replace("table r ", "table e "))
        _load(s, "r", data)
    return r, t


@pytest.fixture(scope="module")
def cluster(data):
    cs = ClusterSession(Cluster(2, device="cpu"))
    cs.execute(R_DDL + " distribute by shard(g)")
    td = cs.cluster.catalog.table("r")
    cs._insert_rows(td, data, len(data["k"]))
    return cs


def rows_match(got, want, rtol=F64_RTOL):
    assert len(got) == len(want), f"{len(got)} rows != {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"row {i}: arity"
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float) \
                    and not (math.isnan(a) and math.isnan(b)):
                assert a == pytest.approx(b, rel=rtol, abs=0), \
                    f"row {i}: {a} != {b} ({g} vs {w})"
            else:
                assert a == b or (a != a and b != b), \
                    f"row {i}: {a!r} != {b!r} ({g} vs {w})"


# every window statement of tests/test_sql_surface.py over its `t` / `w`
SURFACE_QUERIES = [
    "select g, x, row_number() over (partition by g order by x),"
    " rank() over (partition by g order by x),"
    " dense_rank() over (partition by g order by x) from t order by g, x",
    "select g, x, sum(v) over (partition by g order by x) from t "
    "order by g, x",
    "select g, sum(v) over (partition by g), avg(v) over (partition by g), "
    "min(v) over (partition by g), max(v) over (partition by g), "
    "count(*) over (partition by g) from t order by g",
    "select x, row_number() over (order by x desc) from t order by x desc",
    "select g, sum(v) as s, rank() over (order by sum(v) desc) from t "
    "group by g order by g",
    "select g, x, lag(v) over (partition by g order by x), lead(v) over "
    "(partition by g order by x) from t order by g, x, v",
    "select x, lag(v, 1, x) over (order by x desc) from t order by x desc",
    "select x, lag(g) over (order by x) from t where x > 4 order by x",
    "select x, lead(v) over (order by x) from t where x > 4 order by x",
    "select v, rank() over (order by v) from w order by 2",
    "select g, x, sum(v) over (partition by g order by x, v rows between "
    "1 preceding and 1 following) from t order by g, x, v",
    "select g, x, sum(v) over (partition by g order by x, v rows between "
    "current row and unbounded following) from t order by g, x, v",
    "select x, min(v) over (order by x, v), max(v) over (order by x, v) "
    "from t where g = 'a' order by x, v",
    "select x, v, min(v) over (order by x, v rows between 1 preceding and "
    "current row) from t order by x, v",
    "select g, x, first_value(v) over (partition by g order by x, v), "
    "last_value(v) over (partition by g order by x, v rows between "
    "unbounded preceding and unbounded following) from t order by g, x, v",
    "select x, sum(v) over (order by x) from t where g = 'a' order by x, v",
    "select x, v, sum(v) over (order by x rows between unbounded preceding "
    "and current row) from t where g = 'a' order by x, v",
]

# the functions of K13 over seeded data: NULL, TEXT and float keys,
# DESC, several specs in one SELECT, a column default, empty frames
R_QUERIES = [
    "select k, row_number() over (partition by g order by x, k), "
    "rank() over (partition by g order by x), dense_rank() over "
    "(partition by g order by x) from r order by k",
    "select k, rank() over (partition by h order by v), dense_rank() over "
    "(order by v desc), row_number() over (order by h desc, v, k) "
    "from r order by k",
    "select k, rank() over (order by f), dense_rank() over (partition by g "
    "order by f desc), rank() over (partition by f order by k) "
    "from r order by k",
    "select k, lag(v) over (partition by g order by k), lead(v, 2) over "
    "(partition by g order by k), lag(x, 3, h) over (order by k desc), "
    "lead(h, 1, x) over (partition by h order by k) from r order by k",
    "select k, lag(s) over (partition by h order by k), lead(g, 3) over "
    "(order by k), lag(f, 2) over (order by x, k) from r order by k",
    "select k, count(v) over (partition by g), sum(v) over (partition by g "
    "order by x), avg(v) over (partition by h order by x rows between 2 "
    "preceding and 1 following), count(*) over (partition by h) "
    "from r order by k",
    "select k, sum(f) over (partition by g order by k), avg(f) over "
    "(order by x, k rows between 3 preceding and 2 preceding), sum(v) over "
    "(order by k rows between 3 preceding and 2 preceding), count(v) over "
    "(order by k rows between 3 preceding and 2 preceding) "
    "from r order by k",
    "select k, min(v) over (partition by g order by x rows between 1 "
    "preceding and 3 following), max(f) over (partition by h), min(x) over "
    "(order by k rows between 2 following and 5 following), max(h) over "
    "(partition by g order by k) from r order by k",
    "select k, min(s) over (partition by g), max(s) over (order by x, k "
    "rows between 2 preceding and current row), first_value(s) over "
    "(partition by h order by x, k), last_value(g) over (order by s, k) "
    "from r order by k",
    "select k, row_number() over (partition by s order by g desc, k), "
    "rank() over (order by s desc), dense_rank() over (partition by g "
    "order by s) from r order by k",
    "select k, count(*) over (order by x range between unbounded preceding "
    "and current row), sum(x) over (order by x range between current row "
    "and unbounded following), sum(v) over (partition by h order by x "
    "range between current row and current row) from r order by k",
    "select k, first_value(v) over (partition by g order by x rows between "
    "2 preceding and 1 preceding), last_value(f) over (partition by g "
    "order by k rows between 1 following and 4 following), first_value(x) "
    "over (order by k desc) from r order by k",
    "select g, sum(v), rank() over (order by sum(v) desc), count(*) over "
    "() from r group by g order by g",
    "select k, rk from (select k, rank() over (partition by g order by "
    "v desc) as rk from r) z where rk <= 3 order by k",
    "select k, row_number() over (order by k), sum(v) over "
    "(partition by g), lag(s) over (order by k) from e order by k",
    "select k, sum(v) over (partition by g order by k), avg(v) over "
    "(partition by g) from r where h is not null and k > 20 order by k",
]

CASES = SURFACE_QUERIES + R_QUERIES


@pytest.mark.parametrize("sql", CASES)
def test_window_matches_reference(sessions, sql):
    r, t = sessions
    rows_match(t.query(sql), r.query(sql))


def test_window_declines_the_fused_tier(sessions):
    """The fused screen declines a Window, as the reference's does; the
    aggregate below it still offers itself to the fused tier."""
    _, t = sessions
    before = TF.declines_snapshot().get("window", 0)
    t.query("select g, sum(v), rank() over (order by sum(v) desc) from r "
            "group by g order by g")
    assert TF.declines_snapshot().get("window", 0) > before


CLUSTER_QUERIES = [
    # partition covers the distribution key: DataNode-local windows
    "select k, row_number() over (partition by g order by x, k), sum(v) "
    "over (partition by g order by k), min(s) over (partition by g) "
    "from r order by k",
    # no partition over the distribution key: after the gather
    "select k, rank() over (partition by h order by v), lag(v) over "
    "(order by k), avg(f) over (order by x, k rows between 3 preceding "
    "and 2 preceding) from r order by k",
    "select g, sum(v), rank() over (order by sum(v) desc) from r "
    "group by g order by g",
]


@pytest.mark.parametrize("sql", CLUSTER_QUERIES)
def test_window_on_cluster_matches_single_node(sessions, cluster, sql):
    _, t = sessions
    rows_match(cluster.query(sql), t.query(sql))
    assert cluster.last_tier == "mesh"


def test_gathered_window_feeding_a_join_runs_once(sessions, cluster,
                                                  monkeypatch):
    """A window over all rows that feeds a join (TPC-DS q44's shape)
    reads the gather: the device tier runs that fragment once, over the
    gathered rows, and K11 + K12 route its output to both DataNodes."""
    from opentenbase_tpu_torch.exec import mesh_exec as ME
    _, t = sessions
    seen, binds = {}, []
    screen, bind = ME.MeshRunner._screen, ME.MeshRunner._bind

    def watch_screen(self, dp):
        seen["dp"], seen["once"] = dp, screen(self, dp)
        return seen["once"]

    def watch_bind(node, ex_batches):
        binds.append(id(node))
        return bind(node, ex_batches)

    monkeypatch.setattr(ME.MeshRunner, "_screen", watch_screen)
    monkeypatch.setattr(ME.MeshRunner, "_bind", staticmethod(watch_bind))
    sql = ("select a.k, a.rk, r.x from (select k, rank() over (order by "
           "v desc, k) as rk from r) a join r on a.k = r.x "
           "where a.rk <= 40 order by a.rk, a.k")
    got = cluster.query(sql)
    rows_match(got, t.query(sql))
    assert cluster.last_tier == "mesh" and len(got) > 0
    dp, once = seen["dp"], seen["once"]
    assert len(once) == 1
    (i,) = once
    frag = dp.fragments[i]
    assert frag.location == "dn" and binds.count(id(frag.plan)) == 1
    out = {ex.index: ex.kind for ex in dp.exchanges
           if ex.source_fragment == i}
    assert out and set(out.values()) <= {"redistribute", "broadcast"}
    counts = {e: c for e, _kind, c in
              ME.mesh_runner_for(cluster.cluster).last_exchanges}
    for e in out:
        assert counts[e].shape == (1, 2) and (counts[e] > 0).all()


# ---------------------------------------------------------------------------
# K13a-K13c plain versions against a direct numpy oracle
# ---------------------------------------------------------------------------

def _oracle_bounds(words, n_part, float_words, s_valid):
    w, n = words.shape

    def differs(i, rows):
        return any(words[r, i] != words[r, i - 1]
                   or (r in float_words and words[r, i] > TK._INF_WORD)
                   for r in rows)

    p_start, peer_start, ob_cum = [], [], []
    ps = pe = cnt = 0
    for i in range(n):
        pb = i == 0 or differs(i, range(1, 1 + n_part))
        ob = pb or differs(i, range(1 + n_part, w))
        ps = i if pb else ps
        pe = i if ob else pe
        cnt += ob
        p_start.append(ps)
        peer_start.append(pe)
        ob_cum.append(cnt)
    p_end, peer_end_v = [], []
    for i in range(n):
        j = i
        while j + 1 < n and p_start[j + 1] == p_start[i]:
            j += 1
        valid_rows = [q for q in range(p_start[i], j + 1) if s_valid[q]]
        e = max(valid_rows) if valid_rows else -1
        q = i
        while q + 1 < n and peer_start[q + 1] == peer_start[i]:
            q += 1
        p_end.append(e)
        peer_end_v.append(min(q, e))
    return [np.asarray(x, dtype=np.int64)
            for x in (p_start, peer_start, peer_end_v, p_end, ob_cum)]


def _random_sorted_words(rng, n, n_part, n_order, float_order):
    """Sorted order words as order_words + sort_perm make them, with
    invalid rows anywhere in the input (so in the middle of the padded
    range before the sort) and NaN / +-0.0 float keys."""
    valid = rng.random(n) < 0.8
    keys, descs = [], []
    for _ in range(n_part):
        keys.append(torch.from_numpy(rng.integers(0, 3, n)))
        descs.append(False)
    for j in range(n_order):
        if float_order and j == 0:
            keys.append(torch.from_numpy(rng.choice(
                [np.nan, -0.0, 0.0, 1.5, -2.0], n)))
        else:
            keys.append(torch.from_numpy(rng.integers(0, 4, n)))
        descs.append(bool(rng.integers(0, 2)))
    words = TK.order_words(tuple(keys), torch.from_numpy(valid),
                           tuple(descs))
    perm = TK.sort_perm_plain(words)
    fw = tuple(1 + j for j, k in enumerate(keys) if k.dtype.is_floating_point)
    s_valid = torch.from_numpy(valid)[perm]
    return words[:, perm].contiguous(), fw, s_valid, perm


@pytest.mark.parametrize("n,n_part,n_order,float_order", [
    (1, 0, 1, False), (1, 1, 0, False), (2, 0, 0, False),
    (37, 1, 1, False), (64, 2, 1, True), (200, 0, 2, True),
    (257, 1, 0, False), (300, 1, 2, False)])
def test_window_bounds_plain_matches_oracle(n, n_part, n_order, float_order):
    rng = np.random.default_rng(n * 7 + n_part)
    words, fw, s_valid, _ = _random_sorted_words(rng, n, n_part, n_order,
                                                 float_order)
    got = TK.window_bounds(words, n_part, fw, s_valid)
    want = _oracle_bounds(words.numpy(), n_part, fw, s_valid.numpy())
    for name, g, w in zip(("p_start", "peer_start", "peer_end_v", "p_end",
                           "ob_cum"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_window_bounds_one_partition_spans_every_row():
    n = 50
    words = torch.zeros((2, n), dtype=torch.int64)
    s_valid = torch.ones(n, dtype=torch.bool)
    p_start, peer_start, peer_end_v, p_end, ob_cum = TK.window_bounds(
        words, 1, (), s_valid)
    assert (p_start == 0).all() and (peer_start == 0).all()
    assert (p_end == n - 1).all() and (peer_end_v == n - 1).all()
    assert (ob_cum == 1).all()


FRAMES = [None,
          ("rows", ("preceding", 2), ("following", 1)),
          ("rows", ("preceding", 3), ("preceding", 2)),
          ("rows", ("current", None), ("unbounded_following", None)),
          ("rows", ("following", 1), ("following", 4)),
          ("range", ("unbounded_preceding", None), ("current", None)),
          ("range", ("current", None), ("unbounded_following", None))]


def _oracle_frame(frame, has_order, i, ps, pe, peer_s, peer_e):
    if frame is None:
        return (ps, peer_e) if has_order else (ps, pe)
    mode, (sk, so), (ek, eo) = frame
    if mode == "rows":
        def rb(kind, k):
            return {"unbounded_preceding": ps, "preceding": i - (k or 0),
                    "current": i, "following": i + (k or 0),
                    "unbounded_following": pe}[kind]
        return max(rb(sk, so), ps), min(rb(ek, eo), pe)
    return (ps if sk == "unbounded_preceding" else peer_s,
            pe if ek == "unbounded_following" else peer_e)


def _oracle_reduce(func, bounds, frame, has_order, s_valid, a, anm,
                   offset=1, dflt=None, dnull=None, scale=0):
    """Per sorted row, straight from the definitions (sorted order)."""
    p_start, peer_start, peer_end_v, p_end, ob_cum = bounds
    n = len(s_valid)
    vals, nulls = [], []
    for i in range(n):
        ps = p_start[i]
        nul = False
        if func == "row_number":
            v = i - ps + 1
        elif func == "rank":
            v = peer_start[i] - ps + 1
        elif func == "dense_rank":
            v = ob_cum[i] - ob_cum[ps] + 1
        elif func in ("lag", "lead"):
            src = i - offset if func == "lag" else i + offset
            inside = 0 <= src < n and p_start[src] == ps and s_valid[src]
            if inside:
                v, nul = a[src], bool(anm[src])
            elif dflt is not None:
                v, nul = dflt[i], bool(dnull[i])
            else:
                v, nul = None, True
        else:
            fs, fe = _oracle_frame(frame, has_order, i, ps, p_end[i],
                                   peer_start[i], peer_end_v[i])
            rows = [] if (fe < fs or not s_valid[i]) else \
                [q for q in range(max(fs, 0), min(fe, n - 1) + 1)
                 if s_valid[q] and not anm[q]]
            if func == "count":
                v = len(rows)
            elif func in ("first_value", "last_value"):
                if fe < fs or not s_valid[i]:
                    v, nul = None, True
                else:
                    pos = min(max(fs if func == "first_value" else fe, 0),
                              n - 1)
                    v, nul = a[pos], bool(anm[pos])
            elif not rows:
                v, nul = None, True
            elif func == "sum":
                v = sum(a[q] for q in rows)
            elif func == "avg":
                v = sum(float(a[q]) for q in rows) / len(rows) / 10 ** scale
            elif func == "min":
                v = min(a[q] for q in rows)
            else:
                v = max(a[q] for q in rows)
        vals.append(v)
        nulls.append(nul)
    return vals, nulls


_NO_FRAME = ("row_number", "rank", "dense_rank", "lag", "lead")
REDUCE_CASES = [(f, 0) for f in _NO_FRAME] + [
    (f, fi) for f in TK.WIN_FUNCS if f not in _NO_FRAME
    for fi in range(len(FRAMES))]


@pytest.mark.parametrize("func,fi", REDUCE_CASES)
def test_window_frame_reduce_plain_matches_oracle(func, fi):
    frame = FRAMES[fi]
    rng = np.random.default_rng(100 + fi * 13 + TK.WIN_FUNCS[func])
    n = 150
    words, fw, s_valid, perm = _random_sorted_words(rng, n, 1, 1, False)
    bounds = TK.window_bounds(words, 1, fw, s_valid)
    a = torch.from_numpy(rng.integers(-50, 50, n).astype(np.int64))
    anm = torch.from_numpy(rng.random(n) < 0.2)
    dflt = torch.from_numpy(rng.integers(-9, 9, n).astype(np.int64))
    dnull = torch.from_numpy(rng.random(n) < 0.3)
    code = TK.window_frame(frame, True)
    table = None
    if func in ("min", "max"):
        table = TK.range_minmax(a, s_valid & ~anm, func == "min")
    got, gnul = TK.window_frame_reduce(
        func, bounds, code, perm, s_valid, a, anm, offset=2, dflt_s=dflt,
        dnull_s=dnull, has_default=True, scale=2, table=table)
    want, wnul = _oracle_reduce(
        func, [b.numpy() for b in bounds], frame, True, s_valid.numpy(),
        a.numpy(), anm.numpy(), offset=2, dflt=dflt.numpy(),
        dnull=dnull.numpy(), scale=2)
    # the kernel scatters to input order; undo it
    got = got[perm].numpy()
    gnul = gnul[perm].numpy() if gnul is not None else [False] * n
    for i in range(n):
        if not s_valid[i]:
            continue
        assert bool(gnul[i]) == wnul[i], (i, func)
        if not wnul[i]:
            if func == "avg":
                assert got[i] == pytest.approx(want[i], rel=F64_RTOL)
            else:
                assert got[i] == want[i], (i, func, got[i], want[i])


def test_lag_without_default_is_null_outside_the_partition():
    n = 6
    words = torch.tensor([[0] * n, [0, 0, 0, 1, 1, 1]], dtype=torch.int64)
    s_valid = torch.ones(n, dtype=torch.bool)
    perm = torch.arange(n)
    bounds = TK.window_bounds(words, 1, (), s_valid)
    a = torch.arange(10, 10 + n, dtype=torch.int64)
    val, nul = TK.window_frame_reduce("lag", bounds, None, perm, s_valid, a,
                                      None, offset=1)
    assert nul.tolist() == [True, False, False, True, False, False]
    assert val[~nul].tolist() == [10, 11, 13, 14]


@pytest.mark.parametrize("n", [1, 2, 3, 17, 256, 300])
@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_range_minmax_plain_matches_oracle(n, is_min, dtype):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.integers(-100, 100, n)).to(dtype)
    contrib = torch.from_numpy(rng.random(n) < 0.7)
    table = TK.range_minmax(a, contrib, is_min).numpy()
    assert table.shape == (int(math.floor(math.log2(n))) + 1, n)
    neutral = TK._minmax_neutral(dtype, is_min)
    an = np.where(contrib.numpy(), a.numpy(), neutral)
    for j in range(table.shape[0]):
        for i in range(n):
            span = an[i:min(i + (1 << j), n)]
            want = span.min() if is_min else span.max()
            if i + (1 << j) > n:   # past the end: the neutral element
                want = min(want, neutral) if is_min else max(want, neutral)
            assert table[j, i] == want, (j, i)


def test_window_frame_codes():
    assert TK.window_frame(None, True) == (0, 0, 0, 0, 0, 1)
    assert TK.window_frame(("rows", ("preceding", 3), ("following", 2)),
                           False) == (1, 1, 3, 3, 2, 0)
    assert TK.window_frame(("range", ("unbounded_preceding", None),
                            ("current", None)), True) == (2, 0, 0, 2, 0, 1)
