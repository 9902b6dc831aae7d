"""f64 keys and f64 window sums: the port against a plain Python oracle.

GROUP BY, DISTINCT and hash joins key a double precision column by its
canonical order word (utils/dtypes.py float_word: -0.0 is +0.0, every
NaN one NaN, word order the numeric order with NaN last), so 0.25 and
0.5 stay apart, NaN groups and joins as one value and -0.0 meets +0.0,
as PostgreSQL's float8 comparisons have it.  The reference truncates
the value to int64 there (ROADMAP queue 3), so these statements are held
to an oracle computed here, on three tiers of the port: the eager
Session, the fused tier (Executor._fuse on, the join row floor at 0) and
ClusterSession over Cluster(2, device="cpu").  Window sum / avg of an
f64 argument add only the finite values of a frame's own partition: a
NaN or an infinity reaches only the frames that hold it.  Where the keys
are integral f64 values inside int64 the reference's truncation is exact
and the port still equals the JAX package.  f64 results compare within
relative 1e-12 (the sums add in another order).
"""

import math

import numpy as np
import pytest
import torch

from opentenbase_tpu.exec.session import LocalNode as RNode
from opentenbase_tpu.exec.session import Session as RSession
from opentenbase_tpu_torch.exec import executor as TX
from opentenbase_tpu_torch.exec import fused as TF
from opentenbase_tpu_torch.exec.dist_session import ClusterSession
from opentenbase_tpu_torch.exec.session import LocalNode as TNode
from opentenbase_tpu_torch.exec.session import Session as TSession
from opentenbase_tpu_torch.ops import kernels as TK
from opentenbase_tpu_torch.parallel.cluster import Cluster
from opentenbase_tpu_torch.utils.dtypes import float_word, word_float

RTOL = 1e-12
NAN, INF = float("nan"), float("inf")

# the probe tables of ROADMAP queue 3, then the extremes
P = {"k": [1, 2, 3, 4, 5, 6], "f": [0.5, 0.25, 1.0, 1.75, -0.0, 0.0]}
Q_ = {"k": [1, 2, 3], "f": [0.75, 1.5, 0.5]}
A = {"k": list(range(1, 15)),
     "g": [1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2],
     "f": [NAN, -NAN, INF, -INF, 1e300, -0.0, 0.0, None, 0.5, 0.25,
           NAN, INF, 1e300, None]}
B = {"k": list(range(1, 9)),
     "g": [1, 2, 1, 2, 1, 1, 2, 2],
     "f": [NAN, INF, -0.0, 1e300, 0.25, None, -INF, 0.5]}
W = {"k": [1, 2, 3, 4], "g": [1, 1, 2, 2], "f": [1.0, NAN, 2.0, 3.0]}
# window partitions: NaN and both infinities in g = 1, 1e300 in g = 2,
# small values in g = 3 (a whole-array prefix loses all of g = 3)
V = {"k": list(range(1, 16)),
     "g": [1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3],
     "f": [1.0, NAN, 2.0, INF, -INF, 3.0, 1e300, 4.0, None, 0.125, 0.25,
           None, 0.5, -0.75, 1.5]}
TABLES = (("p", P), ("q", Q_), ("a", A), ("b", B), ("w", W), ("v", V))


def _ddl(name, cols, dist=""):
    body = "k bigint, " + ("g int, " if "g" in cols else "") \
        + "f double precision"
    return f"create table {name} ({body}){dist}"


def _coldata(cols):
    out = {"k": np.asarray(cols["k"], np.int64)}
    if "g" in cols:
        out["g"] = np.asarray(cols["g"], np.int32)
    out["f"] = list(cols["f"])
    return out


def _load_single(s):
    for name, cols in TABLES:
        s.execute(_ddl(name, cols))
        td = s.node.catalog.table(name)
        s._insert_rows(td, s.node.stores[name], _coldata(cols),
                       len(cols["k"]))
    return s


@pytest.fixture(scope="module")
def eager():
    return _load_single(TSession(TNode(device="cpu")))


@pytest.fixture(scope="module")
def cluster():
    cs = ClusterSession(Cluster(2, device="cpu"))
    for name, cols in TABLES:
        cs.execute(_ddl(name, cols, " distribute by shard(k)"))
        td = cs.cluster.catalog.table(name)
        cs._insert_rows(td, _coldata(cols), len(cols["k"]))
    return cs


@pytest.fixture(params=["eager", "fused", "cluster"])
def run(request, eager, monkeypatch):
    """query(sql) on one tier of the port."""
    if request.param == "cluster":
        cs = request.getfixturevalue("cluster")
        return cs.query
    monkeypatch.setattr(TX.Executor, "_fuse", request.param == "fused")
    monkeypatch.setattr(TF, "FUSE_JOIN_MIN_ROWS", 0)
    return eager.query


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

def _key(x):
    """float8 equality class of a value (None for NULL)."""
    if x is None:
        return None
    if math.isnan(x):
        return "nan"
    return x + 0.0          # -0.0 -> 0.0


def _norm(v):
    if isinstance(v, float):
        return "nan" if math.isnan(v) else v + 0.0
    return v


def _group_counts(cols):
    out = {}
    for f in cols["f"]:
        out[_key(f)] = out.get(_key(f), 0) + 1
    return out


def _as_counts(rows):
    return {_norm(f) if f is not None else None: c for f, c in rows}


def _join_pairs(left, right, keys):
    out = []
    for i in range(len(left["k"])):
        for j in range(len(right["k"])):
            ks = [(_key(left[c][i]), _key(right[c][j])) for c in keys]
            if all(a is not None and a == b for a, b in ks):
                out.append((left["k"][i], right["k"][j]))
    return sorted(out)


def _frame_sum(vals):
    """PostgreSQL's float8 sum of a frame's non-NULL values (None when
    all are NULL)."""
    xs = [x for x in vals if x is not None]
    if not xs:
        return None
    if any(math.isnan(x) for x in xs) or (INF in xs and -INF in xs):
        return NAN
    if INF in xs:
        return INF
    if -INF in xs:
        return -INF
    s = 0.0
    for x in xs:
        s += x
    return s


def _window_oracle(cols):
    """Per k: (sum(f) over (partition by g order by k), avg(f) over
    (partition by g))."""
    out = {}
    for i, k in enumerate(cols["k"]):
        g = cols["g"][i]
        part = [j for j in range(len(cols["k"])) if cols["g"][j] == g]
        run = [cols["f"][j] for j in part if cols["k"][j] <= k]
        whole = [cols["f"][j] for j in part]
        s = _frame_sum(whole)
        n = sum(x is not None for x in whole)
        out[k] = (_frame_sum(run), None if s is None else s / n)
    return out


def _close(a, b):
    if a is None or b is None:
        return a is None and b is None
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if math.isinf(a) or math.isinf(b):
        return a == b
    return a == pytest.approx(b, rel=RTOL, abs=0)


# ---------------------------------------------------------------------------
# GROUP BY, DISTINCT, joins, windows on every tier
# ---------------------------------------------------------------------------

def test_group_by_keeps_fractional_keys_apart(run):
    got = _as_counts(run("select f, count(*) from p group by f"))
    assert got == {0.0: 2, 0.25: 1, 0.5: 1, 1.0: 1, 1.75: 1}


@pytest.mark.parametrize("table", ["a", "b"])
def test_group_by_extremes_matches_oracle(run, table):
    cols = dict(A=A, B=B)[table.upper()]
    got = _as_counts(run(f"select f, count(*) from {table} group by f"))
    assert got == _group_counts(cols)


def test_grouped_sum_with_float_and_int_keys(run):
    got = run("select g, f, sum(k) from a group by g, f")
    want = {}
    for g, f, k in zip(A["g"], A["f"], A["k"]):
        want[(g, _key(f))] = want.get((g, _key(f)), 0) + k
    assert {(g, _norm(f) if f is not None else None): s
            for g, f, s in got} == want


@pytest.mark.parametrize("table", ["p", "a"])
def test_distinct_matches_oracle(run, table):
    cols = dict(p=P, a=A)[table]
    got = [_norm(r[0]) if r[0] is not None else None
           for r in run(f"select distinct f from {table}")]
    assert len(got) == len(set(got))
    assert set(got) == set(_group_counts(cols))


def test_single_key_join_matches_oracle(run):
    got = run("select p.k, q.k from p join q on p.f = q.f")
    assert sorted(got) == [(1, 3)] == _join_pairs(P, Q_, ["f"])


def test_single_key_join_of_extremes(run):
    got = run("select a.k, b.k from a join b on a.f = b.f")
    want = _join_pairs(A, B, ["f"])
    assert sorted(got) == want
    # NaN joins NaN, -0.0 joins +0.0, 1e300 and the infinities their own
    assert (1, 1) in want and (2, 1) in want and (7, 3) in want \
        and (5, 4) in want and (3, 2) in want


def test_two_key_join_matches_oracle(run):
    got = run("select a.k, b.k from a join b on a.f = b.f and a.g = b.g")
    assert sorted(got) == _join_pairs(A, B, ["f", "g"])


def test_window_sum_stays_in_its_partition(run):
    got = run("select k, sum(f) over (partition by g order by k) from w "
              "order by k")
    assert [r[0] for r in got] == [1, 2, 3, 4]
    assert got[0][1] == 1.0 and math.isnan(got[1][1])
    assert got[2][1] == 2.0 and got[3][1] == 5.0


@pytest.mark.parametrize("table", ["w", "v"])
def test_window_sum_avg_match_oracle(run, table):
    cols = dict(w=W, v=V)[table]
    got = run(f"select k, sum(f) over (partition by g order by k), "
              f"avg(f) over (partition by g) from {table} order by k")
    want = _window_oracle(cols)
    assert [r[0] for r in got] == sorted(want)
    for k, s, a in got:
        assert _close(s, want[k][0]), (k, s, want[k][0])
        assert _close(a, want[k][1]), (k, a, want[k][1])


# ---------------------------------------------------------------------------
# where the reference's truncation is exact: the port equals it
# ---------------------------------------------------------------------------

INTEGRAL = [
    "select f, count(*), sum(k) from z group by f order by f",
    "select distinct f from z order by f",
    "select z.k, y.k from z join y on z.f = y.f order by z.k, y.k",
    "select z.k, y.k from z join y on z.f = y.f and z.g = y.g "
    "order by z.k, y.k",
]


@pytest.fixture(scope="module")
def integral():
    rng = np.random.default_rng(31)
    data = {}
    for name, n in (("z", 40), ("y", 25)):
        data[name] = {"k": np.arange(n, dtype=np.int64),
                      "g": rng.integers(0, 3, n).astype(np.int32),
                      "f": [float(x) for x in rng.choice(
                          [-3.0, -1.0, -0.0, 0.0, 2.0, 7.0, 2.0 ** 40], n)]}
    r, t = RSession(RNode()), TSession(TNode(device="cpu"))
    for s in (r, t):
        for name, cols in data.items():
            s.execute(f"create table {name} (k bigint, g int, "
                      "f double precision)")
            s._insert_rows(s.node.catalog.table(name), s.node.stores[name],
                           dict(cols), len(cols["k"]))
    return r, t


@pytest.mark.parametrize("sql", INTEGRAL)
def test_integral_float_keys_equal_reference(integral, sql):
    r, t = integral
    want = r.query(sql)
    assert len(want) > 0
    assert [tuple(_norm(v) for v in row) for row in t.query(sql)] == \
        [tuple(_norm(v) for v in row) for row in want]


# ---------------------------------------------------------------------------
# the order word itself
# ---------------------------------------------------------------------------

def test_float_words_order_and_miss_the_join_sentinels():
    """Word order is the numeric order with NaN last; every NaN has one
    word and -0.0 has +0.0's; the inverse gives the canonical values
    back; no word is INT64_MAX (a NULL join key) or INT64_MAX - 1 (an
    invalid probe row), even for NaNs with other payloads or signs."""
    odd_nans = np.array([0x7FF8000000000001, 0xFFF8000000000000,
                         0x7FFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF,
                         0x7FF0000000000001], np.uint64).view(np.float64)
    vals = np.concatenate([
        np.array([-INF, -1.7976931348623157e308, -1e300, -1.0, -5e-324,
                  -0.0, 0.0, 5e-324, 1e-300, 0.25, 1.0, 1e300,
                  1.7976931348623157e308, INF]), odd_nans])
    x = torch.from_numpy(vals)
    w = float_word(x)
    assert not bool(((w == TK.INT64_MAX) | (w == TK.INT64_MAX - 1)).any())
    nan_words = w[torch.isnan(x)]
    assert bool((nan_words == 0x7FF8000000000000).all())
    finite = w[~torch.isnan(x)]
    assert bool((finite[1:] >= finite[:-1]).all())
    assert int(finite[5]) == int(finite[6]) == 0        # -0.0 and +0.0
    assert bool((finite < nan_words[0]).all())
    back = word_float(w)
    assert torch.equal(back[~torch.isnan(x)],
                       torch.from_numpy(vals[~np.isnan(vals)]) + 0.0)
    assert bool(torch.isnan(back[torch.isnan(x)]).all())
