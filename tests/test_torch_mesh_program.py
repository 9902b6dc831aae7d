"""The cluster tier's DataNode side as one program (K16): MeshProgram in
opentenbase_tpu_torch/exec/mesh_exec.py, the fixed-capacity K12 and K3
at the gather class, against the JAX package.

On the CPU a program has no graph: every call runs its traced body (the
executor in traced mode, static output classes, the plain kernel
versions), so these tests hold that body against the reference's
ClusterSession on the same data, and exercise the size-class ladder,
the MESH tier's key and the eager comparison arm.  Keys, counts,
integers and scaled decimals must be equal exactly; f64 values
(averages, quotients) within relative 1e-10, the only difference being
the order of summation.
"""

import numpy as np
import pytest
import torch

from opentenbase_tpu.exec.dist_session import ClusterSession as RSession
from opentenbase_tpu.parallel.cluster import Cluster as RCluster
from opentenbase_tpu.tpch import datagen as rdatagen
from opentenbase_tpu.tpch.queries import Q
from opentenbase_tpu.tpch.schema import SCHEMA
from opentenbase_tpu_torch.exec import mesh_exec as ME
from opentenbase_tpu_torch.exec import plancache
from opentenbase_tpu_torch.exec.dist_session import ClusterSession
from opentenbase_tpu_torch.ops import kernels as TK
from opentenbase_tpu_torch.parallel.cluster import Cluster
from opentenbase_tpu_torch.tpch import datagen as tdatagen

SF = 0.01


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


class _Tier:
    """What the program tier did during a block: MESH lookups, misses
    and captures, ladder host reads, runs of the fragment body."""

    def __init__(self, monkeypatch):
        self.bodies = 0
        body = ME.MeshRunner._run_fragments

        def rec(runner, run, *a):
            self.bodies += 1
            return body(runner, run, *a)
        monkeypatch.setattr(ME.MeshRunner, "_run_fragments", rec)
        self.mark()

    def mark(self):
        m = plancache.MESH
        self.base = (m.hits, m.misses, m.compiles, ME.LADDER_READS,
                     self.bodies)

    def delta(self):
        m = plancache.MESH
        now = (m.hits, m.misses, m.compiles, ME.LADDER_READS, self.bodies)
        return dict(zip(("hits", "misses", "captures", "reads", "bodies"),
                        (a - b for a, b in zip(now, self.base))))


@pytest.fixture(scope="module")
def data():
    return rdatagen.generate(sf=SF)


def _clusters(data, n):
    r = RSession(RCluster(n_datanodes=n))
    r.execute(SCHEMA)
    for tname, tbl in data.items():
        r._insert_rows(r.cluster.catalog.table(tname), tbl,
                       len(next(iter(tbl.values()))))
    t = ClusterSession(Cluster(n, device="cpu"))
    t.execute(SCHEMA)
    tdatagen.load_into_cluster(t, data)
    return r, t


@pytest.fixture(scope="module")
def envs(data):
    return {n: _clusters(data, n) for n in (2, 3)}


# ---------------------------------------------------------------------------
# TPC-H Q1, Q3, Q5 through the program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [1, 3, 5])
@pytest.mark.parametrize("n", [2, 3])
def test_program_matches_reference(envs, n, q, monkeypatch):
    """The traced program on n DataNodes = the reference's
    ClusterSession = the port's eager device tier; a warm repeat hits
    its MESH entry, runs the body once and reads the host once."""
    r, t = envs[n]
    want = r.query(Q[q])
    assert len(want) > 0
    tier = _Tier(monkeypatch)
    got = t.query(Q[q])
    rows_match(got, want)
    assert t.last_tier == "mesh" and t.fallbacks == []
    first = tier.delta()
    assert first["captures"] <= 1 and first["reads"] == first["bodies"] >= 1
    tier.mark()
    rows_match(t.query(Q[q]), want)
    assert tier.delta() == {"hits": 1, "misses": 0, "captures": 0,
                            "reads": 1, "bodies": 1}
    runner = ME.mesh_runner_for(t.cluster)
    assert [k for _i, k, _c in runner.last_exchanges] \
        == ["redistribute"] * {1: 1, 3: 2, 5: 4}[q]
    for _i, _k, counts in runner.last_exchanges:
        assert isinstance(counts, torch.Tensor) and counts.shape == (n, n)
    monkeypatch.setattr(ME.MeshRunner, "_capture", False)
    tier.mark()
    rows_match(t.query(Q[q]), want)
    assert tier.delta()["hits"] + tier.delta()["misses"] == 0
    assert all(isinstance(c, np.ndarray)
               for _i, _k, c in runner.last_exchanges)


def test_literal_change_reuses_the_program(envs, monkeypatch):
    """Q3 with another date: its literals ride the input buffer, so the
    second statement hits the first one's MESH entry and answers as the
    reference does."""
    r, t = envs[2]
    tier = _Tier(monkeypatch)
    sqls = [Q[3], Q[3].replace("1995-03-15", "1995-03-02")]
    assert sqls[0] != sqls[1]
    rows_match(t.query(sqls[0]), r.query(sqls[0]))
    tier.mark()
    got = t.query(sqls[1])
    rows_match(got, r.query(sqls[1]))
    assert tier.delta()["misses"] == 0 and tier.delta()["hits"] == 1
    assert got != t.query(sqls[0])


# ---------------------------------------------------------------------------
# the size-class ladder and the MESH key on small tables
# ---------------------------------------------------------------------------

_DDL = [
    "create table t (k bigint primary key, c int, v int) "
    "distribute by shard(k)",
    "create table u (id int primary key, w int) distribute by shard(id)",
    "create table g (gk bigint primary key, gg int) distribute by shard(gk)",
    "insert into t values " + ", ".join(f"({i}, 7, {i % 10})"
                                         for i in range(1000)),
    "insert into u values " + ", ".join(f"({i}, {i % 5})"
                                         for i in range(1000)),
    "insert into g values " + ", ".join(f"({i}, {i % 2})"
                                         for i in range(400)),
]


@pytest.fixture()
def small():
    r = RSession(RCluster(n_datanodes=2))
    t = ClusterSession(Cluster(2, device="cpu"))
    for sql in _DDL:
        r.execute(sql)
        t.execute(sql)
    return r, t


def test_skewed_redistribute_grows_its_bucket_once(small, monkeypatch):
    """Every t row has c = 7, so redistributing t by c sends all of it to
    one DataNode: the bucket of multiplier 1 overflows, the multiplier
    grows, the plan reruns with the same rows, and the learned value
    makes the next call run once."""
    r, t = small
    sql = "select count(*), sum(v * w) from t, u where c = id"
    tier = _Tier(monkeypatch)
    got = t.query(sql)
    rows_match(got, r.query(sql))
    assert got == [(1000, 9000)]
    first = tier.delta()
    assert first["bodies"] >= 2 and first["reads"] == first["bodies"]
    runner = ME.mesh_runner_for(t.cluster)
    ((i, kind, counts),) = runner.last_exchanges
    assert kind == "redistribute" and sorted(counts.sum(0).tolist()) \
        == [0, 1000]
    (ladder,) = runner._ladder.values()
    assert ladder[1][i] >= 2                    # the bucket multiplier
    tier.mark()
    assert t.query(sql) == got
    assert tier.delta() == {"hits": 1, "misses": 0, "captures": 0,
                            "reads": 1, "bodies": 1}


def test_gather_class_grows_past_the_base_padding(small, monkeypatch):
    """A many-to-many self join gathered without aggregation: 80,000 rows
    cross to the coordinator, above the gather's first class
    min(base padding, 65536); the class grows until every DataNode's
    rows fit, and the rows equal the reference's."""
    r, t = small
    sql = "select a.gk, b.gk from g a, g b where a.gg = b.gg " \
          "order by a.gk, b.gk"
    tier = _Tier(monkeypatch)
    got = t.query(sql)
    assert len(got) == 80000
    rows_match(got, r.query(sql))
    assert tier.delta()["bodies"] >= 2
    runner = ME.mesh_runner_for(t.cluster)
    base_pad = max(ME.MeshRunner._stage_table(runner, "g").padded, 1)
    (ladder,) = [v for v in runner._ladder.values() if v[0]]
    (gclass,) = ladder[2].values()
    assert gclass > min(base_pad, 1 << 16) and gclass >= 40000


def test_write_on_one_datanode_gives_a_new_key(small, monkeypatch):
    """An INSERT that lands on one DataNode restages the table: the
    program's key carries the staged versions, so the next call misses
    and answers with the new row."""
    r, t = small
    sql = "select c, count(*), sum(v) from t where v > 2 group by c"
    rows_match(t.query(sql), r.query(sql))
    tier = _Tier(monkeypatch)
    for s in (r, t):
        s.execute("insert into t values (5000, 7, 9)")
    got = t.query(sql)
    rows_match(got, r.query(sql))
    assert got[0][1] == 701
    assert tier.delta()["misses"] == 1


def test_eager_arm_equals_the_program(small, monkeypatch):
    r, t = small
    sql = "select c, count(*), sum(v * w) from t, u where v = id " \
          "group by c order by c"
    prog = t.query(sql)
    monkeypatch.setattr(ME.MeshRunner, "_capture", False)
    tier = _Tier(monkeypatch)
    assert t.query(sql) == prog
    assert tier.delta()["reads"] == 0 and tier.delta()["bodies"] == 1
    rows_match(prog, r.query(sql))


def test_masked_literal_read_on_the_host_runs_baked(small, monkeypatch):
    """A capture that fails on a host read of a masked literal (the card
    only; faked here) drops that program, remembers the plan shape and
    runs it with its literals baked; the next call goes there
    directly."""
    from opentenbase_tpu_torch.exec.fused import _MaskedHostRead
    r, t = small
    sql = "select count(*), sum(v) from t where v > 4"
    capture = ME.MeshProgram.capture_if_new
    masked = []

    def fail_masked(self):
        if self.names:       # the literal 4 rides the input buffer
            masked.append(self)
            raise _MaskedHostRead("operation not permitted when stream "
                                  "is capturing")
        return capture(self)
    monkeypatch.setattr(ME.MeshProgram, "capture_if_new", fail_masked)
    want = r.query(sql)
    rows_match(t.query(sql), want)
    assert len(masked) == 1
    assert not any(ent[1] is masked[0]
                   for ent in plancache.MESH._d.values())
    runner = ME.mesh_runner_for(t.cluster)
    assert len(runner._mask_refused) == 1
    rows_match(t.query(sql), want)
    assert len(masked) == 1


# ---------------------------------------------------------------------------
# K12 in its fixed-capacity form, K3 at the gather class
# ---------------------------------------------------------------------------

def _sources(rng, rows, ndst):
    cols, dest, valid = [], [], []
    for i, n in enumerate(rows):
        x = torch.from_numpy(rng.integers(-10**9, 10**9, n))
        f = torch.from_numpy(rng.normal(0, 1, n))
        m = torch.from_numpy(rng.random(n) < 0.3)
        cols.append((x, f, m if i != 1 else None))
        dest.append(torch.from_numpy(
            rng.integers(-1, ndst + 1, n).astype(np.int32)))
        valid.append(torch.from_numpy(rng.random(n) < 0.8))
    return cols, dest, valid


@pytest.mark.parametrize("ndst", [1, 2, 3, 4])
def test_exchange_fixed_plain_matches_exchange_plain(ndst):
    """The same live rows in the same order per destination as the sized
    form, the count matrix equal, and where a region is too small its
    first rows kept and the overflow exact."""
    rng = np.random.default_rng(ndst)
    cols, dest, valid = _sources(rng, [300, 0, 177, 64][:max(ndst, 2)],
                                 ndst)
    outs, ov, cm, region = TK.exchange_plain(cols, dest, valid, ndst)
    totals = cm.sum(axis=0)
    for fixed in (region, int(totals.max()), max(int(totals.max()) // 3, 1),
                  1):
        fo, fv, fc, over = TK.exchange_fixed_plain(cols, dest, valid, ndst,
                                                   fixed)
        assert torch.equal(fc, torch.from_numpy(cm))
        assert over.tolist() == np.maximum(totals - fixed, 0).tolist()
        assert fv.shape == (ndst * fixed,)
        for d in range(ndst):
            keep = min(int(totals[d]), fixed)
            want = slice(d * region, d * region + keep)
            got = slice(d * fixed, d * fixed + keep)
            assert bool(fv[got].all()) and not bool(
                fv[d * fixed + keep:(d + 1) * fixed].any())
            for g, w in zip(fo, outs):
                assert torch.equal(g[got], w[want])


def test_exchange_fixed_broadcast_form_cannot_overflow():
    """The broadcast form's region is the sources' summed padding: every
    live row arrives, in source order."""
    rng = np.random.default_rng(9)
    rows = [40, 0, 25]
    cols, _d, valid = _sources(rng, rows, 1)
    fo, fv, fc, over = TK.exchange_fixed_plain(cols, None, valid, 1,
                                               sum(rows))
    live = torch.cat(valid)
    assert over.tolist() == [0] and int(fv.sum()) == int(live.sum())
    xs = torch.cat([c[0] for c in cols])[live]
    assert torch.equal(fo[0][:int(live.sum())], xs)
    # a source without the null mask contributes zeros there
    ms = torch.cat([c[2] if c[2] is not None else torch.zeros(n, dtype=bool)
                    for c, n in zip(cols, rows)])[live]
    assert torch.equal(fo[2][:int(live.sum())], ms)


# the fixed form's kernel ranks rows in tiles of this many (csrc/exchange.cu
# kXTile)
XTILE = 4096
EDGE_CASES = {
    "empty and 1-row sources": ((0, 1, 300), 2, 64, False),
    "rows at the tile's multiples": ((XTILE, 2 * XTILE), 4, XTILE, False),
    "one row past the tile": ((XTILE + 1, 1), 4, XTILE, False),
    "1 destination": ((5000,), 1, 2 * XTILE, False),
    "2 destinations": ((3000, 3000), 2, XTILE, False),
    "64 destinations": ((9000,), 64, 256, False),
    "region 1": ((500, 500), 4, 1, False),
    "region 1, 64 destinations": ((2 * XTILE + 1,), 64, 1, False),
    "every row to one destination": ((XTILE + 9, 77), 4, 2 * XTILE, True),
}


def _exchange_oracle(cols, dest, valid, ndst, region):
    """The stable partition in numpy, row by row: destination d gets its
    live rows in source order, then row order; the first `region` of
    them fill rows [d * region, ...) of each output (zeros elsewhere,
    and where a source lacks a column)."""
    counts = np.zeros((len(valid), ndst), np.int64)
    slots = [[] for _ in range(ndst)]
    for s, v in enumerate(valid):
        v = v.numpy()
        d = np.zeros(len(v), np.int64) if dest is None \
            else dest[s].numpy().astype(np.int64)
        for i in range(len(v)):
            if v[i] and 0 <= d[i] < ndst:
                counts[s, d[i]] += 1
                slots[d[i]].append((s, i))
    out_valid = np.zeros(ndst * region, bool)
    outs = []
    for j in range(len(cols[0])):
        dt = next(c[j] for c in cols if c[j] is not None).numpy().dtype
        o = np.zeros(ndst * region, dt)
        for d in range(ndst):
            for r, (s, i) in enumerate(slots[d][:region]):
                out_valid[d * region + r] = True
                if cols[s][j] is not None:
                    o[d * region + r] = cols[s][j].numpy()[i]
        outs.append(o)
    over = np.maximum(counts.sum(axis=0) - region, 0)
    return outs, out_valid, counts, over


@pytest.mark.parametrize("case", list(EDGE_CASES))
@pytest.mark.parametrize("form", ["routed", "broadcast"])
def test_exchange_fixed_plain_matches_the_oracle_at_the_kernels_edges(
        case, form):
    """exchange_fixed_plain (the card's kernel is held to it) against a
    row-by-row numpy oracle on the shapes at the fixed form's edges:
    empty and 1-row sources, rows at the tile's multiples and one past,
    1 to 64 destinations, region 1 (every destination overflows) and
    every row bound for one destination."""
    rows, ndst, region, skew = EDGE_CASES[case]
    rng = np.random.default_rng(len(case))
    cols, dest, valid = _sources(rng, rows, ndst)
    if skew:
        dest = [torch.full_like(d, ndst - 1) for d in dest]
    if form == "broadcast":
        dest, ndst = None, 1
    fo, fv, fc, over = TK.exchange_fixed_plain(cols, dest, valid, ndst,
                                               region)
    wo, wv, wc, wover = _exchange_oracle(cols, dest, valid, ndst, region)
    assert fc.numpy().tolist() == wc.tolist()
    assert over.numpy().tolist() == wover.tolist()
    np.testing.assert_array_equal(fv.numpy(), wv)
    for g, w in zip(fo, wo):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("out_size", [1, 7, 100])
def test_compact_below_the_count_keeps_the_first_rows(out_size):
    """K3 at a gather class below the live count: the first out_size
    live rows in row order, the full count on the device."""
    rng = np.random.default_rng(out_size)
    mask = torch.from_numpy(rng.random(500) < 0.5)
    x = torch.from_numpy(rng.integers(0, 10**6, 500))
    count, (cx,) = TK.compact(mask, (x,), out_size)
    assert int(count) == int(mask.sum()) > out_size
    assert torch.equal(cx, x[mask][:out_size])
