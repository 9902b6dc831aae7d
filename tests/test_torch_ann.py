"""Vector search (K15) in the port against the JAX package, on the CPU.

The port's ops/ann.py wrappers run their plain PyTorch versions here
(the CUDA kernels of csrc/ann.cu and csrc/kmeans.cu run on the card,
through chip_smoke.py); the same seeded numpy inputs go through the JAX
package's opentenbase_tpu/ops/ann.py and through the port.  Then the
reference's tests/test_ann.py SQL runs through both packages' Session,
and ClusterSession on Cluster(2) and Cluster(3), with the IVF index
state carried across (TableStore.adopt_ann_index).

Tolerances: f32 sums in another order change the last bits, so
distances agree within relative 1e-5 (l2 through its square, with an
absolute term of 1e-5 (|v|^2 + |q|^2); cosine absolute 1e-5; ip absolute
1e-5 |v| |q|).  Index lists are equal exactly, except that two rows may
swap where their distances (or assignment scores) are within that
tolerance; the data below puts no such tie at the k-th place.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opentenbase_tpu.exec.dist_session import ClusterSession as RClusterSession
from opentenbase_tpu.exec.session import LocalNode as RNode
from opentenbase_tpu.exec.session import Session as RSession
from opentenbase_tpu.ops import ann as RANN
from opentenbase_tpu.parallel.cluster import Cluster as RCluster
from opentenbase_tpu_torch.exec import fused, plancache
from opentenbase_tpu_torch.exec.dist_session import ClusterSession
from opentenbase_tpu_torch.exec.session import LocalNode, Session
from opentenbase_tpu_torch.ops import ann as ANN
from opentenbase_tpu_torch.parallel.cluster import Cluster
from opentenbase_tpu_torch.sql.analyze import BindError

RTOL = 1e-5
N, DIM = 800, 16              # the SQL tables (tests/test_ann.py's size)
NK, DK = 4096, 128            # the kernel cases
METRICS = ("l2", "cosine", "ip")
OPS = {"l2": "<->", "cosine": "<=>", "ip": "<#>"}


def _vec_lit(v):
    return "[" + ",".join(f"{x:.6f}" for x in v) + "]"


def _lit_vec(v):
    """The query vector as the SQL literal carries it."""
    return np.asarray(_vec_lit(v).strip("[]").split(","), dtype=np.float32)


def _mixture(rng, n, d, clusters):
    """Gaussian clusters: IVF recall means something on these."""
    centers = rng.normal(scale=4.0, size=(clusters, d))
    lab = rng.integers(0, clusters, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


def _dist_f64(vecs, q, metric):
    v, q = vecs.astype(np.float64), q.astype(np.float64)
    dots = v @ q
    if metric == "ip":
        return -dots
    if metric == "cosine":
        return 1 - dots / np.maximum(np.linalg.norm(v, axis=1)
                                     * np.linalg.norm(q), 1e-30)
    return np.sqrt(np.maximum((v * v).sum(1) - 2 * dots + q @ q, 0))


def _dist_tol(vecs, q, metric):
    """Per-row absolute tolerance of a distance (see the module doc)."""
    vn2 = (vecs.astype(np.float64) ** 2).sum(1)
    qn2 = float(q.astype(np.float64) @ q)
    if metric == "cosine":
        return np.full(len(vecs), RTOL)
    if metric == "ip":
        return RTOL * np.sqrt(vn2 * qn2)
    d = _dist_f64(vecs, q, "l2")
    # |a^2 - b^2| <= RTOL (|v|^2 + |q|^2)  =>  |a - b| <= that / (a + b)
    return RTOL * d + RTOL * (vn2 + qn2) / np.maximum(d, np.sqrt(
        RTOL * (vn2 + qn2)))


def assert_dists(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    both_inf = np.isinf(got) & np.isinf(want) & (got == want)
    err = np.where(both_inf, 0.0, np.abs(got - want))
    assert (err <= tol + RTOL * np.abs(want)).all(), \
        f"max excess {np.max(err - tol - RTOL * np.abs(want))}"


def assert_same_rank(got, want, dist, tol):
    """Equal row lists, but for swaps of rows whose distances `dist`
    (by row) agree within `tol` (by row)."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            assert abs(dist[g] - dist[w]) <= tol[g] + tol[w], \
                f"rank {i}: {g} != {w} (distances {dist[g]} {dist[w]})"
    assert sorted(got) == sorted(want) or all(
        abs(dist[g] - dist[w]) <= tol[g] + tol[w]
        for g, w in zip(got, want))


@pytest.fixture(scope="module")
def kdata():
    rng = np.random.default_rng(15)
    vecs = _mixture(rng, NK, DK, 32)
    q = (vecs[7] + rng.normal(scale=0.5, size=DK)).astype(np.float32)
    return vecs, q


# ---------------------------------------------------------------------------
# kernels: the port's plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(N, DIM), (NK, DK)])
def test_distances(metric, shape, kdata):
    rng = np.random.default_rng(shape[0] + shape[1])
    vecs = rng.normal(size=shape).astype(np.float32)
    q = rng.normal(size=shape[1]).astype(np.float32)
    want = np.asarray(RANN.distances(jnp.asarray(vecs), jnp.asarray(q),
                                     metric))
    got = ANN.distances(torch.from_numpy(vecs), torch.from_numpy(q), metric)
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    assert_dists(got.numpy(), want, _dist_tol(vecs, q, metric))


@pytest.mark.parametrize("k", [1, 5, 12, 40])
def test_topk_ties_masks_and_short_valid(k):
    """One shared distance array: runs of equal distances, masked rows,
    and fewer valid rows than k where k = 40 (the +inf slots take the
    lowest masked rows, as lax.top_k(-masked, k) orders them)."""
    rng = np.random.default_rng(3)
    n = 64
    d = rng.choice(np.asarray([3.0, 1.0, 2.0, 1.0, 0.5, 7.0], np.float32), n)
    d[10:14] = 1.0
    valid = rng.random(n) < 0.5
    valid[:6] = [True, True, True, False, True, False]
    want_i, want_d = RANN.topk_nearest(jnp.asarray(d), jnp.asarray(valid), k)
    got_i, got_d = ANN.topk_nearest(torch.from_numpy(d),
                                    torch.from_numpy(valid), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    if k == 40:
        assert valid.sum() < k and np.isinf(got_d.numpy()).any()


def test_topk_example_order():
    """lax.top_k(-[3,1,2,1,1,inf,inf], 6) is [1,3,4,2,0,5]."""
    d = torch.tensor([3, 1, 2, 1, 1, 0, 0], dtype=torch.float32)
    valid = torch.tensor([True] * 5 + [False] * 2)
    idx, dist = ANN.topk_nearest(d, valid, 6)
    assert idx.tolist() == [1, 3, 4, 2, 0, 5]
    assert np.isinf(dist[-1].item())


NEG_NAN = np.copysign(np.float32(np.nan), np.float32(-1))


def _nan_rule_oracle(d, valid, k):
    """Rows of the k smallest in PostgreSQL's float order: masked rows
    +inf, -0.0 as 0.0, every NaN (either sign) after +inf, ties to the
    lower row."""
    x = d.astype(np.float64)
    if valid is not None:
        x = np.where(valid, x, np.inf)
    nan = np.isnan(x)
    return np.lexsort((np.arange(len(x)), np.where(nan, 0.0, x), nan))[:k]


@pytest.mark.parametrize("case", ["example", "both signs", "ties", "masked",
                                  "mostly nan"])
def test_topk_plain_ranks_every_nan_after_inf(case):
    """topk_nearest_plain against the oracle of the NaN rule.  The
    reference's lax.top_k(-masked, k) ranks a sign-set NaN first (on
    the example, rows [3 6 7 2 5 0 4 1]); the port keeps PostgreSQL's
    order on every platform."""
    rng = np.random.default_rng(21)
    valid = None
    if case == "example":
        d = np.asarray([3, np.nan, 1, NEG_NAN, np.inf, 2, -0.0, 0.0],
                       np.float32)
    else:
        d = rng.choice(np.asarray([1.0, -0.0, 0.0, 2.0, np.inf, np.nan,
                                   NEG_NAN], np.float32), 300)
        if case == "ties":
            d[:100] = 1.0
        if case == "masked":
            valid = rng.random(300) < 0.4
        if case == "mostly nan":
            d = np.where(rng.random(300) < 0.9, NEG_NAN, d).astype(np.float32)
    k = len(d)
    idx, dist = ANN.topk_nearest_plain(
        torch.from_numpy(d), None if valid is None else
        torch.from_numpy(valid), k)
    want = _nan_rule_oracle(d, valid, k)
    np.testing.assert_array_equal(idx.numpy(), want)
    masked = d if valid is None else np.where(valid, d, np.float32(np.inf))
    np.testing.assert_array_equal(dist.numpy().view(np.int32),
                                  masked[want].view(np.int32))
    if case == "example":
        assert idx.tolist() == [6, 7, 2, 5, 0, 4, 1, 3]


@pytest.mark.parametrize("metric", METRICS)
def test_distances_plain_keeps_nan_on_nonfinite_rows(metric):
    """Rows with an infinite or NaN component (either sign): the same
    NaN rows as the reference's distances, and the same bits elsewhere
    (infinities).  l2's inf - inf is NaN in both, never a clamped 0:
    the card's kernels are held to this plain version."""
    rng = np.random.default_rng(5)
    n, d = 48, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    specials = (np.inf, -np.inf, np.nan, NEG_NAN)
    for i in range(n):
        vecs[i, i % d] = specials[i % 4]
        if i % 3 == 0:
            vecs[i, (i + 5) % d] = specials[(i + 1) % 4]
    q = rng.normal(size=d).astype(np.float32)
    want = np.asarray(RANN.distances(jnp.asarray(vecs), jnp.asarray(q),
                                     metric))
    got = ANN.distances_plain(torch.from_numpy(vecs), torch.from_numpy(q),
                              metric).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.int32),
                                  want[keep].view(np.int32))
    assert np.isnan(got).any()


IT_ROWS = ("insert into it values (1, '[1,1]'), (2, '[Infinity,0]'), "
           "(3, '[2,2]'), (4, '[3,3]')")


@pytest.mark.parametrize("tier", ["session", "cluster host tier"])
def test_sql_nan_distance_ranks_last(tier):
    """Row 2's l2 distance to [1,1] is inf - inf, NaN: it ranks after
    every other row, so the top two are rows 1 and 3.  The reference's
    Session returns [(2,)] here (its x86 NaN carries the sign bit, which
    lax.top_k ranks first, and it then counts one finite slot)."""
    if tier == "session":
        s = Session(LocalNode(device="cpu"))
        s.execute("create table it (id bigint, v vector(2))")
    else:
        s = ClusterSession(Cluster(2, device="cpu"))
        s.execute("create table it (id bigint, v vector(2)) "
                  "distribute by shard(id)")
        s.execute("set enable_mesh_exchange = off")
    s.execute(IT_ROWS)
    assert s.query("select id from it order by v <-> '[1,1]' limit 2") \
        == [(1,), (3,)]
    if tier != "session":
        assert s.last_tier == "host"


def _scores_f64(vecs, c, metric):
    v, c = vecs.astype(np.float64), c.astype(np.float64)
    dots = v @ c.T
    if metric == "ip":
        return dots
    if metric == "cosine":
        return dots / np.maximum(np.linalg.norm(v, axis=1)[:, None]
                                 * np.linalg.norm(c, axis=1)[None], 1e-30)
    return 2 * dots - (c * c).sum(1)[None]


@pytest.mark.parametrize("metric", METRICS)
def test_assign_clusters(metric, kdata):
    vecs, _ = kdata
    cents = vecs[np.random.default_rng(1).choice(NK, 64, replace=False)]
    cents = cents + np.float32(0.25)
    want = np.asarray(RANN.assign_clusters(jnp.asarray(vecs),
                                           jnp.asarray(cents), metric))
    got = ANN.assign_clusters(torch.from_numpy(vecs),
                              torch.from_numpy(cents), metric)
    assert got.dtype == torch.int32
    got = got.numpy()
    diff = np.nonzero(got != want)[0]
    if len(diff):
        s = _scores_f64(vecs[diff], cents, metric)
        r = np.arange(len(diff))
        scale = np.abs(s).max(1) + 1
        assert (np.abs(s[r, got[diff]] - s[r, want[diff]])
                <= 4 * RTOL * scale).all()
    assert len(diff) <= 2


def _special_assign_case(case):
    """Rows and centroids of small integers (every score exact in f32,
    whatever the order of the products) with the values that decide
    jnp.argmax's rule: NaN, +-inf and 1e20 components, an all-zero row,
    duplicated centroids and a zero centroid; `case` adds centroids of
    1e20 (an l2 score of inf - inf, a cosine |v| |c| of inf x 0), NaN
    centroids (every row takes the first NaN), or centroids whose l2
    norms overflow (a row of -inf scores gives 0)."""
    rng = np.random.default_rng(31)
    d, nlist = 16, 24
    cents = rng.integers(-3, 4, (nlist, d)).astype(np.float32)
    cents[7] = cents[19] = cents[3]
    cents[11] = 0.0
    rows = rng.integers(-3, 4, (120, d)).astype(np.float32)
    rows[:30] = cents[rng.integers(0, nlist, 30)]      # exact ties
    rows[30, 5] = np.nan
    rows[31, 0] = 1e20
    rows[32, 3] = -1e20
    rows[33] = 0.0
    rows[34, 2] = np.inf
    rows[35, 9] = -np.inf
    rows[36, :2] = (np.inf, -np.inf)
    if case == "big":
        cents[5, 0], cents[17, 0] = 1e20, -1e20
    elif case == "nan":
        cents[6, 4] = cents[13, 0] = np.nan
    elif case == "overflow":
        cents[np.arange(nlist), np.arange(nlist) % d] = 1e20
    return rows, cents


@pytest.mark.parametrize("case", ["rows", "big", "nan", "overflow"])
@pytest.mark.parametrize("metric", METRICS)
def test_assign_clusters_nan_inf_and_ties_equal_reference(metric, case):
    """jnp.argmax's rule, exactly: a NaN score wins (the first NaN),
    ties go to the lower centroid, a row of -inf scores gives 0; the
    card's kernel is held to the same plain version by chip_smoke.py."""
    rows, cents = _special_assign_case(case)
    want = np.asarray(RANN.assign_clusters(jnp.asarray(rows),
                                           jnp.asarray(cents), metric))
    got = ANN.assign_clusters(torch.from_numpy(rows),
                              torch.from_numpy(cents), metric).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "nan":
        assert (want[37:] == 6).all()       # the first NaN centroid
    if case == "overflow" and metric == "l2":
        assert (want[37:] == 0).all()       # every score -inf
    if case == "rows":
        assert want[30] == 0                # a NaN row: every score NaN


def test_lloyd_step(kdata):
    vecs, _ = kdata
    nlist = 32
    cents = np.array(RANN.kmeans(vecs, nlist, iters=0))
    valid = np.ones(NK, bool)
    valid[::9] = False
    want = np.asarray(RANN._lloyd_step(jnp.asarray(vecs), jnp.asarray(valid),
                                       jnp.asarray(cents), nlist))
    got = ANN._lloyd_step(torch.from_numpy(vecs), torch.from_numpy(valid),
                          torch.from_numpy(cents), nlist).numpy()
    # the l2 assignments agree (no tie on this data), so only the order
    # of the f32 sums differs
    a_got = ANN.assign_clusters(torch.from_numpy(vecs),
                                torch.from_numpy(cents)).numpy()
    a_want = np.asarray(RANN.assign_clusters(jnp.asarray(vecs),
                                             jnp.asarray(cents)))
    np.testing.assert_array_equal(a_got, a_want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


def test_lloyd_empty_cluster_keeps_its_centroid():
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    cents = np.concatenate([vecs[:3], np.full((1, 8), 1e6, np.float32)])
    valid = np.ones(50, bool)
    want = np.asarray(RANN._lloyd_step(jnp.asarray(vecs), jnp.asarray(valid),
                                       jnp.asarray(cents), 4))
    got = ANN._lloyd_step(torch.from_numpy(vecs), torch.from_numpy(valid),
                          torch.from_numpy(cents), 4).numpy()
    np.testing.assert_array_equal(got[3], cents[3])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


def _lloyd_layout(case, rng, tile):
    """(labels, valid, nlist) of a Lloyd step whose clusters have a chosen
    shape: `skewed`, one cluster holding 90% of the rows; `tile_edges`,
    runs of tile - 1, tile and tile + 1 rows (and 1, 3, 2 tile + 1)
    between empty clusters; `invalid`, a tenth of the rows invalid."""
    if case == "skewed":
        n, nlist = 6000, 12
        lab = np.where(rng.random(n) < 0.9, 4, rng.integers(0, 9, n))
        return lab, rng.random(n) < 0.97, nlist
    lengths = [tile - 1, tile, tile + 1, 1, 2 * tile + 1, 3]
    lab = np.repeat(2 * np.arange(len(lengths)) + 1, lengths)
    lab = lab[rng.permutation(len(lab))]
    valid = np.ones(len(lab), bool) if case == "tile_edges" \
        else rng.random(len(lab)) < 0.9
    return lab, valid, 2 * len(lengths) + 2


@pytest.mark.parametrize("case", ["skewed", "tile_edges", "invalid"])
def test_lloyd_step_on_skewed_clusters_matches_reference(case):
    """_lloyd_step's plain version against the reference where the card's
    update cuts the sorted rows into tiles of ANN.LLOYD_TILE: one
    cluster holding most rows, runs one short of, equal to and one past a
    tile, empty clusters between them (their centroids kept exactly) and
    invalid rows.  The rows sit close to well separated centroids, so
    both assign them alike and only the order of the f32 sums differs."""
    rng = np.random.default_rng(31)
    lab, valid, nlist = _lloyd_layout(case, rng, ANN.LLOYD_TILE)
    d = 8
    cents = rng.normal(scale=50.0, size=(nlist, d)).astype(np.float32)
    vecs = (cents[lab] + rng.normal(scale=0.5, size=(len(lab), d))).astype(
        np.float32)
    want = np.asarray(RANN._lloyd_step(jnp.asarray(vecs), jnp.asarray(valid),
                                       jnp.asarray(cents), nlist))
    got = ANN._lloyd_step(torch.from_numpy(vecs), torch.from_numpy(valid),
                          torch.from_numpy(cents), nlist).numpy()
    empty = np.bincount(lab[valid], minlength=nlist) == 0
    assert empty.any()
    np.testing.assert_array_equal(got[empty], cents[empty])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("n,nlist", [(300, 16), (10, 16)])
def test_kmeans_first_centroids_are_the_references(n, nlist):
    """Same generator calls, so the same initial centroids (and the same
    normal top-up when there are fewer rows than lists)."""
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(n, 8)).astype(np.float32)
    want = RANN.kmeans(vecs, nlist, iters=0)
    got = ANN.kmeans(vecs, nlist, iters=0, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_kmeans_is_reproducible(kdata):
    vecs = kdata[0][:1024]
    a = ANN.kmeans(vecs, 16, device="cpu")
    b = ANN.kmeans(vecs, 16, device="cpu")
    np.testing.assert_array_equal(a, b)
    want = RANN.kmeans(vecs, 16)
    np.testing.assert_allclose(a, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_search(metric, kdata):
    vecs, q = kdata
    nlist, nprobe, k = 32, 4, 10
    cents = np.array(RANN.kmeans(vecs, nlist))
    assign = np.array(RANN.assign_clusters(jnp.asarray(vecs),
                                             jnp.asarray(cents), metric))
    valid = np.ones(NK, bool)
    valid[5::11] = False
    want_i, want_d = RANN.ivf_search(
        jnp.asarray(vecs), jnp.asarray(assign), jnp.asarray(cents),
        jnp.asarray(q), jnp.asarray(valid), nprobe, k, metric)
    got_i, got_d = ANN.ivf_search(
        torch.from_numpy(vecs), torch.from_numpy(assign),
        torch.from_numpy(cents), torch.from_numpy(q),
        torch.from_numpy(valid), nprobe, k, metric)
    dist = _dist_f64(vecs, q, metric)
    tol = _dist_tol(vecs, q, metric)
    assert_same_rank(got_i.numpy(), np.asarray(want_i), dist, tol)
    assert_dists(got_d.numpy(), np.asarray(want_d), tol[np.asarray(want_i)])
    # the probe scan alone: rows of unprobed lists are +inf
    probed = torch.zeros(nlist + 1, dtype=torch.bool)
    cd = ANN.distances(torch.from_numpy(cents), torch.from_numpy(q), metric)
    probed[ANN.topk_nearest(cd, None, nprobe)[0]] = True
    scan = ANN.probe_scan(torch.from_numpy(vecs), torch.from_numpy(assign),
                          probed, torch.from_numpy(valid),
                          torch.from_numpy(q), metric).numpy()
    taken = valid & probed.numpy()[assign]
    assert np.isinf(scan[~taken]).all() and np.isfinite(scan[taken]).all()


def test_wrappers_refuse_bad_inputs():
    v = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        ANN.distances(v, torch.zeros(3), "hamming")
    with pytest.raises(ValueError):
        ANN.topk_nearest(torch.zeros(4), None, 5)


# ---------------------------------------------------------------------------
# SQL: the reference's tests/test_ann.py cases through both Sessions
# ---------------------------------------------------------------------------

def _create(s, dim=DIM):
    s.execute(f"create table items (id bigint primary key, "
              f"embedding vector({dim}), cat varchar(4)) "
              f"distribute by shard(id)")


def _columns(vecs, ids=None):
    n = len(vecs)
    ids = np.arange(n, dtype=np.int64) if ids is None else ids
    return {"id": ids, "embedding": vecs,
            "cat": np.asarray([f"c{i % 3}" for i in ids.tolist()])}


@pytest.fixture(scope="module")
def sql():
    rng = np.random.default_rng(5)
    vecs = _mixture(rng, N, DIM, 16)
    q = _lit_vec(vecs[3] + rng.normal(scale=0.3, size=DIM))
    sessions = []
    for s in (RSession(RNode()), Session(LocalNode(device="cpu"))):
        _create(s)
        s._insert_rows(s.node.catalog.table("items"), s.node.stores["items"],
                       _columns(vecs), N)
        sessions.append(s)
    return sessions[0], sessions[1], vecs, q


def _both(sql, text):
    ref, port = sql[0], sql[1]
    return ref.query(text), port.query(text)


def _check_rows(got, want, vecs, q, metric, dcol=None):
    """Rows of (id, [distance]) queries: ids up to near-ties, distances
    within the tolerance."""
    dist = _dist_f64(vecs, q, metric)
    tol = _dist_tol(vecs, q, metric)
    assert_same_rank([r[0] for r in got], [r[0] for r in want], dist, tol)
    if dcol is not None:
        ids = [r[0] for r in want]
        assert_dists([r[dcol] for r in got], [r[dcol] for r in want],
                     tol[ids])


@pytest.mark.parametrize("metric", METRICS)
def test_sql_order_by_distance_limit(sql, metric):
    _, _, vecs, q = sql
    got_want = _both(sql, f"select id from items order by embedding "
                          f"{OPS[metric]} '{_vec_lit(q)}' limit 5")
    want, got = got_want
    assert len(got) == 5
    _check_rows(got, want, vecs, q, metric)


def test_sql_distance_in_select_list(sql):
    _, _, vecs, q = sql
    want, got = _both(sql, f"select id, embedding <-> '{_vec_lit(q)}' as d "
                           f"from items order by d limit 3")
    assert all(isinstance(r[1], float) for r in got)
    _check_rows(got, want, vecs, q, "l2", dcol=1)


def test_sql_filtered_cosine(sql):
    _, _, vecs, q = sql
    want, got = _both(sql, f"select id, embedding <=> '{_vec_lit(q)}' as d "
                           f"from items where cat = 'c0' order by d limit 5")
    assert all(r[0] % 3 == 0 for r in got)
    _check_rows(got, want, vecs, q, "cosine", dcol=1)


def test_sql_range_qual_runs_fused(sql):
    _, _, vecs, q = sql
    r = float(np.sort(_dist_f64(vecs, q, "l2"))[40]) + 0.05
    before = plancache.FUSED.compiles
    want, got = _both(sql, f"select count(*) from items where "
                           f"embedding <-> '{_vec_lit(q)}' < {r}")
    assert got == want and got[0][0] > 0
    assert plancache.FUSED.compiles > before     # one captured program


def test_sql_query_vector_is_a_retained_device_constant(sql):
    """The distance's query vector comes from the content-keyed constant
    cache (no upload per call under capture), and a capture keeps it."""
    from opentenbase_tpu_torch.exec import expr_compile as EC
    _, port, _, q = sql
    with EC.retain_consts() as keep:
        port.query(f"select count(*) from items where embedding <#> "
                   f"'{_vec_lit(q)}' < 0")
        again = EC.device_const(q, "cpu")
    mine = [t for t in keep if t.shape == (DIM,) and torch.equal(
        t, torch.from_numpy(q))]
    assert mine and all(t is again for t in mine)


def test_sql_limit_above_live_rows(sql):
    _, _, vecs, q = sql
    want, got = _both(sql, f"select id from items where cat = 'c1' order by "
                           f"embedding <-> '{_vec_lit(q)}' limit 2000")
    assert len(got) == len(want) == (np.arange(N) % 3 == 1).sum()
    _check_rows(got, want, vecs, q, "l2")


def test_sql_vector_column_output(sql):
    _, _, vecs, q = sql
    want, got = _both(sql, f"select id, embedding from items order by "
                           f"embedding <-> '{_vec_lit(q)}' limit 2")
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g[1], np.float32),
                                      np.asarray(w[1], np.float32))


def test_sql_bad_vector_literal(sql):
    with pytest.raises(BindError):
        sql[1].query("select id from items order by "
                     "embedding <-> '[1,2]' limit 1")


def test_sql_ann_declines_the_fused_tier(sql):
    _, _, _, q = sql
    before = fused.declines_snapshot().get("ann_search", 0)
    sql[1].query(f"select id from items order by embedding <-> "
                 f"'{_vec_lit(q)}' limit 1")
    assert fused.declines_snapshot()["ann_search"] == before + 1


@pytest.mark.parametrize("method", ["hnsw", "btree"])
def test_sql_other_index_methods_not_ported(method):
    s = Session(LocalNode(device="cpu"))
    _create(s, 4)
    using = "" if method == "btree" else f"using {method} "
    col = "id" if method == "btree" else "embedding"
    with pytest.raises(NotImplementedError, match="not yet ported"):
        s.execute(f"create index ix on items {using}({col})")


def _ivf_pair(vecs, lists, metric="l2"):
    """Both sessions over the same rows, the port's index adopted from
    the reference's build."""
    ref, port = RSession(RNode()), Session(LocalNode(device="cpu"))
    for s in (ref, port):
        _create(s, vecs.shape[1])
        s._insert_rows(s.node.catalog.table("items"), s.node.stores["items"],
                       _columns(vecs), len(vecs))
    ref.execute(f"create index items_emb on items using ivfflat (embedding) "
                f"with (lists = {lists}, metric = '{metric}')")
    info = ref.node.stores["items"].ann_indexes["embedding"]
    port.node.stores["items"].adopt_ann_index(
        "embedding", info["centroids"], info["metric"], info["nprobe"])
    return ref, port


@pytest.fixture(scope="module")
def ivf():
    rng = np.random.default_rng(8)
    vecs = _mixture(rng, NK, DK, 64)
    qs = [_lit_vec(vecs[i] + rng.normal(scale=0.5, size=DK))
          for i in (11, 2000)]
    ref, port = _ivf_pair(vecs, 64)
    return ref, port, vecs, qs


@pytest.mark.parametrize("qi", [0, 1])
def test_sql_ivf_adopted_index_gives_the_references_ids(ivf, qi):
    ref, port, vecs, qs = ivf
    q = qs[qi]
    text = (f"select id, embedding <-> '{_vec_lit(q)}' as d from items "
            f"order by d limit 10")
    want, got = ref.query(text), port.query(text)
    assert len(got) == 10
    _check_rows(got, want, vecs, q, "l2", dcol=1)
    # the port probed its index: the assignment cache is filled
    info = port.node.stores["items"].ann_indexes["embedding"]
    assert info["_assign_cache"]["cpu"][1].shape[0] >= NK


def test_sql_ivf_cosine_index(ivf):
    _, _, vecs, qs = ivf
    ref, port = _ivf_pair(vecs[:1024], 16, "cosine")
    q = qs[0]
    text = (f"select id from items order by embedding <=> "
            f"'{_vec_lit(q)}' limit 10")
    _check_rows(port.query(text), ref.query(text), vecs[:1024], q, "cosine")


def test_sql_ivf_built_by_the_port_reaches_recall(sql):
    """tests/test_ann.py::test_ivfflat_index_used's floor: 6 of the exact
    10 with lists = 16 (nprobe 2)."""
    _, _, vecs, q = sql
    s = Session(LocalNode(device="cpu"))
    _create(s)
    s._insert_rows(s.node.catalog.table("items"), s.node.stores["items"],
                   _columns(vecs), N)
    gen = s.node.ddl_gen
    s.execute("create index items_emb on items using ivfflat (embedding) "
              "with (lists = 16)")
    assert s.node.ddl_gen == gen + 1
    info = s.node.stores["items"].ann_indexes["embedding"]
    assert info["centroids"].shape == (16, DIM) and info["nprobe"] == 2
    got = s.query(f"select id from items order by embedding <-> "
                  f"'{_vec_lit(q)}' limit 10")
    exact = set(np.argsort(_dist_f64(vecs, q, "l2"))[:10].tolist())
    assert len({r[0] for r in got} & exact) >= 6


def test_sql_ivf_finds_rows_inserted_after_the_build(ivf):
    ref0, port0, vecs, qs = ivf
    ref, port = _ivf_pair(vecs[:1024], 16)
    q = qs[1]
    for s in (ref, port):
        s._insert_rows(s.node.catalog.table("items"), s.node.stores["items"],
                       _columns(q[None], np.asarray([99999])), 1)
    text = f"select id from items order by embedding <-> '{_vec_lit(q)}' " \
           f"limit 3"
    want, got = ref.query(text), port.query(text)
    assert got[0][0] == 99999 == want[0][0]
    allv = np.concatenate([vecs[:1024], q[None]])
    ids = np.concatenate([np.arange(1024), [99999]])
    pos = {int(i): j for j, i in enumerate(ids)}
    dist = _dist_f64(allv, q, "l2")
    tol = _dist_tol(allv, q, "l2")
    assert_same_rank([pos[r[0]] for r in got], [pos[r[0]] for r in want],
                     dist, tol)


# ---------------------------------------------------------------------------
# the cluster: per-DataNode AnnSearch under the coordinator's merge
# ---------------------------------------------------------------------------

def _cluster_pair(n, vecs):
    ref = RClusterSession(RCluster(n_datanodes=n))
    port = ClusterSession(Cluster(n, device="cpu"))
    for s in (ref, port):
        _create(s)
        s._insert_rows(s.cluster.catalog.table("items"), _columns(vecs),
                       len(vecs))
    port.execute("set enable_mesh_exchange = off")
    return ref, port


@pytest.mark.parametrize("ndn", [2, 3])
def test_cluster_host_tier_rows_equal_the_references(sql, ndn):
    _, _, vecs, q = sql
    ref, port = _cluster_pair(ndn, vecs)
    lit = _vec_lit(q)
    for text, metric, dcol in (
            (f"select id from items order by embedding <-> '{lit}' limit 5",
             "l2", None),
            (f"select id, embedding <=> '{lit}' as d from items where "
             f"cat = 'c2' order by d limit 4", "cosine", 1)):
        want, got = ref.query(text), port.query(text)
        assert port.last_tier == "host"
        _check_rows(got, want, vecs, q, metric, dcol)
    # IVF: each DataNode's index adopted from the reference's DataNode
    ref.execute("create index items_emb on items using ivfflat (embedding) "
                "with (lists = 8)")
    port.execute("create index items_emb on items using ivfflat (embedding) "
                 "with (lists = 8)")
    for rdn, tdn in zip(ref.cluster.datanodes, port.cluster.datanodes):
        info = rdn.stores["items"].ann_indexes["embedding"]
        tdn.stores["items"].adopt_ann_index(
            "embedding", info["centroids"], info["metric"], info["nprobe"])
    text = f"select id from items order by embedding <-> '{lit}' limit 10"
    _check_rows(port.query(text), ref.query(text), vecs, q, "l2")


def test_cluster_device_tier_raises(sql):
    _, _, vecs, q = sql
    port = ClusterSession(Cluster(2, device="cpu"))
    _create(port)
    port._insert_rows(port.cluster.catalog.table("items"), _columns(vecs[:64]),
                      64)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port.query(f"select id from items order by embedding <-> "
                   f"'{_vec_lit(q)}' limit 5")
