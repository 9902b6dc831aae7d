"""Kernel parity for the cluster tier's kernels: K11 routing (bucket ids,
the routing hash and the shard-map placement), the K12 exchange and K3
compaction, plus the port of parallel/mesh.py, against the JAX package on
the same numpy inputs.

On the CPU each port wrapper runs its plain PyTorch version; the CUDA
kernels are held against those on the card by chip_smoke.py.  Hashes,
destinations, rows, their order and counts must be equal exactly.
"""

import numpy as np
import pytest
import torch

import jax
import opentenbase_tpu  # noqa: F401  (x64 on, as the reference runs)
import jax.numpy as jnp
from opentenbase_tpu.catalog import types as RT
from opentenbase_tpu.catalog.schema import NUM_SHARDS
from opentenbase_tpu.exec.dist import DistExecutor as RDist
from opentenbase_tpu.exec.dist import HostBatch as RHostBatch
from opentenbase_tpu.ops import kernels as RK
from opentenbase_tpu.parallel import mesh as RM
from opentenbase_tpu.parallel.cluster import Cluster as RCluster
from opentenbase_tpu.plan import exprs as RE
from opentenbase_tpu.utils.hashing import hash_columns_np, hash_string
from opentenbase_tpu_torch.ops import kernels as TK
from opentenbase_tpu_torch.parallel import mesh as TM
from opentenbase_tpu_torch.utils import hashing as TH

I64 = np.iinfo(np.int64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lut(values):
    """int64 bit patterns of hash_string over a dictionary."""
    return _t(np.asarray([hash_string(v) for v in values] or [0],
                         dtype=np.uint64).view(np.int64))


# ---------------------------------------------------------------------------
# K11 routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbuckets", [4096, 7, 3])
@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_bucket_ids_matches_reference(ncols, nbuckets):
    rng = np.random.default_rng(100 + ncols * 10 + nbuckets)
    n = 2000
    cols = [rng.integers(I64.min, I64.max, n, dtype=np.int64,
                         endpoint=True),
            rng.integers(-50, 50, n).astype(np.int64),
            rng.integers(-2**40, 2**40, n).astype(np.int64)][:ncols]
    cols[0][:6] = [0, -1, I64.min, I64.max, 1, -(1 << 40)]
    want = np.asarray(RK.bucket_ids(tuple(jnp.asarray(c) for c in cols),
                                    nbuckets))
    got = TK.bucket_ids(tuple(_t(c) for c in cols), nbuckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    h = hash_columns_np(cols)
    np.testing.assert_array_equal(
        got.numpy(), (h % np.uint64(nbuckets)).astype(np.int32))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 4096, 1 << 20])
def test_unsigned_remainder(n):
    rng = np.random.default_rng(n)
    h = rng.integers(I64.min, I64.max, 5000, dtype=np.int64, endpoint=True)
    h[:4] = [I64.min, I64.max, -1, 0]
    want = (h.view(np.uint64) % np.uint64(n)).astype(np.int64)
    np.testing.assert_array_equal(TH.umod_plain(_t(h), n).numpy(), want)


def _route_table(ndn):
    """A reference cluster catalog with a table sharded on (int, text)."""
    from opentenbase_tpu.sql.parser import parse_sql
    from opentenbase_tpu.sql.ddl import table_def_from_ast
    c = RCluster(n_datanodes=ndn)
    td = c.create_table(table_def_from_ast(parse_sql(
        "create table rt (a bigint, s varchar(12), v int) "
        "distribute by shard(a, s)")[0]))
    return c, td


@pytest.mark.parametrize("ndn", [2, 3, 4])
def test_route_dest_matches_locator_placement(ndn):
    """The destination the routing kernel gives a row is the DataNode the
    locator stored it on: shard_map[hash_columns_np(...) % 4096], with
    NULL int keys (placed as 0) and TEXT keys (placed by hash_string of
    the value, NULL as '')."""
    rng = np.random.default_rng(ndn)
    n = 3000
    c, td = _route_table(ndn)
    a = rng.integers(-10**12, 10**12, n).astype(np.int64)
    a_null = rng.random(n) < 0.1
    words = np.asarray([f"w{i}" for i in range(40)] + [""], dtype=object)
    s = words[rng.integers(0, len(words), n)]
    raw_a = [None if m else int(x) for x, m in zip(a, a_null)]
    raw_s = [str(x) for x in s]
    nodes = c.locator.route_rows(td, {
        "a": np.asarray([0 if v is None else v for v in raw_a]),
        "s": np.asarray(raw_s, dtype=object)}, n)
    # the port's batch: int key with its null mask, TEXT as dictionary
    # codes (a shuffled dictionary) with the hash LUT
    dict_vals = list(rng.permutation(words))
    code_of = {v: i for i, v in enumerate(dict_vals)}
    codes = np.asarray([code_of[v] for v in s], dtype=np.int32)
    valid = rng.random(n) < 0.9
    got = TK.route_dest([_t(a), _t(codes)], [_t(a_null), None],
                        [None, _lut(dict_vals)], _t(valid),
                        _t(np.asarray(c.catalog.shard_map, np.int32)), ndn,
                        NUM_SHARDS)
    want = np.where(valid, nodes, ndn)
    np.testing.assert_array_equal(got.numpy(), want)
    # the bucket form (no shard map) is the shard id
    h = hash_columns_np([np.where(a_null, 0, a),
                         np.asarray([hash_string(v) for v in s],
                                    dtype=np.uint64)])
    sid = TK.route_dest([_t(a), _t(codes)], [_t(a_null), None],
                        [None, _lut(dict_vals)], _t(np.ones(n, bool)), None,
                        ndn, NUM_SHARDS)
    np.testing.assert_array_equal(sid.numpy(),
                                  (h % np.uint64(NUM_SHARDS)).astype(np.int32))


def test_route_dest_clips_text_codes_and_uses_the_shard_map():
    """Out-of-range codes clip into the LUT; with 3 DataNodes the shard
    map is not hash % 3."""
    n = 500
    rng = np.random.default_rng(9)
    c, _td = _route_table(3)
    smap = np.asarray(c.catalog.shard_map, np.int32)
    codes = rng.integers(-5, 15, n).astype(np.int32)
    vals = [f"v{i}" for i in range(10)]
    got = TK.route_dest([_t(codes)], None, [_lut(vals)],
                        _t(np.ones(n, bool)), _t(smap), 3, NUM_SHARDS)
    clipped = np.clip(codes, 0, 9)
    h = hash_columns_np([np.asarray([hash_string(vals[i]) for i in clipped],
                                    dtype=np.uint64)])
    want = smap[(h % np.uint64(NUM_SHARDS)).astype(np.int64)]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != (h % np.uint64(3)).astype(np.int32)).any()


# ---------------------------------------------------------------------------
# K12 exchange vs the reference host tier's _route
# ---------------------------------------------------------------------------

def _host_batches(rng, ndn, rows_per_dn, words):
    parts = []
    for d in range(ndn):
        m = rows_per_dn[d]
        k = rng.integers(-50, 50, m).astype(np.int64)
        s = words[rng.integers(0, len(words), m)]
        f = rng.normal(0, 10, m)
        k_null = rng.random(m) < 0.15
        s_null = rng.random(m) < 0.1
        parts.append(RHostBatch(
            {"k": k, "s": np.asarray(s, dtype=object), "f": f},
            {"k": RT.INT64, "s": RT.TEXT, "f": RT.FLOAT64}, m,
            {"k": k_null, "s": s_null}))
    return parts


@pytest.mark.parametrize("ndn", [1, 2, 3, 4])
def test_exchange_matches_host_tier_route(ndn):
    """K12 (plain) after K11 moves the same rows to the same DataNodes in
    the same order as the reference's host tier: keys (int, TEXT) with
    NULLs, a source with no live rows, invalid rows interleaved, and (at
    4 DataNodes) a destination that receives nothing."""
    rng = np.random.default_rng(40 + ndn)
    words = np.asarray([f"w{i}" for i in range(12)])
    rows = [int(rng.integers(30, 200)) for _ in range(ndn)]
    if ndn > 1:
        rows[1] = 0                      # a source with no live rows
    parts = _host_batches(rng, ndn, rows, words)
    if ndn == 4:
        # keep only the rows the reference places on DataNodes 0-2
        sm = np.asarray(RCluster(n_datanodes=ndn).catalog.shard_map)
        for p in parts:
            sh = np.asarray([hash_string(str(x)) for x in p.cols["s"]],
                            dtype=np.uint64)
            h = hash_columns_np([
                np.where(p.nulls["k"], np.uint64(0),
                         p.cols["k"].view(np.uint64)),
                np.where(p.nulls["s"], np.uint64(0), sh)])
            keep = sm[(h % np.uint64(NUM_SHARDS)).astype(np.int64)] != 3
            p.cols = {n: a[keep] for n, a in p.cols.items()}
            p.nulls = {n: a[keep] for n, a in p.nulls.items()}
            p.nrows = int(keep.sum())
    rcl = RCluster(n_datanodes=ndn)
    rex = RDist(rcl, 0, 0)
    keys = [RE.Col("k", RT.INT64), RE.Col("s", RT.TEXT)]
    routed = rex._route(parts, keys)

    # the port's batch: the sources one after another, each with invalid
    # rows interleaved, TEXT as codes of one dictionary
    dict_vals = list(rng.permutation(words))
    code_of = {v: i for i, v in enumerate(dict_vals)}
    cols = {"k": [], "s": [], "f": [], "k_null": [], "s_null": []}
    valid = []
    for p in parts:
        live = np.ones(p.nrows, bool)
        junk = rng.random(p.nrows) < 0.3
        order = np.argsort(np.concatenate([np.arange(p.nrows),
                                           np.nonzero(junk)[0] + 0.5]),
                           kind="stable")
        v = np.concatenate([live, np.zeros(junk.sum(), bool)])[order]
        sel = np.concatenate([np.arange(p.nrows),
                              np.nonzero(junk)[0]])[order]
        cols["k"].append(p.cols["k"][sel])
        cols["s"].append(np.asarray([code_of[x] for x in p.cols["s"]],
                                    np.int32)[sel] if p.nrows
                         else np.zeros(0, np.int32))
        cols["f"].append(p.cols["f"][sel])
        cols["k_null"].append(p.nulls["k"][sel])
        cols["s_null"].append(p.nulls["s"][sel])
        valid.append(v)
    smap = _t(np.asarray(rcl.catalog.shard_map, np.int32))
    names = ["k", "s", "f", "k_null", "s_null"]
    srcs = [{n: _t(cols[n][i]) for n in names} for i in range(ndn)]
    tvalid = [_t(v) for v in valid]
    # the host tier canonicalizes NULL TEXT keys to 0 too: pass both
    # masks; one K11 launch a source, every source read in place by K12
    dest = [TK.route_dest([c["k"], c["s"]], [c["k_null"], c["s_null"]],
                          [None, _lut(dict_vals)], v, smap, ndn, NUM_SHARDS)
            for c, v in zip(srcs, tvalid)]
    outs, ovalid, counts, region = TK.exchange(
        [tuple(c[n] for n in names) for c in srcs], dest, tvalid, ndn)
    assert counts.shape == (ndn, ndn)
    for d in range(ndn):
        r = routed[d]
        assert int(counts[:, d].sum()) == r.nrows
        sl = slice(d * region, d * region + r.nrows)
        assert bool(ovalid[sl].all())
        assert not bool(ovalid[d * region + r.nrows:(d + 1) * region].any())
        got = {n: outs[i][sl].numpy() for i, n in enumerate(names)}
        np.testing.assert_array_equal(got["k"], r.cols["k"])
        np.testing.assert_array_equal(got["f"], r.cols["f"])
        np.testing.assert_array_equal(
            np.asarray(dict_vals, dtype=object)[got["s"]], r.cols["s"])
        for nm in ("k", "s"):
            want_m = r.nulls.get(nm, np.zeros(r.nrows, bool))
            np.testing.assert_array_equal(got[nm + "_null"], want_m)
    if ndn == 4:
        assert int(counts[:, 3].sum()) == 0


def test_exchange_broadcast_form_and_empty_sources():
    """dest=None sends every live row to destination 0 in source order;
    sources with no rows at all are allowed, and a source without a
    column (None: a null mask it never set) gives zeros there."""
    rng = np.random.default_rng(5)
    rows = [0, 37, 0, 81]
    n = sum(rows)
    x = rng.integers(-9, 9, n).astype(np.int64)
    b = (rng.random(n) < 0.5)
    valid = rng.random(n) < 0.7
    offs = np.cumsum([0] + rows)
    cut = [slice(offs[i], offs[i + 1]) for i in range(len(rows))]
    srcs = [(_t(x[c]), _t(b[c]) if i != 3 else None)
            for i, c in enumerate(cut)]
    outs, ov, counts, region = TK.exchange(
        srcs, None, [_t(valid[c]) for c in cut], 1)
    live = np.nonzero(valid)[0]
    assert counts.tolist() == [[0], [int(valid[:37].sum())], [0],
                               [int(valid[37:].sum())]]
    assert region >= len(live)
    np.testing.assert_array_equal(outs[0][:len(live)].numpy(), x[live])
    np.testing.assert_array_equal(outs[1][:len(live)].numpy(),
                                  np.where(live < 37, b[live], False))
    assert int(ov.sum()) == len(live) and bool(ov[:len(live)].all())


# ---------------------------------------------------------------------------
# K3 compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density,out_size", [(0.3, 1024), (0.3, 100),
                                              (0.0, 64), (1.0, 2000),
                                              (0.9, 5000)])
def test_compact_matches_reference(density, out_size):
    rng = np.random.default_rng(int(density * 10) + out_size)
    n = 2000
    mask = rng.random(n) < density
    cols = (rng.integers(I64.min, I64.max, n, dtype=np.int64),
            rng.integers(-100, 100, n).astype(np.int32),
            rng.normal(0, 1, n), rng.random(n) < 0.5,
            rng.integers(0, 60000, n).astype(np.uint16))
    rc, rcols = RK.compact(jnp.asarray(mask),
                           tuple(jnp.asarray(c) for c in cols), out_size)
    tc, tcols = TK.compact(_t(mask), tuple(_t(c) for c in cols), out_size)
    assert int(tc) == int(rc) == int(mask.sum())
    for g, w in zip(tcols, rcols):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# parallel/mesh.py against the reference on the 8-device CPU mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("the reference mesh needs 8 devices")
    return RM.make_mesh(8), TM.make_mesh(8, device="cpu")


def _per_device(cols, valid, ndev):
    """[(key, value) rows of each device's slice, in order]."""
    k, v, m = (np.asarray(cols["k"]), np.asarray(cols["v"]),
               np.asarray(valid))
    per = len(m) // ndev
    return [list(zip(k[d * per:(d + 1) * per][m[d * per:(d + 1) * per]]
                     .tolist(),
                     v[d * per:(d + 1) * per][m[d * per:(d + 1) * per]]
                     .tolist())) for d in range(ndev)]


def _settled_bucket(counts, start):
    """The bucket the reference's redistribute_auto doubling ends on,
    from the port's count matrix."""
    bucket = start
    while (counts > bucket).any():
        bucket *= 2
    return bucket


def test_mesh_redistribute_matches_reference(mesh8):
    rm, tm = mesh8
    rng = np.random.default_rng(0)
    n = 4000
    keys = rng.integers(0, 1 << 40, n).astype(np.int64)
    vals = rng.integers(0, 1000, n).astype(np.int64)
    rcols, rvalid = RM.shard_columns(rm, {"k": keys, "v": vals}, n)
    rout, romask, rbucket = RM.redistribute_auto(rm, rcols, rvalid, "k",
                                                 start_bucket=64)
    tcols, tvalid = TM.shard_columns(tm, {"k": keys, "v": vals}, n)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(rvalid))
    tout, tomask, counts = TM.redistribute(tm, tcols, tvalid, "k")
    assert counts.shape == (8, 8) and int(counts.sum()) == n
    assert _settled_bucket(counts, 64) == rbucket
    assert int(tomask.sum()) == n
    assert _per_device(tout, tomask, 8) == _per_device(rout, romask, 8)


def test_mesh_overflow_matches_reference(mesh8):
    rm, tm = mesh8
    n = 512
    keys = np.full(n, 7, dtype=np.int64)
    rcols, rvalid = RM.shard_columns(rm, {"k": keys}, n)
    _, _, rover = RM.redistribute(rm, rcols, rvalid, "k", 8)
    tcols, tvalid = TM.shard_columns(tm, {"k": keys}, n)
    _, tomask, counts = TM.redistribute(tm, tcols, tvalid, "k")
    assert int(np.maximum(counts - 8, 0).sum()) == rover > 0
    assert int(tomask.sum()) == n      # the port drops nothing
    _, _, rb = RM.redistribute_auto(rm, rcols, rvalid, "k", start_bucket=8)
    assert _settled_bucket(counts, 8) == rb >= 64


def test_mesh_psum_partial_matches_reference(mesh8):
    rm, tm = mesh8
    rng = np.random.default_rng(1)
    n = 10_000
    x = rng.integers(0, 100, n).astype(np.int64)
    f = rng.normal(0, 1, n)
    rcols, rvalid = RM.shard_columns(rm, {"x": x, "f": f}, n)
    tcols, tvalid = TM.shard_columns(tm, {"x": x, "f": f}, n)

    def rfn(valid_l, c):
        return (jnp.sum(jnp.where(valid_l, c["x"], 0)),
                jnp.sum(valid_l.astype(jnp.int64)),
                jnp.sum(jnp.where(valid_l, c["f"], 0.0)))

    def tfn(valid_l, c):
        return (torch.where(valid_l, c["x"], 0).sum(),
                valid_l.to(torch.int64).sum(),
                torch.where(valid_l, c["f"], 0.0).sum())

    rs = RM.psum_partial(rm, rfn, rcols, rvalid, n_out=3)
    ts = TM.psum_partial(tm, tfn, tcols, tvalid, n_out=3)
    assert int(ts[0]) == int(rs[0]) == int(x.sum())
    assert int(ts[1]) == int(rs[1]) == n
    assert float(ts[2]) == pytest.approx(float(rs[2]), rel=1e-10)


# ---------------------------------------------------------------------------
# no fallback for CUDA tensors
# ---------------------------------------------------------------------------

def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """Each cluster-tier wrapper given a CUDA tensor launches its kernel
    or raises (checked without a card by faking the device test)."""
    calls = []

    def no_library():
        calls.append(1)
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(TK, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(TK, "_lib", no_library)
    x = torch.zeros(8, dtype=torch.int64)
    v = torch.ones(8, dtype=torch.bool)
    smap = torch.zeros(NUM_SHARDS, dtype=torch.int32)
    for call in (lambda: TK.bucket_ids((x,), 7),
                 lambda: TK.route_dest([x], None, None, v, smap, 2),
                 lambda: TK.exchange([(x,)], None, [v], 1),
                 lambda: TK.compact(v, (x,), 8)):
        with pytest.raises(RuntimeError, match="no kernel library"):
            call()
    assert len(calls) == 4
