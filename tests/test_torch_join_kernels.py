"""Kernel parity for the join and sort-based GROUP BY kernels (K5-K9) and
the row hash (K11): opentenbase_tpu_torch.ops.kernels against the
reference opentenbase_tpu.ops.kernels / utils.hashing on the same numpy
inputs.

On the CPU each port wrapper runs its plain PyTorch version; the CUDA
kernels are held against those on the card by chip_smoke.py.  Keys,
counts, indices and integer outputs must be equal exactly; f64 sums
("sumf") within relative 1e-10, the only difference being the order of
the summation.  Each reference kernel with two runtime branches is run
on inputs that take each branch, and the tests check which branch the
reference took.
"""

import numpy as np
import pytest
import torch

import opentenbase_tpu  # noqa: F401  (x64 on, as the reference runs)
import jax.numpy as jnp
from opentenbase_tpu.ops import kernels as RK
from opentenbase_tpu.utils import hashing as RH
from opentenbase_tpu_torch.ops import kernels as TK
from opentenbase_tpu_torch.utils import hashing as TH

SUMF_RTOL = 1e-10
I64 = np.iinfo(np.int64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pack_fits(keys, valid, n):
    """The reference's 62-bit single-word pack test (float32)."""
    if not valid.any():
        return False
    span = int(keys[valid].max()) - int(keys[valid].min())
    bits = np.log2(np.float32(span) + np.float32(2)) + \
        np.log2(np.float32(n + 2))
    return bool(bits < np.float32(62.0))


# ---------------------------------------------------------------------------
# K11 hash_columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_hash_columns_matches_reference(ncols):
    rng = np.random.default_rng(20 + ncols)
    n = 3000
    cols = [rng.integers(I64.min, I64.max, n, dtype=np.int64,
                         endpoint=True),
            rng.integers(-50, 50, n).astype(np.int64),
            rng.integers(-2**31, 2**31, n).astype(np.int64)][:ncols]
    cols[0][:6] = [0, -1, I64.min, I64.max, 1, -(1 << 40)]
    want_np = RH.hash_columns_np(cols).view(np.int64)
    want_jax = np.asarray(RH.hash_columns_jax(
        [jnp.asarray(c) for c in cols])).view(np.int64)
    got = _np(TK.hash_columns([_t(c) for c in cols]))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)
    np.testing.assert_array_equal(
        _np(TH.hash_columns_plain([_t(c) for c in cols])), want_np)


def test_hash_columns_widens_int32():
    rng = np.random.default_rng(27)
    a = rng.integers(-2**31, 2**31, 500).astype(np.int32)
    b = rng.integers(0, 25, 500).astype(np.int32)
    want = np.asarray(RH.hash_columns_jax(
        [jnp.asarray(a.astype(np.int64)), jnp.asarray(b.astype(np.int64))]))
    got = _np(TK.hash_columns([_t(a), _t(b)]))
    np.testing.assert_array_equal(got, want.view(np.int64))


# ---------------------------------------------------------------------------
# K6 join_build
# ---------------------------------------------------------------------------

def _build_case(kind, rng, n=600):
    valid = rng.random(n) < 0.8
    if kind == "dense":            # reference: the single-word pack
        keys = rng.integers(1000, 1000 + n // 3, n).astype(np.int64)
    elif kind == "full_range":     # reference: argsort (exact)
        keys = rng.integers(I64.min, I64.max - 1, n, dtype=np.int64)
        keys[::7] = keys[3]        # duplicates
    elif kind == "nulls":          # NULL keys arrive as INT64_MAX
        keys = rng.integers(-20, 20, n).astype(np.int64)
        keys[rng.random(n) < 0.2] = I64.max
    elif kind == "all_invalid":
        keys = rng.integers(0, 9, n).astype(np.int64)
        valid = np.zeros(n, bool)
    else:
        raise ValueError(kind)
    return keys, valid


@pytest.mark.parametrize("kind,fast", [("dense", True),
                                       ("full_range", False),
                                       ("nulls", False),
                                       ("all_invalid", False)])
def test_join_build_matches_reference(kind, fast):
    rng = np.random.default_rng(30)
    keys, valid = _build_case(kind, rng)
    assert _pack_fits(keys, valid, len(keys)) == fast
    wk, wp = RK.join_build(jnp.asarray(keys), jnp.asarray(valid))
    gk, gp = TK.join_build(_t(keys), _t(valid))
    np.testing.assert_array_equal(_np(gk), np.asarray(wk))
    np.testing.assert_array_equal(_np(gp), np.asarray(wp))


def test_join_build_null_tail_is_never_read():
    """All valid keys NULL (INT64_MAX): the reference's pack branch puts
    the valid rows before the invalid ones, its argsort branch keeps row
    order; the port keeps row order.  Only the order of INT64_MAX keys
    differs, and a probe never matches INT64_MAX, so no join reads it."""
    rng = np.random.default_rng(31)
    n = 300
    keys = np.full(n, I64.max, np.int64)
    valid = rng.random(n) < 0.5
    wk, wp = RK.join_build(jnp.asarray(keys), jnp.asarray(valid))
    gk, gp = TK.join_build(_t(keys), _t(valid))
    np.testing.assert_array_equal(_np(gk), np.asarray(wk))
    assert sorted(_np(gp).tolist()) == list(range(n))
    probe = np.asarray([I64.max, 0, I64.max - 1], np.int64)
    pv = np.ones(3, bool)
    _lo, cnt = TK.join_probe_counts(gk, _t(probe), _t(pv))
    assert _np(cnt).tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# K7 join_probe_counts
# ---------------------------------------------------------------------------

def _direct_ok(sk, np_):
    live = sk[sk != I64.max]
    return len(live) > 0 and int(live[-1]) - int(sk[0]) < max(2 * len(sk),
                                                               np_)


def _compare_probe(got, want):
    (glo, gcnt), (wlo, wcnt) = got, want
    gcnt, wcnt = _np(gcnt), np.asarray(wcnt)
    np.testing.assert_array_equal(gcnt, wcnt)
    # lo is read only where count > 0: for rows without a match the
    # reference's two branches themselves differ (0 vs the insertion
    # point)
    hit = wcnt > 0
    np.testing.assert_array_equal(_np(glo)[hit], np.asarray(wlo)[hit])
    return int(hit.sum())


@pytest.mark.parametrize("kind,direct", [("dense", True),
                                         ("sparse", False),
                                         ("nulls", True),
                                         ("wrap", True)])
def test_join_probe_counts_matches_reference(kind, direct):
    rng = np.random.default_rng(40)
    nb, np_ = 400, 1500
    bvalid = rng.random(nb) < 0.85
    if kind == "dense":
        bkeys = rng.integers(-100, 300, nb).astype(np.int64)
        pkeys = rng.integers(-150, 350, np_).astype(np.int64)
    elif kind == "sparse":
        bkeys = rng.integers(-10**15, 10**15, nb).astype(np.int64)
        pkeys = rng.choice(bkeys, np_)
        pkeys[::5] = rng.integers(-10**15, 10**15, len(pkeys[::5]))
        bkeys[::13] = I64.max            # NULL keys on both sides
        pkeys[::17] = I64.max
    elif kind == "nulls":
        bkeys = rng.integers(0, 60, nb).astype(np.int64)
        bkeys[::9] = I64.max
        pkeys = rng.integers(-5, 65, np_).astype(np.int64)
        pkeys[::11] = I64.max
    else:   # keys at the top of int64: probe offsets wrap
        bkeys = (I64.max - 1 - rng.integers(0, 50, nb)).astype(np.int64)
        pkeys = np.concatenate([rng.choice(bkeys, np_ - 4),
                                [I64.min, I64.min + 3, -1, I64.max]])
        pkeys = pkeys.astype(np.int64)
    pvalid = rng.random(np_) < 0.9
    sk, perm = TK.join_build(_t(bkeys), _t(bvalid))
    assert _direct_ok(_np(sk), np_) == direct
    want = RK.join_probe_counts(jnp.asarray(_np(sk)), jnp.asarray(pkeys),
                                jnp.asarray(pvalid))
    got = TK.join_probe_counts(sk, _t(pkeys), _t(pvalid))
    assert _compare_probe(got, want) > 0 or kind == "wrap"
    # invalid probe rows and INT64_MAX keys never match
    cnt = _np(got[1])
    assert (cnt[~pvalid] == 0).all() and (cnt[pkeys == I64.max] == 0).all()


def test_join_probe_counts_empty_and_invalid_builds():
    rng = np.random.default_rng(41)
    pkeys = rng.integers(0, 10, 64).astype(np.int64)
    pvalid = np.ones(64, bool)
    empty = np.zeros(0, np.int64)
    want = RK.join_probe_counts(jnp.asarray(empty), jnp.asarray(pkeys),
                                jnp.asarray(pvalid))
    got = TK.join_probe_counts(_t(empty), _t(pkeys), _t(pvalid))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    sk, _p = TK.join_build(_t(pkeys), _t(np.zeros(64, bool)))
    want = RK.join_probe_counts(jnp.asarray(_np(sk)), jnp.asarray(pkeys),
                                jnp.asarray(pvalid))
    got = TK.join_probe_counts(sk, _t(pkeys), _t(pvalid))
    _compare_probe(got, want)
    assert (_np(got[1]) == 0).all()


# ---------------------------------------------------------------------------
# K8 join_expand
# ---------------------------------------------------------------------------

def _probe_case(rng, nb=300, np_=700):
    bkeys = rng.integers(0, 120, nb).astype(np.int64)     # duplicates
    bvalid = rng.random(nb) < 0.9
    pkeys = rng.integers(-10, 130, np_).astype(np.int64)
    pvalid = rng.random(np_) < 0.85
    sk, perm = TK.join_build(_t(bkeys), _t(bvalid))
    lo, cnt = TK.join_probe_counts(sk, _t(pkeys), _t(pvalid))
    return sk, perm, lo, cnt, pvalid


@pytest.mark.parametrize("left_outer,with_valid", [(False, False),
                                                   (True, True),
                                                   (True, False)])
def test_join_expand_matches_reference(left_outer, with_valid):
    rng = np.random.default_rng(50)
    _sk, perm, lo, cnt, pvalid = _probe_case(rng)
    pv = pvalid if with_valid else None
    eff = np.maximum(_np(cnt), 1) if left_outer else _np(cnt)
    if left_outer and with_valid:
        eff = np.where(pvalid, eff, 0)
    out_size = 1 << int(eff.sum()).bit_length()      # room to spare
    want = RK.join_expand(jnp.asarray(_np(lo)), jnp.asarray(_np(cnt)),
                          jnp.asarray(_np(perm)), out_size, left_outer,
                          None if pv is None else jnp.asarray(pv))
    got = TK.join_expand(lo, cnt, perm, out_size, left_outer,
                         None if pv is None else _t(pv))
    total = int(want[2])
    assert int(got[2]) == total == int(eff.sum()) > 0
    # the valid prefix is exact; past it both write filler that nothing
    # reads (the port (0, 0), the reference clipped leftovers)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g)[:total], np.asarray(w)[:total])
        assert (_np(g)[total:] == 0).all()
    if left_outer:
        assert (_np(got[1])[:total] == -1).sum() == \
            int(((_np(cnt) == 0) & (eff > 0)).sum())


def test_join_expand_exact_fit_and_empty():
    rng = np.random.default_rng(51)
    _sk, perm, lo, cnt, _pv = _probe_case(rng)
    total = int(_np(cnt).sum())
    want = RK.join_expand(jnp.asarray(_np(lo)), jnp.asarray(_np(cnt)),
                          jnp.asarray(_np(perm)), total)
    got = TK.join_expand(lo, cnt, perm, total)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    zero = np.zeros(len(_np(cnt)), np.int64)
    got = TK.join_expand(lo, _t(zero), perm, 4)
    assert int(got[2]) == 0 and (_np(got[0]) == 0).all()


# ---------------------------------------------------------------------------
# K9 compose_index, semi_mask, anti_mask
# ---------------------------------------------------------------------------

def test_compose_index_and_masks_match_reference():
    rng = np.random.default_rng(60)
    prior = rng.integers(0, 10**9, 900).astype(np.int64)
    take = rng.integers(0, 900, 2500).astype(np.int64)
    np.testing.assert_array_equal(
        _np(TK.compose_index(_t(prior), _t(take))),
        np.asarray(RK.compose_index(jnp.asarray(prior), jnp.asarray(take))))
    counts = rng.integers(0, 3, 700).astype(np.int64)
    pvalid = rng.random(700) < 0.7
    np.testing.assert_array_equal(
        _np(TK.semi_mask(_t(counts))),
        np.asarray(RK.semi_mask(jnp.asarray(counts))))
    np.testing.assert_array_equal(
        _np(TK.anti_mask(_t(counts), _t(pvalid))),
        np.asarray(RK.anti_mask(jnp.asarray(counts), jnp.asarray(pvalid))))


# ---------------------------------------------------------------------------
# K5 grouped_agg_sort
# ---------------------------------------------------------------------------

AGG_KINDS = ("sum", "sum", "sumf", "count", "min", "max", "min", "max",
             "sum")


def _agg_inputs(rng, n):
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    i64 = rng.integers(-10**12, 10**12, n).astype(np.int64)
    f64 = rng.normal(0, 1e3, n)
    return (i32, i64, f64, i64, i32, i64, f64, f64, f64)


def _group_case(kind, rng, n=700):
    valid = rng.random(n) < 0.85
    if kind == "dense3":           # pack fits: the single-word branch
        keys = (rng.integers(0, 40, n).astype(np.int64),
                rng.integers(8000, 8030, n).astype(np.int32),
                rng.integers(0, 2, n).astype(np.int64))
    elif kind == "full_range2":    # two full-range keys: packed wraps
        a = rng.integers(I64.min, I64.max, 40, dtype=np.int64)
        keys = (rng.choice(a, n), rng.choice(a[:5], n))
    elif kind == "hashed1":        # one hashed key: exact, no packed word
        keys = (RH.hash_columns_np([rng.integers(0, 50, n)])
                .view(np.int64),)
    elif kind == "float_nulls":    # floats with NaN / +-0.0 + null flag
        f = rng.choice([-1.5, -0.0, 0.0, 2.0, np.nan, -np.nan, np.inf], n)
        nm = rng.random(n) < 0.2
        k2 = np.where(nm, 0, rng.integers(0, 4, n)).astype(np.int64)
        keys = (f, k2, nm.astype(np.int64))
    elif kind == "all_invalid":
        keys = (rng.integers(0, 4, n).astype(np.int64),)
        valid = np.zeros(n, bool)
    else:
        raise ValueError(kind)
    return keys, valid


def _ref_fast(keys, valid, n):
    """Whether the reference takes its pack branch (ops/kernels.py:217)."""
    bits = np.float32(0)
    for k in keys:
        if k.dtype.kind == "f":
            k = np.where(k == 0, 0.0, k).view(np.int64)
        k = k.astype(np.int64)
        span = int(k[valid].max()) - int(k[valid].min()) if valid.any() \
            else 0
        bits = np.float32(bits + np.log2(np.float32(span) + np.float32(2)))
    return bool(np.float32(bits + np.log2(np.float32(n + 2)))
                < np.float32(62.0))


@pytest.mark.parametrize("kind,fast", [("dense3", True),
                                       ("full_range2", False),
                                       ("hashed1", False),
                                       ("float_nulls", False),
                                       ("all_invalid", True)])
def test_grouped_agg_sort_matches_reference(kind, fast):
    rng = np.random.default_rng(70)
    n, max_groups = 700, 1024
    keys, valid = _group_case(kind, rng, n)
    assert _ref_fast(keys, valid, n) == fast
    ins = _agg_inputs(rng, n)
    wk, wo, wn = RK.grouped_agg_sort(
        tuple(jnp.asarray(k) for k in keys), jnp.asarray(valid),
        tuple(jnp.asarray(a) for a in ins), max_groups, AGG_KINDS)
    gk, go, gn = TK.grouped_agg_sort(
        tuple(_t(k) for k in keys), _t(valid), tuple(_t(a) for a in ins),
        max_groups, AGG_KINDS)
    assert int(gn) == int(wn)
    if kind != "all_invalid":
        assert int(gn) > 1
    for g, w in zip(gk, wk):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype
        # group order and keys exact (NaN == NaN, -0.0 == 0.0 here)
        np.testing.assert_array_equal(g, w)
    for kd, g, w in zip(AGG_KINDS, go, wo):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype, (kd, g.dtype, w.dtype)
        if g.dtype.kind == "f" and kd in ("sum", "sumf"):
            np.testing.assert_allclose(g, w, rtol=SUMF_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def test_grouped_agg_sort_float_key_groups():
    """-0.0 and 0.0 group together; NaNs group by bit pattern, as the
    reference's equality image does (no NaN canonicalisation)."""
    k = np.asarray([0.0, -0.0, np.nan, np.nan, 1.0, -np.nan], np.float64)
    v = np.ones(6, bool)
    one = np.ones(6, np.int64)
    gk, (c,), gn = TK.grouped_agg_sort((_t(k),), _t(v), (_t(one),), 8,
                                       ("sum",))
    wk, (wc,), wn = RK.grouped_agg_sort((jnp.asarray(k),), jnp.asarray(v),
                                        (jnp.asarray(one),), 8, ("sum",))
    assert int(gn) == int(wn) == 4
    np.testing.assert_array_equal(_np(c), np.asarray(wc))


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """Each new wrapper given CUDA tensors launches its kernel or raises;
    none falls back to its plain version (checked without a card by
    faking the device test)."""
    calls = []

    def no_library():
        calls.append(1)
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(TK, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(TK, "_lib", no_library)
    k = torch.arange(8, dtype=torch.int64)
    v = torch.ones(8, dtype=torch.bool)
    launches = [
        lambda: TK.hash_columns([k, k]),
        lambda: TK.join_build(k, v),
        lambda: TK.join_probe_counts(k, k, v),
        lambda: TK.join_expand(k, k, k, 16),
        lambda: TK.compose_index(k, k),
        lambda: TK.semi_mask(k),
        lambda: TK.anti_mask(k, v),
        lambda: TK.grouped_agg_sort((k,), v, (k,), 8, ("sum",)),
    ]
    for fn in launches:
        with pytest.raises(RuntimeError, match="no kernel library"):
            fn()
    assert len(calls) == len(launches)
