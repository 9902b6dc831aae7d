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

import ctypes

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
    the valid rows before the invalid ones; the port takes the same
    branch (its gate is the reference's) and gives the same order.  A
    probe never matches INT64_MAX, so no join reads that tail."""
    rng = np.random.default_rng(31)
    n = 300
    keys = np.full(n, I64.max, np.int64)
    valid = rng.random(n) < 0.5
    wk, wp = RK.join_build(jnp.asarray(keys), jnp.asarray(valid))
    gk, gp = TK.join_build(_t(keys), _t(valid))
    np.testing.assert_array_equal(_np(gk), np.asarray(wk))
    np.testing.assert_array_equal(_np(gp), np.asarray(wp))
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


@pytest.mark.parametrize("span_short", [1, 0])
def test_join_probe_counts_at_the_direct_search_boundary(span_short):
    """Live keys spanning T - 1 take the direct table, spanning T the
    binary search (T = max(2 nb, np), NULL keys after them)."""
    rng = np.random.default_rng(44 + span_short)
    nb, np_, tail = 500, 1500, 40
    T = max(2 * nb, np_)
    span = T - span_short
    live = np.sort(rng.integers(-77, -77 + span + 1, nb - tail))
    live[0], live[-1] = -77, -77 + span
    sk = np.concatenate([live, np.full(tail, I64.max)]).astype(np.int64)
    pkeys = np.concatenate([rng.choice(live, np_ // 2), rng.integers(
        -100, span, np_ - np_ // 2)]).astype(np.int64)
    pkeys[:4] = (I64.min, I64.max, -77, -77 + span)
    pvalid = rng.random(np_) < 0.9
    assert _direct_ok(sk, np_) == bool(span_short)
    want = RK.join_probe_counts(jnp.asarray(sk), jnp.asarray(pkeys),
                                jnp.asarray(pvalid))
    got = TK.join_probe_counts(_t(sk), _t(pkeys), _t(pvalid))
    assert _compare_probe(got, want) > 0


@pytest.mark.parametrize("scale", [1, 10**12])
def test_join_probe_counts_long_run_of_one_key(scale):
    """One key over many blocks of rows and runs of hundreds of rows, on
    the direct table (scale 1) and the binary search (keys 1e12 apart)."""
    rng = np.random.default_rng(46)
    runs = np.repeat(np.cumsum(rng.integers(1, 4, 40)),
                     rng.integers(100, 400, 40))
    keys = np.sort(np.concatenate([np.full(3000, 17), runs]))
    sk = (keys * scale - 5).astype(np.int64)
    pkeys = (rng.choice(np.concatenate([keys, [17] * 500, [-3, 999]]), 4000)
             * scale - 5).astype(np.int64)
    pvalid = rng.random(4000) < 0.95
    assert _direct_ok(sk, 4000) == (scale == 1)
    want = RK.join_probe_counts(jnp.asarray(sk), jnp.asarray(pkeys),
                                jnp.asarray(pvalid))
    got = TK.join_probe_counts(_t(sk), _t(pkeys), _t(pvalid))
    _compare_probe(got, want)
    assert int(_np(got[1]).max()) == 3000 + int((runs == 17).sum())


class _FakeProbeLib:
    """otbt_probe_table_bytes and otbt_join_probe_counts without a card:
    the counts by join_probe_counts_plain on the tensors behind the
    pointers, written through the output pointer (lo, then count);
    records the arguments of each call."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.sizes = {}
        self.calls = []

    def otbt_probe_table_bytes(self, T, wide):
        self.sizes[wide] = 8208 + T * (8 if wide else 4)
        return self.sizes[wide]

    def otbt_join_probe_counts(self, sk, nb, probe, pv, np_, T, table,
                               table_bytes, wide, out, stream):
        lo, cnt = TK.join_probe_counts_plain(
            self.by_ptr[sk], self.by_ptr[probe], self.by_ptr[pv])
        for j, x in enumerate((lo, cnt)):
            ctypes.memmove(out + 8 * np_ * j, x.data_ptr(), 8 * np_)
        self.calls.append((nb, np_, T, table_bytes, wide))
        return 0


@pytest.mark.parametrize("route,np_,wide", [("rows", 701, False),
                                            ("rows", 701, True),
                                            ("forced", 200, False),
                                            ("forced", 200, True)])
def test_join_probe_counts_hands_one_table_and_one_output(monkeypatch, route,
                                                          np_, wide):
    """On the card the K7 wrapper makes one scratch allocation of the size
    the library names (int64 slots from PROBE_WIDE_ROWS build rows, or
    when probe_counts_cuda is asked for them), passes that choice and
    T = max(2 nb, np), and returns lo and count as the two rows of one
    (2, np) output, counted as one launch; the outputs equal the plain
    version (the library faked with it: no card here)."""
    rng = np.random.default_rng(48)
    sk = _t(np.sort(rng.integers(0, 90, 300)).astype(np.int64))
    pk = _t(rng.integers(-5, 95, np_).astype(np.int64))
    pv = _t(rng.random(np_) < 0.9)
    lib = _FakeProbeLib((sk, pk, pv))
    monkeypatch.setattr(TK, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(TK, "_lib", lambda: lib)
    monkeypatch.setattr(TK, "_stream", lambda: 0)
    TK.reset_launches()
    if route == "rows":
        if wide:
            monkeypatch.setattr(TK, "PROBE_WIDE_ROWS", 300)
        lo, cnt = TK.join_probe_counts(sk, pk, pv)
    else:
        lo, cnt = TK.probe_counts_cuda(sk, pk, pv, wide)
    T = max(600, np_)
    assert lib.calls == [(300, np_, T, lib.sizes[int(wide)], int(wide))]
    assert lib.sizes[int(wide)] == 8208 + T * (8 if wide else 4)
    assert TK.LAUNCHES["join_probe_counts"] == 1
    assert lo.untyped_storage().data_ptr() == cnt.untyped_storage(
    ).data_ptr() and cnt.data_ptr() == lo.data_ptr() + 8 * np_
    _compare_probe((lo, cnt), TK.join_probe_counts_plain(sk, pk, pv))


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


def test_join_expand_one_probe_row_with_5000_matches():
    """A skewed join: one probe row matches 5000 build rows (the card
    spreads its pairs over a whole block), among rows with a few."""
    rng = np.random.default_rng(52)
    bkeys = np.concatenate([np.full(5000, 7), rng.integers(8, 60, 900)])
    bvalid = np.concatenate([np.ones(5000, bool), rng.random(900) < 0.9])
    pkeys = rng.integers(8, 70, 1500)
    pkeys[[3, 700, 1499]] = 7
    sk, perm = TK.join_build(_t(bkeys.astype(np.int64)), _t(bvalid))
    lo, cnt = TK.join_probe_counts(sk, _t(pkeys.astype(np.int64)),
                                   _t(np.ones(1500, bool)))
    assert int(_np(cnt).max()) == 5000
    total = int(_np(cnt).sum())
    for out_size in (total, total + 37):
        want = RK.join_expand(jnp.asarray(_np(lo)), jnp.asarray(_np(cnt)),
                              jnp.asarray(_np(perm)), out_size)
        got = TK.join_expand(lo, cnt, perm, out_size)
        assert int(got[2]) == int(want[2]) == total
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(_np(g)[:total],
                                          np.asarray(w)[:total])
            assert (_np(g)[total:] == 0).all()


def test_join_expand_left_outer_with_padding_rows_and_an_exact_fit():
    """Left outer: padding rows (probe_valid False) emit nothing, valid
    rows without a match one (p, -1) pair; out_size exactly the total, so
    no slot is filler and the whole outputs equal the reference's."""
    rng = np.random.default_rng(53)
    _sk, perm, lo, cnt, pvalid = _probe_case(rng, nb=400, np_=900)
    pvalid[-200:] = False                       # a padded tail
    eff = np.where(pvalid, np.maximum(_np(cnt), 1), 0)
    total = int(eff.sum())
    want = RK.join_expand(jnp.asarray(_np(lo)), jnp.asarray(_np(cnt)),
                          jnp.asarray(_np(perm)), total, True,
                          jnp.asarray(pvalid))
    got = TK.join_expand(lo, cnt, perm, total, True, _t(pvalid))
    assert int(got[2]) == int(want[2]) == total
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert (_np(got[1]) == -1).sum() == int(((_np(cnt) == 0) & pvalid).sum())
    assert not np.isin(np.arange(700, 900), _np(got[0])).any()


class _FakeExpandLib:
    """otbt_join_expand_scratch_bytes and otbt_join_expand without a card:
    the plain version's pairs (computed before the call) written through
    the output pointers; records each call."""

    def __init__(self, want):
        self.want = want
        self.calls = []

    def otbt_join_expand_scratch_bytes(self, np_):
        return 4 * np_ + 100

    def otbt_join_expand(self, lo, counts, perm, pv, np_, nb, left_outer,
                         probe_idx, build_idx, out_size, total, scratch,
                         scratch_bytes, stream):
        pi, bi, tot = self.want
        ctypes.memmove(probe_idx, pi.data_ptr(), 8 * out_size)
        ctypes.memmove(build_idx, bi.data_ptr(), 8 * out_size)
        ctypes.memmove(total, tot.reshape(1).data_ptr(), 8)
        self.calls.append((np_, nb, left_outer, pv is not None, probe_idx,
                           build_idx, out_size, total, scratch,
                           scratch_bytes))
        return 0


@pytest.mark.parametrize("left_outer", [False, True])
def test_join_expand_makes_one_allocation_and_no_zero_fill(monkeypatch,
                                                           left_outer):
    """On the card the K8 wrapper makes one allocation (both outputs, the
    total and the library's scratch, in that order), fills nothing with
    zeros (the kernel writes every slot), makes one library call and
    counts one launch; the outputs equal the plain version (the library
    faked with it: no card here)."""
    rng = np.random.default_rng(54)
    _sk, perm, lo, cnt, pvalid = _probe_case(rng)
    pv = _t(pvalid)
    out_size = 1 << 11
    want = TK.join_expand_plain(lo, cnt, perm, out_size, left_outer, pv)
    lib = _FakeExpandLib(want)
    allocs = []
    real_empty = torch.empty

    def empty(*a, **kw):
        allocs.append((a, kw))
        return real_empty(*a, **kw)

    def no_fill(*a, **kw):
        raise AssertionError("a zero-fill on the K8 path")
    monkeypatch.setattr(TK, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(TK, "_lib", lambda: lib)
    monkeypatch.setattr(TK, "_stream", lambda: 0)
    monkeypatch.setattr(torch, "empty", empty)
    for name in ("zeros", "zeros_like", "full", "full_like"):
        monkeypatch.setattr(torch, name, no_fill)
    for name in ("zero_", "fill_"):
        monkeypatch.setattr(torch.Tensor, name, no_fill)
    TK.reset_launches()
    got = TK.join_expand(lo, cnt, perm, out_size, left_outer, pv)
    monkeypatch.undo()
    assert len(allocs) == 1 and len(lib.calls) == 1
    assert TK.LAUNCHES["join_expand"] == 1
    (np_, nb, lo_flag, with_pv, pi, bi, size, tot, scratch, sbytes), = \
        lib.calls
    assert (np_, nb, lo_flag, with_pv, size) == (700, 300, int(left_outer),
                                                 True, out_size)
    base = got[0].data_ptr()
    assert (pi, bi, tot, scratch) == (base, base + 8 * out_size,
                                      base + 16 * out_size,
                                      base + 8 * (2 * out_size + 1))
    assert got[0].untyped_storage().nbytes() >= 8 * (2 * out_size + 1) \
        + sbytes
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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


@pytest.mark.parametrize("n_take", [0, 1, 2, 1001])
@pytest.mark.parametrize("k", [1, 2, 17, 49])
def test_compose_indices_match_reference_prior_by_prior(k, n_take):
    """K9 for one join side: k priors of different lengths and two null
    masks (49 with 49 priors: past one launch's 48) gathered at one take,
    with indices past either end (a JAX gather counts a negative index
    from the end, then clamps), against the reference's compose_index
    applied prior by prior (and the same gather of each mask)."""
    rng = np.random.default_rng(62 + k * 7 + n_take)
    lens = rng.integers(1, 400, k)
    priors = [rng.integers(0, 10**9, m).astype(np.int64) for m in lens]
    masks = [rng.random(m) < 0.4
             for m in ((lens[0], 3) if k < 49 else lens)]
    take = rng.integers(-450, 450, n_take).astype(np.int64)
    outs, mouts = TK.compose_indices(tuple(_t(p) for p in priors), _t(take),
                                     tuple(_t(m) for m in masks))
    assert len(outs) == k and len(mouts) == len(masks)
    for got, prior in zip(outs, priors):
        assert got.dtype == torch.int64 and got.shape == (n_take,)
        np.testing.assert_array_equal(_np(got), np.asarray(
            RK.compose_index(jnp.asarray(prior), jnp.asarray(take))))
    for got, m in zip(mouts, masks):
        assert got.dtype == torch.bool and got.shape == (n_take,)
        np.testing.assert_array_equal(
            _np(got), np.asarray(jnp.asarray(m)[jnp.asarray(take)]))
    # the reference's one-prior signature is the same gather
    np.testing.assert_array_equal(
        _np(TK.compose_index(_t(priors[0]), _t(take))), _np(outs[0]))


class _FakeComposeLib:
    """otbt_compose_indices without a card: each launch's gathers done
    by compose_indices_plain on the tensors behind its pointers, written
    through the output pointers; records (priors, masks) a launch."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.launches = []

    def otbt_compose_indices(self, priors, n_priors, outs, k, masks,
                             n_masks, mask_outs, m, take, n, stream):
        ps = tuple(self.by_ptr[priors[j]] for j in range(k))
        ms = tuple(self.by_ptr[masks[j]] for j in range(m))
        assert [p.shape[0] for p in ps] == list(n_priors[:k])
        assert [x.shape[0] for x in ms] == list(n_masks[:m])
        got, mgot = TK.compose_indices_plain(ps, self.by_ptr[take], ms)
        for dst, src in zip(list(outs[:k]) + list(mask_outs[:m]),
                            got + mgot):
            ctypes.memmove(dst, src.data_ptr(), src.numel() *
                           src.element_size())
        self.launches.append((k, m))
        return 0


@pytest.mark.parametrize("k,m,sets", [(5, 2, [(5, 2)]),
                                      (48, 0, [(48, 0)]),
                                      (49, 49, [(48, 48), (1, 1)]),
                                      (97, 3, [(48, 3), (48, 0), (1, 0)])])
def test_compose_indices_launches_a_set_of_48_at_a_time(monkeypatch, k, m,
                                                        sets):
    """On the card compose_indices makes one launch for up to 48 priors
    and 48 masks and one a set of 48 beyond (csrc/join.cu kMaxCompose),
    each counted; the outputs equal the plain version (the library faked
    with it: no card here)."""
    rng = np.random.default_rng(k * 100 + m)
    priors = tuple(_t(rng.integers(0, 10**9, int(rng.integers(1, 300))))
                   for _ in range(k))
    masks = tuple(_t(rng.random(int(rng.integers(1, 300))) < 0.5)
                  for _ in range(m))
    take = _t(rng.integers(-320, 320, 501))
    lib = _FakeComposeLib(priors + masks + (take,))
    monkeypatch.setattr(TK, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(TK, "_lib", lambda: lib)
    monkeypatch.setattr(TK, "_stream", lambda: 0)
    TK.reset_launches()
    outs, mouts = TK.compose_indices(priors, take, masks)
    assert lib.launches == sets
    assert TK.LAUNCHES["compose_index"] == len(sets)
    want, mwant = TK.compose_indices_plain(priors, take, masks)
    assert len(outs) == k and len(mouts) == m
    for g, w in zip(outs + mouts, want + mwant):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 4099])
@pytest.mark.parametrize("offset", [0, 1])
def test_masks_at_odd_lengths_and_offset_views_match_reference(n, offset):
    """semi_mask / anti_mask around the card kernel's 16-row group and
    on views that start one element in (the kernel's unaligned loads)."""
    rng = np.random.default_rng(61 + n)
    counts = rng.integers(0, 3, n + 1).astype(np.int64)
    pvalid = rng.random(n + 1) < 0.7
    tc = _t(counts)[offset:offset + n]
    tv = _t(pvalid)[offset:offset + n]
    assert tc.storage_offset() == offset and tc.is_contiguous()
    c, v = counts[offset:offset + n], pvalid[offset:offset + n]
    np.testing.assert_array_equal(
        _np(TK.semi_mask(tc)), np.asarray(RK.semi_mask(jnp.asarray(c))))
    np.testing.assert_array_equal(
        _np(TK.anti_mask(tc, tv)),
        np.asarray(RK.anti_mask(jnp.asarray(c), jnp.asarray(v))))


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


def _group_parity(keys, valid, ins, kinds, max_groups):
    wk, wo, wn = RK.grouped_agg_sort(
        tuple(jnp.asarray(k) for k in keys), jnp.asarray(valid),
        tuple(jnp.asarray(a) for a in ins), max_groups, kinds)
    for traced in (False, True):
        gk, go, gn = TK.grouped_agg_sort(
            tuple(_t(k) for k in keys), _t(valid), tuple(_t(a) for a in ins),
            max_groups, kinds, traced=traced)
        assert int(gn) == int(wn)
        for g, w in zip(gk, wk):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        for kd, g, w in zip(kinds, go, wo):
            g, w = _np(g), np.asarray(w)
            assert g.dtype == w.dtype, (kd, g.dtype, w.dtype)
            if g.dtype.kind == "f" and kd in ("sum", "sumf"):
                np.testing.assert_allclose(g, w, rtol=SUMF_RTOL, atol=0)
            else:
                np.testing.assert_array_equal(g, w)
    return int(wn)


def test_grouped_agg_sort_one_group_over_4500_rows():
    """One group spans more than 4096 sorted rows (more than four of the
    card's 1024-row tiles), then small groups; both forms."""
    rng = np.random.default_rng(71)
    n = 6000
    keys = (np.where(np.arange(n) < 4500, 7,
                     rng.integers(0, 50, n)).astype(np.int64),)
    valid = rng.random(n) < 0.95
    assert _group_parity(keys, valid, _agg_inputs(rng, n), AGG_KINDS,
                         8192) > 40


def test_grouped_agg_sort_nan_and_inf_f64_aggregates():
    """f64 sum, min and max over NaN, +-inf and +-0.0: a group with a NaN
    is NaN, +inf and -inf sum to NaN, -0.0 sums to 0.0."""
    rng = np.random.default_rng(72)
    n = 3000
    vals = rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.25], n)
    vals[:40] = -0.0
    keys = (np.where(np.arange(n) < 40, -1, rng.integers(0, 60, n)),)
    ins = (vals, vals, vals, vals, rng.integers(0, 9, n))
    kinds = ("sumf", "sum", "min", "max", "count")
    assert _group_parity(keys, np.ones(n, bool), ins, kinds, 128) == 61


def test_grouped_agg_sort_drops_groups_past_max_groups():
    """More groups than max_groups: n_groups counts them all, the outputs
    hold the first max_groups in the reference's order."""
    rng = np.random.default_rng(73)
    n = 2500
    keys = (rng.integers(0, 300, n), rng.integers(0, 3, n).astype(np.int32))
    valid = rng.random(n) < 0.9
    assert _group_parity(keys, valid, _agg_inputs(rng, n), AGG_KINDS,
                         16) > 16


class _FakeGroupLib:
    """K5's C interface and K10's without a card: the sort writes the
    plain version's order, the reduce the plain version's outputs (both
    computed before the call); records each call's name and sizes."""

    def __init__(self, perm, want, nkeys):
        self.perm, self.want, self.nkeys = perm, want, nkeys
        self.calls = []

    def otbt_group_scratch_bytes(self, n, k, aggs):
        self.calls.append(("scratch_bytes", n, k, aggs))
        return 64

    def otbt_group_words(self, kptr, kdt, k, n, valid, aggs, scratch,
                         sbytes, words, stream):
        self.calls.append(("words", k, n, aggs, sbytes))
        return 0

    def otbt_sort_scratch_bytes(self, w, n):
        self.calls.append(("sort_scratch_bytes", w, n))
        return 0

    def otbt_sort_perm(self, words, w, n, scratch, sbytes, perm, first,
                       stream):
        self.calls.append(("sort", w, n))
        ctypes.memmove(perm, self.perm.data_ptr(), 8 * n)
        return 0

    def otbt_group_reduce(self, kptr, kdt, kouts, k, n, valid, perm,
                          max_groups, aggs, ins, kinds, dtypes, idents, outs,
                          n_groups, scratch, sbytes, stream):
        self.calls.append(("reduce", k, n, max_groups, aggs,
                           tuple(kinds[i] for i in range(aggs)),
                           tuple(dtypes[i] for i in range(aggs))))
        gk, go, gn = self.want
        for c, g in enumerate(gk):
            ctypes.memmove(kouts[c], g.data_ptr(), g.numel() * g.element_size())
        for j, o in enumerate(go):
            ctypes.memmove(outs[j], o.data_ptr(), o.numel() * o.element_size())
        ctypes.memmove(n_groups, gn.reshape(1).data_ptr(), 8)
        return 0


def test_grouped_agg_sort_reads_nothing_from_the_device(monkeypatch):
    """On the card neither form of the K5 wrapper reads the device from
    the host (Tensor.cpu, .item, .tolist, .numpy and the scalar
    conversions raise here), both make the same sequence of library
    calls (the words, K10's sort, one reduce), and one launch is
    counted; the library is faked with the plain version (no card)."""
    rng = np.random.default_rng(74)
    n = 900
    keys, valid = _group_case("dense3", rng, n)
    args = (tuple(_t(k) for k in keys), _t(valid),
            tuple(_t(a) for a in _agg_inputs(rng, n)), 1024, AGG_KINDS)
    seqs = {}
    for traced in (False, True):
        want = TK.grouped_agg_sort_plain(*args, traced=traced)
        ints = TK._sortable_ints(args[0])
        perm = TK.sort_perm_plain(TK._group_words_traced_plain(ints,
                                                               args[1]))
        lib = _FakeGroupLib(perm, want, len(keys))
        with monkeypatch.context() as m:
            m.setattr(TK, "_on_cpu", lambda *ts: False)
            m.setattr(TK, "_lib", lambda: lib)
            m.setattr(TK, "_stream", lambda: 0)

            def host_read(*a, **kw):
                raise AssertionError("a host read on the K5 path")
            for name in ("cpu", "item", "tolist", "numpy", "__bool__",
                         "__int__", "__float__"):
                m.setattr(torch.Tensor, name, host_read)
            TK.reset_launches()
            got = TK.grouped_agg_sort(*args, traced=traced)
            launches = dict(TK.LAUNCHES)
        assert launches["grouped_agg_sort"] == 1
        assert launches["sort_rows"] == 0
        seqs[traced] = [c[0] for c in lib.calls], lib.calls
        (gk, go, gn), (wk, wo, wn) = got, want
        assert int(gn) == int(wn)
        for g, w in zip(gk + go, wk + wo):
            assert torch.equal(g, w)
    assert seqs[False] == seqs[True]
    assert seqs[True][0] == ["scratch_bytes", "words", "sort_scratch_bytes",
                             "sort", "reduce"]
    k = len(keys)
    assert ("sort", 1 + k + 1, n) in seqs[True][1]


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
        lambda: TK.compose_indices((k, k), k, (v,)),
        lambda: TK.semi_mask(k),
        lambda: TK.anti_mask(k, v),
        lambda: TK.grouped_agg_sort((k,), v, (k,), 8, ("sum",)),
    ]
    for fn in launches:
        with pytest.raises(RuntimeError, match="no kernel library"):
            fn()
    assert len(calls) == len(launches)


@pytest.mark.parametrize("private", [True, False])
def test_stream_handle_with_and_without_the_private_getter(monkeypatch,
                                                          private):
    """_stream() gives the current device's raw stream through torch's
    private _cuda_getCurrentRawStream where torch has it, and through
    torch.cuda.current_stream().cuda_stream where it does not (both
    faked here: no card)."""
    class FakeStream:
        cuda_stream = 0xBEEF
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: FakeStream())
    if private:
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda dev: 0xA000 + dev, raising=False)
        assert TK._stream() == 0xA003
    else:
        monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream",
                            raising=False)
        assert TK._stream() == 0xBEEF
