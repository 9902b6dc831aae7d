"""Kernel parity: opentenbase_tpu_torch.ops.kernels against the reference
opentenbase_tpu.ops.kernels on the same numpy inputs.

On the CPU each port wrapper runs its plain PyTorch version (the CUDA
kernels are held against those on the card by chip_smoke.py).  Integer,
decimal and bool outputs must be equal exactly; f64 sums ("sumf") within
relative 1e-10, the only difference being the order of the summation.
"""

import ctypes

import numpy as np
import pytest
import torch

import opentenbase_tpu  # noqa: F401  (x64 on, as the reference runs)
import jax.numpy as jnp
from opentenbase_tpu.ops import kernels as RK
from opentenbase_tpu_torch.ops import kernels as TK

SUMF_RTOL = 1e-10


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# K1 visibility_mask
# ---------------------------------------------------------------------------

def test_visibility_mask_matches_reference():
    rng = np.random.default_rng(1)
    n = 4096
    aborted = (1 << 62) + 1
    xmin_ts = rng.choice([0, 90, 100, 110, 1 << 62, aborted], n)
    xmax_ts = rng.choice([0, 95, 105, 1 << 62], n)
    xmin_txid = rng.choice([0, 3, 7], n)
    xmax_txid = rng.choice([0, 3, 7], n)
    cols = [np.asarray(c, np.int64) for c in
            (xmin_ts, xmax_ts, xmin_txid, xmax_txid)]
    want = RK.visibility_mask(*(jnp.asarray(c) for c in cols),
                              jnp.int64(100), jnp.int64(7),
                              jnp.int64(aborted))
    got = TK.visibility_mask(*(_t(c) for c in cols), 100, 7, aborted)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# K2 decode_column / cmp_on_codes
# ---------------------------------------------------------------------------

def _codec_case(family, width, out, seed=2, n=1000):
    rng = np.random.default_rng(seed)
    cdt = np.dtype(f"uint{width}")
    odt = np.dtype(out)
    top = min((1 << width) - 1, 200 if family == "dict" else (1 << width) - 1)
    codes = rng.integers(0, top + 1, n).astype(cdt)
    codes[:7] = 0                              # padding rows
    codes[7] = top                             # the widest code
    if family == "pack":
        aux = np.zeros(1, odt)
    elif family == "for":
        aux = np.asarray([-12345 if odt == np.int32 else -(1 << 40)], odt)
    else:
        cap = 128                              # codes >= cap read nothing
        aux = np.zeros(cap, odt)
        aux[1:] = rng.integers(-10**6, 10**6, cap - 1)
    return codes, aux


CODEC_CASES = [(f, w, o) for f in ("pack", "for", "dict")
               for w in (8, 16, 32) for o in ("int32", "int64")]


@pytest.mark.parametrize("family,width,out", CODEC_CASES)
def test_decode_column_matches_reference(family, width, out):
    codes, aux = _codec_case(family, width, out)
    want = np.asarray(RK.decode_column(jnp.asarray(codes), jnp.asarray(aux),
                                       family))
    got = _np(TK.decode_column(_t(codes), _t(aux), family))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if family != "pack":
        assert (got[:7] == 0).all()            # padding decodes to 0


@pytest.mark.parametrize("family,width,out", CODEC_CASES)
@pytest.mark.parametrize("op", ["=", "<>", "<", "<=", ">", ">="])
def test_cmp_on_codes_matches_reference(family, width, out, op):
    codes, aux = _codec_case(family, width, out, seed=3)
    mid = RK.decode_column(jnp.asarray(codes), jnp.asarray(aux), family)
    lit = int(np.asarray(mid)[11])             # a value that occurs
    want = np.asarray(RK.cmp_on_codes(jnp.asarray(codes), jnp.asarray(aux),
                                      family, op, lit))
    got = _np(TK.cmp_on_codes(_t(codes), _t(aux), family, op, lit))
    np.testing.assert_array_equal(got, want)


def test_cmp_on_codes_unknown_op_is_none():
    codes, aux = _codec_case("for", 8, "int64")
    assert TK.cmp_on_codes(_t(codes), _t(aux), "for", "like", 1) is None


# ---------------------------------------------------------------------------
# K4 grouped_agg_dense
# ---------------------------------------------------------------------------

def _agg_inputs(rng, n):
    return {
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
        "i64": rng.integers(-10**12, 10**12, n).astype(np.int64),
        "f64": rng.normal(0, 1e3, n),
    }


def _compare_agg(got, want, kinds):
    """Present, counts, ints and min/max exactly (NaN where the reference
    has NaN); f64 sums within SUMF_RTOL, their NaN and infinities at the
    same places."""
    (gouts, gpres), (wouts, wpres) = got, want
    np.testing.assert_array_equal(_np(gpres), np.asarray(wpres))
    for k, g, w in zip(kinds, gouts, wouts):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if g.dtype.kind == "f" and k in ("sumf", "sum"):
            np.testing.assert_allclose(g, w, rtol=SUMF_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["sum", "count", "min", "max", "sumf"])
@pytest.mark.parametrize("dtype", ["i32", "i64", "f64"])
def test_grouped_agg_dense_matches_reference(kind, dtype):
    rng = np.random.default_rng(4)
    n, groups = 5000, 7
    gid = rng.integers(0, groups, n).astype(np.int64)
    gid[gid == 3] = 4                           # group 3 stays empty
    gid[:5] = [-1, groups, groups + 3, 0, 1]    # out-of-range ids drop
    valid = rng.random(n) < 0.8
    vals = _agg_inputs(rng, n)[dtype]
    want = RK.grouped_agg_dense(jnp.asarray(gid), jnp.asarray(valid),
                                (jnp.asarray(vals),), groups, (kind,))
    got = TK.grouped_agg_dense(_t(gid), _t(valid), (_t(vals),), groups,
                               (kind,))
    _compare_agg(got, want, (kind,))


def test_grouped_agg_dense_all_invalid_and_many_aggs():
    rng = np.random.default_rng(5)
    n, groups = 300, 3
    gid = rng.integers(0, groups, n).astype(np.int64)
    ins = _agg_inputs(rng, n)
    kinds = ("sum", "min", "max", "sumf", "count") * 2
    args = (ins["i32"], ins["i64"], ins["f64"], ins["i64"], ins["i32"],
            ins["i64"], ins["i32"], ins["i32"], ins["f64"], ins["f64"])
    for valid in (np.zeros(n, bool), rng.random(n) < 0.5):
        want = RK.grouped_agg_dense(
            jnp.asarray(gid), jnp.asarray(valid),
            tuple(jnp.asarray(a) for a in args), groups, kinds)
        got = TK.grouped_agg_dense(_t(gid), _t(valid),
                                   tuple(_t(a) for a in args), groups, kinds)
        _compare_agg(got, want, kinds)


# The card's K4 takes one of three branches by the table's words, (k + 1)
# x groups, against its shared memory (csrc/grouped_agg.cu plan_for): on
# the H100 at 3 aggregates the thread-private tables end at 28 groups and
# the block tables at 3616.  The plain version has no branches; these
# cases hold it to the reference at those edges and at the shapes each
# branch exists for.
K4_EDGE_GROUPS = (28, 29, 3616, 3617)


def _k4_case(case, rng, n=3000):
    """(gid, valid, inputs, kinds, groups) of a named K4 case."""
    valid = rng.random(n) < 0.85
    i64 = rng.integers(-10**12, 10**12, n).astype(np.int64)
    i32 = rng.integers(-10**6, 10**6, n).astype(np.int32)
    f = rng.normal(0, 1e3, n)
    if case == "one_group":
        return (np.zeros(n, np.int64), valid,
                (i64, f, f, i32, i32, i64, i32, rng.random(n) < 0.5),
                ("sum", "sumf", "min", "max", "min", "count", "sum", "sumf"),
                1)
    if case == "q1_shape":
        gid = rng.choice([0, 1, 3, 5], n).astype(np.int64)
        return gid, valid, (i64,) * 8, ("sum",) * 7 + ("count",), 6
    if case == "nonfinite":
        nf = rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.25], n)
        nf[rng.random(n) < 0.9] = 1.0
        gid = rng.integers(0, 5, n).astype(np.int64)
        gid[gid == 2] = 1                       # group 2 stays empty
        return gid, valid, (nf, nf, nf, nf), ("sumf", "sum", "min", "max"), 5
    if case == "out_of_range":
        gid = rng.integers(-3, 10, n).astype(np.int64)
        return gid, valid, (i32, i64, f), ("max", "sum", "min"), 7
    if case == "all_invalid":
        gid = rng.integers(0, 6, n).astype(np.int64)
        return (gid, np.zeros(n, bool), (i64, f, f, i32),
                ("sum", "sumf", "min", "max"), 6)
    groups = int(case)
    gid = rng.integers(-2, groups + 2, n).astype(np.int64)
    return gid, valid, (f, i32, f), ("sumf", "min", "max"), groups


@pytest.mark.parametrize("case", ["one_group", "q1_shape", "nonfinite",
                                  "out_of_range", "all_invalid"]
                         + [str(g) for g in K4_EDGE_GROUPS])
def test_grouped_agg_dense_branch_cases_match_reference(case):
    """One group, Q1's shape (6 slots, 4 occupied, 8 aggregates), NaN and
    infinities in sumf / min / max, int32 and bool inputs, out-of-range
    ids, all rows invalid, and group counts on either side of the card's
    branch edges: the plain version equals the reference."""
    gid, valid, ins, kinds, groups = _k4_case(case, np.random.default_rng(9))
    want = RK.grouped_agg_dense(jnp.asarray(gid), jnp.asarray(valid),
                                tuple(jnp.asarray(a) for a in ins), groups,
                                kinds)
    got = TK.grouped_agg_dense(_t(gid), _t(valid), tuple(_t(a) for a in ins),
                               groups, kinds)
    _compare_agg(got, want, kinds)


class _FakeDenseLib:
    """K4's C interface without a card: each launch writes the plain
    version's outputs (computed before the call) through the output
    pointer, an int32 output into the first half of its region; records
    each call."""

    def __init__(self, want_sets):
        self.want_sets = list(want_sets)
        self.calls = []

    def otbt_grouped_agg_dense_scratch_bytes(self, n, g, k):
        return 8 * 3 * (k + 1) * g + 16

    def otbt_grouped_agg_dense(self, gid, valid, n, g, k, ins, kinds, dtypes,
                               idents, out, scratch, scratch_bytes, stream):
        outs, present = self.want_sets[len(self.calls)]
        for a, o in enumerate(outs):
            ctypes.memmove(out + 8 * a * g, o.data_ptr(),
                           o.numel() * o.element_size())
        ctypes.memmove(out + 8 * k * g, present.data_ptr(), 8 * g)
        self.calls.append((n, g, k, out, scratch, scratch_bytes))
        return 0


def test_grouped_agg_dense_makes_one_allocation_and_no_fill(monkeypatch):
    """On the card the K4 wrapper makes one allocation a set of 32
    aggregates (the outputs, present, then the kernel's scratch; the
    outputs are views of it), fills nothing (the kernel writes every
    word, an empty group's identity too), makes one library call and
    counts one launch a set; the outputs equal the plain version's (the
    library faked with it: no card here)."""
    rng = np.random.default_rng(10)
    n, g = 700, 5
    gid = _t(rng.integers(-1, g + 1, n).astype(np.int64))
    valid = _t(rng.random(n) < 0.8)
    cols = (_t(rng.integers(-9, 9, n).astype(np.int32)),
            _t(rng.normal(size=n)), _t(rng.integers(-9, 9, n)))
    kinds = ("min", "max", "sumf", "sum", "count") * 8
    ins = (cols[0], cols[1], cols[1], cols[2], cols[0]) * 8
    want = TK.grouped_agg_dense_plain(gid, valid, ins, g, kinds)
    sets = [TK.grouped_agg_dense_plain(gid, valid, ins[lo:lo + 32], g,
                                       kinds[lo:lo + 32])
            for lo in (0, 32)]
    lib = _FakeDenseLib(sets)
    allocs = []
    real_empty = torch.empty

    def empty(*a, **kw):
        allocs.append(real_empty(*a, **kw))
        return allocs[-1]

    def no_fill(*a, **kw):
        raise AssertionError("a fill on the K4 path")
    monkeypatch.setattr(TK, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(TK, "_lib", lambda: lib)
    monkeypatch.setattr(TK, "_stream", lambda: 0)
    monkeypatch.setattr(torch, "empty", empty)
    for name in ("zeros", "zeros_like", "full", "full_like"):
        monkeypatch.setattr(torch, name, no_fill)
    for name in ("zero_", "fill_"):
        monkeypatch.setattr(torch.Tensor, name, no_fill)
    TK.reset_launches()
    got = TK.grouped_agg_dense(gid, valid, ins, g, kinds)
    monkeypatch.undo()
    assert len(allocs) == 2 and len(lib.calls) == 2
    assert TK.LAUNCHES["grouped_agg_dense"] == 2
    for buf, (n_, g_, k, out, scratch, sbytes) in zip(allocs, lib.calls):
        assert (n_, g_) == (n, g) and k in (32, 8)
        assert out == buf.data_ptr() and scratch == out + 8 * (k + 1) * g
        assert buf.untyped_storage().nbytes() >= 8 * (k + 1) * g + sbytes
    for o, a in zip(got[0], range(40)):
        buf = allocs[a // 32]
        assert o.untyped_storage().data_ptr() == buf.data_ptr()
        assert o.is_contiguous()
    _compare_agg(got, want, kinds)


def test_q1_step_matches_reference_entry():
    import __graft_entry__ as G
    from opentenbase_tpu_torch import entry as PE
    fn, (cols,) = G.entry()
    want = fn({k: jnp.asarray(v) for k, v in cols.items()})
    pcols = PE.q1_arrays()
    for k in cols:
        np.testing.assert_array_equal(pcols[k], cols[k])
    pfn, (tcols,) = PE.entry(device="cpu")
    got = pfn(tcols)
    _compare_agg(got, want, PE.Q1_KINDS)


# ---------------------------------------------------------------------------
# K10 sort_rows
# ---------------------------------------------------------------------------

def _sort_case(rng, n, distinct: bool):
    if distinct:
        a = rng.permutation(n).astype(np.int64) - n // 2
        f = rng.permutation(n).astype(np.float64) - n / 2
    else:
        a = rng.integers(-3, 3, n).astype(np.int32)
        f = rng.choice([-1.5, -0.0, 0.0, 2.0, np.nan, -np.inf, np.inf], n)
    b = rng.integers(0, 2, n).astype(bool)
    valid = rng.random(n) < 0.85
    return a, f, b, valid


@pytest.mark.parametrize("descs", [(False, False, False), (True, False, True),
                                   (False, True, False), (True, True, True)])
@pytest.mark.parametrize("distinct", [True, False])
@pytest.mark.parametrize("limit", [None, 10])
def test_sort_rows_matches_reference(descs, distinct, limit):
    rng = np.random.default_rng(6)
    n = 257
    a, f, b, valid = _sort_case(rng, n, distinct)
    keys_np = (f, a, b) if distinct else (a, f, b)
    payload = (np.arange(n, dtype=np.int64), f.copy())
    want_p, want_v = RK.sort_rows(
        tuple(jnp.asarray(k) for k in keys_np), jnp.asarray(valid),
        tuple(jnp.asarray(p) for p in payload), descs, limit)
    got_p, got_v = TK.sort_rows(
        tuple(_t(k) for k in keys_np), _t(valid),
        tuple(_t(p) for p in payload), descs, limit)
    np.testing.assert_array_equal(_np(got_v), np.asarray(want_v))
    # both sorts are stable, so even with ties the permutation agrees
    np.testing.assert_array_equal(_np(got_p[0]), np.asarray(want_p[0]))
    np.testing.assert_array_equal(_np(got_p[1]), np.asarray(want_p[1]))
    # and as a multiset, the valid rows come out exactly once each
    kept = _np(got_p[0])[_np(got_v)]
    assert len(set(kept.tolist())) == len(kept)


def test_order_words_float_canonicalisation():
    x = torch.tensor([1.0, -0.0, 0.0, float("nan"), -float("nan"),
                      -float("inf"), float("inf"), -2.5], dtype=torch.float64)
    valid = torch.ones(8, dtype=torch.bool)
    for desc in (False, True):
        w = TK.order_words((x,), valid, (desc,))
        perm = TK.sort_perm_plain(w)
        want_perm = np.asarray(RK.sort_rows(
            (jnp.asarray(x.numpy()),), jnp.asarray(valid.numpy()),
            (jnp.arange(8),), (desc,))[0][0])
        np.testing.assert_array_equal(perm.numpy(), want_perm)
