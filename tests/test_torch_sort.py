"""K10 sort_rows as an LSD radix sort, and K6 join_build on it.

A numpy model of the CUDA radix sort's schedule (csrc/sort.cu) is held
against the reference's jax.lax.sort / sort_rows and against the port's
plain sort_perm_plain.  The model follows the kernel step for step: each
word's min and max (sort_stats), the key (uint64)(x - min), 8-bit
digits from low to high below the span's top bit, words from the last to
the first, and per pass the blocks' digit sums, their scan over blocks,
the identity skip of a digit that holds all n rows (the buffer parity
kept), and the scatter of each tile in digit order; below the one-block
threshold the shared-memory path with its OR / AND test of constant
digits.  It runs here, where the kernel cannot, so a schedule error shows
on a machine without a card; chip_smoke.py holds the kernel itself
against sort_perm_plain on the same cases.

Permutations must be equal exactly (every sort here is stable with the
row index as the last key).  K6: the port's join_build_plain (what the
wrapper runs on the CPU) against the reference's join_build on both of
its branches, the perm and the sorted keys equal exactly.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import opentenbase_tpu  # noqa: F401  (x64 on, as the reference runs)
import jax
import jax.numpy as jnp
from opentenbase_tpu.ops import kernels as RK
from opentenbase_tpu_torch.ops import kernels as TK

I64 = np.iinfo(np.int64)
U64 = np.uint64
SMALL_MAX = 4096        # csrc/sort.cu kSmallMax
WIDE_MIN = 1 << 19      # kWideMin: 4096-row tiles from here on
RESIDENT = 264          # passes kernel blocks resident on an H100


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _span_digits(span: int) -> int:
    return 0 if span == 0 else (span.bit_length() - 1) // 8 + 1


def _digits(keys, d):
    return ((keys >> U64(8 * d)) & U64(0xff)).astype(np.int64)


def _stable_positions(dig):
    """Each item's position in its tile's digit order: the counts' bases
    plus its rank among the earlier items of its digit."""
    lp = np.empty(len(dig), np.int64)
    lp[np.argsort(dig, kind="stable")] = np.arange(len(dig))
    return lp


def _model_small(words, log):
    """The one-block path: every word loaded through the current order,
    constant digits found from the OR and AND of the keys."""
    w, n = words.shape
    perm = np.arange(n, dtype=np.int64)
    keys = np.zeros(n, U64)
    mn = 0
    for s in range(w):
        x = words[w - 1 - s][perm]
        mn = int(x.min())
        keys = x.astype(U64) - U64(mn & ((1 << 64) - 1))
        varying = int(np.bitwise_or.reduce(keys) ^ np.bitwise_and.reduce(keys))
        for d in range(8):
            if (varying >> (8 * d)) & 0xff == 0:
                continue
            lp = _stable_positions(_digits(keys, d))
            k2, p2 = np.empty_like(keys), np.empty_like(perm)
            k2[lp], p2[lp] = keys, perm
            keys, perm = k2, p2
            log.append((s, d))
    first = (keys + U64(mn & ((1 << 64) - 1))).view(np.int64)
    return perm, first


def _model_large(words, tile, resident, log):
    """The cooperative passes kernel: G blocks, block g owning tiles
    [g tb, (g + 1) tb); per pass the blocks' digit sums (cols), their
    scan over blocks, the one-bucket skip, the tiles scattered in digit
    order.  Two ping-pong buffers; b is the one holding the order."""
    w, n = words.shape
    T = -(-n // tile)
    G = min(T, resident)
    tb = -(-T // G)
    G = -(-T // tb)
    mins = words.min(axis=1) if w else np.zeros(0, np.int64)
    maxs = words.max(axis=1) if w else np.zeros(0, np.int64)
    nds = [_span_digits((int(maxs[c]) - int(mins[c])) % (1 << 64))
           for c in range(w)]
    last = None
    for s in range(w):
        if nds[w - 1 - s]:
            last = (s, nds[w - 1 - s] - 1)
    keys = [np.zeros(n, U64), np.zeros(n, U64)]
    perm = [np.zeros(n, np.int64), np.zeros(n, np.int64)]
    out_perm = np.full(n, -1, np.int64)
    out_first = np.full(n, -7, np.int64)
    b, ordered = 0, False
    for s in range(w):
        c = w - 1 - s
        x = words[c]
        mn = U64(int(mins[c]) & ((1 << 64) - 1))
        in_kb = False
        for d in range(nds[c]):
            if in_kb:
                k_src, p_src = keys[b], perm[b]
            else:
                p_src = perm[b] if ordered else np.arange(n, dtype=np.int64)
                k_src = x[p_src].astype(U64) - mn
            dig = _digits(k_src, d)
            # 1. each block's digit sums over its tiles
            cols = np.zeros((G, 256), np.int64)
            for g in range(G):
                lo, hi = g * tb * tile, min((g + 1) * tb * tile, n)
                cols[g] = np.bincount(dig[lo:hi], minlength=256)
            # 2. scanned over the blocks, one digit at a time
            tot = cols.sum(axis=0)
            cols = np.cumsum(cols, axis=0) - cols
            # 3. the identity skip, else the scatter
            if (tot == n).any():
                log.append((s, d, "skip"))
                continue
            base = np.cumsum(tot) - tot
            fin = (s, d) == last
            k_dst, p_dst = np.zeros(n, U64), np.zeros(n, np.int64)
            for g in range(G):
                run = base + cols[g]
                for t in range(g * tb, min((g + 1) * tb, T)):
                    lo, hi = t * tile, min((t + 1) * tile, n)
                    dg = dig[lo:hi]
                    cnt = np.bincount(dg, minlength=256)
                    start = np.cumsum(cnt) - cnt
                    lp = _stable_positions(dg)
                    sk, sp = np.empty(hi - lo, U64), np.empty(hi - lo,
                                                              np.int64)
                    sk[lp], sp[lp] = k_src[lo:hi], p_src[lo:hi]
                    sd = _digits(sk, d)
                    pos = run[sd] + np.arange(hi - lo) - start[sd]
                    if fin:
                        out_perm[pos] = sp
                        if c == 0:
                            out_first[pos] = (sk + mn).view(np.int64)
                    else:
                        k_dst[pos], p_dst[pos] = sk, sp
                    run = run + cnt
            log.append((s, d))
            keys[1 - b], perm[1 - b] = k_dst, p_dst
            b, ordered, in_kb = 1 - b, True, True
    if last is None:
        out_perm = np.arange(n, dtype=np.int64)
        out_first = words[0].copy() if w else out_first
    elif last[0] != w - 1 and w:
        out_first = np.full(n, mins[0], np.int64)
    return out_perm, out_first


def radix_model(words, tile=None, resident=RESIDENT):
    """(perm, word 0 in sorted order, the passes run) of csrc/sort.cu's
    otbt_sort_perm on [w, n] int64 words; `tile` overrides the kernel's
    tile rows (to run many tiles and blocks at a small n)."""
    words = np.ascontiguousarray(words, np.int64)
    log = []
    n = words.shape[1]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), log
    if n <= SMALL_MAX and tile is None:
        perm, first = _model_small(words, log)
    else:
        tile = tile or (4096 if n >= WIDE_MIN else 2048)
        perm, first = _model_large(words, tile, resident, log)
    return perm, first, log


def _lax_perm(words):
    """The reference's order: jax.lax.sort over the words and the row
    index, num_keys = w (the words carry ~valid and the keys, as
    RK.sort_rows' operands do)."""
    w, n = words.shape
    ops = [jnp.asarray(x) for x in words] + [jnp.arange(n, dtype=jnp.int64)]
    return np.asarray(jax.lax.sort(ops, num_keys=w)[-1])


def _check(words, tiles=(None, 8, 64)):
    words = np.ascontiguousarray(words, np.int64)
    want = _lax_perm(words)
    np.testing.assert_array_equal(
        TK.sort_perm_plain(torch.from_numpy(words)).numpy(), want)
    for tile in tiles:
        if tile is not None and words.shape[1] > 3000:
            continue
        perm, first, _log = radix_model(words, tile=tile, resident=5
                                        if tile else RESIDENT)
        np.testing.assert_array_equal(perm, want)
        if words.shape[0]:
            np.testing.assert_array_equal(first, words[0][want])
    return want


# ---------------------------------------------------------------------------
# the listed cases
# ---------------------------------------------------------------------------

SIZES = [0, 1, 2, 7, 9, 255, 257, SMALL_MAX - 1, SMALL_MAX, SMALL_MAX + 1]


def _case_words(kind, n, rng):
    valid = rng.random(n) < 0.8
    ow = TK.order_words
    if kind == "wide":
        k = rng.integers(-10**12, 10**12, n)
        return ow((torch.from_numpy(k),), torch.from_numpy(valid), (False,))
    if kind == "equal":
        return ow((torch.full((n,), 5, dtype=torch.int64),),
                  torch.ones(n, dtype=torch.bool), (False,))
    if kind == "duplicates":
        return ow(tuple(torch.from_numpy(rng.integers(0, 3, n))
                        for _ in range(3)), torch.from_numpy(valid),
                  (False, True, False))
    if kind == "extremes":
        k = rng.choice(np.array([I64.min, I64.max, 0, -1, I64.min + 1,
                                 I64.max - 1], np.int64), n)
        return ow((torch.from_numpy(k),), torch.from_numpy(valid), (True,))
    if kind == "all_valid":
        k = rng.integers(-50, 50, n)
        return ow((torch.from_numpy(k),), torch.ones(n, dtype=torch.bool),
                  (False,))
    if kind == "all_invalid":
        k = rng.integers(-50, 50, n)
        return ow((torch.from_numpy(k),), torch.zeros(n, dtype=torch.bool),
                  (False,))
    raise ValueError(kind)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["wide", "equal", "duplicates", "extremes",
                                  "all_valid", "all_invalid"])
def test_radix_model_matches_lax_sort(kind, n):
    rng = np.random.default_rng(n * 7 + len(kind))
    _check(_case_words(kind, n, rng).numpy())


@pytest.mark.parametrize("desc", [False, True])
def test_radix_model_float_words_match_sort_rows(desc):
    """NaN, +-0.0 and +-inf through order_words: the model's order is the
    reference sort_rows' order of the float column itself."""
    rng = np.random.default_rng(40 + desc)
    for n in (300, SMALL_MAX + 1):
        f = rng.choice([-1.5, -0.0, 0.0, 2.0, np.nan, -np.nan, np.inf,
                        -np.inf, 1e300], n)
        valid = rng.random(n) < 0.9
        words = TK.order_words((torch.from_numpy(f),),
                               torch.from_numpy(valid), (desc,)).numpy()
        want = np.asarray(RK.sort_rows(
            (jnp.asarray(f),), jnp.asarray(valid),
            (jnp.arange(n, dtype=jnp.int64),), (desc,))[0][0])
        for tile in (None, 32):
            perm, _f, _l = radix_model(words, tile=tile)
            np.testing.assert_array_equal(perm, want)


@pytest.mark.parametrize("fast", [True, False])
def test_radix_model_traced_group_words(fast):
    """K5's traced words: under the fast branch one packed word and zero
    words, which the model (like the kernel) sorts with no pass."""
    rng = np.random.default_rng(50 + fast)
    n = 700
    valid = torch.from_numpy(rng.random(n) < 0.85)
    if fast:
        ints = torch.from_numpy(np.stack([rng.integers(0, 40, n),
                                          rng.integers(8000, 8030, n)]))
    else:
        ints = torch.from_numpy(rng.integers(I64.min, I64.max, (2, n),
                                             dtype=np.int64))
    words = TK._group_words_traced_plain(ints, valid).numpy()
    assert (words[1:] == 0).all() == fast
    _check(words)
    _p, _f, log = radix_model(words, tile=64)
    if fast:
        assert {s for s, *_ in log} == {words.shape[0] - 1}


def test_radix_model_schedule():
    """Which passes run: a +-1e12 key's 6 digits; the ~valid word's one
    digit when it varies and none when every row is valid; the Lloyd
    update's keys (0..1000) 2; a digit whose histogram holds every row
    (keys all multiples of 256) is skipped and keeps the parity."""
    rng = np.random.default_rng(60)
    n = 5000
    allv = torch.ones(n, dtype=torch.bool)
    key = torch.from_numpy(rng.integers(-10**12, 10**12, n))
    _p, _f, log = radix_model(TK.order_words((key,), allv, (False,)).numpy())
    assert log == [(0, d) for d in range(6)]
    some = torch.from_numpy(rng.random(n) < 0.5)
    _p, _f, log = radix_model(TK.order_words((key,), some, (False,)).numpy())
    assert log == [(0, d) for d in range(6)] + [(1, 0)]
    lloyd = rng.integers(0, 1001, n)[None, :]
    _p, _f, log = radix_model(lloyd)
    assert log == [(0, 0), (0, 1)]
    coarse = (rng.integers(0, 1 << 16, n) * 256)[None, :]
    want = _check(coarse, tiles=(None, 256))
    perm, _f, log = radix_model(coarse)
    assert log == [(0, 0, "skip"), (0, 1), (0, 2)]
    np.testing.assert_array_equal(perm, want)
    _p, _f, log = radix_model(coarse[:, :SMALL_MAX])
    assert log == [(0, 1), (0, 2)]
    # a constant middle digit: the pass after the skip reads the buffer
    # the pass before it wrote
    gap = (rng.integers(0, 256, n) + (rng.integers(0, 256, n) << 16))
    gap[0] = 0                  # the min: x - min borrows from no digit
    want = _check(gap[None, :], tiles=(None,))
    perm, _f, log = radix_model(gap[None, :])
    assert log == [(0, 0), (0, 1, "skip"), (0, 2)]


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       n=st.sampled_from([3, 17, 64, 200, 333]),
       w=st.integers(1, 3),
       tile=st.sampled_from([None, 8, 32]),
       kinds=st.lists(st.sampled_from(["const", "bit", "narrow", "wide",
                                       "full", "coarse", "gap"]), min_size=3,
                      max_size=3))
def test_radix_model_hypothesis(seed, n, w, tile, kinds):
    rng = np.random.default_rng(seed)
    gen = {
        "const": lambda: np.full(n, rng.integers(I64.min, I64.max,
                                                 dtype=np.int64)),
        "bit": lambda: rng.integers(0, 2, n),
        "narrow": lambda: rng.integers(-300, 300, n),
        "wide": lambda: rng.integers(-10**15, 10**15, n),
        "full": lambda: rng.integers(I64.min, I64.max, n, dtype=np.int64,
                                     endpoint=True),
        "coarse": lambda: rng.integers(-40, 40, n) << 20,
        "gap": lambda: np.concatenate([[0], rng.integers(0, 256, n - 1) + (
            rng.integers(0, 9, n - 1) << 16)]),
    }
    words = np.stack([gen[k]().astype(np.int64) for k in kinds[:w]])
    _check(words, tiles=(tile,))


# ---------------------------------------------------------------------------
# K6 join_build: the reference's two branches
# ---------------------------------------------------------------------------

def _pack_fits(keys, valid, n):
    """The reference's gate (ops/kernels.py:317-327), in float32."""
    if not valid.any():
        return False
    span = int(keys[valid].max()) - int(keys[valid].min())
    bits = np.log2(np.float32(span) + np.float32(2)) + \
        np.log2(np.float32(n + 2))
    return bool(bits < np.float32(62.0))


def _build_case(kind, rng):
    if kind == "probe":
        return (np.array([7, I64.max, I64.max - 3, I64.max - 1], np.int64),
                np.array([False, True, True, True]))
    n = 1022                                    # log2(n + 2) = 10
    valid = rng.random(n) < 0.8
    if kind in ("gate_fast", "gate_exact"):
        # span 2^52 - 2^40 packs (bits 61.9996), 2^52 does not (62.0)
        span = (1 << 52) - (1 << 40) if kind == "gate_fast" else 1 << 52
        keys = rng.integers(-5, 5, n) + (1 << 40)
        keys[valid.argmax()] = (1 << 40) - 100
        keys[n - 1 - valid[::-1].argmax()] = (1 << 40) - 100 + span
        return keys.astype(np.int64), valid
    if kind == "dense":
        return rng.integers(1000, 1000 + n // 3, n).astype(np.int64), valid
    if kind == "full_range":
        keys = rng.integers(I64.min, I64.max, n, dtype=np.int64)
        keys[::7] = keys[3]
        return keys, valid
    if kind == "null_keys":
        # NULL keys arrive as INT64_MAX: the span passes 2^62, exact
        keys = rng.integers(-20, 20, n).astype(np.int64)
        keys[rng.random(n) < 0.2] = I64.max
        return keys, valid
    if kind == "all_null":
        return np.full(n, I64.max, np.int64), valid
    if kind == "all_invalid":
        return rng.integers(0, 9, n).astype(np.int64), np.zeros(n, bool)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,fast", [
    ("probe", True), ("gate_fast", True), ("gate_exact", False),
    ("dense", True), ("full_range", False), ("null_keys", False),
    ("all_null", True), ("all_invalid", False)])
def test_join_build_branches_match_reference(kind, fast):
    rng = np.random.default_rng(70 + len(kind))
    keys, valid = _build_case(kind, rng)
    assert _pack_fits(keys, valid, len(keys)) == fast
    assert TK._build_gate_plain(torch.from_numpy(keys),
                                torch.from_numpy(valid))[0] == fast
    wk, wp = RK.join_build(jnp.asarray(keys), jnp.asarray(valid))
    for fn in (TK.join_build_plain, TK.join_build):
        gk, gp = fn(torch.from_numpy(keys), torch.from_numpy(valid))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    if kind == "probe":
        assert np.asarray(wp).tolist() == [2, 3, 1, 0]


def test_join_build_fast_branch_word_is_what_the_sort_sees():
    """The fast branch's word (key - min, rng for an invalid row) sorted
    by the radix model gives the reference's perm and, through the
    epilogue, its sorted keys."""
    rng = np.random.default_rng(80)
    n = 6000
    keys = rng.integers(0, 1 << 23, n).astype(np.int64)
    valid = rng.random(n) < 0.9
    fast, mn, rng_ = TK._build_gate_plain(torch.from_numpy(keys),
                                          torch.from_numpy(valid))
    assert fast
    word = np.where(valid, np.clip(keys - mn, 0, rng_ - 1), rng_)
    perm, acc_s, log = radix_model(word[None, :])
    assert len(log) == 3                        # 2^23 keys: 3 digits
    wk, wp = RK.join_build(jnp.asarray(keys), jnp.asarray(valid))
    np.testing.assert_array_equal(perm, np.asarray(wp))
    np.testing.assert_array_equal(
        np.where(acc_s >= rng_, I64.max, acc_s + mn), np.asarray(wk))
