"""Chip smoke test of the PyTorch/CUDA port (opentenbase_tpu_torch).

Drives the port's main path on one CUDA card: CREATE the TPC-H schema,
bulk-load lineitem at SF1 (6.0 M rows), run TPC-H Q1 and Q6 through
Session.query, and check the rows against a numpy oracle computed here
from the generated arrays.  Around that it builds the CUDA kernels from
opentenbase_tpu_torch/csrc, holds each kernel against its plain PyTorch
version on the inputs the main path gave it, shows from the launch
counters that the path went through every kernel, and times the kernels,
their plain versions and the queries.

Run from the repository root:  python3 chip_smoke.py  [--sf 1.0]
It needs one CUDA card and fails (exit code != 0, no result line)
without one.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12           # H100 SXM non-tensor peak (ops bound)
SUMF_RTOL = 1e-9                 # f64 atomics sum in another order
REPS = 5                         # warm query runs behind each median
DEVICE = "cuda"
KERNEL_SOURCES = {
    "visibility_mask": ("opentenbase_tpu_torch/csrc/visibility.cu",
                        "opentenbase_tpu/ops/kernels.py:40"),
    "decode_column": ("opentenbase_tpu_torch/csrc/codec.cu",
                      "opentenbase_tpu/ops/kernels.py:55"),
    "cmp_on_codes": ("opentenbase_tpu_torch/csrc/codec.cu",
                     "opentenbase_tpu/ops/kernels.py:69"),
    "grouped_agg_dense": ("opentenbase_tpu_torch/csrc/grouped_agg.cu",
                          "opentenbase_tpu/ops/kernels.py:133"),
    "sort_rows": ("opentenbase_tpu_torch/csrc/sort.cu",
                  "opentenbase_tpu/ops/kernels.py:488"),
}


class SmokeFailure(RuntimeError):
    pass


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 1: setup
# ---------------------------------------------------------------------------

def setup(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from opentenbase_tpu_torch.ops import build
    try:
        nv = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                            text=True, timeout=60).stdout.strip()
        say("nvcc:", nv.splitlines()[-1] if nv else "?")
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else "unknown"
    say(card)
    t0 = time.perf_counter()
    build.lib()
    say(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({len(build.sources())} sources, nvcc {build.build_seconds:.1f} s)")
    return card


def small_kernel_check(torch, K):
    """Each kernel once on small inputs against its plain version — a
    short first check that every kernel builds and launches."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    n = 1000
    cols = [torch.from_numpy(rng.integers(0, 5, n).astype(np.int64)).to(dev)
            for _ in range(4)]
    got = K.visibility_mask(*cols, 3, 2, 4)
    want = K.visibility_mask_plain(*cols, 3, 2, 4)
    check(torch.equal(got, want), "visibility_mask differs (small)")
    codes = torch.from_numpy(rng.integers(0, 200, n).astype(np.uint16)).to(dev)
    aux = torch.from_numpy(rng.integers(-50, 50, 128)).to(dev)
    for fam in ("pack", "for", "dict"):
        a = aux if fam == "dict" else aux[:1].contiguous()
        check(torch.equal(K.decode_column(codes, a, fam),
                          K.decode_column_plain(codes, a, fam)),
              f"decode_column {fam} differs (small)")
        check(torch.equal(K.cmp_on_codes(codes, a, fam, "<=", 7),
                          K.cmp_on_codes_plain(codes, a, fam, "<=", 7)),
              f"cmp_on_codes {fam} differs (small)")
    gid = torch.from_numpy(rng.integers(-1, 6, n)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    v = torch.from_numpy(rng.integers(-9, 9, n)).to(dev)
    kinds = ("sum", "count", "min", "max", "sumf")
    compare_agg(K.grouped_agg_dense(gid, valid, (v,) * 5, 5, kinds),
                K.grouped_agg_dense_plain(gid, valid, (v,) * 5, 5, kinds),
                kinds, "small")
    # the aggregate kernel's other branches: a shared-memory table above
    # the 48 KB default (opt-in), one too large for shared memory (global
    # accumulators), float min/max (compare-and-swap), int32 inputs, and
    # more aggregates than one launch takes
    m = 200_000
    gid = torch.from_numpy(rng.integers(-2, 4100, m)).to(dev)
    valid = torch.from_numpy(rng.random(m) < 0.9).to(dev)
    f = torch.from_numpy(rng.normal(0, 1e3, m)).to(dev)
    i32 = torch.from_numpy(rng.integers(-10**6, 10**6, m).astype(np.int32)) \
        .to(dev)
    for groups, kinds, ins in (
            (3000, ("min", "max", "sumf", "sum"), (f, f, f, i32)),
            (4096, ("min", "max", "sum", "count", "sumf", "min", "max"),
             (i32, i32, i32, i32, i32, f, f)),
            (7, ("sum", "min", "max", "sumf", "count") * 8, (i32, f) * 20)):
        compare_agg(K.grouped_agg_dense(gid, valid, ins, groups, kinds),
                    K.grouped_agg_dense_plain(gid, valid, ins, groups, kinds),
                    kinds, f"{groups} groups, {len(kinds)} aggregates")
    for rows in (0, 1, 5, n):
        key = torch.from_numpy(rng.integers(0, 9, rows)).to(dev)
        v = torch.from_numpy(rng.random(rows) < 0.7).to(dev)
        p = (torch.arange(rows, device=dev),)
        got = K.sort_rows((key,), v, p, (True,))
        want = K.sort_rows_plain((key,), v, p, (True,))
        check(torch.equal(got[0][0], want[0][0])
              and torch.equal(got[1], want[1]),
              f"sort_rows differs ({rows} rows)")
    torch.cuda.synchronize()
    say("kernels vs plain (small inputs and edge branches): ok")


def compare_agg(got, want, kinds, what):
    import torch
    (gouts, gp), (wouts, wp) = got, want
    check(torch.equal(gp, wp), f"grouped_agg_dense present differs ({what})")
    err = 0.0
    for k, g, w in zip(kinds, gouts, wouts):
        check(g.dtype == w.dtype, f"grouped_agg_dense {k} dtype ({what})")
        if g.dtype.is_floating_point and k in ("sum", "sumf"):
            d = (g - w).abs()
            tol = SUMF_RTOL * w.abs()
            check(bool((d <= tol).all()),
                  f"grouped_agg_dense {k} beyond rtol {SUMF_RTOL} ({what})")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        else:
            check(torch.equal(g, w), f"grouped_agg_dense {k} differs "
                  f"({what})")
    return err


# ---------------------------------------------------------------------------
# phase 3: the slice (and the numpy oracle)
# ---------------------------------------------------------------------------

def _days(iso):
    import numpy as np
    return int((np.datetime64(iso, "D")
                - np.datetime64("1970-01-01", "D")).astype(np.int64))


def oracle(li):
    """Q1 and Q6 rows computed with numpy from the generated lineitem,
    in the engine's storage units (decimals as scaled int64)."""
    import numpy as np
    qty = np.round(np.asarray(li["l_quantity"]) * 100).astype(np.int64)
    price = np.round(np.asarray(li["l_extendedprice"]) * 100).astype(np.int64)
    disc = np.round(np.asarray(li["l_discount"]) * 100).astype(np.int64)
    tax = np.round(np.asarray(li["l_tax"]) * 100).astype(np.int64)
    ship = np.asarray(li["l_shipdate"], np.int64)
    rf = np.asarray(li["l_returnflag"])
    ls = np.asarray(li["l_linestatus"])
    m = ship <= _days("1998-12-01") - 90
    q1 = []
    for f in sorted(set(rf[m].tolist())):
        for s in sorted(set(ls[m].tolist())):
            g = m & (rf == f) & (ls == s)
            c = int(g.sum())
            if not c:
                continue
            dp = price[g] * (100 - disc[g])
            ch = dp * (100 + tax[g])
            q1.append((f, s, int(qty[g].sum()) / 100,
                       int(price[g].sum()) / 100, int(dp.sum()) / 10**4,
                       int(ch.sum()) / 10**6,
                       float(qty[g].astype(np.float64).sum()) / c / 100,
                       float(price[g].astype(np.float64).sum()) / c / 100,
                       float(disc[g].astype(np.float64).sum()) / c / 100,
                       c))
    m6 = (ship >= _days("1994-01-01")) & (ship < _days("1995-01-01")) \
        & (disc >= 5) & (disc <= 7) & (qty < 2400)
    q6 = [(int((price[m6] * disc[m6]).sum()) / 10**4,)]
    return q1, q6


def rows_equal(got, want, what, approx=()):
    """Rows equal exactly, except the columns in `approx` (Q1's averages:
    the same exact f64 sum divided the same way, held to 1e-12)."""
    check(len(got) == len(want), f"{what}: {len(got)} rows, want "
          f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check(len(g) == len(w), f"{what} row {i}: arity")
        for j, (a, b) in enumerate(zip(g, w)):
            ok = abs(a - b) <= 1e-12 * abs(b) if j in approx else a == b
            check(ok, f"{what} row {i} col {j}: {a!r} != {b!r}")


def record_calls(K, names):
    """Wrap the kernels' module functions (as the executor reaches them)
    to record the arguments of each main-path call."""
    calls = {n: [] for n in names}
    originals = {n: getattr(K, n) for n in names}

    def wrap(n, fn):
        def rec(*a, **kw):
            calls[n].append((a, kw))
            return fn(*a, **kw)
        return rec
    for n in names:
        setattr(K, n, wrap(n, originals[n]))

    def restore():
        for n, fn in originals.items():
            setattr(K, n, fn)
    return calls, restore


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def time_fn(torch, fn, reps=20):
    """Device ms per call: CUDA events around `reps` calls, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def timed_calls(K, plain, name, a, kw):
    """(kernel call, plain call) that time one recorded main-path call.
    The sort is timed at its launch (K.sort_perm on the order words of
    the recorded keys) against sort_perm_plain on the same words, without
    the wrapper's word building and payload gather.  The other wrappers
    are the launch plus allocating its outputs (for grouped_agg_dense,
    setting the workspace to its identities on the card)."""
    if name == "sort_rows":
        words = K.order_words(a[0], a[1], a[3])
        return (lambda: K.sort_perm(words)), \
            (lambda: K.sort_perm_plain(words))
    return (lambda: getattr(K, name)(*a, **kw)), \
        (lambda: plain[name](*a, **kw))


def nbytes(t):
    return t.numel() * t.element_size()


def call_bytes_ops(name, a, out):
    """(bytes each input read once + each output written once, ops) of
    one kernel call, from this run's tensors."""
    if name == "visibility_mask":
        n = a[0].shape[0]
        return sum(nbytes(t) for t in a[:4]) + n, 8 * n
    if name in ("decode_column", "cmp_on_codes"):
        codes, aux = a[0], a[1]
        return nbytes(codes) + nbytes(aux) + nbytes(out), 2 * codes.shape[0]
    if name == "grouped_agg_dense":
        gid, valid, ins, g = a[0], a[1], a[2], int(a[3])
        n = gid.shape[0]
        by = nbytes(gid) + nbytes(valid) + sum(nbytes(t) for t in ins) \
            + (len(ins) + 1) * g * 8
        return by, n * (len(ins) + 1)
    if name == "sort_rows":
        keys, valid = a[0], a[1]
        n = valid.shape[0]
        m = 1
        while m < n:
            m <<= 1
        words = (1 + len(keys)) * n * 8
        lg = max(m.bit_length() - 1, 1)
        return words + n * 8, (m // 2) * lg * (lg + 1) // 2 * (2 + len(keys))
    raise KeyError(name)


def result_err(torch, got, want):
    """max |kernel - plain| over the outputs of one call."""
    if isinstance(got, torch.Tensor):
        if got.dtype == torch.bool:
            return float((got != want).sum())
        return float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
    err = 0.0
    for g, w in zip(got, want):
        err = max(err, result_err(torch, g, w))
    return err


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor (default 1: about 6.0 M "
                    "lineitem rows)")
    ap.add_argument("--profile", action="store_true",
                    help="also split warm Q1/Q6 into session phases and "
                    "profile one of each (torch.profiler)")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "opentenbase_tpu_torch")):
        print("chip_smoke: opentenbase_tpu_torch/ not found beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from opentenbase_tpu_torch.exec.session import LocalNode, Session
    from opentenbase_tpu_torch.ops import kernels as K
    from opentenbase_tpu_torch.tpch import datagen
    from opentenbase_tpu_torch.tpch.queries import Q
    from opentenbase_tpu_torch.tpch.schema import SCHEMA

    t_start = time.perf_counter()
    card = setup(torch)
    small_kernel_check(torch, K)

    # ---- the slice ----
    t0 = time.perf_counter()
    data = datagen.generate(sf=args.sf)
    t_gen = time.perf_counter() - t0
    n_li = len(data["lineitem"]["l_orderkey"])
    say(f"datagen sf={args.sf}: {t_gen:.1f} s ({n_li} lineitem rows)")
    node = LocalNode()                         # the card, by default
    check(node.device.type == DEVICE, f"node on {node.device}")
    s = Session(node)
    s.execute(SCHEMA)
    t0 = time.perf_counter()
    datagen.load_into(s, {"lineitem": data["lineitem"]}, ("lineitem",))
    t_load = time.perf_counter() - t0
    say(f"load lineitem: {t_load:.1f} s")
    want_q1, want_q6 = oracle(data["lineitem"])

    names = list(KERNEL_SOURCES)
    calls, restore = record_calls(K, names)
    K.reset_launches()
    t0 = time.perf_counter()
    got_q1 = s.query(Q[1])
    torch.cuda.synchronize()
    t_q1_cold = time.perf_counter() - t0
    q1_calls = {n: list(c) for n, c in calls.items()}
    for c in calls.values():
        c.clear()
    t0 = time.perf_counter()
    got_q6 = s.query(Q[6])
    torch.cuda.synchronize()
    t_q6_cold = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    q6_calls = {n: list(c) for n, c in calls.items()}
    restore()
    say(f"main path launches (Q1 + Q6): {json.dumps(launches)}")
    for n in names:
        check(launches[n] > 0, f"kernel {n} was not launched on the main "
              "path")
    rows_equal(got_q1, want_q1, "Q1", approx=(6, 7, 8))
    rows_equal(got_q6, want_q6, "Q6")
    check(len(got_q1) == 4 and all(np.isfinite(v) for r in got_q1
                                   for v in r[2:]), "Q1 result shape")
    say(f"Q1 = numpy oracle ({len(got_q1)} groups); Q6 = numpy oracle "
        f"(revenue {got_q6[0][0]})")
    say(f"cold (first, staging included): Q1 {t_q1_cold * 1e3:.1f} ms, "
        f"Q6 {t_q6_cold * 1e3:.1f} ms; staged "
        f"{node.cache.uploaded_bytes / 1e6:.1f} MB to the card")

    # ---- kernels against their plain versions, main-path inputs ----
    plain = {"visibility_mask": K.visibility_mask_plain,
             "decode_column": K.decode_column_plain,
             "cmp_on_codes": K.cmp_on_codes_plain,
             "grouped_agg_dense": K.grouped_agg_dense_plain,
             "sort_rows": K.sort_rows_plain}
    max_err = {n: 0.0 for n in names}
    for qcalls in (q1_calls, q6_calls):
        for n in names:
            for a, kw in qcalls[n]:
                got = getattr(K, n)(*a, **kw)
                want = plain[n](*a, **kw)
                torch.cuda.synchronize()
                if n == "grouped_agg_dense":
                    max_err[n] = max(max_err[n], compare_agg(
                        got, want, a[4], "main path"))
                    continue
                e = result_err(torch, got, want)
                check(e == 0.0, f"{n} differs from its plain version on "
                      f"a main-path call (max err {e})")
    say("kernels vs plain (main-path inputs): ok")

    # sort at 2^20 rows: three keys with ties, NaN and +-0.0, and a limit
    rng = np.random.default_rng(7)
    m = 1 << 20
    dev = torch.device(DEVICE)
    fk = rng.choice([-1.5, -0.0, 0.0, 2.0, np.nan, np.inf, -np.inf], m)
    big = (tuple(torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, 50, m).astype(np.int32), fk,
        rng.integers(-10**9, 10**9, m))),
        torch.from_numpy(rng.random(m) < 0.9).to(dev),
        (torch.arange(m, device=dev),), (False, True, False))
    got = K.sort_rows(*big)
    want = K.sort_rows_plain(*big)
    check(torch.equal(got[0][0], want[0][0]) and torch.equal(got[1], want[1]),
          "sort_rows differs from its plain version at 2^20 rows")
    got = K.sort_rows(*big, limit=100)
    want = K.sort_rows_plain(*big, limit=100)
    check(torch.equal(got[0][0], want[0][0]), "sort_rows limit differs")
    torch.cuda.synchronize()
    say("sort_rows at 2^20 rows (3 keys, NaN, +-0.0, limit) = plain: ok")

    # ---- times ----
    say(f"card: {card}")
    q1_ms = statistics.median(
        [_wall(torch, lambda: s.query(Q[1])) for _ in range(REPS)])
    q6_ms = statistics.median(
        [_wall(torch, lambda: s.query(Q[6])) for _ in range(REPS)])
    say(f"Q1 warm median {q1_ms:.2f} ms ({n_li / q1_ms / 1e3:.1f} Mrows/s), "
        f"Q6 warm median {q6_ms:.2f} ms ({n_li / q6_ms / 1e3:.1f} Mrows/s) "
        f"over {REPS} runs [{card}]")
    records = []
    for n in names:
        ms = pms = bytes_ = ops = 0.0
        for a, kw in q1_calls[n]:
            out = getattr(K, n)(*a, **kw)
            kernel_call, plain_call = timed_calls(K, plain, n, a, kw)
            ms += time_fn(torch, kernel_call)
            pms += time_fn(torch, plain_call)
            b, o = call_bytes_ops(n, a, out)
            bytes_ += b
            ops += o
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        lib_ms = _library_ms(torch, n, q1_calls[n])
        src, replaces = KERNEL_SOURCES[n]
        records.append({
            "name": n, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[n], "max_abs_err": max_err[n],
            "ms": ms, "plain_ms": pms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})
        say(f"kernel {n}: {len(q1_calls[n])} call(s) per Q1, "
            f"{ms:.4f} ms, plain {pms:.4f} ms, bound {max(t_bytes, t_ops):.4f}"
            f" ms ({bytes_ / 1e6:.1f} MB), library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'} [{card}]")
    # sort at 2^20 rows, one int64 key: the kernel against torch.sort
    key = torch.from_numpy(rng.integers(-10**12, 10**12, m)).to(dev)
    allv = torch.ones(m, dtype=torch.bool, device=dev)
    words = K.order_words((key,), allv, (False,))
    k_ms = time_fn(torch, lambda: K.sort_perm(words), reps=5)
    t_ms = time_fn(torch, lambda: torch.sort(key, stable=True), reps=5)
    check(torch.equal(K.sort_perm(words), torch.sort(key, stable=True)[1]),
          "sort_perm differs from torch.sort at 2^20 rows")
    say(f"sort 2^20 rows, one int64 key: kernel {k_ms:.3f} ms, torch.sort "
        f"{t_ms:.3f} ms, bound {3 * m * 8 / HBM_BYTES_PER_S * 1e3:.4f}"
        f" ms [{card}]")
    if args.profile:
        host_phases(torch, s, Q, card, REPS)
        profile_queries(torch, s, Q, card)
    say(f"phases: datagen {t_gen:.1f} s, load {t_load:.1f} s, total "
        f"{time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def host_phases(torch, s, Q, card, reps):
    """Warm Q1/Q6 split into the session's phases, medians over `reps`:
    parse + bind + plan, execute (to a synchronised device batch), and
    materialize (device -> host rows)."""
    from opentenbase_tpu_torch.exec.executor import (ExecContext, Executor,
                                                     materialize)
    from opentenbase_tpu_torch.sql.parser import parse_sql
    for q in (1, 6):
        plan, run, mat = [], [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            planned = s._plan_select(parse_sql(Q[q])[0])
            t1 = time.perf_counter()
            t = s._begin_implicit()
            ctx = ExecContext(s.node.stores, t.snapshot_ts, t.txid,
                              s.node.cache)
            batch = Executor(ctx).run(planned)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            materialize(batch, planned.output_names)
            t3 = time.perf_counter()
            plan.append(t1 - t0)
            run.append(t2 - t1)
            mat.append(t3 - t2)
        say(f"phases Q{q} (median of {reps}): parse+plan "
            f"{statistics.median(plan) * 1e3:.3f} ms, execute "
            f"{statistics.median(run) * 1e3:.3f} ms, materialize "
            f"{statistics.median(mat) * 1e3:.3f} ms [{card}]")


def profile_queries(torch, s, Q, card):
    """One warm Q1 and one warm Q6 under torch.profiler: device time by
    kernel and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for q in (1, 6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.query(Q[q])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for ev in prof.key_averages():
            # device-side events only (kernels, memcpy/memset): a CPU op's
            # self device time repeats the time of the kernels it launched
            if ev.device_type != DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((dev_us, ev.count, ev.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        say(f"profile Q{q}: wall {wall_us / 1e3:.3f} ms (profiler on), "
            f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%),"
            f" {sum(r[1] for r in rows)} device events [{card}]")
        for dev_us, count, key in rows[:12]:
            say(f"  {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")


def _wall(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _library_ms(torch, name, calls):
    """Time of one PyTorch call computing the same function on the same
    inputs, where one exists: the int widening `.to()` for a pack-family
    decode.  None for the others (no single call computes a visibility
    mask, a code-space compare, Q1's eleven mixed aggregates or a
    multi-key sort)."""
    if name != "decode_column" or not calls:
        return None
    total = 0.0
    for a, _kw in calls:
        if a[2] != "pack":
            return None
        total += time_fn(torch, lambda: a[0].to(a[1].dtype))
    return total


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
