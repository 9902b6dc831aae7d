"""Chip smoke test of the PyTorch/CUDA port (opentenbase_tpu_torch).

Drives the port's main paths on one CUDA card: CREATE the TPC-H schema,
bulk-load all eight tables at SF1 (6.0 M lineitem rows), then
- slice 1: TPC-H Q1 and Q6 through Session.query, checked against numpy
  oracles computed here from the generated arrays;
- slice 2: Q3 and Q5 (hash joins, late materialization, sort-based and
  dense GROUP BY), checked against numpy oracles, and Q4, Q13 and Q22
  (semi, left outer with a residual, anti joins), checked against the
  same queries run by the port on the CPU over the same tables (the
  plain versions, which the tests hold against the JAX package);
- slice 3, the cluster tier: the same SF1 data loaded into Cluster(2),
  two logical DataNodes on the card, and Q1, Q3 and Q5 through
  ClusterSession.query, checked against the numpy oracles, against the
  single-node Session on the card and against the same ClusterSession
  on its host tier (SET enable_mesh_exchange = off); the Q5-shaped SQL
  of __graft_entry__.dryrun_multichip on Cluster(3) (a shard map that
  is not hash % 3), device tier against host tier; and the port of
  parallel/mesh.py (redistribute, psum_partial) on 2 DataNodes;
- slice 7, the cluster program (K16): Q1, Q3 and Q5 on the same
  Cluster(2) and Q5 on a Cluster(4) loaded from the same data, the
  DataNode side of each one captured program (the fragments, the K12
  exchange in its fixed-capacity form, K3 at the gather class): one
  capture on the first call, then each warm call one graph replay with
  one host read (the size-class ladder's); rows against the oracles,
  the single-node Session and the host tier; the learned ladder, the
  count matrices, warm ms captured against eager in turns, the replay's
  device ms against the same body launched op by op, and the busy
  share;
- slice 4, the fused tier: Q1, Q6, Q3 and Q5 through Session.query, each
  fragment one captured program (CUDA graph; Q1 and Q6 through the fused
  scan-aggregate kernel), checked against the oracles and the eager tier,
  with captures, warm replays, host reads, graph pool bytes and fused
  versus eager warm times; the fused scan-aggregate kernel against its
  plain version at K = 1 and K = 16; and the serving tier: 16 client
  threads through Scheduler with the TPC-H substitution parameters of
  Q1, Q6 and Q3, every result against its serial Session result.
- slice 5, vector search: a 1 M x 128 f32 table (a 1000-cluster Gaussian
  mixture from the seed, ann-benchmarks SIFT1M's shape) with ids and 10
  categories through Session.query: exact l2 / cosine / ip top-10,
  filtered on the category, and a range count on the fused tier, against
  an f64 numpy oracle; CREATE INDEX ... USING ivfflat WITH (lists =
  1000) twice (identical centroids); 100 IVF queries (recall@10 >= 0.8,
  the kernel path's ids = the plain path's); IVF statements served
  through Scheduler; the same table on Cluster(2)'s host tier.
- slice 6, TPC-DS and window functions (K13): the 20 TPC-DS tables with
  store_sales at its SF1 size (2,880,400 rows, 9.7 M rows in all) in a
  LocalNode of its own; the 8 window queries, two more window
  statements (a moving min / max and lag over a grouped aggregate; rank
  and a ROWS-frame min over every store_sales row) and 63 of the 64 plain
  queries through Session.query on the default (fused) tier; the window
  statements and 8 plain queries against the port on the CPU over the
  same stores, the other 56 plain queries the same way at sf 72.01 in a
  second load (q85 runs there only: its many-to-many join outgrows the
  card at SF1 size); the 4 queries outside the slice (DISTINCT
  aggregates) raise; the 8 window queries on Cluster(2) (each as a
  cluster program) against the single node; warm ms of each window
  query, eager against the default tier, in turns, and their busy share.
- slice 15, Append and set operations: the 23 TPC-DS set-operation
  queries (UNION [ALL], ROLLUP, INTERSECT, EXCEPT) in the same load on
  the default tier, each against the port on the CPU over the same
  stores and again in the sf 72.01 load, with the kernel launches inside
  each Append (K9's TEXT remap, K3's pack) and SetOp (K5, K8, K9) by
  query, cold ms and warm ms eager against default in turns; the
  operators run again through the kernels and through their plain
  versions on the path's inputs, timed, with a bytes bound (the
  exec_setop and exec_append records).  In the check phase: INT / DATE
  min and max over no rows on the fused tier (K14), and
  tests/test_sql_surface.py's set-operation statements on the card's
  Session and on Cluster(2) as cluster programs.
The slices 1-3 phases run the eager tiers (Executor._fuse = False,
MeshRunner._capture = False), as before the fused tier and the cluster
program existed.
Around that it builds the CUDA kernels from opentenbase_tpu_torch/csrc,
holds each kernel against its plain PyTorch version on small inputs
(every branch; K10's radix sort on every case of its CPU model from 0
rows to 2^22 + 3, K6 on both of its branches, one sort and one join
build captured into a CUDA graph and replayed with new inputs; K13 at
K13b's scan tile edges, 3 tiles + 5 rows in partitions across every
tile boundary, all rows invalid, every argument NULL and 2^22 + 3 rows,
K13b captured and replayed with new inputs across a group of scan
tiles, its kernel launches and memsets a call from torch.profiler, an
f64 argument with NaN, +-inf and 1e300 in some partitions; K9's
masks at 1, 15, 16, 17 and
2^20 + 3 rows and on views offset by one element; K3 at its one-block
limit, pass and look-back tile edges, 1 to 17 and 129 columns, captured
and replayed, 1 launch a call (+ 1 memset above the limit; one each a
set of 128 columns); K9's compose_indices with 1 to 49 priors and null
masks, captured and replayed; K7 at the direct / search boundary, on
runs across blocks, an all-NULL build and probe keys at both ends of
int64, in every table form and with int64 slots, 2 launches a call;
K8 on an exact fit, 64 x the total, left outer with padding rows, all
counts 0, rows off its tile and one probe row with 2^20 matches (its
time against the plain version), at most 1 launch + 1 memset a call;
K5, eager and traced, on one group over 2^20 rows, every row its own
group at 2^21, groups past max_groups, f64 NaN / +-inf / +-0.0 and 40
aggregates, its f64 sums the same bits in two runs, 2 + K10's + 1
launches a call and no memset;
K4 on one group, Q1's shape, all rows invalid, 40 aggregates, group
counts on either side of its private / block and block / global edges,
f64 NaN / +-inf / +-0.0 on each branch and views offset by one element,
its private branch's f64 sums the same bits in two runs, 1 kernel + 1
memset a call (1 + 0 on one block, 2 + 0 on the block and global
branches); the Lloyd update on one
cluster holding 90% of the rows, runs of a tile +- 1 between empty
clusters, 7 and 200 dimensions, all rows invalid and one row, the same
bits in two runs, 2 kernels and no memset after the sort;
K12's fixed form on an empty and a 1-row source, rows at its tile's
multiples and one past, 1 and 64 destinations, region 1, every row to
one destination, 65 columns and 20 sources (each in the broadcast form
too), 1 kernel + 1 memset a call (one more kernel a column set);
K15a and K15d on rows with an infinite, a NaN (either sign) or a zero
component and a zero query (the same NaN rows as their plain
versions), K15b on NaN distances of both signs, +inf, -0.0 and ties up
to 2^20 + 3 rows against its plain version on the CPU and the NaN rule
(every NaN after +inf), 1 kernel + at most 1 memset a call, and the
card's Session on the `it` table, whose infinite row ranks last;
K15c exactly equal to its plain version on NaN, +-inf, 1e20, tied and
overflowing rows and centroids for all three metrics, and at its tile
edges (n, lists and dimensions around 128, 16 and the resident row
tile), its registers, spills and blocks an SM; an int window sum past
2^31 on the eager, fused and Cluster(2) tiers; GROUP BY, DISTINCT,
joins and window sums over double precision keys with NaN, +-inf, 1e300,
-0.0 and NULL on the eager, fused and Cluster(2) tiers against a Python
oracle) and
on the inputs the main paths gave it, shows from the
launch counters (set to 0 before each path, read after it) that each
path went through each of its kernels, and times the kernels, their
plain versions, a PyTorch library call where one computes the same
function, and the queries; for K13b, K9, K3, K12's fixed form and
K15b also the device-only time (the recorded calls captured into a
CUDA graph and replayed) and the
host time of a wrapper call, and the shapes of K3's and K9's compose
calls; K3's two forms (one block, look-back tiles) in turns on cluster
Q3's calls and in its recaptured program; K7, K15c, K8 and K5 also
device-only and host, and the graph nodes of each program's replay; K4
device-only, host and nodes a call on Q1's, Q6's (one group) and the
cluster program Q1's calls, the Lloyd update on every step of the first
index build (largest and median cluster beside each), each beside a
yardstick of the plain version's PyTorch calls (several calls, not one
library call).

Run from the repository root:  python3 chip_smoke.py  [--sf 1.0]
(--checks: only build the kernels and run the kernel checks, about half
a minute)
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
SUMF_RTOL = 1e-9                 # f64 sums: the plain versions'
#                                  index_add_ adds in another order
REPS = 5                         # warm query runs behind each median
DEVICE = "cuda"
# kernel -> (source, the reference kernel it replaces, the query whose
# main-path calls are timed: Qn on one DataNode, "cN" cluster QN, "mesh"
# the parallel/mesh.py path)
KERNEL_SOURCES = {
    "visibility_mask": ("opentenbase_tpu_torch/csrc/visibility.cu",
                        "opentenbase_tpu/ops/kernels.py:40", 1),
    "decode_column": ("opentenbase_tpu_torch/csrc/codec.cu",
                      "opentenbase_tpu/ops/kernels.py:55", 1),
    "cmp_on_codes": ("opentenbase_tpu_torch/csrc/codec.cu",
                     "opentenbase_tpu/ops/kernels.py:69", 1),
    "grouped_agg_dense": ("opentenbase_tpu_torch/csrc/grouped_agg.cu",
                          "opentenbase_tpu/ops/kernels.py:133", 1),
    "sort_rows": ("opentenbase_tpu_torch/csrc/sort.cu",
                  "opentenbase_tpu/ops/kernels.py:488", 1),
    "grouped_agg_sort": ("opentenbase_tpu_torch/csrc/groupsort.cu",
                         "opentenbase_tpu/ops/kernels.py:178", 3),
    "join_build": ("opentenbase_tpu_torch/csrc/join.cu",
                   "opentenbase_tpu/ops/kernels.py:306", 5),
    "join_probe_counts": ("opentenbase_tpu_torch/csrc/join.cu",
                          "opentenbase_tpu/ops/kernels.py:349", 5),
    "join_expand": ("opentenbase_tpu_torch/csrc/join.cu",
                    "opentenbase_tpu/ops/kernels.py:418", 5),
    "compose_index": ("opentenbase_tpu_torch/csrc/join.cu",
                      "opentenbase_tpu/ops/kernels.py:452", 5),
    "semi_mask": ("opentenbase_tpu_torch/csrc/join.cu",
                  "opentenbase_tpu/ops/kernels.py:463", 4),
    "anti_mask": ("opentenbase_tpu_torch/csrc/join.cu",
                  "opentenbase_tpu/ops/kernels.py:468", 22),
    "hash_columns": ("opentenbase_tpu_torch/csrc/hash.cu",
                     "opentenbase_tpu/utils/hashing.py:70", 5),
    "route_dest": ("opentenbase_tpu_torch/csrc/hash.cu",
                   "opentenbase_tpu/exec/mesh_exec.py:581", "c5"),
    "bucket_ids": ("opentenbase_tpu_torch/csrc/hash.cu",
                   "opentenbase_tpu/ops/kernels.py:509", "mesh"),
    "exchange": ("opentenbase_tpu_torch/csrc/exchange.cu",
                 "opentenbase_tpu/exec/mesh_exec.py:610", "c5"),
    "exchange_fixed": ("opentenbase_tpu_torch/csrc/exchange.cu",
                       "opentenbase_tpu/exec/mesh_exec.py:610", "m5"),
    "compact": ("opentenbase_tpu_torch/csrc/compact.cu",
                "opentenbase_tpu/ops/kernels.py:103", "c3"),
    "fused_scan_agg": ("opentenbase_tpu_torch/csrc/fused.cu",
                       "opentenbase_tpu/exec/fused.py:563", "f1"),
    "window_bounds": ("opentenbase_tpu_torch/csrc/window.cu",
                      "opentenbase_tpu/exec/executor.py:1523", "dsx2"),
    "window_frame_reduce": ("opentenbase_tpu_torch/csrc/window.cu",
                            "opentenbase_tpu/exec/executor.py:1733",
                            "dsx2"),
    "range_minmax": ("opentenbase_tpu_torch/csrc/window.cu",
                     "opentenbase_tpu/exec/executor.py:1765", "dsx2"),
}
# kernel (its launch counter) -> the wrapper the main path calls, where
# the two names differ: the executor composes a join side's indices in
# one compose_indices call
WRAPPERS = {"compose_index": "compose_indices"}


def wrapper_of(K, name):
    return getattr(K, WRAPPERS.get(name, name))


SLICE1 = ("visibility_mask", "decode_column", "cmp_on_codes",
          "grouped_agg_dense", "sort_rows")
SLICE1_QUERIES = (1, 6)
# the kernels slice 2's path must reach (Q3 and Q5 on the card, then Q4,
# Q13 and Q22)
SLICE2 = ("visibility_mask", "decode_column", "grouped_agg_dense",
          "grouped_agg_sort", "join_build", "join_probe_counts",
          "join_expand", "compose_index", "semi_mask", "anti_mask",
          "sort_rows", "hash_columns")
SLICE2_QUERIES = (3, 5, 4, 13, 22)
# slice 3, the cluster tier: every cluster query must reach the routing,
# exchange and compaction kernels; the path as a whole the others too
CLUSTER_KERNELS = ("route_dest", "exchange", "compact")
SLICE3 = CLUSTER_KERNELS + ("visibility_mask", "decode_column",
                            "grouped_agg_dense", "grouped_agg_sort",
                            "join_build", "join_probe_counts", "join_expand",
                            "compose_index", "sort_rows", "hash_columns")
SLICE3_QUERIES = ("c1", "c3", "c5")     # Q1, Q3, Q5 on Cluster(2)
MESH_LIBRARY = ("bucket_ids", "exchange", "grouped_agg_dense")
# slice 4, the fused tier: Q1, Q6, Q3, Q5 as captured programs
FUSED_QUERIES = ("f1", "f6", "f3", "f5")
SLICE4 = ("fused_scan_agg", "visibility_mask", "decode_column",
          "grouped_agg_dense", "grouped_agg_sort", "join_build",
          "join_probe_counts", "join_expand", "compose_index", "sort_rows",
          "hash_columns")
SERVE_THREADS = 16
SERVE_PER_THREAD = 4


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
    # every wrapper launches on the stream K._stream() names
    side = torch.cuda.Stream()
    for st in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(st):
            check(K._stream() == st.cuda_stream,
                  f"K._stream() {K._stream():#x}, current stream "
                  f"{st.cuda_stream:#x}")
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


# sizes of the sort checks: empty, tiny, the one-block path's edge
# (4096 rows) on both sides, powers of two +- 1, and the large sizes
SORT_SIZES = (0, 1, 2, 3, 4095, 4096, 4097, (1 << 16) - 1, (1 << 16) + 1,
              1 << 20, (1 << 22) + 3)


def sort_cases(torch, K, np, rng, n, dev):
    """(label, [w, n] int64 words) for every case of K10's radix sort:
    one key spread over +-1e12, all rows equal, heavy duplicates over
    three words, INT64_MIN and INT64_MAX in one word (span 2^64 - 1),
    float keys with NaN, +-0.0 and +-inf (ASC and DESC), K5's traced
    words with zero words (fast branch) and without (exact), the ~valid
    word all valid and all invalid, the Lloyd update's narrow word, and
    keys with a constant low or middle digit (skipped passes)."""
    i64 = np.iinfo(np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    valid = t(rng.random(n) < 0.85)
    allv = torch.ones(n, dtype=torch.bool, device=dev)
    nonev = torch.zeros(n, dtype=torch.bool, device=dev)
    wide = t(rng.integers(-10**12, 10**12, n))
    ext = t(rng.choice(np.array([i64.min, i64.max, 0, -1, 1, i64.min + 1,
                                 i64.max - 1], np.int64), n))
    fl = t(rng.choice([-1.5, -0.0, 0.0, 2.0, np.nan, -np.nan, np.inf,
                       -np.inf], n))
    narrow = tuple(t(rng.integers(0, m, n)) for m in (40, 30, 2))
    hashed = tuple(t(rng.integers(i64.min, i64.max, n, dtype=np.int64))
                   for _ in range(2))
    ow = K.order_words
    traced = [] if n == 0 else [
        ("traced K5 words, fast (zero words)",
         K._group_words_traced_plain(torch.stack(narrow), valid)),
        ("traced K5 words, exact", K._group_words_traced_plain(
            torch.stack(hashed), valid))]
    return traced + [
        ("one key +-1e12", ow((wide,), valid, (False,))),
        ("all rows equal", ow((t(np.full(n, 7)),), allv, (False,))),
        ("heavy duplicates", ow(tuple(t(rng.integers(0, 3, n))
                                      for _ in range(3)), valid,
                                (False, True, False))),
        ("int64 extremes", ow((ext,), valid, (True,))),
        ("floats NaN +-0 +-inf", ow((fl, fl), valid, (False, True))),
        ("~valid all valid", ow((wide,), allv, (False,))),
        ("~valid all invalid", ow((wide,), nonev, (False,))),
        ("Lloyd keys", torch.where(valid, t(rng.integers(0, 1000, n)),
                                   1000).unsqueeze(0).contiguous()),
        # a constant low digit, and a constant middle digit (its pass is
        # skipped between two that run: the buffer parity must hold)
        ("constant low digit", ow((t(rng.integers(0, 1 << 16, n) * 256),),
                                  allv, (False,))),
        ("constant middle digit", t(np.concatenate([[0], rng.integers(
            0, 256, max(n - 1, 0)) + (rng.integers(0, 256, max(n - 1, 0))
                                      << 16)])[:n]).unsqueeze(0)
         .contiguous()),
    ]


def sort_graph_inputs(torch, K, np, rng, n, dev):
    """Two input sets for one captured sort and join build whose plans
    differ: the active passes (hence the buffer parity) and the join's
    branch (fast, then exact)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    i64 = np.iinfo(np.int64)
    allv = torch.ones(n, dtype=torch.bool, device=dev)
    valid = t(rng.random(n) < 0.8)
    a = K.order_words((t(rng.integers(-10**12, 10**12, n)),), allv, (False,))
    b = K.order_words((t(rng.integers(0, 300, n)),), valid, (True,))
    ja = (t(rng.integers(0, n // 3 + 1, n)), valid)
    jb = (t(rng.integers(i64.min, i64.max, n, dtype=np.int64)),
          t(rng.random(n) < 0.6))
    return [(a, ja), (b, jb)]


def sort_kernel_check(torch, K):
    """K10's radix sort against sort_perm_plain on every case at every
    size of SORT_SIZES (and its sorted first word against a gather), K6
    against join_build_plain on both branches and the reference probe,
    then one sort_perm and one join_build captured into a CUDA graph and
    replayed twice with new inputs copied in (a plan or parity word that
    is not reset shows there)."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(9)
    checked = 0
    for n in SORT_SIZES:
        for label, words in sort_cases(torch, K, np, rng, n, dev):
            got = K.sort_perm(words)
            want = K.sort_perm_plain(words)
            torch.cuda.synchronize()
            check(got.shape == (n,) and torch.equal(got, want),
                  f"sort_perm differs from plain ({label}, {n} rows)")
            if words.shape[0] > 0:
                perm, first = K._sort_launch(words, "sort_rows", first=True)
                check(torch.equal(perm, want)
                      and torch.equal(first, words[0].index_select(0, want)),
                      f"sorted first word differs ({label}, {n} rows)")
            checked += 1
    imax = np.iinfo(np.int64).max
    probe = (np.array([7, imax, imax - 3, imax - 1], np.int64),
             np.array([False, True, True, True]))
    for n in (4, 3000, 5000, 1 << 18):
        cases = [probe] if n == 4 else [
            (rng.integers(-100, n // 3, n).astype(np.int64),
             rng.random(n) < 0.85),
            (rng.integers(np.iinfo(np.int64).min, imax, n, dtype=np.int64),
             rng.random(n) < 0.85),
            (np.full(n, imax, np.int64), rng.random(n) < 0.5)]
        for bk, bv in cases:
            tk, tv = torch.from_numpy(bk).to(dev), torch.from_numpy(bv).to(dev)
            got = K.join_build(tk, tv)
            want = K.join_build_plain(tk, tv)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"join_build differs from plain ({n} rows)")
    check(K.join_build_plain(*(torch.from_numpy(x).to(dev) for x in probe)
                             )[1].tolist() == [2, 3, 1, 0],
          "join_build_plain's perm on the reference probe")
    # captured: one sort and one build, replayed with new inputs
    for n in (3000, 1 << 20):
        sets = sort_graph_inputs(torch, K, np, rng, n, dev)
        words = sets[0][0].clone()
        jk, jv = sets[0][1][0].clone(), sets[0][1][1].clone()
        K.sort_perm(words)
        K.join_build(jk, jv)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with K.capture_launches() as tally:
            with torch.cuda.graph(g):
                perm = K.sort_perm(words)
                sk, jp = K.join_build(jk, jv)
        for rep, (w2, (k2, v2)) in enumerate(reversed(sets)):
            words.copy_(w2)
            jk.copy_(k2)
            jv.copy_(v2)
            g.replay()
            torch.cuda.synchronize()
            check(torch.equal(perm, K.sort_perm_plain(w2)),
                  f"captured sort_perm differs on replay {rep} ({n} rows)")
            wk, wp = K.join_build_plain(k2, v2)
            check(torch.equal(sk, wk) and torch.equal(jp, wp),
                  f"captured join_build differs on replay {rep} ({n} rows)")
        check(tally.get("sort_rows") == 1 and tally.get("join_build") == 1,
              f"capture tally {tally}")
        del g
    torch.cuda.synchronize()
    say(f"sort_perm = plain on {checked} cases x sizes {SORT_SIZES}; "
        "join_build = plain (both branches, the reference probe); "
        "captured sort + build replayed with new inputs: ok")


def sort_measure(torch, K, card, build_sizes=()):
    """K10 at 2^20 one-key (+-1e12) words against torch.sort(stable=True)
    and the bytes bound; the one-block path at 4096 rows against the
    multi-block path at 4097; K6 at the given build sizes on a dense key
    (fast branch) and a hashed full-range key (exact branch) against
    torch.sort(stable=True) of the masked keys."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(21)
    m = 1 << 20
    key = torch.from_numpy(rng.integers(-10**12, 10**12, m)).to(dev)
    allv = torch.ones(m, dtype=torch.bool, device=dev)
    words = K.order_words((key,), allv, (False,))
    k_ms = time_fn(torch, lambda: K.sort_perm(words), reps=20)
    t_ms = time_fn(torch, lambda: torch.sort(key, stable=True), reps=20)
    check(torch.equal(K.sort_perm(words), torch.sort(key, stable=True)[1]),
          "sort_perm differs from torch.sort at 2^20 rows")
    say(f"sort 2^20 rows, one int64 key: kernel {k_ms:.4f} ms, torch.sort "
        f"{t_ms:.4f} ms, bound {3 * m * 8 / HBM_BYTES_PER_S * 1e3:.4f}"
        f" ms [{card}]")
    for n in (1024, 4096, 4097, 16384):
        w = K.order_words((torch.from_numpy(rng.integers(-10**12, 10**12, n))
                           .to(dev),), torch.from_numpy(rng.random(n) < 0.9)
                          .to(dev), (False,))
        ms = time_fn(torch, lambda: K.sort_perm(w), reps=50)
        say(f"sort {n} rows, 2 words ({'one block' if n <= 4096 else 'multi-block'}"
            f"): {ms:.4f} ms [{card}]")
    for n in build_sizes:
        valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        for label, hi in (("dense", n), ("hashed", None)):
            keys = torch.from_numpy(
                rng.integers(0, hi, n) if hi else rng.integers(
                    np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                    dtype=np.int64)).to(dev)
            masked = torch.where(valid, keys, K.INT64_MAX)
            b_ms = time_fn(torch, lambda: K.join_build(keys, valid), reps=20)
            l_ms = time_fn(torch, lambda: torch.sort(masked, stable=True),
                           reps=20)
            got = K.join_build(keys, valid)
            want = K.join_build_plain(keys, valid)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"join_build differs ({label}, {n} rows)")
            say(f"join_build {n} rows, {label} key: kernel {b_ms:.4f} ms, "
                f"torch.sort(stable=True) {l_ms:.4f} ms, bound "
                f"{(9 * n + 16 * n) / HBM_BYTES_PER_S * 1e3:.4f} ms [{card}]")


def join_cases(np, rng, n):
    """Build / probe inputs that take each branch of the probe: dense
    keys (the direct table) and keys spread over int64 (binary search),
    with NULL keys (INT64_MAX), invalid rows and duplicates."""
    imax = np.iinfo(np.int64).max
    bvalid = rng.random(n) < 0.85
    dense = rng.integers(-100, n // 3, n).astype(np.int64)
    sparse = rng.integers(-10**15, 10**15, n).astype(np.int64)
    sparse[::13] = imax
    m = 4 * n
    pvalid = rng.random(m) < 0.9
    pdense = rng.integers(-200, n // 3 + 100, m).astype(np.int64)
    psparse = rng.choice(sparse, m)
    psparse[::5] = rng.integers(-10**15, 10**15, len(psparse[::5]))
    psparse[::17] = imax
    return [(dense, bvalid, pdense, pvalid, True),
            (sparse, bvalid, psparse, pvalid, False)]


def compare_probe(torch, got, want, what):
    """Counts equal; lo equal where a row has a match (lo of a row
    without one is unspecified)."""
    check(torch.equal(got[1], want[1]), f"join_probe_counts counts differ "
          f"({what})")
    hit = want[1] > 0
    check(torch.equal(got[0][hit], want[0][hit]),
          f"join_probe_counts lo differs ({what})")


def compare_expand(torch, got, want, what):
    check(int(got[2]) == int(want[2]), f"join_expand total differs ({what})")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"join_expand pairs differ ({what})")


def compare_group(torch, got, want, kinds, what):
    """Group keys, counts, ints exact; f64 sums within SUMF_RTOL."""
    (gk, go, gn), (wk, wo, wn) = got, want
    check(int(gn) == int(wn), f"grouped_agg_sort n_groups ({what})")
    for g, w in zip(gk, wk):
        eq = (g == w) | (torch.isnan(g) & torch.isnan(w)) \
            if g.dtype.is_floating_point else g == w
        check(g.dtype == w.dtype and bool(eq.all()),
              f"grouped_agg_sort keys differ ({what})")
    err = 0.0
    for k, g, w in zip(kinds, go, wo):
        check(g.dtype == w.dtype, f"grouped_agg_sort {k} dtype ({what})")
        if g.dtype.is_floating_point and k in ("sum", "sumf"):
            # a non-finite sum (NaN, or inf) is the same value exactly
            fin = torch.isfinite(w)
            d = torch.where(fin, (g - w).abs(), torch.zeros_like(w))
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            check(bool(torch.where(fin, d <= SUMF_RTOL * w.abs(),
                                   same).all()),
                  f"grouped_agg_sort {k} beyond rtol {SUMF_RTOL} ({what})")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        else:
            eq = (g == w) | (torch.isnan(g) & torch.isnan(w)) \
                if g.dtype.is_floating_point else g == w
            check(bool(eq.all()), f"grouped_agg_sort {k} differs ({what})")
    return err


GROUP_KINDS = ("sum", "sum", "sumf", "count", "min", "max", "min", "max",
               "sum")


def group_cases(np, rng, n):
    """Key sets for each branch of grouped_agg_sort: packed (three
    narrow keys), exact with a wrapping packed word (two full-range
    keys), exact with one hashed key, floats with NaN / +-0.0 and a
    null-flag key, and no valid row."""
    imax = np.iinfo(np.int64)
    valid = rng.random(n) < 0.85
    a = rng.integers(imax.min, imax.max, 40, dtype=np.int64)
    f = rng.choice([-1.5, -0.0, 0.0, 2.0, np.nan, -np.nan, np.inf], n)
    nm = rng.random(n) < 0.2
    return [
        ((rng.integers(0, 40, n), rng.integers(8000, 8030, n).astype(
            np.int32), rng.integers(0, 2, n)), valid),
        ((rng.choice(a, n), rng.choice(a[:5], n)), valid),
        ((rng.integers(imax.min, imax.max, n, dtype=np.int64) | 1,), valid),
        ((f, np.where(nm, 0, rng.integers(0, 4, n)), nm.astype(np.int64)),
         valid),
        ((rng.integers(0, 4, n),), np.zeros(n, bool)),
    ]


def join_kernel_check(torch, K):
    """The join, group-by and hash kernels on small and large inputs,
    every branch, against their plain versions."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    imin, imax = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    for n in (1000, (1 << 20) + 7):
        cols = [rng.integers(imin, imax, n, dtype=np.int64, endpoint=True),
                rng.integers(-50, 50, n), rng.integers(0, 9, n)]
        for k in (1, 2, 3):
            tc = [t(c) for c in cols[:k]]
            check(torch.equal(K.hash_columns(tc), K.hash_columns_plain(tc)),
                  f"hash_columns differs ({k} columns, {n} rows)")
    for n in (1000, (1 << 18) + 5):
        for bk, bv, pk, pv, direct in join_cases(np, rng, n):
            what = f"{'direct' if direct else 'search'}, {n} build rows"
            got = K.join_build(t(bk), t(bv))
            want = K.join_build_plain(t(bk), t(bv))
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"join_build differs ({what})")
            sk, perm = got
            lo, cnt = K.join_probe_counts(sk, t(pk), t(pv))
            compare_probe(torch, (lo, cnt),
                          K.join_probe_counts_plain(sk, t(pk), t(pv)), what)
            for outer, pvt in ((False, None), (True, t(pv)), (True, None)):
                eff = torch.clamp(cnt, min=1) if outer else cnt
                if pvt is not None:
                    eff = torch.where(pvt, eff, 0)
                size = int(eff.sum()) + 100
                compare_expand(
                    torch, K.join_expand(lo, cnt, perm, size, outer, pvt),
                    K.join_expand_plain(lo, cnt, perm, size, outer, pvt),
                    f"{what}, left_outer={outer}")
            take = t(rng.integers(0, n, 3 * n))
            check(torch.equal(K.compose_index(perm, take),
                              K.compose_index_plain(perm, take)),
                  f"compose_index differs ({what})")
            check(torch.equal(K.semi_mask(cnt), K.semi_mask_plain(cnt)),
                  f"semi_mask differs ({what})")
            check(torch.equal(K.anti_mask(cnt, t(pv)),
                              K.anti_mask_plain(cnt, t(pv))),
                  f"anti_mask differs ({what})")
        allv = np.zeros(n, bool)
        got = K.join_build(t(bk), t(allv))
        want = K.join_build_plain(t(bk), t(allv))
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              "join_build differs (no valid row)")
        compare_probe(torch, K.join_probe_counts(got[0], t(pk), t(pv)),
                      K.join_probe_counts_plain(got[0], t(pk), t(pv)),
                      "no valid build row")
    for n in (700, 100_000):
        ins = (rng.integers(-1000, 1000, n).astype(np.int32),
               rng.integers(-10**12, 10**12, n), rng.normal(0, 1e3, n))
        ins = tuple(t(x) for x in (ins[0], ins[1], ins[2], ins[1], ins[0],
                                   ins[1], ins[2], ins[2], ins[2]))
        for i, (keys, valid) in enumerate(group_cases(np, rng, n)):
            tk = tuple(t(k) for k in keys)
            args = (tk, t(valid), ins, 1 << (n - 1).bit_length(),
                    GROUP_KINDS)
            compare_group(torch, K.grouped_agg_sort(*args),
                          K.grouped_agg_sort_plain(*args), GROUP_KINDS,
                          f"case {i}, {n} rows")
            # the traced form (no host read): the same groups in the same
            # order as the eager form, and as its plain version
            traced = K.grouped_agg_sort(*args, traced=True)
            compare_group(torch, traced,
                          K.grouped_agg_sort_plain(*args, traced=True),
                          GROUP_KINDS, f"traced, case {i}, {n} rows")
            compare_group(torch, traced, K.grouped_agg_sort_plain(*args),
                          GROUP_KINDS, f"traced vs eager, case {i}, {n} rows")
    mask_check(torch, K, np, rng, t)
    # visibility with the snapshot and txid in device memory
    cols = [t(rng.integers(0, 5, 5000).astype(np.int64)) for _ in range(4)]
    snap = torch.tensor(3, dtype=torch.int64, device=dev)
    txid = torch.tensor(2, dtype=torch.int64, device=dev)
    check(torch.equal(K.visibility_mask(*cols, snap, txid, 4),
                      K.visibility_mask_plain(*cols, 3, 2, 4)),
          "visibility_mask with device snapshot differs")
    torch.cuda.synchronize()
    say("join / group-by / hash kernels vs plain (both branches, small and "
        "large inputs): ok")


def probe_cases(np, rng):
    """(label, sorted build keys, probe keys, probe valid, branch) at K7's
    edges: live keys spanning T - 1 (direct) and T (search), T = max(2 nb,
    np); one key repeated over many blocks of rows; runs of 200-700 rows
    across block boundaries on both branches; an all-INT64_MAX build;
    probe keys at INT64_MIN and INT64_MAX (and one inside) on both."""
    imin, imax = np.iinfo(np.int64).min, np.iinfo(np.int64).max

    def probes(keys, m, lo, hi):
        pk = np.concatenate([rng.choice(keys, m // 2),
                             rng.integers(lo, hi, m - m // 2)])
        pk[:6] = (imin, imax, imin + 1, imax - 1, 0, -1)
        rng.shuffle(pk[6:])
        return pk.astype(np.int64), rng.random(m) < 0.9

    out = []
    nb, m, tail = 5000, 4000, 300
    T = max(2 * nb, m)
    for span, direct in ((T - 1, True), (T, False)):
        live = np.sort(rng.integers(-1234, -1234 + span + 1, nb - tail))
        live[0], live[-1] = -1234, -1234 + span
        sk = np.concatenate([np.sort(live), np.full(tail, imax)])
        out.append((f"span T{'' if span == T else ' - 1'}", sk,
                    *probes(live, m, -2000, span), direct))
    hot = np.sort(np.concatenate([np.full(150_000, 7),
                                  rng.integers(0, 100_000, 50_000)]))
    out.append(("one key over 586 blocks of rows", hot,
                *probes(hot, 300_000, -5, 100_005), True))
    runs = np.repeat(np.cumsum(rng.integers(1, 4, 800)),
                     rng.integers(200, 701, 800))
    out.append(("runs of 200-700 rows", runs,
                *probes(runs, 100_000, -5, int(runs[-1]) + 5), True))
    sparse = runs * 10**12 - 7
    out.append(("runs of 200-700 rows, sparse", sparse,
                *probes(sparse, 100_000, -10**15, 10**15), False))
    out.append(("no live key", np.full(1000, imax),
                *probes(np.arange(5), 3000, -5, 5), False))
    ends = np.sort(np.concatenate([[imin, imin + 1, imax - 1], rng.integers(
        imin // 2, imax // 2, 2000)]))
    out.append(("keys at both ends of int64", ends,
                *probes(ends, 6000, imin, imax), False))
    return out


def probe_kernel_check(torch, K):
    """K7 against join_probe_counts_plain (counts equal, lo equal where a
    row matches) on probe_cases, with int32 and with int64 table slots
    (probe_counts_cuda asked for them; join_probe_counts takes them from
    2^31 build rows on); the branch each case takes checked with the
    plain rule; the kernel launches and memsets a call (graph nodes):
    2 + 0."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(12)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    imax = np.iinfo(np.int64).max
    cases = probe_cases(np, rng)
    for label, sk, pk, pv, direct in cases:
        live = sk[sk != imax]
        T = max(2 * len(sk), len(pk))
        took = bool(len(live)) and int(live[-1]) - int(sk[0]) < T
        check(took == direct, f"probe case {label}: the direct branch "
              f"is {took}, want {direct}")
        tsk, tpk, tpv = t(sk), t(pk), t(pv)
        want = K.join_probe_counts_plain(tsk, tpk, tpv)
        compare_probe(torch, K.join_probe_counts(tsk, tpk, tpv), want,
                      f"{label}, int32 slots")
        compare_probe(torch, K.probe_counts_cuda(tsk, tpk, tpv, True), want,
                      f"{label}, int64 slots")
    label, sk, pk, pv, _d = cases[2]
    tsk, tpk, tpv = t(sk), t(pk), t(pv)
    launches = kernel_launches(
        torch, lambda: K.join_probe_counts(tsk, tpk, tpv))
    check(launches == (2, 0), f"join_probe_counts: {launches[0]} launches, "
          f"{launches[1]} memsets a call, want (2, 0)")
    torch.cuda.synchronize()
    say(f"K7 join_probe_counts vs plain ({len(cases)} edge cases: span T - 1 "
        "and T, one key over 586 blocks, runs across blocks on both "
        "branches, an all-INT64_MAX build, probe keys at INT64_MIN and "
        "INT64_MAX; int32 and int64 slots): ok; kernel launches + memsets "
        f"a call: {launches[0]} + {launches[1]}")


def expand_cases(np, rng):
    """(label, lo, counts, perm, out_size, left_outer, probe_valid) at
    K8's edges: one probe row with 2^20 matches among short rows (skew);
    all-zero counts with out_size > 0; an exact fit; out_size far past
    the total (the traced class); left outer with padding rows; probe
    rows that are not a multiple of the 4096-row tile."""
    nb = (1 << 20) + 4099
    perm = rng.permutation(nb)
    out = []
    for np_ in (4096 * 25 + 77, 4096 * 3):
        cnt = np.where(rng.random(np_) < 0.4, rng.integers(1, 6, np_), 0)
        lo = np.where(cnt > 0, rng.integers(0, nb - 6, np_), 0)
        pv = rng.random(np_) < 0.9
        pv[-1000:] = False
        eff = np.where(pv, np.maximum(cnt, 1), 0)
        out += [
            (f"{np_} rows, exact fit", lo, cnt, perm, int(cnt.sum()), False,
             None),
            (f"{np_} rows, out_size 64 x the total", lo, cnt, perm,
             64 * int(cnt.sum()), False, None),
            (f"{np_} rows, left outer with padding rows", lo, cnt, perm,
             int(eff.sum()) + 4097, True, pv),
            (f"{np_} rows, left outer, exact fit", lo, cnt, perm,
             int(eff.sum()), True, pv),
            (f"{np_} rows, all counts 0", lo, np.zeros(np_, np.int64), perm,
             5000, False, None),
        ]
    np_ = 200_003
    cnt = np.where(rng.random(np_) < 0.3, rng.integers(1, 4, np_), 0)
    lo = np.where(cnt > 0, rng.integers(0, nb - 4, np_), 0)
    cnt[123_457], lo[123_457] = 1 << 20, 0
    out.append(("skew: one probe row with 2^20 matches", lo, cnt, perm,
                int(cnt.sum()) + 1000, False, None))
    return out


def expand_kernel_check(torch, K, card):
    """K8 against join_expand_plain, exactly (total, pairs, (0, 0) past
    the total), on expand_cases; the kernel and memset nodes of one call
    (at most 1 + 1); the skewed case's time against its plain version."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(13)

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dev)
    cases = expand_cases(np, rng)
    for label, lo, cnt, perm, size, outer, pv in cases:
        a = (t(lo), t(cnt), t(perm), size, outer, t(pv))
        compare_expand(torch, K.join_expand(*a), K.join_expand_plain(*a),
                       label)
    label, lo, cnt, perm, size, outer, pv = cases[-1]
    a = (t(lo), t(cnt), t(perm), size, outer, t(pv))
    skew_ms = time_fn(torch, lambda: K.join_expand(*a), reps=5)
    skew_plain = time_fn(torch, lambda: K.join_expand_plain(*a), reps=5)
    launches = kernel_launches(torch, lambda: K.join_expand(*a))
    check(launches[0] <= 1 and launches[1] <= 1,
          f"join_expand: {launches[0]} launches, {launches[1]} memsets a "
          "call, want at most 1 + 1")
    torch.cuda.synchronize()
    say(f"K8 join_expand vs plain ({len(cases)} edge cases: exact fit, "
        "64 x the total, left outer with padding rows, all counts 0, "
        "rows off the tile, one probe row with 2^20 matches): ok; kernel "
        f"launches + memsets a call: {launches[0]} + {launches[1]}; the "
        f"skewed call ({len(lo)} probe rows, {int(cnt.sum())} pairs) "
        f"{skew_ms:.4f} ms, plain {skew_plain:.4f} ms [{card}]")


def group_edge_cases(np, rng):
    """(label, keys, valid, inputs, kinds, max_groups) at K5's edges: one
    group over 2^20 sorted rows; every row its own group at 2^21; more
    groups than max_groups; f64 sum, min and max over NaN, +-inf and
    +-0.0; 40 aggregates (two reduce launches)."""
    n = (1 << 20) + 5000
    big = np.where(np.arange(n) < (1 << 20), 7, rng.integers(0, 900, n))
    vals = rng.normal(0, 1e3, n)
    ints = rng.integers(-10**9, 10**9, n)
    m = 1 << 21
    nf = rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.25], 70000)
    nk = rng.integers(0, 5000, 70000)
    nk[:300] = -1
    nf[:300] = -0.0
    return [
        ("one group over 2^20 rows", (big,), rng.random(n) < 0.97,
         (vals, ints, vals, vals, ints), ("sumf", "sum", "min", "max",
                                          "count"), 1 << 11),
        ("every row its own group, 2^21 rows", (rng.permutation(m),),
         np.ones(m, bool), (rng.normal(0, 1, m),), ("sumf",), m),
        ("groups past max_groups", (rng.integers(0, 5000, 70000),
                                    rng.integers(0, 3, 70000).astype(
                                        np.int32)),
         rng.random(70000) < 0.9, (nf, nk), ("sumf", "count"), 1000),
        ("f64 NaN, +-inf, +-0.0", (nk,), np.ones(70000, bool),
         (nf, nf, nf, nf), ("sumf", "sum", "min", "max"), 8192),
        ("40 aggregates", (nk,), np.ones(70000, bool),
         (nk, nf) * 20, ("sum", "max") * 20, 8192),
    ]


def group_kernel_check(torch, K, card):
    """K5 against grouped_agg_sort_plain, eager and traced, on
    group_edge_cases (keys, counts and ints exact, f64 sums within
    SUMF_RTOL); the f64 sums of the 2^20-row group twice, bit for bit;
    the kernel and memset nodes of one call (2 + K10's + 1 a set of 32
    aggregates, no memset)."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(14)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = group_edge_cases(np, rng)
    for label, keys, valid, ins, kinds, mg in cases:
        a = (tuple(t(k) for k in keys), t(valid), tuple(t(x) for x in ins),
             mg, kinds)
        for traced in (False, True):
            compare_group(torch, K.grouped_agg_sort(*a, traced=traced),
                          K.grouped_agg_sort_plain(*a, traced=traced), kinds,
                          f"{label}, traced={traced}")
        if label.startswith("one group"):
            runs = [K.grouped_agg_sort(*a)[1][0] for _ in range(2)]
            check(torch.equal(runs[0].view(torch.int64),
                              runs[1].view(torch.int64)),
                  "grouped_agg_sort: f64 sums differ between two runs")
            big = a
    nodes = {}
    for label, a in (("2^20 + 5000 rows, 5 aggregates", big),
                     ("4096 rows", ((big[0][0][:4096],), big[1][:4096],
                                    (big[2][0][:4096],), 64, ("sumf",)))):
        nodes[label] = kernel_launches(
            torch, lambda a=a: K.grouped_agg_sort(*a))
        want = (2 + (3 if a[1].shape[0] > 4096 else 1) + 1, 0)
        check(nodes[label] == want, f"grouped_agg_sort {label}: "
              f"{nodes[label]} launches + memsets a call, want {want}")
    torch.cuda.synchronize()
    say(f"K5 grouped_agg_sort vs plain, eager and traced ({len(cases)} edge "
        "cases: one group over 2^20 rows, every row its own group at 2^21, "
        "groups past max_groups, f64 NaN / +-inf / +-0.0, 40 aggregates): "
        "ok; f64 sums the same bits in two runs; kernel launches + memsets "
        "a call: " + ", ".join(f"{k} {v[0]} + {v[1]}"
                               for k, v in nodes.items()) + f" [{card}]")


def k4_branch_edges(K, n, k):
    """(first group count on the block branch, first on the global one) of
    K4 at n rows and k aggregates, from the library's own plan."""
    lib = K._lib()

    def first(want):
        lo, hi = 1, 1 << 20
        while lo < hi:
            mid = (lo + hi) // 2
            if lib.otbt_grouped_agg_dense_branch(n, mid, k) >= want:
                hi = mid
            else:
                lo = mid + 1
        return lo
    return first(1), first(2)


K4_BRANCHES = ("private", "block", "global")


class K4Tally:
    """Every K4 launch of the main path, by path and branch: wraps
    K.grouped_agg_dense (as the executor reaches it) and asks the
    library which branch each launch of a call takes (one a set of 32
    aggregates), captured calls included.  Keeps the first call made
    outside capture of each (rows, groups, aggregates) shape that takes
    the block branch, for block_vs_global.  `path` names the phase
    running; restore() unwraps."""

    def __init__(self, K):
        import threading
        self.K = K
        self.path = "setup"
        self.by_path = {}      # path -> {branch: launches}
        self.shapes = {}       # (branch, rows, groups, aggregates) -> launches
        self.block_calls = {}  # (rows, groups, aggregates) -> (a, kw)
        self.lock = threading.Lock()
        self.orig = K.grouped_agg_dense
        K.grouped_agg_dense = self._call

    def _call(self, *a, **kw):
        import torch
        gid, g, kinds = a[0], int(a[3]), tuple(a[4])
        if gid.is_cuda:
            n = gid.shape[0]
            lib = self.K._lib()
            keep = not torch.cuda.is_current_stream_capturing()
            for lo in range(0, max(len(kinds), 1), 32):
                k = len(kinds[lo:lo + 32])
                br = K4_BRANCHES[lib.otbt_grouped_agg_dense_branch(n, g, k)]
                with self.lock:
                    c = self.by_path.setdefault(self.path, {})
                    c[br] = c.get(br, 0) + 1
                    key = (br, n, g, k)
                    self.shapes[key] = self.shapes.get(key, 0) + 1
                    if (br == "block" and keep and len(kinds) <= 32
                            and (n, g, k) not in self.block_calls):
                        self.block_calls[(n, g, k)] = (a, kw)
        return self.orig(*a, **kw)

    def restore(self):
        self.K.grouped_agg_dense = self.orig

    def report(self, card):
        say("K4 launches by path and branch (every call, captured ones "
            "included): " + json.dumps(self.by_path))
        say("K4 launch shapes (branch, rows, groups, aggregates: "
            "launches): " + "; ".join(
                f"{b} {n} x {g} x {k}: {c}"
                for (b, n, g, k), c in sorted(self.shapes.items())))


def block_vs_global(torch, K, tally, card, most=8):
    """The block branch against the global one on the main path's own
    calls: each kept block-branch shape (the `most` largest by rows x
    aggregates) timed device-only in turns (block, global, global,
    block, 4 a side) against the same call with num_groups raised to the
    first group count of the global branch at its rows and aggregates
    (the rows fold into the same slots; the global branch's init writes
    the extra identities, (k + 1) x the added groups words).  The global
    call's first num_groups outputs are held against the block call's
    (ints exact, f64 sums within SUMF_RTOL).  [{shape, ms}]."""
    lib = K._lib()
    kept = sorted(tally.block_calls.items(),
                  key=lambda kv: -kv[0][0] * max(kv[0][2], 1))[:most]
    out = []
    for (n, g, k), (a, kw) in kept:
        _e1, e2 = k4_branch_edges(K, n, k)
        check(lib.otbt_grouped_agg_dense_branch(n, e2, k) == 2 and e2 > g,
              f"block_vs_global: no global group count above {g}")
        b = (a[0], a[1], a[2], e2, a[4])
        got = K.grouped_agg_dense(*a, **kw)
        outs_g, pres_g = K.grouped_agg_dense(*b, **kw)
        compare_agg(got, ([o[:g] for o in outs_g], pres_g[:g]), a[4],
                    f"K4 block against global, {n} x {g} x {k}")
        sides = {"block": lambda: K.grouped_agg_dense(*a, **kw),
                 "global": lambda: K.grouped_agg_dense(*b, **kw)}
        ms = {s: [] for s in sides}
        for r in range(4):
            for s in (("block", "global") if r % 2 == 0
                      else ("global", "block")):
                ms[s].append(graph_device_ms(torch, sides[s]))
        out.append({"rows": n, "groups": g, "aggregates": k,
                    "global_groups": e2, "device_ms": ms})
        say(f"K4 {n} rows x {g} groups x {k} aggregates: device-only block "
            + " ".join(f"{x:.4f}" for x in ms["block"]) + ", global ("
            f"{e2} groups) " + " ".join(f"{x:.4f}" for x in ms["global"])
            + f" ms [{card}]")
    if not kept:
        say("K4: no main-path call took the block branch")
    return out


def dense_agg_cases(np, rng, K):
    """(label, gid, valid, inputs, kinds, groups) at K4's edges: one group;
    Q1's shape (6 slots, 4 occupied, 8 aggregates); group counts on either
    side of the private / block and block / global edges (gids out of range
    on both sides); f64 NaN, +-inf and +-0.0 in sums, min and max on each
    branch; int32 and bool inputs; all rows invalid; 40 aggregates (two
    launches); views offset by one element at an odd length (scalar
    loads); 100 rows (one block) on the private and block branches."""
    n = (1 << 20) + 3
    i64 = rng.integers(-10**12, 10**12, n)
    i32 = rng.integers(-10**6, 10**6, n).astype(np.int32)
    f = rng.normal(0, 1e3, n)
    b = rng.random(n) < 0.5
    valid = rng.random(n) < 0.9
    nf = rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.25], n)
    nf[rng.random(n) < 0.999] = 1.0     # a few non-finite values a group
    kinds3 = ("sumf", "min", "max")
    e1, e2 = k4_branch_edges(K, n, 3)
    cases = [
        ("one group", np.zeros(n, np.int64), valid,
         (i64, f, f, f, i32, i32, b, i64, b),
         ("sum", "sumf", "min", "max", "min", "max", "sum", "count", "sumf"),
         1),
        ("Q1's shape", rng.choice([0, 1, 3, 5], n), valid, (i64,) * 8,
         ("sum",) * 7 + ("count",), 6),
        ("all rows invalid", rng.choice([0, 1, 3, 5], n), np.zeros(n, bool),
         (i64, f, f, i32), ("sum", "sumf", "min", "max"), 6),
        ("40 aggregates", rng.integers(-1, 9, n), valid, (i64, f) * 20,
         ("sum", "max", "min", "sumf") * 10, 7),
    ]
    for g in (e1 - 1, e1, e2 - 1, e2):
        br = K4_BRANCHES[K._lib().otbt_grouped_agg_dense_branch(n, g, 3)]
        cases.append((f"{g} groups, 3 aggregates ({br})",
                      rng.integers(-2, g + 2, n), valid, (f, i32, f), kinds3,
                      g))
    for g in (5, e1, e2):
        br = K4_BRANCHES[K._lib().otbt_grouped_agg_dense_branch(n, g, 4)]
        cases.append((f"f64 NaN, +-inf, +-0.0, {g} groups ({br})",
                      rng.integers(0, g, n), valid, (nf, nf, nf, nf),
                      ("sumf", "sum", "min", "max"), g))
    m = n - 2   # odd; the check offsets each by one element on the card
    cases.append(("views offset by one element, odd length",
                  rng.integers(-1, 7, m), rng.random(m) < 0.9,
                  (i64[:m], i32[:m], f[:m], b[:m]),
                  ("sum", "min", "max", "sum"), 6))
    cases.append(("100 rows (one block)", rng.integers(-1, 7, 100),
                  valid[:100], (i64[:100], f[:100], i32[:100]),
                  ("sum", "sumf", "max"), 6))
    cases.append((f"100 rows, {e1} groups (block, one block)",
                  rng.integers(-1, e1 + 1, 100), valid[:100],
                  (i64[:100], f[:100], i32[:100]), ("sum", "sumf", "max"),
                  e1))
    return cases, (e1, e2)


def dense_agg_kernel_check(torch, K, card):
    """K4 against grouped_agg_dense_plain on dense_agg_cases (ints and
    min/max exact, f64 sums within SUMF_RTOL, NaN and infinities at the
    same places); the f64 sums of the private branch twice, bit for bit;
    Q1's shape on the private branch; the kernel and memset nodes of one
    call: 1 + 1 on many blocks of the private branch, 1 + 0 on one, 2 + 0
    on the block and global branches."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(15)

    def t(a):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x
    cases, (e1, e2) = dense_agg_cases(np, rng, K)
    lib = K._lib()
    check(lib.otbt_grouped_agg_dense_branch((1 << 23), 6, 8) == 0,
          "grouped_agg_dense: Q1's call (2^23 rows, 6 groups, 8 aggregates) "
          "is not on the private branch")
    args = {}
    for label, gid, valid, ins, kinds, g in cases:
        if label.startswith("views"):
            # views of larger tensors on the card, one element in
            gid_t = t(np.concatenate([[0], gid]))[1:]
            val_t = t(np.concatenate([[False], valid]))[1:]
            ins_t = tuple(t(np.concatenate([x[:1], x]))[1:] for x in ins)
        else:
            gid_t, val_t = t(gid), t(valid)
            ins_t = tuple(t(x) for x in ins)
        a = (gid_t, val_t, ins_t, g, kinds)
        try:
            got = K.grouped_agg_dense(*a)
        except RuntimeError as e:
            raise SmokeFailure(f"grouped_agg_dense ({label}): {e}") from None
        compare_agg(got, K.grouped_agg_dense_plain(*a), kinds, label)
        args[label] = a
    repeat = [lab for lab in args if lab == "one group"
              or lab.startswith(f"{e1 - 1} groups")
              or lab.startswith("f64 NaN, +-inf, +-0.0, 5 ")]
    for lab in repeat:
        a = args[lab]
        runs = [K.grouped_agg_dense(*a)[0] for _ in range(2)]
        for k, x, y in zip(a[4], *runs):
            if x.dtype.is_floating_point:
                check(torch.equal(x.view(torch.int64), y.view(torch.int64)),
                      f"grouped_agg_dense {k}: two runs differ in their bits "
                      f"({lab})")
    nodes = {}
    for lab, want in (("Q1's shape", (1, 1)), ("100 rows (one block)", (1, 0)),
                      (f"{e1} groups, 3 aggregates (block)", (2, 0)),
                      (f"{e2} groups, 3 aggregates (global)", (2, 0))):
        a = args[lab]
        nodes[lab] = kernel_launches(torch, lambda a=a: K.grouped_agg_dense(*a))
        check(nodes[lab] == want, f"grouped_agg_dense {lab}: {nodes[lab]} "
              f"launches + memsets a call, want {want}")
    torch.cuda.synchronize()
    say(f"K4 grouped_agg_dense vs plain ({len(cases)} edge cases: one group, "
        f"Q1's shape, all rows invalid, 40 aggregates, {e1 - 1} / {e1} "
        f"groups (private / block edge at 3 aggregates), {e2 - 1} / {e2} "
        "(block / global), f64 NaN / +-inf / +-0.0 on each branch, offset "
        "views at an odd length, 100 rows on two branches): ok; f64 sums "
        "the same bits in "
        "two runs (" + ", ".join(repeat) + "); kernel launches + memsets a "
        "call: " + ", ".join(f"{k} {v[0]} + {v[1]}" for k, v in nodes.items())
        + f" [{card}]")


def lloyd_cases(np, rng, tile):
    """(label, assign, valid, nlist, d) at the Lloyd update's edges: one
    cluster holding 90% of the rows; runs of tile - 1, tile and tile + 1
    rows (and 1, 3, 2 tile + 1, 5 tile) between empty clusters, the rows
    shuffled; all rows invalid; one row; each at 128, 7 and 200
    dimensions."""
    out = []
    n = 100_000
    big = np.where(rng.random(n) < 0.9, 5, rng.integers(0, 61, n))
    lengths = [tile - 1, tile, tile + 1, 1, 2 * tile + 1, 3, tile - 1,
               tile + 1, 5 * tile, tile]
    runs = np.repeat(2 * np.arange(len(lengths)) + 1, lengths)
    m = len(runs) + 300
    edge = np.concatenate([runs, rng.integers(0, 2 * len(lengths), 300)])
    edge_valid = np.concatenate([np.ones(len(runs), bool),
                                 np.zeros(300, bool)])
    perm = rng.permutation(m)
    for d in (128, 7, 200):
        out.append((f"one cluster with 90% of {n} rows, d={d}",
                    big.astype(np.int32), rng.random(n) < 0.95, 64, d))
        out.append((f"runs of tile - 1, tile, tile + 1 between empty "
                     f"clusters, d={d}", edge[perm].astype(np.int32),
                    edge_valid[perm], 2 * len(lengths) + 3, d))
    out.append(("all rows invalid", rng.integers(0, 10, 5000).astype(
        np.int32), np.zeros(5000, bool), 10, 128))
    out.append(("one row", np.asarray([3], np.int32), np.ones(1, bool), 8,
                128))
    return out


def lloyd_kernel_check(torch, ANN, card):
    """The Lloyd update against lloyd_update_plain on lloyd_cases (within
    lloyd_close's tolerance, an empty cluster's centroid unchanged bit for
    bit); two runs the same bits; the update after the sort 2 kernels and
    no memset a call."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(16)
    K = ANN.K
    cases = lloyd_cases(np, rng, ANN.LLOYD_TILE)
    nodes = None
    for label, assign, valid, nlist, d in cases:
        n = len(assign)
        vecs = torch.from_numpy(rng.normal(size=(n, d)).astype(
            np.float32)).to(dev)
        cents = torch.from_numpy(rng.normal(size=(nlist, d)).astype(
            np.float32)).to(dev)
        a = (vecs, torch.from_numpy(valid).to(dev),
             torch.from_numpy(assign).to(dev), cents, nlist)
        try:
            got = ANN.lloyd_update(*a)
        except RuntimeError as e:
            raise SmokeFailure(f"ann_lloyd_update ({label}): {e}") from None
        want = ANN.lloyd_update_plain(*a)
        lloyd_close(torch, got, want, vecs, f"ann_lloyd_update ({label})")
        live = np.bincount(assign[valid], minlength=nlist)[:nlist] > 0
        empty = torch.from_numpy(~live).to(dev)
        check(torch.equal(got[empty], cents[empty]),
              f"ann_lloyd_update: an empty cluster moved ({label})")
        again = ANN.lloyd_update(*a)
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"ann_lloyd_update: two runs differ in their bits ({label})")
        if nodes is None and n > 50_000:
            keys = torch.where(a[1], a[2].to(torch.int64),
                               torch.full((), nlist, dtype=torch.int64,
                                          device=dev))
            perm, skeys = K._sort_launch(keys.unsqueeze(0), "sort_rows",
                                         first=True)
            nodes = kernel_launches(torch, lambda: ANN.lloyd_update_sorted(
                vecs, skeys, perm, cents, nlist))
            check(nodes == (2, 0), f"ann_lloyd_update after the sort: "
                  f"{nodes} launches + memsets a call, want (2, 0)")
    torch.cuda.synchronize()
    say(f"K15c Lloyd update vs plain ({len(cases)} edge cases: one cluster "
        f"with 90% of the rows, runs of tile +- 1 ({ANN.LLOYD_TILE}) between "
        "empty clusters, d = 128 / 7 / 200, all rows invalid, one row): ok; "
        "the same bits in two runs; after the sort "
        f"{nodes[0]} kernels + {nodes[1]} memsets a call [{card}]")


MASK_SIZES = (1, 15, 16, 17, (1 << 20) + 3)


def mask_check(torch, K, np, rng, t):
    """K9's semi / anti masks at lengths around the kernel's 16-row group
    and past 2^20, on contiguous tensors and on views offset by one
    element (counts 8 bytes off a 16-byte boundary, probe_valid 1 byte),
    against their plain versions."""
    for n in MASK_SIZES:
        cnt = t(rng.integers(0, 3, n + 1))
        pv = t(rng.random(n + 1) < 0.7)
        for label, c, v in (("aligned", cnt[:n], pv[:n]),
                            ("counts offset", cnt[1:], pv[:n]),
                            ("probe_valid offset", cnt[:n], pv[1:]),
                            ("both offset", cnt[1:], pv[1:])):
            check(torch.equal(K.semi_mask(c), K.semi_mask_plain(c)),
                  f"semi_mask differs ({n} rows, {label})")
            check(torch.equal(K.anti_mask(c, v), K.anti_mask_plain(c, v)),
                  f"anti_mask differs ({n} rows, {label})")
    torch.cuda.synchronize()


def compare_exchange(torch, got, want, what):
    (go, gv, gc, gr), (wo, wv, wc, wr) = got, want
    check(gr == wr and (gc == wc).all(), f"exchange counts differ ({what})")
    check(torch.equal(gv, wv), f"exchange valid mask differs ({what})")
    for g, w in zip(go, wo):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"exchange column differs ({what})")


def compare_exchange_fixed(torch, got, want, what):
    """The fixed-capacity K12 against its plain version: the count
    matrix, the overflow and the valid mask equal, every column equal
    where the valid mask is set (the kernel leaves the other slots
    unwritten, the plain version zero-fills them)."""
    (go, gv, gc, gover), (wo, wv, wc, wover) = got, want
    check(torch.equal(gc, wc) and torch.equal(gover, wover),
          f"exchange_fixed counts or overflow differ ({what})")
    check(torch.equal(gv, wv), f"exchange_fixed valid mask differs ({what})")
    for g, w in zip(go, wo):
        check(g.dtype == w.dtype and torch.equal(g[gv], w[wv]),
              f"exchange_fixed column differs ({what})")


def compare_compact(torch, got, want, what):
    (gc, go), (wc, wo) = got, want
    check(int(gc) == int(wc), f"compact count differs ({what})")
    for g, w in zip(go, wo):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"compact column differs ({what})")


def cluster_kernel_check(torch, K):
    """K11 routing and the K12 exchange against their plain versions on
    inputs that reach every branch: NULL and TEXT keys (codes out of
    range too), one to three keys, 1, 2 and 3 DataNodes (the shard map
    is not hash % 3), a source with no live rows, a destination that
    receives nothing, and the broadcast form (K3: compact_kernel_check)."""
    import numpy as np
    from opentenbase_tpu_torch.utils.hashing import hash_string
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    imin, imax = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    words = [f"w{i}" for i in range(50)]
    lut = t(np.asarray([hash_string(w) for w in words],
                       np.uint64).view(np.int64))
    for n in (1000, (1 << 20) + 3):
        c0 = t(rng.integers(imin, imax, n, dtype=np.int64, endpoint=True))
        c1 = t(rng.integers(-50, 50, n))
        c2 = t(rng.integers(0, 9, n).astype(np.int32))
        codes = t(rng.integers(-3, 55, n).astype(np.int32))
        nulls = t(rng.random(n) < 0.1)
        valid = t(rng.random(n) < 0.8)
        for k in (1, 2, 3):
            for nb in (4096, 7, 3):
                keys = (c0, c1, c2)[:k]
                check(torch.equal(K.bucket_ids(keys, nb),
                                  K.bucket_ids_plain(keys, nb)),
                      f"bucket_ids differs ({k} keys, {nb} buckets)")
        for ndn in (1, 2, 3):
            smap = t((np.arange(4096) % ndn).astype(np.int32))
            for keys, nm, luts in (([c0], [nulls], None),
                                   ([c0, codes], [nulls, None], [None, lut]),
                                   ([codes, c1, c2], [None, nulls, None],
                                    [lut, None, None])):
                args = (keys, nm, luts, valid, smap, ndn)
                got = K.route_dest(*args)
                check(torch.equal(got, K.route_dest_plain(*args, 4096)),
                      f"route_dest differs ({len(keys)} keys, {ndn} DNs)")
            dest = got
            cols = (c0, c2, c0.to(torch.float64), nulls,
                    codes.to(torch.int16))
            cut = [n // ndn] * ndn
            cut[-1] += n - sum(cut)
            offs = np.cumsum([0] + cut)
            rs = [slice(int(offs[i]), int(offs[i + 1])) for i in range(ndn)]
            v = valid.clone()
            if ndn > 1:
                v[rs[1]] = False        # a source with no live rows
            # every source read in place; with 2 or more, source 0 lacks
            # the null mask (None: its rows get zeros there)
            srcs = [tuple(None if (i == 0 < ndn - 1 and j == 3) else c[r]
                          for j, c in enumerate(cols))
                    for i, r in enumerate(rs)]
            vs = [v[r] for r in rs]
            cases = [(dest, f"{ndn} DNs")]
            if ndn == 3:   # a destination that receives nothing
                cases.append((torch.where(dest == 2, torch.zeros_like(dest),
                                          dest), "3 DNs, dn2 empty"))
            for d, what in cases:
                ds = [d[r] for r in rs]
                want = K.exchange_plain(srcs, ds, vs, ndn)
                compare_exchange(torch, K.exchange(srcs, ds, vs, ndn), want,
                                 f"{what}, {n} rows")
                # the fixed-capacity form: a region that fits, one that
                # fits exactly and one too small (rows dropped, overflow)
                most = int(want[2].sum(axis=0).max())
                for region in (want[3], max(most, 1), max(most // 2, 1)):
                    compare_exchange_fixed(
                        torch, K.exchange_fixed(srcs, ds, vs, ndn, region),
                        K.exchange_fixed_plain(srcs, ds, vs, ndn, region),
                        f"{what}, {n} rows, region {region}")
            compare_exchange(torch, K.exchange(srcs, None, vs, 1),
                             K.exchange_plain(srcs, None, vs, 1),
                             f"broadcast from {ndn} DNs, {n} rows")
            compare_exchange_fixed(
                torch, K.exchange_fixed(srcs, None, vs, 1, n),
                K.exchange_fixed_plain(srcs, None, vs, 1, n),
                f"broadcast from {ndn} DNs, {n} rows, fixed form")
    torch.cuda.synchronize()
    say("cluster kernels vs plain (routing, exchange in both forms; every "
        "branch, small and large inputs): ok")
    exchange_edge_check(torch, K, np, rng, dev)


# csrc/exchange.cu kXTile: rows a tile of the fixed form
XCHG_TILE = 4096


def exchange_edge_cases():
    """(label, rows per source, ndst, region, skew, columns) at K12
    fixed's edges: an empty and a 1-row source, rows at multiples of the
    tile and one past, 1 and 64 destinations, region 1 (every
    destination overflows), every row to one destination, a second
    launch past 64 columns and past 248 column pointers (20 sources of
    17 columns)."""
    t = XCHG_TILE
    return (
        ("an empty source and a 1-row source", (0, 1, 3000), 2, 4096,
         False, 6),
        ("rows at the tile's multiples and one past",
         (t, 2 * t, t + 1, 3 * t + 1), 4, 2 * t, False, 6),
        ("1 destination", (3 * t + 5, 77), 1, 4 * t, False, 6),
        ("64 destinations", (5 * t + 3, t), 64, 512, False, 6),
        ("region 1: every destination overflows", (t + 9, 100), 2, 1,
         False, 6),
        ("region 1, 64 destinations", (2 * t + 1,), 64, 1, False, 3),
        ("skew: every row to one destination", (2 * t + 100, 3 * t), 4,
         8 * t, True, 6),
        ("65 columns", (t + 5, 2 * t), 2, 4 * t, False, 65),
        ("20 sources", (700,) * 20, 3, 8 * t, False, 17),
    )


def exchange_sources(torch, np, rng, rows, ndst, skew, k, dev):
    """(cols, dest, valid) of sources with `rows` rows: k columns of
    1, 2, 4 and 8 bytes (source 0 lacks column 2 where there are more
    sources), destinations -1 .. ndst (out of range at both ends), or
    all ndst - 1 with `skew`, 85% valid."""
    kinds = (np.int64, np.int32, np.bool_, np.int16, np.float64, np.uint8)
    srcs, ds, vs = [], [], []
    for i, n in enumerate(rows):
        cols = []
        for j in range(k):
            kind = kinds[j % len(kinds)]
            a = rng.random(n) < 0.5 if kind is np.bool_ else \
                rng.integers(-1000, 1000, n).astype(kind)
            cols.append(None if i == 0 and j == 2 and len(rows) > 1
                        else torch.from_numpy(a).to(dev))
        srcs.append(tuple(cols))
        d = np.full(n, ndst - 1, np.int32) if skew else \
            rng.integers(-1, ndst + 1, n).astype(np.int32)
        ds.append(torch.from_numpy(d).to(dev))
        vs.append(torch.from_numpy(rng.random(n) < 0.85).to(dev))
    return srcs, ds, vs


def exchange_edge_check(torch, K, np, rng, dev):
    """K12 fixed against its plain version on exchange_edge_cases (and
    each in the broadcast form): count matrix, overflow, valid mask and
    every moved value; the kernel and memset nodes of one captured call
    (1 + 1 up to 64 columns, one more kernel a set beyond)."""
    nodes = {}
    for label, rows, ndst, region, skew, k in exchange_edge_cases():
        srcs, ds, vs = exchange_sources(torch, np, rng, rows, ndst, skew, k,
                                        dev)
        compare_exchange_fixed(
            torch, K.exchange_fixed(srcs, ds, vs, ndst, region),
            K.exchange_fixed_plain(srcs, ds, vs, ndst, region), label)
        compare_exchange_fixed(
            torch, K.exchange_fixed(srcs, None, vs, 1, region),
            K.exchange_fixed_plain(srcs, None, vs, 1, region),
            f"{label}, broadcast form")
        if label in ("skew: every row to one destination", "65 columns",
                     "20 sources"):
            nodes[label] = kernel_launches(
                torch, lambda: K.exchange_fixed(srcs, ds, vs, ndst, region))
    sets = {"skew: every row to one destination": 1, "65 columns": 2,
            "20 sources": 2}
    for label, (kern, mems) in nodes.items():
        check(kern == sets[label] and mems == 1,
              f"exchange_fixed ({label}): {kern} kernels + {mems} memsets "
              f"a call, want {sets[label]} + 1")
    torch.cuda.synchronize()
    say(f"K12 exchange_fixed vs plain ({len(exchange_edge_cases())} edge "
        "cases, each also in the broadcast form: an empty and a 1-row "
        "source, rows at the tile's multiples and one past, 1 and 64 "
        "destinations, region 1, every row to one destination, 65 columns,"
        " 20 sources of 17): ok; kernel + memset nodes a call: " + ", ".join(
            f"{label} {a} + {b}" for label, (a, b) in nodes.items()))


def compact_sizes(K):
    """K3's row counts: 1, the one-block path's limit - 1, the limit and
    + 1, a one-block pass - 1, a pass and + 1, a look-back tile - 1, a
    tile and + 1, 3 tiles + 5 rows and 2^20 + 3."""
    one, tile, pas = K.COMPACT_ONE_ROWS, K._CMP_TILE, K._CMP_PASS
    return tuple(sorted({1, one - 1, one, one + 1, pas - 1, pas, pas + 1,
                         tile - 1, tile, tile + 1, 3 * tile + 5,
                         (1 << 20) + 3}))


def compact_columns(torch, rng, n, k, dev):
    """k columns cycling through widths 1, 2, 4 and 8 bytes."""
    import numpy as np
    kinds = (np.bool_, np.int16, np.int32, np.int64, np.uint8, np.float32,
             np.float64)
    cols = []
    for j in range(k):
        dt = np.dtype(kinds[j % len(kinds)])
        if dt == np.bool_:
            x = rng.random(n) < 0.5
        elif dt.kind == "f":
            x = rng.normal(0, 1e3, n).astype(dt)
        else:
            x = rng.integers(0, 100, n).astype(dt)
        cols.append(torch.from_numpy(x).to(dev))
    return tuple(cols)


def compact_kernel_check(torch, K):
    """K3 against compact_plain, exactly: every size of compact_sizes at
    mask densities 0, 1/2 and 1, output sizes from 1 (count > out_size)
    to past n (out_size > n, and past the one-block limit for small n),
    with 1, 16, 17 and 129 columns (two launches) of widths 1, 2, 4 and
    8 (the library's scratch size on both paths); the one-block form
    over several passes (the limit raised to 4 passes); two CUDA-graph
    replays with new inputs at 33 tiles + 5 rows (past a group of 32
    look-back tiles); the kernel launches and memsets of a call on each
    path and at 129 columns (torch.profiler).  Returns those counts."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(9)

    def sweep(sizes, ks, what):
        for n in sizes:
            colsets = {k: compact_columns(torch, rng, n, k, dev) for k in ks}
            for density in (0.0, 0.5, 1.0):
                mask = torch.from_numpy(rng.random(n) < density).to(dev)
                live = int(mask.sum())
                outs = sorted({1, max(live // 2, 1), n, n + 100,
                               K.COMPACT_ONE_ROWS + 7})
                for out_size in outs:
                    for k, cc in colsets.items():
                        if k != 16 and out_size not in (1, n):
                            continue
                        compare_compact(
                            torch, K.compact(mask, cc, out_size),
                            K.compact_plain(mask, cc, out_size),
                            f"n {n}, density {density}, out {out_size}, "
                            f"{k} columns{what}")
    sweep(compact_sizes(K), (1, 16, 17), "")
    sweep((1000, K.COMPACT_ONE_ROWS + 1), (129,), "")
    default = K.COMPACT_ONE_ROWS
    K.COMPACT_ONE_ROWS = 4 * K._CMP_PASS
    try:
        sweep((2 * K._CMP_PASS + 5, 4 * K._CMP_PASS), (1, 16),
              ", one block over passes")
    finally:
        K.COMPACT_ONE_ROWS = default
    torch.cuda.synchronize()
    # graph replays past a group of look-back tiles
    n = 33 * K._CMP_TILE + 5
    sets = [(torch.from_numpy(rng.random(n) < 0.5).to(dev),
             compact_columns(torch, rng, n, 3, dev)) for _ in range(3)]
    smask, scols = sets[0][0].clone(), tuple(c.clone() for c in sets[0][1])
    K.compact(smask, scols, n)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with K.capture_launches() as tally:
        with torch.cuda.graph(g):
            got = K.compact(smask, scols, n)
    for rep, (m, cc) in enumerate(sets[1:]):
        smask.copy_(m)
        for dst, src in zip(scols, cc):
            dst.copy_(src)
        g.replay()
        torch.cuda.synchronize()
        compare_compact(torch, got, K.compact_plain(m, cc, n),
                        f"captured, replay {rep}")
    check(tally.get("compact") == 1, f"capture tally {tally}")
    del g
    launches = {}
    big = K.COMPACT_ONE_ROWS + 3 * K._CMP_TILE + 5
    for label, n, k, want in (("one block", 1000, 4, (1, 0)),
                              ("look-back", big, 4, (1, 1)),
                              ("one block, 129 columns", 1000, 129, (2, 0)),
                              ("look-back, 129 columns", big, 129, (2, 2))):
        mask = torch.from_numpy(rng.random(n) < 0.5).to(dev)
        cc = compact_columns(torch, rng, n, k, dev)
        got = kernel_launches(torch, lambda: K.compact(mask, cc, n))
        check(got == want, f"compact ({label}): {got[0]} launches, "
              f"{got[1]} memsets a call, want {want}")
        launches[label] = got
    say(f"K3 compact vs plain (n = "
        f"{', '.join(str(x) for x in compact_sizes(K))}; densities 0, 1/2, "
        f"1; count > out_size, out_size > n; 1, 16, 17, 129 columns of 1-8 "
        f"bytes; one block over 2-4 passes): ok; captured at 33 tiles + 5 "
        f"rows and replayed twice with new inputs: ok; kernel launches + "
        f"memsets a call: " +
        ", ".join(f"{lbl} {k} + {m}" for lbl, (k, m) in launches.items()))
    return launches


COMPOSE_SIZES = (0, 1, 2, 3, 511, 512, 513, (1 << 20) + 3)


def compose_kernel_check(torch, K):
    """K9's compose_indices against its plain version, exactly: take
    lengths of COMPOSE_SIZES (odd and even, one and two rows a thread),
    1, 2, 17, 48 (the most a launch takes) and 49 priors (two launches)
    of different lengths, 0, 1, 3 and 49 null masks, indices past both
    ends, a take that starts one element off a 16-byte boundary; a
    CUDA-graph capture replayed twice with new inputs; the launches of a
    call at 5 priors and 2 masks and at 49 and 49 (torch.profiler)."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(10)

    def case(n, k, m, lens=None):
        if lens is None:
            lens = rng.integers(1, 5000, max(k, m, 1))
        priors = tuple(torch.from_numpy(rng.integers(
            0, 1 << 40, int(lens[j]))).to(dev) for j in range(k))
        masks = tuple(torch.from_numpy(rng.random(int(lens[j])) < 0.3).to(
            dev) for j in range(m))
        take = torch.from_numpy(rng.integers(-5100, 5100, n + 1)).to(dev)
        return priors, take, masks

    def same(got, want, what):
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"compose_indices differs ({what})")
        check(len(got[0]) == len(want[0]) and len(got[1]) == len(want[1]),
              f"compose_indices output count ({what})")

    for n in COMPOSE_SIZES:
        for k, m in ((1, 0), (2, 1), (17, 3), (48, 1), (0, 3), (49, 49)):
            priors, take1, masks = case(n, k, m)
            for label, take in (("aligned", take1[:n]),
                                ("take offset", take1[1:])):
                same(K.compose_indices(priors, take, masks),
                     K.compose_indices_plain(priors, take, masks),
                     f"{n} rows, {k} priors, {m} masks, {label}")
    torch.cuda.synchronize()
    sets = [case(100_003, 3, 2, (4099, 17, 65536)) for _ in range(3)]
    static = [tuple(x.clone() for x in part) if isinstance(part, tuple)
              else part.clone() for part in sets[0]]
    sp, st, sm = static
    st = st[:100_003].contiguous()
    K.compose_indices(sp, st, sm)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with K.capture_launches() as tally:
        with torch.cuda.graph(g):
            got = K.compose_indices(sp, st, sm)
    for rep, (p, t_, m) in enumerate(sets[1:]):
        for dst, src in zip(sp + sm, p + m):
            dst.copy_(src)
        st.copy_(t_[:100_003])
        g.replay()
        torch.cuda.synchronize()
        same(got, K.compose_indices_plain(p, t_[:100_003], m),
             f"captured, replay {rep}")
    check(tally.get("compose_index") == 1, f"capture tally {tally}")
    del g
    for k, m, want in ((5, 2, 1), (49, 49, 2)):
        priors, take, masks = case(100_000, k, m)
        take = take[:100_000].contiguous()
        got = kernel_launches(torch, lambda: K.compose_indices(
            priors, take, masks))
        check(got == (want, 0), f"compose_indices ({k} priors, {m} masks): "
              f"{got[0]} launches, {got[1]} memsets a call, want {want}")
    say(f"K9 compose_indices vs plain (take of "
        f"{', '.join(str(x) for x in COMPOSE_SIZES)} rows; 1, 2, 17, 48, "
        "49 priors; 0-3 and 49 null masks; indices past both ends; an "
        "unaligned take): ok; captured and replayed twice with new inputs: "
        "ok; kernel launches a call: 1 for 5 priors and 2 masks, 2 for 49 "
        "and 49")


# ---------------------------------------------------------------------------
# f64 keys and f64 window sums on the card (the port against an oracle)
# ---------------------------------------------------------------------------

_NAN, _INF = float("nan"), float("inf")
# the probe tables of ROADMAP queue 3 (p, q, w), the extremes (a, b) and
# window partitions with NaN / both infinities, 1e300 and small values (v)
FLOAT_TABLES = (
    ("p", {"k": [1, 2, 3, 4, 5, 6], "f": [0.5, 0.25, 1.0, 1.75, -0.0, 0.0]}),
    ("q", {"k": [1, 2, 3], "f": [0.75, 1.5, 0.5]}),
    ("a", {"k": list(range(1, 15)), "g": [1, 2] * 7,
           "f": [_NAN, -_NAN, _INF, -_INF, 1e300, -0.0, 0.0, None, 0.5,
                 0.25, _NAN, _INF, 1e300, None]}),
    ("b", {"k": list(range(1, 9)), "g": [1, 2, 1, 2, 1, 1, 2, 2],
           "f": [_NAN, _INF, -0.0, 1e300, 0.25, None, -_INF, 0.5]}),
    ("w", {"k": [1, 2, 3, 4], "g": [1, 1, 2, 2],
           "f": [1.0, _NAN, 2.0, 3.0]}),
    ("v", {"k": list(range(1, 16)),
           "g": [1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3],
           "f": [1.0, _NAN, 2.0, _INF, -_INF, 3.0, 1e300, 4.0, None, 0.125,
                 0.25, None, 0.5, -0.75, 1.5]}))


def _fkey(x):
    """float8 equality class (NaN = NaN, -0.0 = +0.0; None for NULL)."""
    import math
    if x is None:
        return None
    return "nan" if math.isnan(x) else x + 0.0


def _frame_sum(vals):
    """PostgreSQL's float8 sum of a frame's non-NULL values."""
    import math
    xs = [x for x in vals if x is not None]
    if not xs:
        return None
    if any(math.isnan(x) for x in xs) or (_INF in xs and -_INF in xs):
        return _NAN
    if _INF in xs or -_INF in xs:
        return _INF if _INF in xs else -_INF
    acc = 0.0
    for x in xs:
        acc += x
    return acc


def float_key_oracle(tables):
    """statement -> (its answer from the oracle, how to compare): the
    GROUP BY, DISTINCT, join and window statements float_key_check
    runs."""
    def counts(c):
        out = {}
        for f in c["f"]:
            out[_fkey(f)] = out.get(_fkey(f), 0) + 1
        return out

    def pairs(x, y, keys):
        return sorted((x["k"][i], y["k"][j]) for i in range(len(x["k"]))
                      for j in range(len(y["k"]))
                      if all(_fkey(x[c][i]) is not None
                             and _fkey(x[c][i]) == _fkey(y[c][j])
                             for c in keys))

    def window(c):
        out = []
        for i, k in enumerate(c["k"]):
            part = [j for j in range(len(c["k"])) if c["g"][j] == c["g"][i]]
            whole = [c["f"][j] for j in part]
            s = _frame_sum(whole)
            cnt = sum(x is not None for x in whole)
            out.append((k, _frame_sum([c["f"][j] for j in part
                                       if c["k"][j] <= k]),
                        None if s is None else s / cnt))
        return out
    t = dict(tables)
    return {
        "select f, count(*) from p group by f": (counts(t["p"]), "counts"),
        "select f, count(*) from a group by f": (counts(t["a"]), "counts"),
        "select f, count(*) from b group by f": (counts(t["b"]), "counts"),
        "select distinct f from a": (sorted(map(str, counts(t["a"]))),
                                     "distinct"),
        "select p.k, q.k from p join q on p.f = q.f":
            (pairs(t["p"], t["q"], ["f"]), "pairs"),
        "select a.k, b.k from a join b on a.f = b.f":
            (pairs(t["a"], t["b"], ["f"]), "pairs"),
        "select a.k, b.k from a join b on a.f = b.f and a.g = b.g":
            (pairs(t["a"], t["b"], ["f", "g"]), "pairs"),
        "select k, sum(f) over (partition by g order by k), avg(f) over "
        "(partition by g) from w order by k": (window(t["w"]), "window"),
        "select k, sum(f) over (partition by g order by k), avg(f) over "
        "(partition by g) from v order by k": (window(t["v"]), "window"),
    }


def _f_close(a, b, rtol):
    import math
    if a is None or b is None:
        return a is None and b is None
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= rtol * abs(b)


def float_answer_ok(rows, want, how):
    if how == "counts":
        return {_fkey(f): c for f, c in rows} == want
    if how == "distinct":
        got = [str(_fkey(r[0])) for r in rows]
        return len(got) == len(set(got)) and sorted(got) == want
    if how == "pairs":
        return sorted(tuple(r) for r in rows) == want
    return len(rows) == len(want) and all(
        g[0] == w[0] and _f_close(g[1], w[1], WIN_RTOL)
        and _f_close(g[2], w[2], WIN_RTOL) for g, w in zip(rows, want))


def float_key_check(torch, K):
    """GROUP BY, DISTINCT, single- and two-key joins on double precision
    keys and partitioned f64 window sum / avg, through the port's
    Session on the card (eager tier, then the fused tier with the join
    row floor at 0) and ClusterSession over Cluster(2) on the card (the
    cluster program), against the plain Python oracle: fractional keys
    stay apart, NaN groups and joins as one value, -0.0 meets +0.0, and
    a NaN or an infinity reaches only the window frames that hold it
    (the first measurement of the card's f64-key path)."""
    import numpy as np
    from opentenbase_tpu_torch.exec import executor as X
    from opentenbase_tpu_torch.exec import fused as F
    from opentenbase_tpu_torch.exec import mesh_exec as ME
    from opentenbase_tpu_torch.exec.dist_session import ClusterSession
    from opentenbase_tpu_torch.exec.session import LocalNode, Session
    from opentenbase_tpu_torch.parallel.cluster import Cluster

    def ddl(name, c, dist=""):
        return (f"create table {name} (k bigint, "
                + ("g int, " if "g" in c else "")
                + f"f double precision){dist}")

    def coldata(c):
        out = {"k": np.asarray(c["k"], np.int64), "f": list(c["f"])}
        if "g" in c:
            out["g"] = np.asarray(c["g"], np.int32)
        return out
    s = Session(LocalNode())
    cs = ClusterSession(Cluster(2))
    check(s.node.device.type == DEVICE, f"node on {s.node.device}")
    for name, c in FLOAT_TABLES:
        s.execute(ddl(name, c))
        s._insert_rows(s.node.catalog.table(name), s.node.stores[name],
                       coldata(c), len(c["k"]))
        cs.execute(ddl(name, c, " distribute by shard(k)"))
        cs._insert_rows(cs.cluster.catalog.table(name), coldata(c),
                        len(c["k"]))
    oracle = float_key_oracle(FLOAT_TABLES)
    fuse, floor, capture = X.Executor._fuse, F.FUSE_JOIN_MIN_ROWS, \
        ME.MeshRunner._capture
    tiers = 0
    try:
        for tier, sess in (("eager", s), ("fused", s), ("Cluster(2)", cs)):
            X.Executor._fuse = tier == "fused"
            F.FUSE_JOIN_MIN_ROWS = 0
            ME.MeshRunner._capture = True
            for sql, (want, how) in oracle.items():
                rows = sess.query(sql)
                torch.cuda.synchronize()
                check(float_answer_ok(rows, want, how),
                      f"f64 keys on the card, {tier}: {sql} gave {rows}, "
                      f"want {want}")
            tiers += 1
    finally:
        X.Executor._fuse, F.FUSE_JOIN_MIN_ROWS = fuse, floor
        ME.MeshRunner._capture = capture
    say(f"f64 keys and window sums on the card ({len(oracle)} statements: "
        "GROUP BY, DISTINCT, one- and two-key joins, partitioned sum / avg; "
        f"NaN, +-inf, 1e300, -0.0, NULL) = the oracle on {tiers} tiers "
        "(eager, fused, Cluster(2) program): ok")


# an int column's window sum past 2^31 (ROADMAP queue 3's standing item:
# the reference's int32 cumsum wraps there, the port widens to int64)
INT_WINDOW_SQL = ("select k, sum(x) over (order by k rows between 1 "
                  "preceding and 1 following) from w32 order by k")
INT_WINDOW_ROWS = {"k": [1, 2, 3, 4, 5],
                   "x": [5, None, 2147483647, 2147483647, -3]}
INT_WINDOW_WANT = [(1, 5), (2, 2147483652), (3, 4294967294),
                   (4, 4294967291), (5, 2147483644)]


def int_window_check(torch):
    """INT_WINDOW_SQL through the port's Session on the card (eager and
    fused tiers) and ClusterSession over Cluster(2) on the card, against
    the sums computed by hand: K13b widens an int32 argument as its
    plain version does."""
    import numpy as np
    from opentenbase_tpu_torch.exec import executor as X
    from opentenbase_tpu_torch.exec.dist_session import ClusterSession
    from opentenbase_tpu_torch.exec.session import LocalNode, Session
    from opentenbase_tpu_torch.parallel.cluster import Cluster
    data = {"k": np.asarray(INT_WINDOW_ROWS["k"], np.int64),
            "x": list(INT_WINDOW_ROWS["x"])}
    s = Session(LocalNode())
    s.execute("create table w32 (k bigint, x int)")
    s._insert_rows(s.node.catalog.table("w32"), s.node.stores["w32"],
                   dict(data), 5)
    cs = ClusterSession(Cluster(2))
    cs.execute("create table w32 (k bigint, x int) distribute by shard(k)")
    cs._insert_rows(cs.cluster.catalog.table("w32"), dict(data), 5)
    fuse = X.Executor._fuse
    try:
        for tier, sess in (("eager", s), ("fused", s), ("Cluster(2)", cs)):
            X.Executor._fuse = tier == "fused"
            rows = [tuple(r) for r in sess.query(INT_WINDOW_SQL)]
            torch.cuda.synchronize()
            check(rows == INT_WINDOW_WANT, f"int window sum on the card, "
                  f"{tier}: {rows}, want {INT_WINDOW_WANT}")
    finally:
        X.Executor._fuse = fuse
    say("int32 window sum past 2^31 on the card = the hand sums on 3 tiers "
        "(eager, fused, Cluster(2)): ok")


WIN_RTOL = 1e-12    # K13b f64 sums / averages: the scan adds in tiles


def compare_window(torch, got, want, what, rtol=0.0):
    """A K13 result (tensor or tuple of tensors / None) against its plain
    version: integers and nulls exactly, f64 within rtol (NaN = NaN).
    Returns the max abs error."""
    if isinstance(got, torch.Tensor) or got is None:
        got, want = (got,), (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g is None or w is None:
            check(g is None and w is None, f"K13 {what}: null mask "
                  "present on one side only")
            continue
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"K13 {what}: shape/dtype {g.shape} {g.dtype} != "
              f"{w.shape} {w.dtype}")
        if g.dtype.is_floating_point:
            both_nan = torch.isnan(g) & torch.isnan(w)
            d = torch.where(both_nan, torch.zeros_like(g), (g - w).abs())
            d = torch.where(torch.isinf(g) & (g == w), torch.zeros_like(g), d)
            bad = ~((d == 0) | (d <= rtol * w.abs()))
            check(not bool(bad.any()), f"K13 {what}: f64 values differ "
                  f"beyond {rtol} ({int(bad.sum())} rows)")
            if d.numel():
                err = max(err, float(d.max()))
        else:
            check(torch.equal(g, w), f"K13 {what}: values differ")
    return err


def window_case(torch, K, rng, n, n_part, n_order, float_order, dev,
                p_valid=0.8, part_width=None):
    """Sorted order words as the executor makes them (K10 over keys with
    ties, NaN and +-0.0, invalid rows anywhere in the input), and their
    sort permutation and sorted validity.  part_width: the first
    partition key is row // part_width (partitions of that many rows)."""
    import numpy as np
    valid = rng.random(n) < p_valid
    keys, descs = [], []
    for j in range(n_part):
        keys.append(torch.from_numpy(
            np.arange(n) // part_width if part_width and j == 0
            else rng.integers(0, 3, n)).to(dev))
        descs.append(False)
    for j in range(n_order):
        if float_order and j == 0:
            keys.append(torch.from_numpy(rng.choice(
                [np.nan, -0.0, 0.0, 1.5, -2.0], n)).to(dev))
        else:
            keys.append(torch.from_numpy(rng.integers(0, 4, n)).to(dev))
        descs.append(bool(rng.integers(0, 2)))
    valid_t = torch.from_numpy(valid).to(dev)
    words = K.order_words(tuple(keys), valid_t, tuple(descs))
    perm = K.sort_perm(words)
    fw = tuple(1 + j for j, k in enumerate(keys) if k.dtype.is_floating_point)
    return (words.index_select(1, perm).contiguous(), fw,
            valid_t.index_select(0, perm), perm)


WIN_FRAMES = (None, ("rows", ("preceding", 2), ("following", 1)),
              ("rows", ("preceding", 3), ("preceding", 2)),
              ("rows", ("current", None), ("unbounded_following", None)),
              ("rows", ("following", 1), ("following", 4)),
              ("range", ("unbounded_preceding", None), ("current", None)),
              ("range", ("current", None), ("unbounded_following", None)))
WIN_SCAN_FUNCS = ("count", "sum", "avg", "min", "max")   # K13b: scan + frame


def window_cases(K):
    """(n, n_part, n_order, float order, p_valid, part_width, p_null) of
    window_kernel_check: small sizes, the K13b scan tile's edges (tile
    - 1, tile, tile + 1), 3 tiles + 5 rows in partitions of 5000 rows
    (every tile boundary inside a partition), all rows invalid, every
    argument NULL, 2^20 + 3 and 2^22 + 3 rows."""
    t = K._WFR_TILE
    return ((1, 0, 1, False, 0.8, None, 0.2), (1, 1, 0, False, 0.8, None, 0.2),
            (2, 0, 0, False, 0.8, None, 0.2), (37, 1, 1, True, 0.8, None, 0.2),
            (1000, 2, 1, True, 0.8, None, 0.2),
            (1025, 0, 2, False, 0.8, None, 0.2),
            (t - 1, 1, 1, False, 0.8, None, 0.2),
            (t, 1, 1, True, 0.8, None, 0.2),
            (t + 1, 0, 1, False, 0.8, None, 0.2),
            (3 * t + 5, 1, 1, False, 1.0, 5000, 0.2),
            (3 * t + 5, 1, 1, False, 0.0, None, 0.2),
            (3 * t + 5, 1, 1, False, 0.8, None, 1.0),
            ((1 << 20) + 3, 1, 1, True, 0.8, None, 0.2),
            ((1 << 22) + 3, 1, 1, False, 0.8, None, 0.2))


def window_kernel_check(torch, K):
    """K13a-K13c against their plain versions on inputs that take every
    branch: every size of window_cases, partition / order word counts,
    NaN and +-0.0 order keys, invalid rows sorted to the end, every
    function over every frame kind, int64 and f64 arguments with NULLs
    (an f64 one also with NaN, +-inf and 1e300 in some partitions),
    lag/lead with and without a default; then K13b captured into a CUDA
    graph and replayed twice with new inputs, and the kernel launches
    and memsets of one K13b call of each function (torch.profiler)."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(5)
    cases = window_cases(K)
    for n, n_part, n_order, flt, p_valid, width, p_null in cases:
        words, fw, s_valid, perm = window_case(
            torch, K, rng, n, n_part, n_order, flt, dev, p_valid, width)
        bounds = K.window_bounds(words, n_part, fw, s_valid)
        compare_window(torch, bounds, K.window_bounds_plain(
            words, n_part, fw, s_valid), f"window_bounds n={n}")
        for arg in ("int64", "f64", "f64 non-finite"):
            a = torch.from_numpy(rng.integers(-50, 50, n)).to(dev)
            if arg != "int64":
                a = a.to(torch.float64) * 0.25
            if arg == "f64 non-finite":
                a = nonfinite(torch, rng, a)
            anm = torch.from_numpy(rng.random(n) < p_null).to(dev)
            dflt = torch.from_numpy(rng.integers(-9, 9, n)).to(dev).to(
                a.dtype)
            dnull = torch.from_numpy(rng.random(n) < 0.3).to(dev)
            contrib = s_valid & ~anm
            for func in K.WIN_FUNCS:
                framed = func not in ("row_number", "rank", "dense_rank",
                                      "lag", "lead")
                frames = WIN_FRAMES if framed and n < (1 << 20) else \
                    (WIN_FRAMES[:2] if framed else (None,))
                table = None
                if func in ("min", "max"):
                    table = K.range_minmax(a, contrib, func == "min")
                    compare_window(torch, table, K.range_minmax_plain(
                        a, contrib, func == "min"), f"range_minmax n={n}")
                for fr in frames:
                    for dflt_on in ((False, True) if func in ("lag", "lead")
                                    else (False,)):
                        kw = dict(offset=2, scale=2, table=table)
                        if dflt_on:
                            kw.update(dflt_s=dflt, dnull_s=dnull,
                                      has_default=True)
                        args = (func, bounds, K.window_frame(fr, n_order > 0),
                                perm, s_valid, a, anm)
                        compare_window(
                            torch, K.window_frame_reduce(*args, **kw),
                            K.window_frame_reduce_plain(*args, **kw),
                            f"window_frame_reduce {func} n={n} {fr} "
                            f"{arg} valid {p_valid} null {p_null}",
                            rtol=WIN_RTOL)
        cnt = K.window_frame_reduce("count", bounds, K.window_frame(None, 1),
                                    perm, s_valid)
        compare_window(torch, cnt, K.window_frame_reduce_plain(
            "count", bounds, K.window_frame(None, 1), perm, s_valid),
            f"count(*) n={n}")
    torch.cuda.synchronize()
    window_graph_check(torch, K, rng, dev)
    launches = window_call_launches(torch, K, rng, dev)
    say(f"window kernels (K13a-c) vs plain (every function and frame kind, "
        f"n = {', '.join(str(c[0]) for c in cases)}; all invalid, all NULL): "
        "ok; K13b captured at 33 tiles + 5 rows and replayed twice with new "
        "inputs: ok; K13b "
        "kernel launches (+ memsets) a call: " + ", ".join(
            f"{f} {_g(k)}" + (f" + {_g(m)}" if m else "")
            for f, (k, m) in launches.items()))


def nonfinite(torch, rng, a):
    """a with about 2% of its rows NaN, 1% +inf and 1% -inf, and one row
    1e300: non-finite values in some partitions and not in others, and
    one huge value in one partition (two would cancel in another order
    on each side: a divergence from PostgreSQL kept in ROADMAP queue 3,
    not a fault of either side)."""
    u = torch.from_numpy(rng.random(a.shape[0])).to(a.device)
    a = torch.where(u < 0.02, float("nan"), a)
    a = torch.where((u >= 0.02) & (u < 0.03), float("inf"), a)
    a = torch.where((u >= 0.03) & (u < 0.04), float("-inf"), a)
    a[int(rng.integers(0, a.shape[0]))] = 1e300
    return a


def window_graph_check(torch, K, rng, dev):
    """sum (f64, with NaN, infinities and 1e300 among its rows), avg and
    count over a ROWS frame at 33 tiles + 5 rows (past the scan's group
    of 32 tiles, so each replay reads a group prefix another tile
    published), captured into one CUDA graph, replayed twice with other
    inputs copied in: each replay equals the plain versions on its
    inputs (a tile counter, status word or group flag that is not reset
    shows here)."""
    n = 33 * K._WFR_TILE + 5
    frame = K.window_frame(WIN_FRAMES[1], True)
    sets = []
    for _ in range(3):
        words, fw, s_valid, perm = window_case(torch, K, rng, n, 1, 1, False,
                                               dev)
        bounds = K.window_bounds(words, 1, fw, s_valid)
        a = torch.from_numpy(rng.integers(-50, 50, n)).to(dev)
        anm = torch.from_numpy(rng.random(n) < 0.2).to(dev)
        sets.append([*bounds, perm, s_valid, a,
                     nonfinite(torch, rng, a.to(torch.float64) * 0.25), anm])

    def run(fn, x):
        bounds, (perm, s_valid, a, af, anm) = tuple(x[:5]), x[5:]
        return (fn("sum", bounds, frame, perm, s_valid, af, anm),
                fn("avg", bounds, frame, perm, s_valid, a, anm, scale=2),
                fn("count", bounds, frame, perm, s_valid, a, anm))
    static = [x.clone() for x in sets[0]]
    run(K.window_frame_reduce, static)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with K.capture_launches() as tally:
        with torch.cuda.graph(g):
            outs = run(K.window_frame_reduce, static)
    for rep, x in enumerate(sets[1:]):
        for dst, src in zip(static, x):
            dst.copy_(src)
        g.replay()
        torch.cuda.synchronize()
        for got, want, f in zip(outs, run(K.window_frame_reduce_plain, x),
                                ("sum", "avg", "count")):
            compare_window(torch, got, want, f"captured window_frame_reduce "
                           f"{f}, replay {rep}", rtol=WIN_RTOL)
    check(tally.get("window_frame_reduce") == 3, f"capture tally {tally}")
    del g


def window_call_launches(torch, K, rng, dev):
    """func -> (kernel launches, memsets) of one K13b call at 3 tiles + 5
    rows, from torch.profiler; fails past 2 launches and 1 memset for a
    frame function that reads the prefixes, 1 launch for the others."""
    n = 3 * K._WFR_TILE + 5
    words, fw, s_valid, perm = window_case(torch, K, rng, n, 1, 1, False, dev)
    bounds = K.window_bounds(words, 1, fw, s_valid)
    a = torch.from_numpy(rng.integers(-50, 50, n)).to(dev)
    anm = torch.from_numpy(rng.random(n) < 0.2).to(dev)
    out = {}
    for func in K.WIN_FUNCS:
        table = K.range_minmax(a, s_valid & ~anm, func == "min") \
            if func in ("min", "max") else None
        frame = K.window_frame(WIN_FRAMES[1], True)
        k, m = kernel_launches(
            torch, lambda: K.window_frame_reduce(
                func, bounds, frame, perm, s_valid, a, anm, table=table))
        scan = func in WIN_SCAN_FUNCS
        check(k <= (2 if scan else 1)
              and m <= (1 if scan else 0),
              f"window_frame_reduce {func}: {k} launches, {m} memsets")
        out[func] = (k, m)
    return out


def _same_nonfinite(torch, g, w):
    """g and w have NaN at the same places and the same infinities."""
    gn, wn = g.isnan(), w.isnan()
    gi = torch.where(gn | g.isfinite(), torch.zeros_like(g), g)
    wi = torch.where(wn | w.isfinite(), torch.zeros_like(w), w)
    return torch.equal(gn, wn) and torch.equal(gi, wi)


def compare_agg(got, want, kinds, what):
    """K4 against its plain version: present, counts, ints and min/max
    exact (NaN at the same places), f64 sums within SUMF_RTOL where
    finite and their NaN and infinities at the same places."""
    import torch
    (gouts, gp), (wouts, wp) = got, want
    check(torch.equal(gp, wp), f"grouped_agg_dense present differs ({what})")
    err = 0.0
    for k, g, w in zip(kinds, gouts, wouts):
        check(g.dtype == w.dtype, f"grouped_agg_dense {k} dtype ({what})")
        if not g.dtype.is_floating_point:
            check(torch.equal(g, w), f"grouped_agg_dense {k} differs "
                  f"({what})")
            continue
        check(_same_nonfinite(torch, g, w), f"grouped_agg_dense {k}: NaN or "
              f"infinities differ ({what})")
        fin = w.isfinite()
        if k in ("sum", "sumf"):
            d = torch.where(fin, (g - w).abs(), torch.zeros_like(w))
            check(bool(((d <= SUMF_RTOL * w.abs()) | ~fin).all()),
                  f"grouped_agg_dense {k} beyond rtol {SUMF_RTOL} ({what})")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        else:
            check(torch.equal(torch.where(fin, g, torch.zeros_like(g)),
                              torch.where(fin, w, torch.zeros_like(w))),
                  f"grouped_agg_dense {k} differs ({what})")
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


def _scaled(a):
    import numpy as np
    return np.round(np.asarray(a) * 100).astype(np.int64)


def _iso(days):
    import numpy as np
    return str(np.datetime64("1970-01-01", "D")
               + np.timedelta64(int(days), "D"))


def oracle_q3(data):
    """Q3 rows with numpy: BUILDING customers' orders before the date,
    their lineitems shipped after it, revenue per order in scaled int64,
    top 10 by revenue desc, order date, then order key (the engine's
    group order)."""
    import numpy as np
    c, o, li = data["customer"], data["orders"], data["lineitem"]
    d = _days("1995-03-15")
    ck = np.asarray(c["c_custkey"], np.int64)[
        np.asarray(c["c_mktsegment"]) == "BUILDING"]
    okey = np.asarray(o["o_orderkey"], np.int64)
    odate = np.asarray(o["o_orderdate"], np.int64)
    oship = np.asarray(o["o_shippriority"], np.int64)
    osel = np.nonzero(np.isin(np.asarray(o["o_custkey"], np.int64), ck)
                      & (odate < d))[0]
    osel = osel[np.argsort(okey[osel])]
    sk = okey[osel]
    lk = np.asarray(li["l_orderkey"], np.int64)
    pos = np.minimum(np.searchsorted(sk, lk), max(len(sk) - 1, 0))
    lsel = (sk[pos] == lk) & (np.asarray(li["l_shipdate"], np.int64) > d)
    rev = _scaled(li["l_extendedprice"])[lsel] * \
        (100 - _scaled(li["l_discount"])[lsel])
    uk, inv = np.unique(lk[lsel], return_inverse=True)
    sums = np.zeros(len(uk), np.int64)
    np.add.at(sums, inv, rev)
    oi = osel[np.searchsorted(sk, uk)]
    top = np.lexsort((uk, odate[oi], -sums))[:10]
    return [(int(uk[i]), int(sums[i]) / 10**4, _iso(odate[oi][i]),
             int(oship[oi][i])) for i in top]


def oracle_q5(data):
    """Q5 rows with numpy: 1994 orders, their lineitems whose supplier's
    nation is the customer's and lies in ASIA, revenue per nation in
    scaled int64, by revenue desc."""
    import numpy as np
    reg, nat = data["region"], data["nation"]
    c, o, li, su = (data[t] for t in ("customer", "orders", "lineitem",
                                      "supplier"))
    asia = int(np.asarray(reg["r_regionkey"])[
        np.asarray(reg["r_name"]) == "ASIA"][0])
    nkey = np.asarray(nat["n_nationkey"], np.int64)
    in_asia = np.zeros(int(nkey.max()) + 1, bool)
    in_asia[nkey[np.asarray(nat["n_regionkey"]) == asia]] = True
    names = dict(zip(nkey.tolist(), list(nat["n_name"])))

    def lookup(keys, vals, want):
        order = np.argsort(keys)
        pos = np.minimum(np.searchsorted(keys[order], want), len(keys) - 1)
        return keys[order][pos] == want, vals[order][pos]

    odate = np.asarray(o["o_orderdate"], np.int64)
    om = (odate >= _days("1994-01-01")) & (odate < _days("1995-01-01"))
    _hit, o_cnat = lookup(np.asarray(c["c_custkey"], np.int64),
                          np.asarray(c["c_nationkey"], np.int64),
                          np.asarray(o["o_custkey"], np.int64)[om])
    l_ok, l_cnat = lookup(np.asarray(o["o_orderkey"], np.int64)[om], o_cnat,
                          np.asarray(li["l_orderkey"], np.int64))
    s_ok, l_snat = lookup(np.asarray(su["s_suppkey"], np.int64),
                          np.asarray(su["s_nationkey"], np.int64),
                          np.asarray(li["l_suppkey"], np.int64))
    m = l_ok & s_ok & (l_cnat == l_snat) & in_asia[l_snat]
    rev = _scaled(li["l_extendedprice"])[m] * \
        (100 - _scaled(li["l_discount"])[m])
    sums = np.zeros(len(in_asia), np.int64)
    np.add.at(sums, l_snat[m], rev)
    seen = np.zeros(len(in_asia), bool)
    seen[l_snat[m]] = True
    rows = [(names[k], int(sums[k]) / 10**4) for k in np.nonzero(seen)[0]]
    return sorted(rows, key=lambda r: -r[1])


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
    attrs = {n: WRAPPERS.get(n, n) for n in names}
    originals = {n: getattr(K, attrs[n]) for n in names}

    import torch

    def wrap(n, fn):
        def rec(*a, **kw):
            # a call recorded into a CUDA graph under capture launches
            # nothing, and its tensors belong to the graph's pool
            if not torch.cuda.is_current_stream_capturing():
                calls[n].append((a, kw))
            return fn(*a, **kw)
        return rec
    for n in names:
        setattr(K, attrs[n], wrap(n, originals[n]))

    def restore():
        for n, fn in originals.items():
            setattr(K, attrs[n], fn)
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


def _g(x) -> str:
    """A count a call, or "-" where it was not measured."""
    return "-" if x is None else f"{x:g}"


def graph_device_ms(torch, fn, reps=20):
    """Device ms a call of `fn`: `reps` calls captured into one CUDA
    graph and replayed between CUDA events, so no host dispatch is in
    the time (the graph's own gaps between kernels are)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    ms = time_fn(torch, g.replay, reps=5) / reps
    del g
    return ms


# CUgraphNodeType (cuda.h): the node types a captured call is counted by
_CU_GRAPH_NODE_KERNEL, _CU_GRAPH_NODE_MEMSET = 0, 2


def graph_nodes(torch, fn):
    """{CUgraphNodeType: nodes} of one call of `fn` captured into a CUDA
    graph: each kernel and memset the call enqueues is one node, read from
    the graph under capture through the driver API (libcuda), so the count
    needs no profiler."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    types = {}
    status, graph = ctypes.c_int(-1), ctypes.c_void_p()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        cid, deps, ndeps = ctypes.c_ulonglong(), ctypes.c_void_p(), \
            ctypes.c_size_t()
        rc = cu.cuStreamGetCaptureInfo_v2(
            stream, ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps))
        n = ctypes.c_size_t(0)
        if rc == 0 and graph.value:
            rc = cu.cuGraphGetNodes(graph, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * max(n.value, 1))()
        if rc == 0 and n.value:
            rc = cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
        for node in nodes[:n.value] if rc == 0 else ():
            kind = ctypes.c_int()
            rc = rc or cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                             ctypes.byref(kind))
            types[kind.value] = types.get(kind.value, 0) + 1
    del g
    if rc != 0 or not graph.value:
        raise SmokeFailure(f"could not read the captured graph: CUresult "
                           f"{rc}, capture status {status.value}")
    return types


def replay_nodes(torch, K, prog):
    """(kernel nodes, memset nodes) of one run of a captured program's
    body: its traced run captured once more into a CUDA graph (after one
    eager warm-up run, as the program itself captures), its wrapper calls
    kept out of LAUNCHES; None where that capture fails."""
    try:
        with prog._lock, K.capture_launches():
            types = graph_nodes(torch, prog._traced_run)
    except Exception as e:   # a measurement only: say why, go on
        say(f"replay nodes not measured: {type(e).__name__}: {e}")
        return None
    return (types.get(_CU_GRAPH_NODE_KERNEL, 0),
            types.get(_CU_GRAPH_NODE_MEMSET, 0))


def _profiled(torch, fn, reps):
    """The device-side event names of `reps` calls of `fn` under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if ev.device_type == DeviceType.CUDA]


# how often torch.profiler's count a call agreed with the captured graph's,
# and how often it had lost its device events
PROFILER_COUNTS = {"agreed": 0, "lost": 0}


def kernel_launches(torch, fn, reps=4):
    """(kernel launches, memsets) a call of `fn`: the kernel and memset
    nodes of one call captured into a CUDA graph (`graph_nodes`).  The
    device-side events of `reps` calls under torch.profiler are a second
    witness: where they come to whole counts a call, those must equal the
    graph's; where the profiler lost its device events (on some H100
    machines it delivers none) the graph's count stands alone."""
    types = graph_nodes(torch, fn)
    got = (types.get(_CU_GRAPH_NODE_KERNEL, 0),
           types.get(_CU_GRAPH_NODE_MEMSET, 0))
    names = [x.lower() for x in _profiled(torch, fn, reps)]
    memsets = sum("memset" in x for x in names)
    kernels = sum("memset" not in x and "memcpy" not in x for x in names)
    if kernels > 0 and kernels % reps == 0 and memsets % reps == 0:
        check((kernels // reps, memsets // reps) == got,
              f"torch.profiler counts {kernels // reps} launches and "
              f"{memsets // reps} memsets a call, the captured graph "
              f"{got[0]} and {got[1]}")
        PROFILER_COUNTS["agreed"] += 1
    else:
        PROFILER_COUNTS["lost"] += 1
    return got


def device_host_ms(torch, fn, reps=20):
    """(device ms, host ms), each per call of `fn`: graph_device_ms (no
    host dispatch in it; the graph's gaps between kernels are), and the
    host clock around `reps` calls that are not waited for (what the
    wrapper costs the host, enqueue included)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return graph_device_ms(torch, fn, reps), host


def plain_versions(K):
    return {n: getattr(K, WRAPPERS.get(n, n) + "_plain")
            for n in KERNEL_SOURCES}


def timed_calls(K, plain, name, a, kw):
    """(kernel call, plain call) that time one recorded main-path call.
    The sort is timed at its launch (K.sort_perm on the order words of
    the recorded keys) against sort_perm_plain on the same words, without
    the wrapper's word building and payload gather.  The other wrappers
    are their launches plus allocating outputs and scratch (for the
    aggregates, setting the workspace to its identities on the card)."""
    if name == "sort_rows":
        words = K.order_words(a[0], a[1], a[3])
        return (lambda: K.sort_perm(words)), \
            (lambda: K.sort_perm_plain(words))
    return (lambda: wrapper_of(K, name)(*a, **kw)), \
        (lambda: plain[name](*a, **kw))


def nbytes(t):
    return t.numel() * t.element_size()


def _lg(n):
    return max(int(n - 1).bit_length(), 1)


def call_bytes_ops(name, a, kw, out):
    """(bytes each input read once + each output written once, ops) of
    one kernel call, from this run's tensors.  Sorting work is counted
    as n log2 n comparisons, the least a comparison sort needs; a
    gather counts the entries it reads."""
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
        # the order words read once, the permutation written once; n log2 n
        # comparisons, whatever the algorithm
        keys, valid = a[0], a[1]
        n = valid.shape[0]
        return (1 + len(keys)) * n * 8 + n * 8, n * _lg(n)
    if name == "grouped_agg_sort":
        keys, valid, ins, g = a[0], a[1], a[2], int(a[3])
        n = valid.shape[0]
        gk, outs, _ng = out
        by = sum(nbytes(t) for t in keys) + nbytes(valid) \
            + sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in gk) \
            + sum(nbytes(t) for t in outs) + 8
        return by, n * _lg(n) * len(keys) + n * len(ins)
    if name == "join_build":
        n = a[0].shape[0]
        return nbytes(a[0]) + nbytes(a[1]) + 16 * n, n * _lg(n)
    if name == "join_probe_counts":
        # sorted keys and probe keys + valid read, lo and count written
        nb, np_ = a[0].shape[0], a[1].shape[0]
        return 8 * nb + 9 * np_ + 16 * np_, np_ * _lg(nb)
    if name == "join_expand":
        # counts (+ probe_valid for a left outer join) read for every
        # row; lo only for the rows with matches, and each perm entry a
        # match needs, at most nb of them, read once; the pairs and the
        # total written
        counts, nb = a[1], a[2].shape[0]
        n, size = counts.shape[0], int(a[3])
        total = int(out[2])
        outer = bool(kw.get("left_outer", a[4] if len(a) > 4 else False))
        pv = kw.get("probe_valid", a[5] if len(a) > 5 else None)
        has = counts > 0
        if outer and pv is not None:
            has = has & pv
        rows = int(has.sum())
        pairs = int(counts[has].sum())
        pvb = n if outer and pv is not None else 0
        return (8 * n + pvb + 8 * rows + 8 * min(pairs, nb)
                + 16 * size + 8), n + total
    if name == "compose_index":
        # take read once; per prior one entry read and one written a row,
        # per null mask one byte read and one written
        priors, take = a[0], a[1]
        masks = a[2] if len(a) > 2 else kw.get("masks", ())
        n = take.shape[0]
        return 8 * n + 16 * n * len(priors) + 2 * n * len(masks), \
            n * (len(priors) + len(masks))
    if name in ("semi_mask", "anti_mask"):
        n = a[0].shape[0]
        return 9 * n + (n if name == "anti_mask" else 0), n
    if name == "hash_columns":
        cols = a[0]
        n = cols[0].shape[0]
        return sum(nbytes(c) for c in cols) + 8 * n, 15 * n * len(cols)
    if name in ("route_dest", "bucket_ids"):
        # keys (+ null masks, text LUTs, valid, shard map) read once, the
        # int32 destination written; splitmix64 is about 15 operations
        # a key, the remainder and the lookup a few more
        keys = a[0]
        n = keys[0].shape[0]
        extra = [x for x in (list(a[1] or ()) + list(a[2] or ())
                             + [a[3], a[4]]) if x is not None] \
            if name == "route_dest" else []
        by = sum(nbytes(k) for k in keys) + sum(nbytes(x) for x in extra) \
            + 4 * n
        return by, 16 * n * len(keys)
    if name == "exchange":
        # every source's destinations and valid mask read once; the
        # columns read, and the output columns and valid mask written,
        # only for the rows that moved (the count matrix's total); the
        # count matrix written once
        cols, dest, valid = a[0], a[1], a[2]
        _outs, _ovalid, cm, _region = out
        moved = int(cm.sum())
        width = sum(o.element_size() for o in _outs)
        n = sum(v.shape[0] for v in valid)
        by = n + (4 * n if dest is not None else 0) \
            + moved * (2 * width + 1) + 8 * cm.size
        return by, n + moved * len(_outs)
    if name == "exchange_fixed":
        # as the sized form, the rows that moved being those that fit
        # their region; the whole valid mask, the count matrix, the
        # totals and the overflow written once
        cols, dest, valid, region = a[0], a[1], a[2], int(a[4])
        _outs, _ovalid, cm, _over = out
        moved = int(torch_min_sum(cm, region))
        width = sum(o.element_size() for o in _outs)
        n = sum(v.shape[0] for v in valid)
        by = n + (4 * n if dest is not None else 0) \
            + moved * 2 * width + _ovalid.numel() + 8 * cm.numel() \
            + 16 * cm.shape[1]
        return by, n + moved * len(_outs)
    if name == "compact":
        mask, cols = a[0], a[1]
        _count, outs = out
        by = nbytes(mask) + sum(nbytes(c) for c in cols) \
            + sum(nbytes(o) for o in outs) + 8
        return by, mask.shape[0] * (1 + len(cols))
    if name == "fused_scan_agg":
        return fused_bytes_ops(a, out)
    if name in WINDOW_KERNELS:
        return window_bytes_ops(name, a, kw, out)
    raise KeyError(name)


# the shapes of a kernel's timed main-path calls, printed with its line:
# K3's rows, output slots and columns (its one-block path's limit comes
# from these), K9's take length, priors and null masks
def probe_shapes(calls) -> str:
    """Build rows x probe rows and the branch of each recorded K7 call."""
    imax = (1 << 63) - 1
    out = []
    for a, _kw in calls:
        sk, pk = a[0], a[1]
        nb, np_ = sk.shape[0], pk.shape[0]
        live = sk[sk != imax]
        direct = live.numel() > 0 and \
            int(live[-1]) - int(sk[0]) < max(2 * nb, np_)
        out.append(f"{nb} x {np_} ({'direct' if direct else 'search'})")
    return "; ".join(out)


CALL_SHAPES = {
    "join_probe_counts": probe_shapes,
    "compact": lambda calls: "; ".join(
        f"{a[0].shape[0]} rows -> {int(a[2])} slots, {len(a[1])} columns"
        for a, _kw in calls),
    "compose_index": lambda calls: "; ".join(
        f"take {a[1].shape[0]}, {len(a[0])} priors, "
        f"{len(a[2]) if len(a) > 2 else 0} masks" for a, _kw in calls),
}


def exchange_shapes(torch, K, calls, key):
    """One line per recorded K12 fixed call of `key`: rows per source,
    destinations, columns and their widths, region, rows moved."""
    for i, (a, kw) in enumerate(calls):
        cols, dest, valid, ndst, region = a[:5]
        widths = [next((c.element_size() for c in cs if c is not None), 0)
                  for cs in zip(*cols)]
        cm = K.exchange_fixed(*a, **kw)[2]
        say(f"{_qname(key)} exchange_fixed call {i}: rows per source "
            f"{[v.shape[0] for v in valid]}, {ndst} destinations, "
            f"{len(widths)} columns of widths {widths}, region {int(region)},"
            f" {int(torch_min_sum(cm, int(region)))} rows moved"
            f"{'' if dest is not None else ' (gather form)'}")


def torch_min_sum(cm, region: int):
    """Rows of a fixed-capacity exchange that fit: per destination the
    smaller of its row count and the region, summed."""
    return cm.sum(dim=0).clamp(max=region).sum()


def fused_bytes_ops(a, out):
    """fused_scan_agg: the live rows of every column slot (the needed
    columns at their encoded widths and the four MVCC columns) and the
    aux tables read once, the literal rows, snapshots and txids read,
    the [K, A + 1, G] table written; per row the shared program once,
    per query the visibility test and the qual program."""
    spec, cols, n_rows, lits, snaps, txids = a[:6]
    n = int(n_rows)
    by = sum(n * d.element_size() + (nbytes(x) if x is not None else 0)
             for d, x, _f in cols) + nbytes(lits) + nbytes(snaps) \
        + nbytes(txids) + nbytes(out)
    k = snaps.shape[0]
    ops = n * spec.n_shared + n * k * (8 + len(spec.instrs) - spec.n_shared
                                       + len(spec.aggs))
    return by, ops


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


def compare_call(torch, K, plain, name, a, kw):
    """Rerun one recorded main-path call through the kernel and through
    its plain version on the same inputs; returns the max abs error."""
    got = wrapper_of(K, name)(*a, **kw)
    want = plain[name](*a, **kw)
    torch.cuda.synchronize()
    if name == "grouped_agg_dense":
        return compare_agg(got, want, a[4], "main path")
    if name == "grouped_agg_sort":
        return compare_group(torch, got, want, a[4], "main path")
    if name == "join_probe_counts":
        compare_probe(torch, got, want, "main path")
        return 0.0
    if name == "join_expand":
        compare_expand(torch, got, want, "main path")
        return 0.0
    if name == "exchange":
        compare_exchange(torch, got, want, "main path")
        return 0.0
    if name == "exchange_fixed":
        compare_exchange_fixed(torch, got, want, "main path")
        return 0.0
    if name == "compact":
        compare_compact(torch, got, want, "main path")
        return 0.0
    if name == "fused_scan_agg":
        check(torch.equal(got, want), "fused_scan_agg differs from its "
              "plain version on a main-path call")
        return 0.0
    if name in WINDOW_KERNELS:
        return compare_window(torch, got, want, f"{name} main path",
                              rtol=WIN_RTOL)
    e = result_err(torch, got, want)
    check(e == 0.0, f"{name} differs from its plain version on a main-path "
          f"call (max err {e})")
    return e


def run_path(torch, K, s, queries, names, on_query=None):
    """Drive one slice's path: record every kernel call of each query,
    set the launch counters to 0 just before, read them just after.
    Returns (rows, cold ms, calls per query, launches, launches per
    query); `on_query(q)` runs after each query."""
    calls, restore = record_calls(K, names)
    per_query, rows, cold, per_q_launches = {}, {}, {}, {}
    K.reset_launches()
    try:
        for q in queries:
            for c in calls.values():
                c.clear()
            before = dict(K.LAUNCHES)
            t0 = time.perf_counter()
            rows[q] = s.query(Q_TEXT[q])
            torch.cuda.synchronize()
            cold[q] = (time.perf_counter() - t0) * 1e3
            per_query[q] = {n: list(c) for n, c in calls.items()}
            per_q_launches[q] = {n: K.LAUNCHES[n] - before[n]
                                 for n in K.LAUNCHES}
            if on_query is not None:
                on_query(q)
        launches = dict(K.LAUNCHES)
    finally:
        restore()
    return rows, cold, per_query, launches, per_q_launches


Q_TEXT: dict = {}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor (default 1: about 6.0 M "
                    "lineitem rows)")
    ap.add_argument("--vectors", type=int, default=1_000_000,
                    help="rows of the vector table (default 1 M x 128, "
                    "SIFT1M's shape)")
    ap.add_argument("--tpcds-sf", type=float, default=TPCDS_SF,
                    help="TPC-DS scale of the generator (default 720.1: "
                    "store_sales at its SF1 size, 2,880,400 rows)")
    ap.add_argument("--profile", action="store_true",
                    help="also split warm Q1/Q6/Q3/Q5 into session phases "
                    "and profile one of each (torch.profiler)")
    ap.add_argument("--checks", action="store_true",
                    help="only build the kernels and hold each against its "
                    "plain version on the small and large inputs above "
                    "(no data load)")
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
    from opentenbase_tpu_torch.exec import executor as X
    from opentenbase_tpu_torch.exec import mesh_exec as ME
    from opentenbase_tpu_torch.ops import ann as ANN
    Q_TEXT.update(Q)
    Q_TEXT.update({f"c{q}": Q[q] for q in (1, 3, 5)})
    Q_TEXT.update({f"f{q}": Q[q] for q in (1, 6, 3, 5)})
    # slices 1-3 drive the eager tiers, as they did before the fused tier
    # and the cluster program
    X.Executor._fuse = False
    ME.MeshRunner._capture = False

    t_start = time.perf_counter()
    card = setup(torch)
    small_kernel_check(torch, K)
    sort_kernel_check(torch, K)
    join_kernel_check(torch, K)
    probe_kernel_check(torch, K)
    expand_kernel_check(torch, K, card)
    group_kernel_check(torch, K, card)
    dense_agg_kernel_check(torch, K, card)
    cluster_kernel_check(torch, K)
    compact_kernel_check(torch, K)
    compose_kernel_check(torch, K)
    ann_kernel_check(torch, ANN)
    lloyd_kernel_check(torch, ANN, card)
    window_kernel_check(torch, K)
    float_key_check(torch, K)
    int_window_check(torch)
    setop_check(torch, K)
    say(f"launch counts from captured graphs: torch.profiler agreed on "
        f"{PROFILER_COUNTS['agreed']}, lost its device events on "
        f"{PROFILER_COUNTS['lost']}")
    if args.checks:
        say(f"kernel checks: ok ({time.perf_counter() - t_start:.1f} s)")
        return 0

    # ---- data: all eight tables ----
    t0 = time.perf_counter()
    data = datagen.generate(sf=args.sf)
    t_gen = time.perf_counter() - t0
    n_li = len(data["lineitem"]["l_orderkey"])
    say(f"datagen sf={args.sf}: {t_gen:.1f} s ({n_li} lineitem rows)")
    node = LocalNode()                         # the card, by default
    check(node.device.type == DEVICE, f"node on {node.device}")
    s = Session(node)
    s.execute(SCHEMA)
    t_load = 0.0
    for tname in datagen.TABLES:
        t0 = time.perf_counter()
        datagen.load_into(s, data, (tname,))
        dt = time.perf_counter() - t0
        t_load += dt
        say(f"load {tname}: {dt:.1f} s "
            f"({len(next(iter(data[tname].values())))} rows)")
    want_q1, want_q6 = oracle(data["lineitem"])
    want_q3, want_q5 = oracle_q3(data), oracle_q5(data)
    names = list(KERNEL_SOURCES)
    plain = plain_versions(K)

    # every K4 launch of the paths below, by path and branch
    k4_tally = K4Tally(K)
    # ---- slice 1: Q1, Q6 ----
    k4_tally.path = "q1_q6"
    got1, cold1, calls1, launches1, _pq = run_path(torch, K, s,
                                                   SLICE1_QUERIES, names)
    say(f"slice 1 path launches (Q1 + Q6): {json.dumps(launches1)}")
    for n in SLICE1:
        check(launches1[n] > 0, f"kernel {n} was not launched on slice 1's "
              "path")
    rows_equal(got1[1], want_q1, "Q1", approx=(6, 7, 8))
    rows_equal(got1[6], want_q6, "Q6")
    check(len(got1[1]) == 4 and all(np.isfinite(v) for r in got1[1]
                                    for v in r[2:]), "Q1 result shape")
    say(f"Q1 = numpy oracle ({len(got1[1])} groups); Q6 = numpy oracle "
        f"(revenue {got1[6][0][0]})")
    say(f"cold (first, staging included): Q1 {cold1[1]:.1f} ms, Q6 "
        f"{cold1[6]:.1f} ms")

    # ---- slice 2: Q3, Q5 (oracles), Q4, Q13, Q22 (the port on the CPU) ----
    k4_tally.path = "q3_q5_q4_q13_q22"
    got2, cold2, calls2, launches2, pq2 = run_path(torch, K, s,
                                                   SLICE2_QUERIES, names)
    say(f"slice 2 path launches (Q3 + Q5 + Q4 + Q13 + Q22): "
        f"{json.dumps(launches2)}")
    for n in SLICE2:
        check(launches2[n] > 0, f"kernel {n} was not launched on slice 2's "
              "path")
    rows_equal(got2[3], want_q3, "Q3")
    rows_equal(got2[5], want_q5, "Q5")
    check(len(got2[3]) == 10 and len(got2[5]) == 5, "Q3/Q5 result shape")
    say(f"Q3 = numpy oracle ({len(got2[3])} rows, top revenue "
        f"{got2[3][0][1]}); Q5 = numpy oracle ({len(got2[5])} nations)")
    cs = Session(_cpu_twin(node))
    for q in (4, 13, 22):
        want = cs.query(Q[q])
        rows_equal(got2[q], want, f"Q{q} (card vs the port on the CPU)")
        check(len(want) > 0, f"Q{q} returned no rows")
        say(f"Q{q} on the card = the port on the CPU ({len(want)} rows)")
    say("cold (first, staging included): " + ", ".join(
        f"Q{q} {cold2[q]:.1f} ms" for q in SLICE2_QUERIES))
    say(f"staged {node.cache.uploaded_bytes / 1e6:.1f} MB to the card")
    join_shapes(torch, calls2)
    for q in (3, 5):
        sides = calls2[q]["compose_index"]
        priors = sum(len(a[0]) for a, _kw in sides)
        check(pq2[q]["compose_index"] == len(sides),
              f"Q{q}: {pq2[q]['compose_index']} compose_index launches for "
              f"{len(sides)} join sides")
        say(f"Q{q} compose_index: {pq2[q]['compose_index']} launches = "
            f"{len(sides)} join sides, composing {priors} prior index "
            f"vectors and {sum(len(a[2]) for a, _kw in sides)} null masks")

    # ---- slice 3: the cluster tier ----
    k4_tally.path = "cluster2_q1_q3_q5"
    cs, got3, calls3, launches3, cold3 = cluster_path(
        torch, K, data, names, {1: got1[1], 3: got2[3], 5: got2[5]},
        {1: want_q1, 3: want_q3, 5: want_q5})
    k4_tally.path = "cluster3_q5_shape"
    calls_q5s, launches_q5s = q5_shape_path(torch, K, names)
    k4_tally.path = "mesh_library"
    calls_mesh, launches_mesh = mesh_library_path(torch, K, names)
    # ---- slice 7: the cluster tier's DataNode side as one program ----
    k4_tally.path = "cluster_program"
    calls7, launches7, k16 = mesh_program_path(
        torch, K, cs, data, names, {1: got1[1], 3: got2[3], 5: got2[5]},
        {1: want_q1, 3: want_q3, 5: want_q5}, card)
    for key in ("m5", "m5c4"):
        exchange_shapes(torch, K, calls7[key]["exchange_fixed"], key)

    # ---- slice 4: the fused tier and the serving tier ----
    X.Executor._fuse = True
    k4_tally.path = "fused_q1_q6_q3_q5"
    calls_f, launches_f = fused_path(
        torch, K, s, names, {1: got1[1], 6: got1[6], 3: got2[3],
                             5: got2[5]},
        {1: want_q1, 6: want_q6, 3: want_q3, 5: want_q5}, card)
    fused_kernel_check(torch, K, calls_f, card)
    k4_tally.path = "serving"
    calls_srv, launches_srv = serving_path(torch, K, node, names, card)
    # ---- slice 5: vector search ----
    k4_tally.path = "vector"
    vp = vector_path(torch, K, ANN, names, card, args.vectors)
    # ---- slice 6: TPC-DS and window functions ----
    k4_tally.path = "tpcds (sf1 node, check load, cluster2)"
    tp = tpcds_path(torch, K, card, args.tpcds_sf)
    k4_tally.restore()
    k4_tally.report(card)
    k4_block = block_vs_global(torch, K, k4_tally, card)
    # the timing and profile sections below time the eager tiers, as
    # before; fused_path and mesh_program_path timed the programs against
    # them
    X.Executor._fuse = False
    ME.MeshRunner._capture = False

    # ---- kernels against their plain versions, main-path inputs ----
    max_err = {n: 0.0 for n in names}
    for calls in (calls1, calls2, calls3, calls_q5s, calls_mesh, calls7,
                  calls_f, calls_srv, vp["calls_k"], tp["calls"],
                  tp["calls_c"]):
        for qcalls in calls.values():
            for n in names:
                for a, kw in qcalls.get(n, ()):
                    max_err[n] = max(max_err[n], compare_call(
                        torch, K, plain, n, a, kw))
    for n, e in tp["setop_err"].items():
        max_err[n] = max(max_err[n], e)
    say("kernels vs plain (main-path inputs of every path): ok")
    ann_err = vector_compare(torch, ANN, vp)

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
    for q in (1, 6, 3, 5):
        ms = statistics.median(
            [_wall(torch, lambda: s.query(Q[q])) for _ in range(REPS)])
        say(f"Q{q} warm median {ms:.2f} ms ({n_li / ms / 1e3:.1f} M "
            f"lineitem rows/s) over {REPS} runs [{card}]")
    for q in (1, 3, 5):
        ms = statistics.median(
            [_wall(torch, lambda: cs.query(Q[q])) for _ in range(REPS)])
        say(f"cluster Q{q} (2 DataNodes) warm median {ms:.2f} ms "
            f"({n_li / ms / 1e3:.1f} M lineitem rows/s) over {REPS} runs "
            f"[{card}]")
    compact_limit_measure(torch, K, cs, calls3["c3"]["compact"], card)
    qcalls = {**calls1, **calls2, **calls3, **calls_q5s, **calls_mesh,
              **calls7, **calls_f, **tp["calls"]}
    records = []
    for n in names:
        src, replaces, tq = KERNEL_SOURCES[n]
        ms = pms = bytes_ = ops = 0.0
        for a, kw in qcalls[tq][n]:
            out = wrapper_of(K, n)(*a, **kw)
            kernel_call, plain_call = timed_calls(K, plain, n, a, kw)
            ms += time_fn(torch, kernel_call)
            pms += time_fn(torch, plain_call)
            b, o = call_bytes_ops(n, a, kw, out)
            bytes_ += b
            ops += o
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        lib_ms = _library_ms(torch, K, n, qcalls[tq][n])
        by_path = {"q1_q6": launches1[n], "q3_q5_q4_q13_q22": launches2[n],
                   "cluster2_q1_q3_q5": launches3[n],
                   "cluster3_q5_shape": launches_q5s[n],
                   "mesh_library": launches_mesh[n],
                   "cluster_program": launches7[n],
                   "fused_q1_q6_q3_q5": launches_f[n],
                   "serving": launches_srv[n],
                   "vector": vp["launches"][n],
                   "tpcds_sf1": tp["launches"][n],
                   "tpcds_check": tp["launches_k"][n],
                   "tpcds_cluster2": tp["launches_c"][n],
                   "tpcds_setops": tp["launches_s"][n]}
        launches = sum(by_path.values())
        if n == "grouped_agg_dense":
            splits = k4_split(torch, K, {
                "Q1": qcalls[tq][n], "Q6 (one group)": calls1[6][n],
                "cluster program Q1": calls7["m1"][n]}, card)
            split = {**splits["Q1"], "q6": splits["Q6 (one group)"],
                     "program_q1": splits["cluster program Q1"],
                     "branch_launches": k4_tally.by_path,
                     "block_vs_global": k4_block}
        elif n in DEVICE_SPLIT:
            split = device_split(torch, K, n, qcalls[tq][n], card)
        else:
            split = {}
        records.append({
            "name": n, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": max_err[n], "ms": ms, "plain_ms": pms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "timed_on": _qname(tq), **split})
        if n in CALL_SHAPES:
            say(f"kernel {n} calls on {_qname(tq)}: "
                + CALL_SHAPES[n](qcalls[tq][n]))
        say(f"kernel {n}: {len(qcalls[tq][n])} call(s) per {_qname(tq)}, "
            f"{ms:.4f} ms, plain {pms:.4f} ms, bound {max(t_bytes, t_ops):.4f}"
            f" ms ({bytes_ / 1e6:.1f} MB), library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}; launches "
            f"{' + '.join(str(v) for v in by_path.values())} [{card}]")
    records.append(k16)
    records += tp["setop_records"]
    records += vector_measure(torch, K, ANN, vp, ann_err, card,
                              profile=args.profile)
    del vp
    window_measure(torch, K, tp, card)
    # K10 at 2^20 and at the one-block path's edge, K6 at Q5's build
    # sizes on both branches, against torch.sort(stable=True)
    sort_measure(torch, K, card, sorted({a[0].shape[0] for a, _kw in
                                         calls2[5]["join_build"]}))
    say("FUSED tier after the run: " + json.dumps(_fused_tier_stats()))
    if args.profile:
        X.Executor._fuse = True
        profile_queries(torch, [(f"fused Q{q}", s, Q[q])
                                for q in (1, 6, 3, 5)], card)
        X.Executor._fuse = False
        host_phases(torch, s, Q, card, REPS)
        profile_queries(torch, [(f"Q{q}", s, Q[q]) for q in (1, 6, 3, 5)]
                        + [(f"cluster Q{q}", cs, Q[q]) for q in (1, 3, 5)],
                        card)
    say(f"phases: datagen {t_gen:.1f} s, load {t_load:.1f} s, total "
        f"{time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# slice 4: the fused tier and the serving tier
# ---------------------------------------------------------------------------

def _fused_tier_stats() -> dict:
    from opentenbase_tpu_torch.exec import plancache
    f = plancache.FUSED
    return {"hits": f.hits, "misses": f.misses, "captures": f.compiles,
            "capture_ms": round(f.compile_ms, 3), "evictions": f.evictions,
            "live_graphs": f.live(), "pool_bytes": f.pool_bytes()}


def _fused_counters():
    from opentenbase_tpu_torch.exec import executor as X, fused, plancache
    return (plancache.FUSED.compiles, fused.LADDER_READS,
            X.exec_stats_snapshot()["host_syncs"],
            plancache.FUSED.pool_bytes(), fused.declines_snapshot())


def fused_path(torch, K, s, names, eager_rows, oracles, card):
    """Slice 4: Q1, Q6, Q3 and Q5 through Session.query on the fused
    tier, the launch counters set to 0 before the path and read after:
    the first call of each runs the traced fragment and captures its
    program, then REPS warm calls replay it.  Rows against the numpy
    oracles and the eager tier's rows; no decline; captures on the
    first call only; at most one host read a warm call (the join
    ladder's) and no eager join read; the graph pool bytes.  Then warm
    ms, fused against eager, in turns, REPS a side."""
    from opentenbase_tpu_torch.exec import executor as X
    from opentenbase_tpu_torch.tpch.queries import Q
    calls, restore = record_calls(K, names)
    per_query = {}
    K.reset_launches()
    try:
        for fq in FUSED_QUERIES:
            q = int(fq[1:])
            for c in calls.values():
                c.clear()
            cap0, lr0, hs0, pool0, dec0 = _fused_counters()
            t0 = time.perf_counter()
            rows = s.query(Q[q])
            torch.cuda.synchronize()
            cold = (time.perf_counter() - t0) * 1e3
            cap1, lr1, hs1, pool1, dec1 = _fused_counters()
            check(dec1 == dec0, f"fused Q{q}: a screen declined a fragment "
                  f"({dec0} -> {dec1})")
            check(cap1 - cap0 == 1, f"fused Q{q}: {cap1 - cap0} captures on "
                  "the first call, want 1")
            approx = (6, 7, 8) if q == 1 else ()
            rows_equal(rows, oracles[q], f"fused Q{q} (numpy oracle)", approx)
            rows_equal(rows, eager_rows[q], f"fused Q{q} (eager tier)",
                       approx)
            for _ in range(REPS):
                check(s.query(Q[q]) == rows, f"fused Q{q}: a warm replay "
                      "returned other rows")
            torch.cuda.synchronize()
            cap2, lr2, hs2, pool2, _d = _fused_counters()
            check(cap2 == cap1, f"fused Q{q}: a warm call recaptured")
            check(hs2 == hs1, f"fused Q{q}: an eager join read on a warm "
                  "call")
            reads = (lr2 - lr1) / REPS
            check(reads <= 1, f"fused Q{q}: {reads} host reads a warm call")
            per_query[fq] = {n: list(c) for n, c in calls.items()}
            say(f"fused Q{q}: rows = oracle = eager tier ({len(rows)} rows); "
                f"first call {cold:.1f} ms, {cap1 - cap0} capture, "
                f"{lr1 - lr0} host read(s); {REPS} warm replays: 0 captures, "
                f"{reads:g} host read(s) a call (the join ladder's), "
                f"graph pool {(pool2 - pool0) / 2**20:.1f} MiB [{card}]")
        launches = dict(K.LAUNCHES)
    finally:
        restore()
    say(f"slice 4 path launches (fused Q1 + Q6 + Q3 + Q5, first calls and "
        f"{REPS} warm replays each): {json.dumps(launches)}")
    for n in SLICE4:
        check(launches[n] > 0, f"kernel {n} was not launched on the fused "
              "path")
    # warm ms, fused against eager, in turns
    for fq in FUSED_QUERIES:
        q = int(fq[1:])
        fms, ems = [], []
        for _ in range(REPS):
            X.Executor._fuse = True
            fms.append(_wall(torch, lambda: s.query(Q[q])))
            X.Executor._fuse = False
            ems.append(_wall(torch, lambda: s.query(Q[q])))
        X.Executor._fuse = True
        fm, em = statistics.median(fms), statistics.median(ems)
        say(f"fused Q{q} warm median {fm:.3f} ms vs eager {em:.3f} ms "
            f"({em / fm:.2f}x), in turns, {REPS} a side; fused "
            f"{' '.join(f'{v:.3f}' for v in fms)}; eager "
            f"{' '.join(f'{v:.3f}' for v in ems)} [{card}]")
        dev_ms = graph_replay_time(torch, s, Q[q], f"Q{q}", card)
        say(f"fused Q{q} device share of a warm call: {dev_ms:.4f} ms of "
            f"{fm:.3f} ms ({100 * dev_ms / fm:.1f}%) [{card}]")
    return per_query, launches


def graph_replay_time(torch, s, sql, label, card):
    """Device ms of one warm replay of the query's program (input write,
    replay, output copies), CUDA events around REPS replays, against the
    bytes bound of the fragment's needed columns at their encoded widths
    plus the four MVCC columns, read once."""
    from opentenbase_tpu_torch.exec import executor as X, fused
    from opentenbase_tpu_torch.ops import kernels as K
    from opentenbase_tpu_torch.sql.parser import parse_sql
    seen = []
    orig = fused.FusedProgram.run

    def rec(self, queries):
        seen.append((self, list(queries)))
        return orig(self, queries)
    fused.FusedProgram.run = rec
    try:
        s.query(sql)
    finally:
        fused.FusedProgram.run = orig
    check(len(seen) == 1 and seen[0][0].captured,
          f"{label}: not one captured program")
    prog, queries = seen[0]
    ms = time_fn(torch, lambda: prog.run(queries), reps=REPS)
    planned = s._plan_select(parse_sql(sql)[0])
    by = 0
    for scan in fused._find_scans(planned.plan) or ():
        arrs, n = prog.staged[scan.table.name]
        need = fused._needed_columns(planned.plan, scan.alias) | {
            "__xmin_ts", "__xmax_ts", "__xmin_txid", "__xmax_txid"}
        for c in need:
            by += n * arrs[c].element_size()
    bound = by / HBM_BYTES_PER_S * 1e3
    nodes = replay_nodes(torch, K, prog)
    say(f"K14 graph replay {label}: {ms:.4f} ms device, bound {bound:.4f} ms "
        f"({by / 1e6:.1f} MB of needed columns), "
        f"{sum(prog.graph_launches.values())} kernel launches a replay: "
        f"{json.dumps(prog.graph_launches)}; graph nodes (kernels, "
        f"memsets) {nodes} [{card}]")
    X.Executor._fuse = True
    return ms


def fused_kernel_check(torch, K, calls_f, card):
    """fused_scan_agg against its plain version on Q1's and Q6's
    main-path inputs at K = 1 (the recorded call) and K = 16 (the same
    columns, 16 literal rows moved around the recorded ones), exact; with
    the kernel's, the plain version's and the bound's times."""
    for fq in ("f1", "f6"):
        got = calls_f[fq]["fused_scan_agg"]
        check(len(got) >= 1, f"fused {fq}: no fused_scan_agg call recorded")
        a, kw = got[0]
        spec, cols, n_rows, lits, snaps, txids, aborted = a
        dev = lits.device
        k16 = 16
        offs = (torch.arange(k16, device=dev, dtype=torch.int64) - 8) \
            .unsqueeze(1)
        lits16 = (lits[:1] + offs).contiguous()
        args16 = (spec, cols, n_rows, lits16, snaps[:1].repeat(k16),
                  txids[:1].repeat(k16), aborted)
        for k, args in ((1, a), (k16, args16)):
            gk = K.fused_scan_agg(*args)
            pk = K.fused_scan_agg_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(gk, pk), f"fused_scan_agg differs from its "
                  f"plain version ({fq}, K = {k})")
            ms = time_fn(torch, lambda: K.fused_scan_agg(*args))
            pms = time_fn(torch, lambda: K.fused_scan_agg_plain(*args),
                          reps=3)
            by, ops = fused_bytes_ops(args, gk)
            bound = max(by / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
            say(f"fused_scan_agg Q{fq[1:]} K={k}: = plain (exact); kernel "
                f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bound:.4f} ms "
                f"({by / 1e6:.1f} MB, {len(spec.instrs)} instructions, "
                f"{spec.n_groups} groups, {len(spec.aggs)} aggregates) "
                f"[{card}]")


def serving_params(rng, kind: str) -> str:
    """One statement with the TPC-H spec's substitution parameters:
    Q1 DELTA in [60, 120] (2.4.1.3); Q3 SEGMENT BUILDING, DATE in
    1995-03-01..31 (2.4.3.3); Q6 DATE the first of January of a year in
    1993..1997, DISCOUNT in [0.02, 0.09], QUANTITY in [24, 25]
    (2.4.6.3)."""
    from opentenbase_tpu_torch.tpch.queries import Q
    if kind == "q1":
        return Q[1].replace("interval '90' day",
                            f"interval '{int(rng.integers(60, 121))}' day")
    if kind == "q3":
        return Q[3].replace("1995-03-15",
                            f"1995-03-{int(rng.integers(1, 32)):02d}")
    year = int(rng.integers(1993, 1998))
    disc = int(rng.integers(2, 10))
    qty = int(rng.integers(24, 26))
    return (Q[6].replace("1994-01-01", f"{year}-01-01")
            .replace("0.06", f"0.0{disc}")
            .replace("l_quantity < 24", f"l_quantity < {qty}"))


def serving_path(torch, K, node, names, card, seed=4):
    """The serving tier on the card: SERVE_THREADS client threads, each
    with its own Session, run SERVE_PER_THREAD statements each through
    one Scheduler (window 2 ms, at most 16 a batch).  Every result must
    equal the serial Session result of the same statement on the card,
    bit for bit; at least one batch of more than one query must form;
    the admission slots must balance.  Two rounds: the first captures
    each signature's batch classes, the second (new parameters) replays
    them; the path's launches are both rounds'."""
    import numpy as np
    rng = np.random.default_rng(seed)
    kinds = ("q1", "q6", "q3")
    calls = {n_: [] for n_ in names}
    launches = {n_: 0 for n_ in names}
    batched = False
    for rnd in ("cold", "warm"):
        c, ln, hist = _serving_round(torch, K, node, rng, kinds, rnd, card)
        for n_ in names:
            calls[n_] += c.get(n_, [])
            launches[n_] += ln.get(n_, 0)
        batched = batched or any(k > 1 for k in hist)
    check(batched, "serving: no batch of more than one query formed")
    return {"serve": calls}, launches


def _serving_round(torch, K, node, rng, kinds, rnd, card):
    import threading
    from opentenbase_tpu_torch.exec import scheduler as sm
    from opentenbase_tpu_torch.exec.session import Session
    stmts = [[serving_params(rng, kinds[(t + j) % 3])
              for j in range(SERVE_PER_THREAD)]
             for t in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    ref = [[Session(node).query(sql) for sql in row] for row in stmts]
    torch.cuda.synchronize()
    say(f"serving ({rnd}): {SERVE_THREADS * SERVE_PER_THREAD} statements "
        f"run serially on the card in {time.perf_counter() - t0:.2f} s")
    got = [[None] * SERVE_PER_THREAD for _ in range(SERVE_THREADS)]
    errs = []
    sm.reset_stats()
    # the fused scan-aggregate calls of the batches are held against the
    # plain version with the other main-path calls
    calls, restore = record_calls(K, ("fused_scan_agg",))
    K.reset_launches()
    barrier = threading.Barrier(SERVE_THREADS)
    try:
        with sm.Scheduler(node=node) as sched:
            def client(t):
                try:
                    sess = Session(node)
                    barrier.wait()
                    for j, sql in enumerate(stmts[t]):
                        got[t][j] = sched.run(sess, sql)[-1].rows
                except Exception as e:   # noqa: BLE001 (reported below)
                    errs.append(e)
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(SERVE_THREADS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    finally:
        restore()
    if errs:
        raise SmokeFailure(f"serving: {errs[0]!r}")
    for t in range(SERVE_THREADS):
        for j in range(SERVE_PER_THREAD):
            check(got[t][j] == ref[t][j], f"serving: client {t} statement "
                  f"{j} differs from its serial result")
    st = sm.stats_snapshot()
    acq, rel = sm.slot_balance()
    check(acq == rel, f"serving: admission slots {acq} acquired, {rel} "
          "released")
    check(launches["fused_scan_agg"] > 0, "serving: fused_scan_agg was not "
          "launched")
    n = SERVE_THREADS * SERVE_PER_THREAD
    say(f"serving ({rnd}): {n} statements from {SERVE_THREADS} threads = "
        f"serial "
        f"(bit for bit); {n / wall:.1f} statements/s ({wall:.2f} s); "
        f"dispatches {st['dispatches']}, batch_dispatches "
        f"{st['batch_dispatches']}, batched {st['batched']}, batch sizes "
        f"{st['batch_hist']}; queue wait p50 {st['queue_wait_p50_ms']:.2f} "
        f"ms, p99 {st['queue_wait_p99_ms']:.2f} ms; pipelined "
        f"{st['pipelined_dispatches']}; slot_balance() ({acq}, {rel}) "
        f"[{card}]")
    say(f"serving ({rnd}) path launches: {json.dumps(launches)}")
    return calls, launches, st["hist"]


def join_shapes(torch, calls):
    """The shapes the joins and the sort-based aggregate saw."""
    imax = (1 << 63) - 1
    for q, qc in calls.items():
        for a, _kw in qc["join_probe_counts"]:
            sk, pv = a[0], a[2]
            say(f"Q{q} join: build {sk.shape[0]} padded "
                f"({int((sk != imax).sum())} live keys), probe "
                f"{pv.shape[0]} padded ({int(pv.sum())} valid)")
        for a, kw in qc["join_expand"]:
            say(f"Q{q} join expansion: {a[1].shape[0]} probe rows, "
                f"{int(a[1].sum())} matching pairs, output {int(a[3])} rows"
                f"{' (left outer)' if kw.get('left_outer') else ''}")
        for a, _kw in qc["grouped_agg_sort"]:
            say(f"Q{q} sort-based GROUP BY: {a[1].shape[0]} rows "
                f"({int(a[1].sum())} valid), {len(a[0])} keys, max_groups "
                f"{int(a[3])}")
        for a, _kw in qc["hash_columns"]:
            say(f"Q{q} two-key join hash: {len(a[0])} columns x "
                f"{a[0][0].shape[0]} rows")


def _qname(q) -> str:
    if isinstance(q, int):
        return f"Q{q}"
    if q.startswith("dsx"):
        return f"TPC-DS window statement {q[3:]}"
    if q.startswith("dsc"):
        return f"cluster TPC-DS q{q[3:]}"
    if q.startswith("dsk"):
        return f"TPC-DS q{q[3:]} (check load)"
    if q.startswith("ds"):
        return f"TPC-DS q{q[2:]}"
    if q == "mesh":
        return "parallel/mesh.py path"
    if q.startswith("m"):
        return f"cluster program Q{q[1:].replace('c4', '')}" + (
            " (4 DataNodes)" if q.endswith("c4") else "")
    if q.startswith("f"):
        return f"fused Q{q[1:]}"
    return f"cluster Q{q[1:]}"


def cluster_path(torch, K, data, names, single, oracles):
    """Slice 3: load the SF1 tables into Cluster(2) on the card, drive
    Q1, Q3 and Q5 through ClusterSession.query with the launch counters
    set to 0 before the path and read after it (and per query), and hold
    the rows against the numpy oracles, the single-node Session's rows
    and the same session's host tier."""
    import numpy as np
    from opentenbase_tpu_torch.exec.dist_session import ClusterSession
    from opentenbase_tpu_torch.exec.mesh_exec import mesh_runner_for
    from opentenbase_tpu_torch.parallel.cluster import Cluster
    from opentenbase_tpu_torch.tpch import datagen
    from opentenbase_tpu_torch.tpch.queries import Q
    from opentenbase_tpu_torch.tpch.schema import SCHEMA
    cluster = Cluster(n_datanodes=2)             # the card, by default
    check(cluster.device.type == DEVICE, f"cluster on {cluster.device}")
    cs = ClusterSession(cluster)
    cs.execute(SCHEMA)
    t_load = 0.0
    for tname in datagen.TABLES:
        t0 = time.perf_counter()
        datagen.load_into_cluster(cs, data, (tname,))
        t_load += time.perf_counter() - t0
    per_dn = [dn.stores["lineitem"].row_count() for dn in cluster.datanodes]
    say(f"cluster load (2 DataNodes): {t_load:.1f} s; lineitem rows per "
        f"DataNode {per_dn}")
    check(sum(per_dn) == len(data["lineitem"]["l_orderkey"])
          and min(per_dn) > 0, "lineitem not sharded over both DataNodes")
    runner = mesh_runner_for(cluster)
    matrices = {}

    def on_query(q):
        matrices[q] = list(runner.last_exchanges)
    got, cold, calls, launches, per_q = run_path(
        torch, K, cs, SLICE3_QUERIES, names, on_query)
    say(f"slice 3 path launches (cluster Q1 + Q3 + Q5): "
        f"{json.dumps(launches)}")
    for n in SLICE3:
        check(launches[n] > 0, f"kernel {n} was not launched on slice 3's "
              "path")
    for q in SLICE3_QUERIES:
        for n in CLUSTER_KERNELS:
            check(per_q[q][n] > 0, f"{_qname(q)} did not launch {n}")
        # every exchange moved its rows on the kernels: K11 once per
        # source DataNode of each redistribute, K12 once per exchange
        kinds = [kind for _i, kind, _cm in matrices[q]]
        check(per_q[q]["route_dest"] == 2 * kinds.count("redistribute")
              and per_q[q]["exchange"] == len(kinds),
              f"{_qname(q)}: an exchange did not run on K11 + K12")
        check(cs.tier_counts.get("mesh", 0) >= len(SLICE3_QUERIES)
              and cs.fallbacks == [], f"{_qname(q)} left the device tier")
        say(f"{_qname(q)} launches: " + ", ".join(
            f"{n} {per_q[q][n]}" for n in CLUSTER_KERNELS))
        for idx, kind, cm in matrices[q]:
            say(f"{_qname(q)} exchange {idx} ({kind}) rows "
                f"[source DN x destination DN]: {cm.tolist()}")
    for q in (1, 3, 5):
        approx = (6, 7, 8) if q == 1 else ()
        rows_equal(got[f"c{q}"], oracles[q], f"cluster Q{q} vs oracle",
                   approx)
        rows_equal(got[f"c{q}"], single[q],
                   f"cluster Q{q} vs the single-node Session", approx)
    check(all(np.isfinite(v) for r in got["c1"] for v in r[2:]),
          "cluster Q1 not finite")
    cs.execute("set enable_mesh_exchange = off")
    for q in (1, 3, 5):
        host = cs.query(Q[q])
        check(cs.last_tier == "host", "host tier did not run")
        rows_equal(got[f"c{q}"], host, f"cluster Q{q} device vs host tier",
                   (6, 7, 8) if q == 1 else ())
    cs.execute("set enable_mesh_exchange = on")
    say("cluster Q1, Q3, Q5 (2 DataNodes) = numpy oracles = single-node "
        "Session = host tier")
    say("cold (first, cluster staging included): " + ", ".join(
        f"{_qname(q)} {cold[q]:.1f} ms" for q in SLICE3_QUERIES))
    return cs, got, calls, launches, cold


_Q5_SHAPE_DDL = [
    "create table t (k bigint primary key, grp int, v decimal(10,2)) "
    "distribute by shard(k)",
    "create table u (uk bigint primary key, tk bigint, w decimal(10,2)) "
    "distribute by shard(uk)",
    "create table d (id int primary key, label varchar(8)) "
    "distribute by replication",
    "insert into t values " + ", ".join(
        f"({i}, {i % 3}, {i}.25)" for i in range(64)),
    "insert into u values " + ", ".join(
        f"({100 + i}, {i % 64}, {i}.5)" for i in range(96)),
    "insert into d values (0, 'zero'), (1, 'one'), (2, 'two')",
]
_Q5_SHAPE = ("select label, count(*) as n, sum(v * w) as rev "
             "from t, u, d where k = tk and grp = id "
             "group by label order by rev desc")


def q5_shape_path(torch, K, names):
    """The Q5-shaped SQL of __graft_entry__.dryrun_multichip on
    Cluster(3), whose shard map is not hash % 3: device tier against
    host tier, launch counters set to 0 before and read after."""
    from opentenbase_tpu_torch.exec.dist_session import ClusterSession
    from opentenbase_tpu_torch.parallel.cluster import Cluster
    cs = ClusterSession(Cluster(n_datanodes=3))
    for sql in _Q5_SHAPE_DDL:
        cs.execute(sql)
    cs.execute("set enable_mesh_exchange = off")
    host = cs.query(_Q5_SHAPE)
    cs.execute("set enable_mesh_exchange = on")
    Q_TEXT["q5shape"] = _Q5_SHAPE
    got, _cold, calls, launches, _pq = run_path(torch, K, cs, ("q5shape",),
                                                names)
    check(cs.last_tier == "mesh" and cs.fallbacks == [],
          "Q5-shaped SQL left the device tier")
    for n in CLUSTER_KERNELS:
        check(launches[n] > 0, f"Q5-shaped SQL on 3 DataNodes did not "
              f"launch {n}")
    rows_equal(got["q5shape"], host, "Q5-shaped SQL, device vs host tier")
    check(len(host) == 3, "Q5-shaped SQL: 3 groups")
    say(f"Q5-shaped SQL on 3 DataNodes: device tier = host tier "
        f"({len(host)} groups); launches " + ", ".join(
            f"{n} {launches[n]}" for n in CLUSTER_KERNELS))
    return calls, launches


def mesh_library_path(torch, K, names):
    """parallel/mesh.py on 2 DataNodes of the card: redistribute of
    2^20 rows by a key (bucket_ids + the exchange) and psum_partial (the
    cross-DataNode sum on K4's kernel), against numpy."""
    import numpy as np
    from opentenbase_tpu_torch.parallel import mesh as M
    from opentenbase_tpu_torch.utils.hashing import hash_columns_np
    rng = np.random.default_rng(11)
    n = 1 << 20
    keys = rng.integers(0, 1 << 40, n).astype(np.int64)
    vals = rng.integers(0, 1000, n).astype(np.int64)
    mesh = M.make_mesh(2)
    cols, valid = M.shard_columns(mesh, {"k": keys, "v": vals}, n)
    calls, restore = record_calls(K, names)
    K.reset_launches()
    try:
        out, omask, counts = M.redistribute(mesh, cols, valid, "k")
        sums = M.psum_partial(
            mesh, lambda v, c: (torch.where(v, c["v"], 0).sum(),
                                v.to(torch.int64).sum()), cols, valid, 2)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    finally:
        restore()
    for nm in MESH_LIBRARY:
        check(launches[nm] > 0, f"kernel {nm} was not launched on the "
              "parallel/mesh.py path")
    ok, om = out["k"].cpu().numpy(), omask.cpu().numpy()
    per = len(om) // 2
    owner = (hash_columns_np([ok[om]]) % np.uint64(2)).astype(int)
    check(int(om.sum()) == n and (owner == np.nonzero(om)[0] // per).all(),
          "redistribute: rows lost or off their owner")
    check(int(sums[0]) == int(vals.sum()) and int(sums[1]) == n,
          "psum_partial differs from numpy")
    say(f"parallel/mesh.py on 2 DataNodes: {n} rows redistributed "
        f"(rows [source DN x destination DN]: {counts.tolist()}), psum = "
        f"numpy; launches " + ", ".join(
            f"{nm} {launches[nm]}" for nm in MESH_LIBRARY))
    return {"mesh": {k: list(v) for k, v in calls.items()}}, launches


def host_phases(torch, s, Q, card, reps):
    """Warm queries split into the session's phases, medians over `reps`:
    parse + bind + plan, execute (to a synchronised device batch), and
    materialize (device -> host rows)."""
    from opentenbase_tpu_torch.exec.executor import (ExecContext, Executor,
                                                     materialize)
    from opentenbase_tpu_torch.sql.parser import parse_sql
    for q in (1, 6, 3, 5):
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


def profile_queries(torch, items, card):
    """One warm run of each (label, session, sql) under torch.profiler:
    device time by kernel and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for label, s, sql in items:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.query(sql)
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
        say(f"profile {label}: wall {wall_us / 1e3:.3f} ms (profiler on), "
            f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%),"
            f" {sum(r[1] for r in rows)} device events [{card}]")
        for dev_us, count, key in rows[:12]:
            say(f"  {dev_us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
        # the cluster kernels' own device time (K11 route, K12 exchange,
        # K3 compaction and the scatter they share), apart from their
        # wrappers' host work
        mine = [(dev_us, count, _cluster_label(key))
                for dev_us, count, key in rows if _cluster_label(key)]
        if mine:
            say(f"  cluster kernels on the device: "
                f"{sum(r[0] for r in mine) / 1e3:.4f} ms in "
                f"{sum(r[1] for r in mine)} launches: " + ", ".join(
                    f"{label} {dev_us / 1e3:.4f} ms x{count}"
                    for dev_us, count, label in mine))


# ---------------------------------------------------------------------------
# slice 7: the whole cluster plan as one captured program (K16)
# ---------------------------------------------------------------------------

# cluster Q1, Q3, Q5 on Cluster(2) and Q5 on Cluster(4), one program each
PROGRAM_QUERIES = (("m1", 2, 1), ("m3", 2, 3), ("m5", 2, 5),
                   ("m5c4", 4, 5))
SLICE7 = ("mesh_program", "route_dest", "exchange_fixed", "compact",
          "visibility_mask", "decode_column", "grouped_agg_dense",
          "grouped_agg_sort", "join_build", "join_probe_counts",
          "join_expand", "compose_index", "sort_rows")


def _mesh_counters(K):
    from opentenbase_tpu_torch.exec import mesh_exec as ME, plancache
    return (plancache.MESH.compiles, ME.LADDER_READS,
            K.LAUNCHES["mesh_program"], plancache.MESH.hits)


def _mesh_lookups() -> int:
    from opentenbase_tpu_torch.exec import plancache
    return plancache.MESH.hits + plancache.MESH.misses


def _program_of(sess, sql):
    """(MeshProgram, run arguments) of the statement's DataNode side: one
    warm call, its program's run recorded."""
    from opentenbase_tpu_torch.exec import mesh_exec as ME
    seen = []
    orig = ME.MeshProgram.run

    def rec(self, *a):
        seen.append((self, a))
        return orig(self, *a)
    ME.MeshProgram.run = rec
    try:
        sess.query(sql)
    finally:
        ME.MeshProgram.run = orig
    check(len(seen) == 1 and seen[0][0].captured,
          "not one run of one captured cluster program")
    return seen[0]


def program_bytes(prog):
    """Bytes the DataNode side must read: the needed columns of every
    scan of its fragments at their staged widths plus the four MVCC
    columns, over every DataNode's live rows, read once."""
    from opentenbase_tpu_torch.exec import fused
    from opentenbase_tpu_torch.exec.mesh_exec import MeshRunner
    from opentenbase_tpu_torch.plan import physical as P
    by = 0
    for plan in prog.plans.values():
        for scan in MeshRunner._walk(plan):
            if not isinstance(scan, P.SeqScan):
                continue
            st = prog.staged[scan.table.name]
            need = fused._needed_columns(plan, scan.alias) | {
                "__xmin_ts", "__xmax_ts", "__xmin_txid", "__xmax_txid"}
            by += sum(sum(st.counts) * st.arrs[c].element_size()
                      for c in need if c in st.arrs)
    return by


def program_err(torch, got, want) -> float:
    """max |replay - eager run| over the gathered outputs' live rows; the
    valid masks, the overflow vectors and the count matrices must be
    equal."""
    (g_outs, g_vec, g_cnt), (w_outs, w_vec, w_cnt) = got, want
    check(torch.equal(g_vec, w_vec) and torch.equal(g_cnt, w_cnt),
          "K16: the replay's overflow or count matrices differ")
    err = 0.0
    for gi, (gc, gv, gn) in g_outs.items():
        wc, wv, wn = w_outs[gi]
        check(torch.equal(gv, wv), f"K16: gather {gi} valid mask differs")
        for n in gc:
            a, b = gc[n][gv], wc[n][wv]
            if a.dtype.is_floating_point:
                e = float((a - b).abs().max()) if a.numel() else 0.0
                check(e <= SUMF_RTOL * max(float(b.abs().max()), 1.0),
                      f"K16: gather {gi} column {n} differs by {e}")
                err = max(err, e)
            else:
                check(torch.equal(a, b), f"K16: gather {gi} column {n} "
                      "differs")
        for n in gn:
            check(torch.equal(gn[n][gv], wn[n][wv]),
                  f"K16: gather {gi} null mask {n} differs")
    return err


def mesh_program_path(torch, K, cs, data, names, single, oracles, card):
    """Slice 7: cluster Q1, Q3 and Q5 at SF1 on Cluster(2) (`cs`, loaded
    by slice 3) and Q5 on a Cluster(4) loaded here, through
    ClusterSession.query with the DataNode side as one program each
    (MeshRunner._capture, the default), the launch counters set to 0
    before the path and read after it.  The first call of each runs the
    traced body and captures it (after the ladder's growth, if any); the
    REPS warm calls that follow must each be one graph replay with no
    capture, no decline and one host read (the ladder's).  Rows against
    the numpy oracles, the single-node Session and the host tier.  Then
    the learned ladder values, each exchange's count matrix (read after
    the call), warm ms captured against eager in turns, the replay's
    device ms and the K16 record."""
    from opentenbase_tpu_torch.exec import mesh_exec as ME
    from opentenbase_tpu_torch.exec.dist_session import ClusterSession
    from opentenbase_tpu_torch.parallel.cluster import Cluster
    from opentenbase_tpu_torch.tpch import datagen
    from opentenbase_tpu_torch.tpch.queries import Q
    from opentenbase_tpu_torch.tpch.schema import SCHEMA
    cluster4 = Cluster(n_datanodes=4)
    check(cluster4.device.type == DEVICE, f"cluster on {cluster4.device}")
    cs4 = ClusterSession(cluster4)
    cs4.execute(SCHEMA)
    t0 = time.perf_counter()
    datagen.load_into_cluster(cs4, data)
    per_dn = [dn.stores["lineitem"].row_count() for dn in cluster4.datanodes]
    say(f"cluster load (4 DataNodes): {time.perf_counter() - t0:.1f} s; "
        f"lineitem rows per DataNode {per_dn}")
    sessions = {2: cs, 4: cs4}
    host = {}
    for key, ndn, q in PROGRAM_QUERIES:
        sessions[ndn].execute("set enable_mesh_exchange = off")
        host[key] = sessions[ndn].query(Q[q])
        sessions[ndn].execute("set enable_mesh_exchange = on")
    ME.MeshRunner._capture = True
    calls, restore = record_calls(K, names)
    per_query, matrices = {}, {}
    K.reset_launches()
    try:
        for key, ndn, q in PROGRAM_QUERIES:
            sess = sessions[ndn]
            for c in calls.values():
                c.clear()
            cap0, lr0, rp0, _hit0 = _mesh_counters(K)
            t0 = time.perf_counter()
            rows = sess.query(Q[q])
            torch.cuda.synchronize()
            cold = (time.perf_counter() - t0) * 1e3
            cap1, lr1, rp1, hit1 = _mesh_counters(K)
            check(cap1 - cap0 == 1 and rp1 == rp0, f"{_qname(key)}: "
                  f"{cap1 - cap0} captures and {rp1 - rp0} replays on the "
                  "first call, want 1 and 0")
            approx = (6, 7, 8) if q == 1 else ()
            for want, what in ((oracles[q], "numpy oracle"),
                               (single[q], "single-node Session"),
                               (host[key], "host tier")):
                rows_equal(rows, want, f"{_qname(key)} vs the {what}",
                           approx)
            for _ in range(REPS):
                check(sess.query(Q[q]) == rows, f"{_qname(key)}: a warm "
                      "replay returned other rows")
                check(sess.last_tier == "mesh" and sess.fallbacks == [],
                      f"{_qname(key)} left the device tier")
            torch.cuda.synchronize()
            cap2, lr2, rp2, hit2 = _mesh_counters(K)
            check(cap2 == cap1, f"{_qname(key)}: a warm call recaptured")
            check(rp2 - rp1 == REPS and hit2 - hit1 == REPS,
                  f"{_qname(key)}: {rp2 - rp1} replays of {hit2 - hit1} "
                  f"program hits in {REPS} warm calls")
            check(lr2 - lr1 == REPS, f"{_qname(key)}: {lr2 - lr1} ladder "
                  f"host reads in {REPS} warm calls, want one a call")
            runner = ME.mesh_runner_for(sess.cluster)
            matrices[key] = [(i, kind, c.tolist())
                             for i, kind, c in runner.last_exchanges]
            per_query[key] = {n: list(c) for n, c in calls.items()}
            say(f"{_qname(key)}: rows = oracle = single node = host tier "
                f"({len(rows)} rows); first call {cold:.1f} ms, "
                f"{cap1 - cap0} capture, {lr1 - lr0} ladder read(s); "
                f"{REPS} warm calls: {rp2 - rp1} graph replays, 0 captures, "
                f"{(lr2 - lr1) / REPS:g} host read a call")
        launches = dict(K.LAUNCHES)
    finally:
        restore()
    say(f"slice 7 path launches (cluster programs Q1 + Q3 + Q5 on 2 "
        f"DataNodes, Q5 on 4; first calls and {REPS} warm replays each): "
        f"{json.dumps(launches)}")
    for n in SLICE7:
        check(launches[n] > 0, f"kernel {n} was not launched on slice 7's "
              "path")
    for ndn, sess in sessions.items():
        for lkey, (factors, mults, gathers) in \
                ME.mesh_runner_for(sess.cluster)._ladder.items():
            say(f"learned ladder, {ndn} DataNodes, plan {lkey}: join "
                f"factors {factors}, exchange multipliers {mults}, gather "
                f"classes {gathers}")
    for key, mats in matrices.items():
        for i, kind, cm in mats:
            say(f"{_qname(key)} exchange {i} ({kind}) rows [source DN x "
                f"destination DN]: {cm}")
    # warm ms, captured against eager, in turns; the replay's device ms
    record = None
    for key, ndn, q in PROGRAM_QUERIES:
        sess = sessions[ndn]
        ms = {True: [], False: []}
        for r in range(REPS):
            for cap in ((True, False) if r % 2 == 0 else (False, True)):
                ME.MeshRunner._capture = cap
                ms[cap].append(_wall(torch, lambda: sess.query(Q[q])))
        ME.MeshRunner._capture = True
        pm, em = statistics.median(ms[True]), statistics.median(ms[False])
        prog, args = _program_of(sess, Q[q])
        dev_ms = time_fn(torch, lambda: prog.run(*args), reps=REPS)
        with prog._lock:
            plain = prog._traced_run()
        replay = prog.run(*args)
        torch.cuda.synchronize()
        err = program_err(torch, (
            {gi: (b.cols, b.valid, b.nulls) for gi, b in replay[0].items()},
            replay[1], replay[2]), plain)

        def eager_body(prog=prog):
            with prog._lock:
                prog._traced_run()
        plain_ms = time_fn(torch, eager_body, reps=REPS)
        by = program_bytes(prog)
        bound = by / HBM_BYTES_PER_S * 1e3
        per_replay = sum(v for k, v in prog.graph_launches.items()
                         if k != "mesh_program")
        nodes = replay_nodes(torch, K, prog)
        k7 = prog.graph_launches.get("join_probe_counts", 0)
        say(f"{_qname(key)} warm median: captured {pm:.3f} ms, eager "
            f"{em:.3f} ms ({em / pm:.2f}x), {REPS} a side in turns; "
            f"captured {' '.join(f'{v:.3f}' for v in ms[True])}; eager "
            f"{' '.join(f'{v:.3f}' for v in ms[False])} [{card}]")
        say(f"K16 {_qname(key)}: replay {dev_ms:.4f} ms device "
            f"({100 * dev_ms / pm:.1f}% of the warm call), the same body "
            f"launched op by op {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({by / 1e6:.1f} MB of needed columns), {per_replay} kernel "
            f"launches a replay ({k7} K7 calls), graph nodes (kernels, "
            f"memsets) {nodes}, graph "
            f"pool {prog.pool_bytes / 2**20:.1f} MiB, replay = eager run "
            f"(max err {err:g}) [{card}]")
        if key == "m5":
            record = {
                "name": "mesh_program", "route": "cuda",
                "source": "opentenbase_tpu_torch/exec/mesh_exec.py",
                "replaces": "opentenbase_tpu/exec/mesh_exec.py:950",
                "launches": launches["mesh_program"],
                "max_abs_err": err, "ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
                "timed_on": _qname(key), "launches_per_replay": per_replay}
    # the profiler's first window in a process carries its start-up on the
    # host clock: discard one window
    busy_share(torch, lambda: cs.query(Q[1]))
    wall, busy = busy_share(torch, lambda: [cs.query(Q[q])
                                            for q in (1, 3, 5)])
    say(f"cluster programs' busy share (Q1 + Q3 + Q5 on 2 DataNodes, warm): "
        f"{busy_text(wall, busy)} [{card}]")
    del cs4, sessions
    return per_query, launches, record


def compact_limit_measure(torch, K, cs, calls, card, rounds=3):
    """K3's one-block limit against cluster Q3 (`calls`: its recorded
    compact calls on the eager cluster tier; `cs`: the Cluster(2)
    session).  Two forms, in turns (A B, B A, ...): `tiles`, with
    COMPACT_ONE_ROWS at one look-back tile, so the recorded calls take
    the tiles and a memset; and `one block`, the default limit.  For
    each: the calls' event-loop ms (time_fn around the wrapper calls),
    device-only and host ms (device_host_ms), and cluster Q3's program
    recaptured under the form, its replay's device ms (time_fn around
    the replays).  The results must equal compact_plain either way."""
    from opentenbase_tpu_torch.exec import mesh_exec as ME, plancache
    from opentenbase_tpu_torch.tpch.queries import Q
    default = K.COMPACT_ONE_ROWS
    forms = {"tiles": K._CMP_TILE, "one block": default}
    shapes = [(int(a[0].shape[0]), int(a[2])) for a, _kw in calls]
    check(all(max(n, o) <= default and max(n, o) > K._CMP_TILE
              for n, o in shapes),
          f"cluster Q3's compact calls {shapes} do not take both forms")
    res = {f: {"ms": [], "device_ms": [], "host_ms": [], "replay_ms": []}
           for f in forms}
    ME.MeshRunner._capture = True
    try:
        for r in range(rounds):
            for f in (("tiles", "one block") if r % 2 == 0
                      else ("one block", "tiles")):
                K.COMPACT_ONE_ROWS = forms[f]
                ms = dev = host = 0.0
                for a, kw in calls:
                    compare_compact(torch, K.compact(*a, **kw),
                                    K.compact_plain(*a, **kw),
                                    f"cluster Q3, {f}")
                    ms += time_fn(torch, lambda: K.compact(*a, **kw))
                    d, h = device_host_ms(torch,
                                          lambda: K.compact(*a, **kw))
                    dev += d
                    host += h
                for key in list(plancache.MESH._d):
                    plancache.MESH.pop(key)
                cs.query(Q[3])          # captures under this form
                prog, args = _program_of(cs, Q[3])
                rep = time_fn(torch, lambda: prog.run(*args), reps=REPS)
                for k_, v in (("ms", ms), ("device_ms", dev),
                              ("host_ms", host), ("replay_ms", rep)):
                    res[f][k_].append(v)
    finally:
        K.COMPACT_ONE_ROWS = default
        ME.MeshRunner._capture = False
    for key in list(plancache.MESH._d):
        plancache.MESH.pop(key)
    for f, v in res.items():
        say(f"K3 form {f} (one-block limit {forms[f]}) on cluster Q3's "
            f"{len(calls)} calls {shapes}, {rounds} rounds in turns: "
            + "; ".join(f"{k_} " + " ".join(f"{x:.4f}" for x in xs)
                        + f" (median {statistics.median(xs):.4f})"
                        for k_, xs in v.items()) + f" [{card}]")
    return res


# ---------------------------------------------------------------------------
# slice 5: vector search (K15)
# ---------------------------------------------------------------------------

# K15 kernel -> (its wrapper in ops/ann.py, source, the reference kernel)
VECTOR_KERNELS = {
    "ann_distances": ("distances", "opentenbase_tpu_torch/csrc/ann.cu",
                      "opentenbase_tpu/ops/ann.py:21"),
    "ann_topk": ("topk_nearest", "opentenbase_tpu_torch/csrc/ann.cu",
                 "opentenbase_tpu/ops/ann.py:39"),
    "ann_assign": ("assign_clusters", "opentenbase_tpu_torch/csrc/kmeans.cu",
                   "opentenbase_tpu/ops/ann.py:47"),
    "ann_lloyd_update": ("lloyd_update",
                         "opentenbase_tpu_torch/csrc/kmeans.cu",
                         "opentenbase_tpu/ops/ann.py:65"),
    "ann_probe_scan": ("probe_scan", "opentenbase_tpu_torch/csrc/ann.cu",
                       "opentenbase_tpu/ops/ann.py:98"),
}
# the wrappers whose main-path calls are recorded (ivf_search composes
# the others; its kernel path is held against its plain path)
ANN_WRAPPERS = tuple(v[0] for v in VECTOR_KERNELS.values()) + ("ivf_search",)
# the earlier kernels the vector path must reach too: the scan's
# visibility mask, the decode of the id column, the range count's
# aggregate, the sort (the Lloyd update's cluster order, the coordinator's
# merge by distance)
SLICE5_OTHERS = ("visibility_mask", "decode_column", "grouped_agg_dense",
                 "sort_rows")
# the configuration: ann-benchmarks sift-128-euclidean's shape (1 M x 128
# f32, L2, recall@10) with pgvector's IVFFlat advice (lists = rows / 1000,
# probes lists // 8); vectors a 1000-cluster Gaussian mixture from the
# seed
VEC_DIM = 128
VEC_CLUSTERS = 1000
VEC_CATS = 10
VEC_LISTS = 1000
VEC_K = 10
VEC_QUERIES = (("l2", 20), ("cosine", 5), ("ip", 5))
VEC_FILTERED = 5
IVF_QUERIES = 100
IVF_RECALL_MIN = 0.8
CLUSTER_IVF_QUERIES = 20
VEC_RTOL = 1e-5
VEC_OPS = {"l2": "<->", "cosine": "<=>", "ip": "<#>"}


def vec_lit(v) -> str:
    return "[" + ",".join(f"{x:.6f}" for x in v) + "]"


def lit_vec(np, v):
    """The query vector as its SQL literal carries it."""
    return np.asarray(vec_lit(v).strip("[]").split(","), dtype=np.float32)


def vector_data(torch, np, n, seed):
    """n x 128 f32 rows of a 1000-cluster Gaussian mixture (centers at
    scale 4, unit noise), made on the card from the seed."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    centers = torch.randn(VEC_CLUSTERS, VEC_DIM, generator=g,
                          device=dev) * 4.0
    lab = torch.randint(0, VEC_CLUSTERS, (n,), generator=g, device=dev)
    vecs = centers[lab] + torch.randn(n, VEC_DIM, generator=g, device=dev)
    return vecs.float().cpu().numpy()


def vec_exact(np, vecs, queries):
    """f64 distances of every row to each (q, metric) query, with the
    reference's formulas: the oracle."""
    n = len(vecs)
    qm = np.stack([q.astype(np.float64) for q, _m in queries])
    qn2 = (qm * qm).sum(1)
    out = np.empty((len(queries), n))
    step = 1 << 17
    for lo in range(0, n, step):
        v = vecs[lo:lo + step].astype(np.float64)
        dots = v @ qm.T
        vn2 = (v * v).sum(1)[:, None]
        for j, (_q, metric) in enumerate(queries):
            d = dots[:, j]
            if metric == "ip":
                out[j, lo:lo + step] = -d
            elif metric == "cosine":
                out[j, lo:lo + step] = 1 - d / np.maximum(
                    np.sqrt(vn2[:, 0] * qn2[j]), 1e-30)
            else:
                out[j, lo:lo + step] = np.sqrt(np.maximum(
                    vn2[:, 0] - 2 * d + qn2[j], 0))
    return out


def vec_tol(np, vecs, q, metric, rows, dist):
    """Absolute tolerance of the f32 distance of `rows` (tests/
    test_torch_ann.py's): cosine 1e-5; ip 1e-5 |v| |q|; l2 through its
    square, 1e-5 (|v|^2 + |q|^2)."""
    rows = np.asarray(rows, dtype=np.int64)
    vn2 = (vecs[rows].astype(np.float64) ** 2).sum(1)
    qn2 = float(q.astype(np.float64) @ q)
    if metric == "cosine":
        return np.full(len(rows), VEC_RTOL)
    if metric == "ip":
        return VEC_RTOL * np.sqrt(vn2 * qn2)
    d = dist[rows]
    return VEC_RTOL * d + VEC_RTOL * (vn2 + qn2) / np.maximum(
        d, np.sqrt(VEC_RTOL * (vn2 + qn2)))


def vec_rank_ok(np, got, want, vecs, q, metric, dist, what):
    """Equal row lists but for swaps of rows whose oracle distances agree
    within the tolerance."""
    check(len(got) == len(want), f"{what}: {len(got)} rows, want "
          f"{len(want)}")
    rows = sorted(set(got) | set(want))
    tol = dict(zip(rows, vec_tol(np, vecs, q, metric, rows, dist)))
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            check(abs(dist[g] - dist[w]) <= tol[g] + tol[w],
                  f"{what}: rank {i} row {g} != {w} (distances {dist[g]} "
                  f"{dist[w]})")


def vec_top(np, dist, k, keep=None):
    d = dist if keep is None else np.where(keep, dist, np.inf)
    part = np.argpartition(d, k)[:k]
    return part[np.argsort(d[part], kind="stable")].tolist()


def ann_kernel_check(torch, ANN):
    """Each K15 kernel on small inputs against its plain version, every
    branch: three metrics, float4 and scalar rows, ties, masked rows, k
    above the valid count, k at and above the kernel's largest, empty
    clusters and invalid rows."""
    import numpy as np
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for n, d in ((1000, 128), (777, 7), (5, 16)):
        vecs = t(rng.normal(size=(n, d)).astype(np.float32))
        q = t(rng.normal(size=d).astype(np.float32))
        for metric in ("l2", "cosine", "ip"):
            got = ANN.distances(vecs, q, metric)
            want = ANN.distances_plain(vecs, q, metric)
            err = float((got.double() - want.double()).abs().max())
            check(err <= 1e-4 * (1 + float(want.abs().max())),
                  f"ann_distances {metric} d={d} differs (small): {err}")
    for n, k in ((64, 1), (64, 40), (3000, 10), (5000, 1024), (5000, 1500),
                 (200_000, 100)):
        dist = t(rng.choice(np.asarray([3.0, 1.0, 2.0, -0.0, 0.0, 0.5, -2.0],
                                       np.float32), n))
        valid = t(rng.random(n) < 0.5)
        for v in (valid, None):
            gi, gd = ANN.topk_nearest(dist, v, k)
            wi, wd = ANN.topk_nearest_plain(dist, v, k)
            check(torch.equal(gi, wi) and torch.equal(gd, wd),
                  f"ann_topk n={n} k={k} differs (small)")
    assign_edge_check(torch, ANN, np, rng, t)
    for n, nlist, d in ((3000, 70, 128), (1000, 1, 7), (500, 130, 16)):
        vecs = t(rng.normal(size=(n, d)).astype(np.float32))
        cents = t(rng.normal(size=(nlist, d)).astype(np.float32))
        for metric in ("l2", "cosine", "ip"):
            got = ANN.assign_clusters(vecs, cents, metric)
            want = ANN.assign_clusters_plain(vecs, cents, metric)
            assign_close(torch, got, want, vecs, cents, metric,
                         f"ann_assign {metric} nlist={nlist} (small)")
        valid = t(rng.random(n) < 0.8)
        assign = t(rng.integers(0, max(nlist - 3, 1), n).astype(np.int32))
        got = ANN.lloyd_update(vecs, valid, assign, cents, nlist)
        want = ANN.lloyd_update_plain(vecs, valid, assign, cents, nlist)
        lloyd_close(torch, got, want, vecs, f"ann_lloyd_update nlist={nlist}"
                    " (small)")
        if nlist > 3:
            check(torch.equal(got[-1], cents[-1]), "ann_lloyd_update: an "
                  "empty cluster moved")
        probed = t(rng.random(nlist + 1) < 0.3)
        probed[-1] = False
        q = t(rng.normal(size=d).astype(np.float32))
        for metric in ("l2", "cosine", "ip"):
            got = ANN.probe_scan(vecs, assign, probed, valid, q, metric)
            want = ANN.probe_scan_plain(vecs, assign, probed, valid, q,
                                        metric)
            dist_close(torch, got, want, vecs, q, metric,
                       f"ann_probe_scan {metric} (small)")
    torch.cuda.synchronize()
    say("K15 kernels vs plain (small inputs and edge branches): ok")
    vector_edge_check(torch, ANN, np, rng, t)


def nan_topk_oracle(np, dist, valid, k):
    """The rows of the k smallest masked distances in PostgreSQL's float
    order: -0.0 as 0.0, masked rows +inf, every NaN after +inf, ties to
    the lower row."""
    x = dist.astype(np.float64)
    if valid is not None:
        x = np.where(valid, x, np.inf)
    nan = np.isnan(x)
    return np.lexsort((np.arange(len(x)), np.where(nan, 0.0, x), nan))[:k]


def vector_edge_check(torch, ANN, np, rng, t):
    """K15a and K15d on rows with an infinite, a NaN (either sign) or a
    zero component, a zero row and a zero query, all three metrics:
    the same NaN rows as their plain versions and the others within
    1e-4; K15b on NaN distances of both signs, +inf, -0.0 and ties
    (small, and 2^20 + 3 rows with k 10, 125 and 1024) against its
    plain version on the CPU and the oracle of the rule, exactly; its
    kernel and memset nodes a call at the main path's two shapes; the
    card's Session on the probe table `it`."""
    neg_nan = np.copysign(np.float32(np.nan), np.float32(-1))
    n, d = 4103, 128
    v = rng.normal(size=(n, d)).astype(np.float32)
    v[5, 3], v[6, 0], v[7, 9], v[8, 1] = np.inf, -np.inf, np.nan, neg_nan
    v[9] = 0.0
    v[10, :2] = (np.inf, -np.inf)
    vecs = t(v)
    valid = t(rng.random(n) < 0.9)
    assign = t(np.zeros(n, np.int32))
    probed = t(np.asarray([True, False]))
    for qv in (rng.normal(size=d).astype(np.float32),
               np.zeros(d, np.float32)):
        q = t(qv)
        for metric in ("l2", "cosine", "ip"):
            for name, got, want in (
                    ("ann_distances", ANN.distances(vecs, q, metric),
                     ANN.distances_plain(vecs, q, metric)),
                    ("ann_probe_scan",
                     ANN.probe_scan(vecs, assign, probed, valid, q, metric),
                     ANN.probe_scan_plain(vecs, assign, probed, valid, q,
                                          metric))):
                gn, wn = torch.isnan(got), torch.isnan(want)
                check(torch.equal(gn, wn), f"{name} {metric}: NaN rows "
                      f"differ from the plain version ({int(gn.sum())} on "
                      f"the card, {int(wn.sum())} plain)")
                g, w = got[~wn].double(), want[~wn].double()
                check(torch.equal(torch.isinf(g), torch.isinf(w))
                      and torch.equal(g[torch.isinf(g)], w[torch.isinf(w)]),
                      f"{name} {metric}: infinite rows differ")
                fin = torch.isfinite(w)
                err = float((g[fin] - w[fin]).abs().max())
                check(err <= 1e-4 * (1 + float(w[fin].abs().max())),
                      f"{name} {metric} on the edge rows differs: {err}")
    cases = [(np.asarray([3, np.nan, 1, neg_nan, np.inf, 2, -0.0, 0.0],
                         np.float32), None, 8)]
    check(nan_topk_oracle(np, cases[0][0], None, 8).tolist()
          == [6, 7, 2, 5, 0, 4, 1, 3], "the NaN oracle's own example")
    m = (1 << 20) + 3
    big = rng.choice(np.asarray([0.5, 1.0, -0.0, 0.0, 2.0], np.float32), m)
    big[rng.integers(0, m, 1000)] = np.nan
    big[rng.integers(0, m, 1000)] = neg_nan
    big[rng.integers(0, m, 500)] = np.inf
    keep = rng.random(m) < 0.125
    few = np.where(rng.random(m) < 0.999, np.float32(np.nan), big)
    for k in (10, 125, 1024):
        cases += [(big, keep, k), (big, None, k), (few, None, k)]
    for dist, keep_, k in cases:
        dv, vv = t(dist), None if keep_ is None else t(keep_)
        gi, gd = ANN.topk_nearest(dv, vv, k)
        wi, wd = ANN.topk_nearest_plain(dv.cpu(), None if vv is None
                                        else vv.cpu(), k)
        check(torch.equal(gi.cpu(), wi) and torch.equal(
            gd.cpu().view(torch.int32), wd.view(torch.int32)),
            f"ann_topk on NaN / inf distances ({len(dist)} rows, k {k}) "
            "differs from its plain version")
        check(gi.cpu().numpy().tolist() == nan_topk_oracle(
            np, dist, keep_, k).tolist(),
            f"ann_topk on NaN / inf distances ({len(dist)} rows, k {k}) "
            "breaks the NaN rule")
    d1k = t(rng.normal(size=1000).astype(np.float32))
    dm = t(big)
    nodes = {"k 10 over 2^20 + 3": kernel_launches(
                 torch, lambda: ANN.topk_nearest(dm, None, 10)),
             "k 125 over 1000": kernel_launches(
                 torch, lambda: ANN.topk_nearest(d1k, None, 125))}
    for label, (kern, mems) in nodes.items():
        check(kern == 1 and mems <= 1, f"ann_topk ({label}): {kern} "
              f"kernels + {mems} memsets a call, want 1 + at most 1")
    rows = it_probe(None)
    check(rows == [(1,), (3,)], f"the it probe on the card's Session gave "
          f"{rows}, want [(1,), (3,)]")
    torch.cuda.synchronize()
    say(f"K15a / K15d vs plain on inf, NaN (both signs) and zero rows, a "
        f"zero query, 3 metrics; K15b = plain on the CPU = the NaN rule on "
        f"{len(cases)} cases (both NaN signs after +inf, -0.0, ties, "
        f"2^20 + 3 rows, k 10 / 125 / 1024): ok; kernel + memset nodes a "
        "call: " + ", ".join(f"{label} {a} + {b}"
                             for label, (a, b) in nodes.items())
        + f"; the it probe on the card's Session: {rows}")


IT_PROBE = ("insert into it values (1, '[1,1]'), (2, '[Infinity,0]'), "
            "(3, '[2,2]'), (4, '[3,3]')")


def it_probe(device):
    """`select id from it order by v <-> '[1,1]' limit 2` on a Session
    of a LocalNode on `device` (None: the card): row 2's l2 distance is
    inf - inf, NaN, which ranks last."""
    from opentenbase_tpu_torch.exec.session import LocalNode, Session
    s = Session(LocalNode() if device is None else LocalNode(device=device))
    s.execute("create table it (id bigint, v vector(2))")
    s.execute(IT_PROBE)
    return s.query("select id from it order by v <-> '[1,1]' limit 2")


def assign_special_cases(np, rng):
    """(label, rows, centroids) whose scores are exact in f32 whatever the
    order of the FMAs (small integer components), with the values that
    decide jnp.argmax's rule: a NaN component, a component of 1e20 (an l2
    score of inf - inf against a centroid of 1e20, a cosine |v| |c| of
    inf x 0 against the zero centroid), +-inf components, an all-zero
    row, duplicated centroids (ties to the lower index), a NaN centroid
    (every row takes the first NaN), and centroids whose l2 norms
    overflow (a row of -inf scores gives 0)."""
    d, nlist = 16, 24
    cents = rng.integers(-3, 4, (nlist, d)).astype(np.float32)
    cents[7] = cents[3]
    cents[19] = cents[3]
    cents[11] = 0.0
    rows = rng.integers(-3, 4, (300, d)).astype(np.float32)
    rows[:40] = cents[rng.integers(0, nlist, 40)]     # exact ties
    rows[40, 5] = np.nan
    rows[41, 0] = 1e20
    rows[42, 3] = -1e20
    rows[43] = 0.0
    rows[44, 2] = np.inf
    rows[45, 9] = -np.inf
    rows[46, :2] = (np.inf, -np.inf)
    big = cents.copy()
    big[5, 0] = 1e20
    big[17, 0] = -1e20
    nan_c = cents.copy()
    nan_c[6, 4] = np.nan
    nan_c[13, 0] = np.nan
    huge = cents.copy()
    huge[np.arange(nlist), np.arange(nlist) % d] = 1e20
    return [("special rows", rows, cents),
            ("centroids of 1e20", rows, big),
            ("NaN centroids", rows, nan_c),
            ("every l2 norm overflows", rows, huge)]


# K15c's tile edges: rows not a multiple of the 128-row tile, 1 to 1000
# lists around the 128-centroid tile, dimensions around the 16-dimension
# stage, the resident row tile (d <= 160) and the streamed one (300)
ASSIGN_EDGES = {"n": 1283, "nlist": (1, 127, 128, 129, 1000),
                "d": (7, 16, 128, 130, 300)}


def assign_kernel_info(torch, K, d):
    """(registers a thread, spilled bytes a thread, blocks an SM) of the
    compiled l2 assignment kernel at d dimensions."""
    import ctypes
    vals = [ctypes.c_int(0) for _ in range(3)]
    rc = K._lib().otbt_ann_assign_info(d, *(ctypes.addressof(v)
                                            for v in vals))
    check(rc == 0, f"otbt_ann_assign_info failed: error {rc}")
    return tuple(v.value for v in vals)


def assign_edge_check(torch, ANN, np, rng, t):
    """K15c exactly equal to its plain version on assign_special_cases,
    every metric; within assign_close at ASSIGN_EDGES; its kernel
    launches a call (the centroid prep and the product, + the rows'
    norms for cosine) and the compiled kernel's registers, spills and
    blocks an SM (at least 2)."""
    from opentenbase_tpu_torch.ops import kernels as K
    cases = assign_special_cases(np, rng)
    for label, rows, cents in cases:
        for metric in ("l2", "cosine", "ip"):
            got = ANN.assign_clusters(t(rows), t(cents), metric)
            want = ANN.assign_clusters_plain(t(rows), t(cents), metric)
            bad = torch.nonzero(got != want).flatten()[:8].tolist()
            check(not bad, f"ann_assign {metric} differs from its plain "
                  f"version ({label}) at rows {bad}: "
                  f"{got[bad].tolist()} vs {want[bad].tolist()}")
    n = ASSIGN_EDGES["n"]
    for d in ASSIGN_EDGES["d"]:
        vecs = t(rng.normal(size=(n, d)).astype(np.float32))
        for nlist in ASSIGN_EDGES["nlist"]:
            cents = t(rng.normal(size=(nlist, d)).astype(np.float32))
            for metric in ("l2", "cosine", "ip"):
                assign_close(torch, ANN.assign_clusters(vecs, cents, metric),
                             ANN.assign_clusters_plain(vecs, cents, metric),
                             vecs, cents, metric, f"ann_assign {metric} "
                             f"n={n} nlist={nlist} d={d}")
    vecs = t(rng.normal(size=(4096, 128)).astype(np.float32))
    cents = t(rng.normal(size=(1000, 128)).astype(np.float32))
    nodes = {m: kernel_launches(torch, lambda m=m: ANN.assign_clusters(
        vecs, cents, m)) for m in ("l2", "cosine", "ip")}
    for m, want in (("l2", (2, 0)), ("cosine", (3, 0)), ("ip", (2, 0))):
        check(nodes[m] == want, f"ann_assign {m}: {nodes[m][0]} launches, "
              f"{nodes[m][1]} memsets a call, want {want}")
    info = {d: assign_kernel_info(torch, K, d) for d in (128, 300)}
    check(info[128][2] >= 2, f"ann_assign at d = 128: {info[128][2]} "
          "block(s) an SM, want 2")
    torch.cuda.synchronize()
    say(f"K15c ann_assign = plain exactly on {len(cases)} special "
        "cases x 3 metrics (NaN, +-inf and 1e20 components, NaN, zero, "
        "duplicated and overflowing centroids, an all-zero row); within "
        f"assign_close at n={n}, nlist {ASSIGN_EDGES['nlist']}, d "
        f"{ASSIGN_EDGES['d']}: ok; kernel launches a call: "
        + ", ".join(f"{m} {k}" for m, (k, _z) in nodes.items())
        + "; compiled kernel (registers, spilled bytes, blocks an SM): "
        + ", ".join(f"d={d} {v}" for d, v in info.items()))


def dist_close(torch, got, want, vecs, q, metric, what) -> float:
    """Distances within the tolerance (+inf where the plain version has
    +inf); returns max |got - want| over the finite entries."""
    check(got.shape == want.shape, f"{what}: shape")
    gi, wi = torch.isinf(got), torch.isinf(want)
    check(torch.equal(gi, wi), f"{what}: +inf pattern differs")
    g, w = got.double()[~wi], want.double()[~wi]
    if g.numel() == 0:
        return 0.0
    v = vecs.double()[~wi]
    qn2 = float((q.double() ** 2).sum())
    vn2 = (v * v).sum(1)
    if metric == "cosine":
        ok = (g - w).abs() <= VEC_RTOL * (1 + w.abs())
    elif metric == "ip":
        ok = (g - w).abs() <= VEC_RTOL * ((vn2 * qn2).sqrt() + w.abs())
    else:
        ok = (g * g - w * w).abs() <= VEC_RTOL * (vn2 + qn2) \
            + VEC_RTOL * w * w
    bad = int((~ok).sum())
    check(bad == 0, f"{what}: {bad} distances outside the tolerance "
          f"(max err {float((g - w).abs().max())})")
    return float((g - w).abs().max())


def _scores64(torch, vecs, cents, metric):
    v, c = vecs.double(), cents.double()
    dots = v @ c.T
    if metric == "ip":
        return dots
    if metric == "cosine":
        return dots / torch.clamp_min(v.norm(dim=1)[:, None]
                                      * c.norm(dim=1)[None], 1e-30)
    return 2 * dots - (c * c).sum(1)[None]


def assign_close(torch, got, want, vecs, cents, metric, what) -> float:
    """Equal assignments but for rows whose two picks score within the
    tolerance (f32 products summed in another order); returns the
    largest score gap at a differing row."""
    diff = torch.nonzero(got != want).flatten()
    if diff.numel() == 0:
        return 0.0
    s = _scores64(torch, vecs[diff], cents, metric)
    r = torch.arange(diff.numel(), device=s.device)
    gap = (s[r, got[diff].long()] - s[r, want[diff].long()]).abs()
    if metric == "cosine":
        tol = VEC_RTOL * 4
    else:
        vn = vecs[diff].double().norm(dim=1)
        cn = cents.double().norm(dim=1).max()
        tol = VEC_RTOL * 4 * (2 * vn * cn + cn * cn)
    check(bool((gap <= tol).all()), f"{what}: {diff.numel()} rows differ, "
          f"largest score gap {float(gap.max())}")
    return float(gap.max())


def lloyd_close(torch, got, want, vecs, what) -> float:
    """Centroids within relative 1e-5 and 1e-5 of the largest |value| (the
    sums' order differs)."""
    scale = float(vecs.abs().max()) if vecs.numel() else 1.0
    err = (got.double() - want.double()).abs()
    ok = err <= VEC_RTOL * (want.double().abs() + scale)
    check(bool(ok.all()), f"{what}: max err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def compare_ann_call(torch, ANN, name, a, kw) -> float:
    """One recorded main-path call of a K15 wrapper rerun through the
    kernel and its plain version; returns the error measure."""
    fn = getattr(ANN, name)
    got = fn(*a, **kw)
    want = getattr(ANN, name + "_plain")(*a, **kw)
    torch.cuda.synchronize()
    if name == "distances":
        return dist_close(torch, got, want, a[0], a[1],
                          a[2] if len(a) > 2 else kw.get("metric", "l2"),
                          "ann_distances (main path)")
    if name == "topk_nearest":
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              "ann_topk differs from its plain version (main path)")
        return 0.0
    if name == "assign_clusters":
        return assign_close(torch, got, want, a[0], a[1],
                            a[2] if len(a) > 2 else kw.get("metric", "l2"),
                            "ann_assign (main path)")
    if name == "lloyd_update":
        return lloyd_close(torch, got, want, a[0],
                           "ann_lloyd_update (main path)")
    if name == "probe_scan":
        return dist_close(torch, got, want, a[0], a[4],
                          a[5] if len(a) > 5 else kw.get("metric", "l2"),
                          "ann_probe_scan (main path)")
    raise KeyError(name)


def vector_path(torch, K, ANN, names, card, n, seed=11):
    """Slice 5 on the card: the vector table through Session, exact and
    filtered search, a range count, the index built twice, IVF search,
    IVF statements served through Scheduler, and the cluster's host
    tier.  The launch counters are set to 0 just before and read just
    after; every kernel call is recorded for the comparisons."""
    import numpy as np
    from opentenbase_tpu_torch.exec import plancache
    from opentenbase_tpu_torch.exec.session import LocalNode, Session
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    vecs = vector_data(torch, np, n, seed)
    ids = np.arange(n, dtype=np.int64)
    cats = np.asarray([f"c{i}" for i in range(VEC_CATS)])[ids % VEC_CATS]

    def near(row):
        return lit_vec(np, vecs[row] + rng.normal(scale=0.5, size=VEC_DIM))
    exact_q = [(m, near(int(rng.integers(n))), None)
               for m, cnt in VEC_QUERIES for _ in range(cnt)]
    exact_q += [("cosine", near(int(rng.integers(n))), i % VEC_CATS)
                for i in range(VEC_FILTERED)]
    range_q = near(int(rng.integers(n)))
    ivf_q = [near(int(rng.integers(n))) for _ in range(IVF_QUERIES)]
    allq = [(q, m) for m, q, _c in exact_q] + [(range_q, "l2")] \
        + [(q, "l2") for q in ivf_q]
    oracle = vec_exact(np, vecs, allq)
    t_data = time.perf_counter() - t0
    say(f"vectors: {n} x {VEC_DIM} f32 ({vecs.nbytes / 1e6:.0f} MB, "
        f"{VEC_CLUSTERS}-cluster mixture) and the f64 oracle of "
        f"{len(allq)} queries in {t_data:.1f} s")

    node = LocalNode()
    check(node.device.type == DEVICE, f"node on {node.device}")
    s = Session(node)
    s.execute(f"create table items (id bigint primary key, embedding "
              f"vector({VEC_DIM}), cat varchar(4)) distribute by shard(id)")
    td, st = node.catalog.table("items"), node.stores["items"]
    t0 = time.perf_counter()
    s._insert_rows(td, st, {"id": ids, "embedding": vecs, "cat": cats}, n)
    say(f"vector load: {time.perf_counter() - t0:.1f} s ({n} rows)")

    calls_k, restore_k = record_calls(K, names)
    calls_a, restore_a = record_calls(ANN, ANN_WRAPPERS)
    out = {"node": node, "session": s, "vecs": vecs, "ivf_q": ivf_q,
           "oracle": oracle, "n_exact": len(exact_q)}
    K.reset_launches()
    try:
        # (a) exact search: AnnSearch without an index, and the range count
        t0 = time.perf_counter()
        exact_rows = []
        for j, (metric, q, cat) in enumerate(exact_q):
            where = "" if cat is None else f"where cat = 'c{cat}' "
            rows = s.query(f"select id, embedding {VEC_OPS[metric]} "
                           f"'{vec_lit(q)}' as d from items {where}order by "
                           f"d limit {VEC_K}")
            exact_rows.append(rows)
            keep = None if cat is None else (ids % VEC_CATS == cat)
            want = vec_top(np, oracle[j], VEC_K, keep)
            got = [r[0] for r in rows]
            vec_rank_ok(np, got, want, vecs, q, metric, oracle[j],
                        f"exact {metric} query {j}")
            tol = vec_tol(np, vecs, q, metric, got, oracle[j])
            for (rid, dd), tl in zip(rows, tol):
                check(abs(dd - oracle[j][rid]) <= tl + VEC_RTOL * abs(dd),
                      f"exact {metric} query {j}: distance {dd} of row "
                      f"{rid}, oracle {oracle[j][rid]}")
            if cat is not None:
                check(all(r % VEC_CATS == cat for r in got), "filtered "
                      "search returned a row of another category")
        t_exact = time.perf_counter() - t0
        jr = len(exact_q)
        srt = np.sort(oracle[jr])
        lo = min(400, n - 2)
        win = srt[lo:min(lo + 200, n - 1) + 1]
        g = int(np.argmax(np.diff(win)))
        radius = float((win[g] + win[g + 1]) / 2)
        want_count = lo + g + 1
        check(float(win[g + 1] - win[g]) > 1e-3, "range query: no clear gap")
        caps = plancache.FUSED.compiles
        range_sql = (f"select count(*) from items where embedding <-> "
                     f"'{vec_lit(range_q)}' < {radius!r}")
        for _ in range(2):     # the capture, then a replay
            got = s.query(range_sql)
            check(got == [(want_count,)], f"range count {got}, oracle "
                  f"{want_count}")
        check(plancache.FUSED.compiles == caps + 1, "range count: not one "
              "captured program")
        say(f"exact search: {len(exact_q)} queries ({VEC_QUERIES}, "
            f"{VEC_FILTERED} filtered on cat) = f64 oracle in "
            f"{t_exact:.2f} s; range count = oracle ({want_count}) on the "
            "fused tier (one capture, one replay)")

        # (b) the index, built twice from the same rows
        cents, builds = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            s.execute(f"create index items_emb on items using ivfflat "
                      f"(embedding) with (lists = {VEC_LISTS})")
            torch.cuda.synchronize()
            builds.append(time.perf_counter() - t0)
            cents.append(st.ann_indexes["embedding"]["centroids"].copy())
        check(cents[0].tobytes() == cents[1].tobytes(), "two index builds "
              "gave different centroids")
        info = st.ann_indexes["embedding"]
        check(cents[0].shape == (VEC_LISTS, VEC_DIM) and
              info["nprobe"] == VEC_LISTS // 8, "index state")
        say(f"ivfflat build (lists {VEC_LISTS}, nprobe {info['nprobe']}): "
            f"{builds[0]:.2f} s, {builds[1]:.2f} s; centroids identical bit "
            f"for bit [{card}]")
        out["build_s"] = builds

        # (c) IVF search
        t0 = time.perf_counter()
        hits = 0
        out["ivf_rows"] = []
        for j, q in enumerate(ivf_q):
            rows = s.query(f"select id from items order by embedding <-> "
                           f"'{vec_lit(q)}' limit {VEC_K}")
            got = [r[0] for r in rows]
            check(len(got) == VEC_K, f"IVF query {j}: {len(got)} rows")
            exact = set(vec_top(np, oracle[jr + 1 + j], VEC_K))
            hits += len(set(got) & exact)
        t_ivf = time.perf_counter() - t0
        recall = hits / (VEC_K * len(ivf_q))
        out["recall"] = recall
        say(f"IVF search: {len(ivf_q)} queries in {t_ivf:.2f} s, recall@10 "
            f"{recall:.4f} against exact search [{card}]")
        check(recall >= IVF_RECALL_MIN, f"IVF recall@10 {recall} below "
              f"{IVF_RECALL_MIN}")

        # (d) IVF statements served through Scheduler (its serial lane)
        serve_ivf(torch, node, ivf_q, card)

        # (e) the cluster: Cluster(2) on its host tier
        out["cluster"] = vector_cluster(torch, np, exact_rows, vecs, ids,
                                        cats, exact_q, ivf_q, oracle, card)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    finally:
        restore_a()
        restore_k()
    say(f"vector path launches: {json.dumps(launches)}")
    for kname in tuple(VECTOR_KERNELS) + SLICE5_OTHERS:
        check(launches[kname] > 0, f"kernel {kname} was not launched on the "
              "vector path")
    out["launches"] = launches
    out["calls_k"] = {"vector": calls_k}
    out["calls_a"] = calls_a
    return out


def serve_ivf(torch, node, ivf_q, card):
    """SERVE_THREADS x SERVE_PER_THREAD IVF statements (id and distance)
    through one Scheduler: AnnSearch declines the fused screens, so each
    takes the serial lane; each must equal its serial result."""
    import threading
    from opentenbase_tpu_torch.exec import scheduler as sm
    from opentenbase_tpu_torch.exec.session import Session
    def stmt(t, j):
        q = ivf_q[(t * SERVE_PER_THREAD + j) % len(ivf_q)]
        return (f"select id, embedding <-> '{vec_lit(q)}' as d from items "
                f"order by d limit {VEC_K}")
    stmts = [[stmt(t, j) for j in range(SERVE_PER_THREAD)]
             for t in range(SERVE_THREADS)]
    ref = [[Session(node).query(sql) for sql in row] for row in stmts]
    got = [[None] * SERVE_PER_THREAD for _ in range(SERVE_THREADS)]
    errs = []
    sm.reset_stats()
    barrier = threading.Barrier(SERVE_THREADS)
    with sm.Scheduler(node=node) as sched:
        def client(t):
            try:
                sess = Session(node)
                barrier.wait()
                for j, sql in enumerate(stmts[t]):
                    got[t][j] = sched.run(sess, sql)[-1].rows
            except Exception as e:   # noqa: BLE001 (reported below)
                errs.append(e)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(SERVE_THREADS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    if errs:
        raise SmokeFailure(f"vector serving: {errs[0]!r}")
    for t in range(SERVE_THREADS):
        for j in range(SERVE_PER_THREAD):
            check(got[t][j] == ref[t][j], f"vector serving: client {t} "
                  f"statement {j} differs from its serial result")
    st = sm.stats_snapshot()
    acq, rel = sm.slot_balance()
    check(acq == rel, f"vector serving: slots {acq} acquired, {rel} "
          "released")
    check(st["batched"] == 0, "vector serving: an AnnSearch statement rode "
          "a batched dispatch")
    n = SERVE_THREADS * SERVE_PER_THREAD
    say(f"vector serving: {n} IVF statements from {SERVE_THREADS} threads = "
        f"serial (bit for bit); {n / wall:.1f} statements/s ({wall:.2f} s); "
        f"dispatches {st['dispatches']}, batched {st['batched']}; queue wait "
        f"p50 {st['queue_wait_p50_ms']:.2f} ms, p99 "
        f"{st['queue_wait_p99_ms']:.2f} ms [{card}]")


def vector_cluster(torch, np, single_rows, vecs, ids, cats, exact_q, ivf_q,
                   oracle, card):
    """The same table on Cluster(2): exact rows on the host tier equal
    the single node's, per-DataNode IVF indexes give a recall; the device
    tier raises for AnnSearch."""
    from opentenbase_tpu_torch.exec.dist_session import ClusterSession
    from opentenbase_tpu_torch.parallel.cluster import Cluster
    cs = ClusterSession(Cluster(2))
    cs.execute(f"create table items (id bigint primary key, embedding "
               f"vector({VEC_DIM}), cat varchar(4)) distribute by shard(id)")
    t0 = time.perf_counter()
    cs._insert_rows(cs.cluster.catalog.table("items"),
                    {"id": ids, "embedding": vecs, "cat": cats}, len(ids))
    t_load = time.perf_counter() - t0
    try:
        cs.query(f"select id from items order by embedding <-> "
                 f"'{vec_lit(ivf_q[0])}' limit {VEC_K}")
        raise SmokeFailure("cluster AnnSearch ran on the device tier")
    except NotImplementedError:
        pass
    cs.execute("set enable_mesh_exchange = off")
    for j, (metric, q, _cat) in enumerate(exact_q[:5]):
        got = cs.query(f"select id, embedding {VEC_OPS[metric]} "
                       f"'{vec_lit(q)}' as d from items order by d limit "
                       f"{VEC_K}")
        check(cs.last_tier == "host", f"cluster tier {cs.last_tier}")
        if got != single_rows[j]:
            # only an exact tie may order two rows another way
            vec_rank_ok(np, [r[0] for r in got],
                        [r[0] for r in single_rows[j]], vecs, q, metric,
                        oracle[j], f"cluster exact query {j}")
    t0 = time.perf_counter()
    cs.execute(f"create index items_emb on items using ivfflat (embedding) "
               f"with (lists = {VEC_LISTS})")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    jr = len(exact_q) + 1
    hits = 0
    for j, q in enumerate(ivf_q[:CLUSTER_IVF_QUERIES]):
        got = [r[0] for r in cs.query(
            f"select id from items order by embedding <-> '{vec_lit(q)}' "
            f"limit {VEC_K}")]
        hits += len(set(got) & set(vec_top(np, oracle[jr + j], VEC_K)))
    recall = hits / (VEC_K * CLUSTER_IVF_QUERIES)
    say(f"cluster (2 DataNodes, host tier): load {t_load:.1f} s; 5 exact "
        f"queries = the oracle (as on one DataNode); per-DataNode ivfflat "
        f"build {t_build:.2f} s; IVF recall@10 {recall:.4f} over "
        f"{CLUSTER_IVF_QUERIES} queries; device tier: NotImplementedError "
        f"[{card}]")
    return {"recall": recall, "build_s": t_build}


def vector_compare(torch, ANN, vp):
    """Every recorded K15 call against its plain version, and the IVF
    kernel path's ids against the plain path's; returns max error by
    kernel."""
    import numpy as np
    err = {k: 0.0 for k in VECTOR_KERNELS}
    by_wrapper = {v[0]: k for k, v in VECTOR_KERNELS.items()}
    counts = {}
    for wname, kname in by_wrapper.items():
        for a, kw in vp["calls_a"][wname]:
            err[kname] = max(err[kname],
                             compare_ann_call(torch, ANN, wname, a, kw))
        counts[kname] = len(vp["calls_a"][wname])
    vecs = vp["vecs"]
    for j, (a, kw) in enumerate(vp["calls_a"]["ivf_search"]):
        gi, _gd = ANN.ivf_search(*a, **kw)
        wi, _wd = ANN.ivf_search_plain(*a, **kw)
        torch.cuda.synchronize()
        got, want = gi.tolist(), wi.tolist()
        if got != want:
            # the plain path's distances of the rows involved decide
            q, metric = a[3], a[7] if len(a) > 7 else kw.get("metric", "l2")
            d = ANN.distances_plain(a[0], q, metric).double().cpu().numpy()
            qn = q.cpu().numpy()
            padded = np.zeros((len(d), vecs.shape[1]), np.float32)
            padded[:len(vecs)] = vecs
            vec_rank_ok(np, got, want, padded, qn, metric, d,
                        f"IVF call {j}: kernel path vs plain path")
    say(f"K15 kernels vs plain on every main-path call ({json.dumps(counts)}"
        f" calls; IVF kernel path = plain path on "
        f"{len(vp['calls_a']['ivf_search'])} calls): ok; max errors "
        f"{json.dumps(err)}")
    return err


def ann_bytes_ops(torch, name, a, kw):
    """(bytes each input read once + each output written once, ops) of
    one K15 call, from this run's tensors."""
    if name == "ann_distances":
        vecs, q = a[0], a[1]
        n, d = vecs.shape
        return nbytes(vecs) + nbytes(q) + 4 * n, 4 * n * d
    if name == "ann_topk":
        dist, valid, k = a[0], a[1], a[2]
        n = dist.shape[0]
        return nbytes(dist) + (n if valid is not None else 0) + 12 * k, \
            n * _lg(max(k, 2))
    if name == "ann_assign":
        vecs, cents = a[0], a[1]
        n, d = vecs.shape
        return nbytes(vecs) + nbytes(cents) + 4 * n, \
            2 * n * cents.shape[0] * d
    if name == "ann_lloyd_update":
        vecs, valid, assign, cents = a[:4]
        n, d = vecs.shape
        live = int(valid.sum())
        return 4 * d * live + n + 4 * n + 2 * nbytes(cents), live * d
    if name == "ann_probe_scan":
        vecs, assign, probed, valid, q = a[:5]
        n, d = vecs.shape
        nl = probed.shape[0] - 1
        taken = int((valid & probed[assign.long().clamp(0, nl)]).sum())
        return 4 * n + n + nbytes(probed) + nbytes(q) + 4 * d * taken \
            + 4 * n, 4 * d * taken
    raise KeyError(name)


def ann_library_ms(torch, name, a, kw):
    """One PyTorch call computing the same function, where there is one:
    torch.cdist for l2 distances, torch.topk of the masked distances,
    and for the assignment the product and the argmax (two calls);
    None for the Lloyd update and the probe scan."""
    if name == "ann_distances":
        metric = a[2] if len(a) > 2 else kw.get("metric", "l2")
        if metric != "l2":
            return None
        vecs, q = a[0], a[1]
        return time_fn(torch, lambda: torch.cdist(vecs, q[None]), reps=10)
    if name == "ann_topk":
        dist, valid, k = a[0], a[1], a[2]
        masked = dist if valid is None else torch.where(
            valid, dist, torch.full((), float("inf"), device=dist.device))
        return time_fn(torch, lambda: torch.topk(masked, k, largest=False),
                       reps=10)
    if name == "ann_assign":
        vecs, cents = a[0], a[1]
        return time_fn(torch, lambda: (vecs @ cents.T).argmax(1), reps=3)
    return None


def lloyd_steps(torch, ANN, calls, card):
    """The Lloyd update on every step of the first index build (its
    recorded calls at VEC_LISTS lists): the largest and the median
    cluster, event-loop ms of the wrapper, its device-only and host ms,
    the device-only ms of the update after the sort
    (`lloyd_update_sorted`), and the yardstick's device-only ms."""
    import inspect
    iters = inspect.signature(ANN.kmeans).parameters["iters"].default
    build = [c for c in calls if c[0][3].shape[0] == VEC_LISTS][:iters]
    out = []
    for i, (a, kw) in enumerate(build):
        vecs, valid, assign, cents, nlist = a[:5]
        sizes = torch.bincount(assign[valid].long(), minlength=nlist)
        big, med = int(sizes.max()), float(sizes.median())
        keys = torch.where(valid, assign.to(torch.int64),
                           torch.full((), nlist, dtype=torch.int64,
                                      device=vecs.device))
        perm, skeys = ANN.K._sort_launch(keys.unsqueeze(0), "sort_rows",
                                         first=True)
        ms = time_fn(torch, lambda: ANN.lloyd_update(*a, **kw), reps=5)
        dev, host = device_host_ms(torch, lambda: ANN.lloyd_update(*a, **kw),
                                   reps=5)
        upd = graph_device_ms(torch, lambda: ANN.lloyd_update_sorted(
            vecs, skeys, perm, cents, nlist), reps=5)
        yard = graph_device_ms(torch, lloyd_yardstick(torch, a), reps=5)
        out.append({"step": i + 1, "largest": big, "median": med, "ms": ms,
                    "device_ms": dev, "host_ms": host,
                    "update_device_ms": upd, "yardstick_device_ms": yard})
        say(f"Lloyd update, build step {i + 1}: largest cluster {big}, "
            f"median {med:g}; {ms:.4f} ms, device-only {dev:.4f} (after "
            f"the sort {upd:.4f}), host {host:.4f}; yardstick (index_add_ "
            f"of rows and counts, 2 calls) device-only {yard:.4f} [{card}]")
    return out


def vector_measure(torch, K, ANN, vp, err, card, profile=False):
    """Times of the vector path after its launches were read: one Lloyd
    step against its plain version, the sort of its update against
    torch.sort, exact against IVF warm ms per query in turns (with
    `profile`, one of each under torch.profiler), the card's busy share
    over IVF queries, and each K15 kernel at a main-path call against
    its plain version, its bound and the library call."""
    import numpy as np
    s, st = vp["session"], vp["node"].stores["items"]
    calls = vp["calls_a"]
    a, _kw = calls["lloyd_update"][0]
    vecs, valid, assign, cents, nlist = a[:5]
    k_ms = time_fn(torch, lambda: ANN._lloyd_step(vecs, valid, cents, nlist),
                   reps=3)
    p_ms = time_fn(torch, lambda: ANN._lloyd_step_plain(vecs, valid, cents,
                                                        nlist), reps=3)
    say(f"one Lloyd step ({vecs.shape[0]} x {vecs.shape[1]}, {nlist} lists):"
        f" kernels {k_ms:.3f} ms, plain {p_ms:.3f} ms [{card}]")
    steps = lloyd_steps(torch, ANN, calls["lloyd_update"], card)
    # K10 at the update's main-path call: one order word per row
    keys = torch.where(valid, assign.to(torch.int64),
                       torch.full((), nlist, dtype=torch.int64,
                                  device=valid.device))
    words = keys.unsqueeze(0).contiguous()
    s_ms = time_fn(torch, lambda: K.sort_perm(words), reps=5)
    t_ms = time_fn(torch, lambda: torch.sort(keys, stable=True), reps=5)
    check(torch.equal(K.sort_perm(words), torch.sort(keys, stable=True)[1]),
          "sort_perm differs from torch.sort on the Lloyd update's keys")
    say(f"sort_rows at the Lloyd update's call ({keys.shape[0]} rows, one "
        f"order word): kernel {s_ms:.3f} ms, torch.sort(stable=True) "
        f"{t_ms:.3f} ms [{card}]")
    q = vp["ivf_q"][0]
    sql = (f"select id from items order by embedding <-> '{vec_lit(q)}' "
           f"limit {VEC_K}")
    index = st.ann_indexes["embedding"]
    exact, ivf = [], []

    def run_exact():
        st.ann_indexes.pop("embedding")
        try:
            exact.append(_wall(torch, lambda: s.query(sql)))
        finally:
            st.ann_indexes["embedding"] = index
    for r in range(REPS):
        for side in ((run_exact, "ivf") if r % 2 == 0 else ("ivf", run_exact)):
            if side == "ivf":
                ivf.append(_wall(torch, lambda: s.query(sql)))
            else:
                side()
    e_ms, i_ms = statistics.median(exact), statistics.median(ivf)
    say(f"warm ms per query (median of {REPS} a side, in turns): exact "
        f"{e_ms:.3f} ms, IVF {i_ms:.3f} ms [{card}]")
    if profile:
        st.ann_indexes.pop("embedding")
        try:
            profile_queries(torch, [("vector exact l2", s, sql)], card)
        finally:
            st.ann_indexes["embedding"] = index
        profile_queries(torch, [("vector IVF", s, sql)], card)
    wall, busy = busy_share(torch, lambda: [s.query(
        f"select id from items order by embedding <-> '{vec_lit(qq)}' "
        f"limit {VEC_K}") for qq in vp["ivf_q"][:10]])
    say(f"IVF busy share over 10 warm queries: {busy_text(wall, busy)} "
        f"[{card}]")
    timed = {"ann_distances": calls["distances"][0],
             "ann_topk": calls["topk_nearest"][0],
             "ann_assign": next(c for c in calls["assign_clusters"]
                                if c[0][1].shape[0] == VEC_LISTS),
             "ann_lloyd_update": calls["lloyd_update"][0],
             "ann_probe_scan": calls["probe_scan"][0]}
    records = []
    for kname, (wname, src, replaces) in VECTOR_KERNELS.items():
        a, kw = timed[kname]
        fn = getattr(ANN, wname)
        plain = getattr(ANN, wname + "_plain")
        reps = 3 if kname in ("ann_assign", "ann_lloyd_update") else 10
        ms = time_fn(torch, lambda: fn(*a, **kw), reps=reps)
        pms = time_fn(torch, lambda: plain(*a, **kw), reps=reps)
        by, ops = ann_bytes_ops(torch, kname, a, kw)
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        lib = ann_library_ms(torch, kname, a, kw)
        shape = "x".join(str(x) for x in a[0].shape)
        split = {}
        if kname == "ann_topk":
            split = device_split(
                torch, K, kname, [(a, kw)], card, wrapper=fn,
                library=lambda a: (lambda m=ANN._masked(a[0], a[1]):
                                   torch.topk(m, a[2], largest=False)))
        if kname == "ann_lloyd_update":
            split = device_split(
                torch, K, kname, [(a, kw)], card, wrapper=fn,
                library=lambda a: lloyd_yardstick(torch, a),
                lib_key="yardstick", lib_label=LLOYD_YARDSTICK)
            split["steps"] = steps
        if kname == "ann_assign":
            split = device_split(
                torch, K, kname, [(a, kw)], card, wrapper=fn,
                library=lambda a: (lambda: (a[0] @ a[1].T).argmax(1)))
            mhz, watts = clocks_during(torch, lambda: fn(*a, **kw))
            split.update({"sm_clock_mhz": mhz, "power_w": watts})
            say(f"kernel {kname} back to back: SM clock {mhz} MHz, power "
                f"{watts} W (nvidia-smi medians) [{card}]")
        records.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": vp["launches"][kname],
            "launches_by_path": {"vector": vp["launches"][kname]},
            "max_abs_err": err[kname], "ms": ms, "plain_ms": pms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib, "timed_on": f"vector {wname} {shape}",
            **split})
        say(f"kernel {kname}: {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({by / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} GFLOP), library "
            f"{'-' if lib is None else f'{lib:.4f} ms'}; launches "
            f"{vp['launches'][kname]} ({wname} on {shape}) [{card}]")
    return records


def clocks_during(torch, fn, seconds=1.5):
    """(median SM clock MHz, median power draw W) of nvidia-smi's samples
    every 100 ms while `fn` runs back to back for `seconds`."""
    p = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader,nounits", "-lms", "100"],
                         stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                         text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        p.terminate()
        try:
            out, _ = p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
    samples = []
    for line in out.splitlines():
        try:
            mhz, watts = (float(x) for x in line.split(","))
        except ValueError:
            continue
        samples.append((mhz, watts))
    if not samples:
        return None, None
    return (statistics.median(m for m, _w in samples),
            statistics.median(w for _m, w in samples))


def busy_share(torch, fn):
    """(wall ms, device busy ms) of one call of `fn` under torch.profiler:
    the device-side events' time over the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            busy += getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
    return wall, busy / 1e3


def busy_text(wall, busy):
    """A busy share as printed; "not measured" where torch.profiler gave
    no device time (it loses its device events on some H100 machines)."""
    if busy <= 0:
        return (f"device not measured (torch.profiler lost its device "
                f"events), {wall:.3f} ms wall")
    return (f"device {busy:.3f} ms of {wall:.3f} ms wall "
            f"({100 * busy / wall:.1f}%)")


# device kernel name fragment -> label, for the cluster kernels' lines
_CLUSTER_KERNELS = {
    "route_kernel": "route", "xchg_tile_counts": "xchg_tile_counts",
    "xchg_tile_scan": "xchg_tile_scan", "xchg_positions": "xchg_positions",
    "scatter_rows": "scatter_rows", "compact_slots": "compact_slots",
    "fill_tail_row0": "fill_tail_row0",
    "scan_tile_sums<(anonymous namespace)::MaskLoad": "compact scan",
    "scan_tiles<(anonymous namespace)::MaskLoad": "compact scan"}


def _cluster_label(key: str):
    return next((v for k, v in _CLUSTER_KERNELS.items() if k in key), None)


def _wall(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _library_fn(torch, K, name, a):
    """One PyTorch call computing the same function as kernel `name` on
    the recorded arguments `a`, or None (see _library_ms)."""
    if name == "decode_column":
        if a[2] != "pack":
            return None
        return lambda: a[0].to(a[1].dtype)
    if name == "join_build":
        masked = torch.where(a[1], a[0], K.INT64_MAX)
        return lambda: torch.sort(masked, stable=True)
    if name == "join_probe_counts":
        pk = torch.where(a[2], a[1], K.INT64_MAX - 1)
        return lambda: (torch.searchsorted(a[0], pk),
                        torch.searchsorted(a[0], pk, right=True))
    if name == "compose_index":
        # index_select of each prior and m[take] of each null mask
        masks = a[2] if len(a) > 2 else ()
        return lambda: ([p.index_select(0, a[1]) for p in a[0]],
                        [m[a[1]] for m in masks])
    if name == "semi_mask":
        return lambda: a[0] > 0
    if name == "compact":
        # boolean-mask indexing of the first column
        return lambda: a[1][0][a[0]]
    if name == "window_frame_reduce":
        # the prefix sum of the argument (of the validity for ranks):
        # only K13b's scan part
        x = a[5] if len(a) > 5 and a[5] is not None else a[4].to(
            torch.int64)
        return lambda: torch.cumsum(x, 0)
    return None


def _library_ms(torch, K, name, calls):
    """Time of one PyTorch call computing the same function on the same
    inputs, where one exists, summed over the timed calls: the int
    widening `.to()` of a pack-family decode; a stable torch.sort of the
    masked build keys (join_build); two torch.searchsorted (the probe's
    match ranges, without the table); index_select of each prior and
    m[take] of each null mask (compose_index, summed);
    `counts > 0` (semi_mask); `x[mask]` on the first column (compact);
    torch.cumsum of the argument (window_frame_reduce's prefix sums, only
    its scan part).  None for the others: no single call computes a
    visibility mask, a code-space compare, Q1's eleven mixed aggregates,
    a multi-key sort, a grouped aggregate, a pair expansion, an anti mask,
    a splitmix64 hash or routing, or a partition of rows by
    destination."""
    if not calls:
        return None
    total = 0.0
    for a, _kw in calls:
        fn = _library_fn(torch, K, name, a)
        if fn is None:
            return None
        total += time_fn(torch, fn)
    return total


# kernels whose time is also split into device-only and host time
DEVICE_SPLIT = ("semi_mask", "anti_mask", "window_frame_reduce", "compact",
                "compose_index", "join_probe_counts", "join_expand",
                "grouped_agg_sort", "exchange_fixed", "grouped_agg_dense",
                "ann_lloyd_update")
# kernels whose split also counts the kernel and memset nodes of a call
SPLIT_NODES = ("exchange_fixed", "ann_topk", "grouped_agg_dense",
               "ann_lloyd_update")
K4_YARDSTICK = ("yardstick: k + 1 PyTorch calls, index_add_ or "
                "scatter_reduce_ an aggregate and present")
LLOYD_YARDSTICK = "yardstick: 2 PyTorch calls, index_add_ of rows and counts"


def k4_yardstick(torch, a):
    """K4's yardstick on the recorded arguments `a`: one index_add_ (sum,
    sumf, count) or scatter_reduce_ (min, max) an aggregate and one for
    present, into outputs allocated here; the masked group ids, the
    widened inputs and the ones are made here too, outside the time.
    Several calls, not one library call."""
    gid, valid, ins, g, kinds = a[0], a[1], a[2], int(a[3]), a[4]
    inrange = valid & (gid >= 0) & (gid < g)
    slot = torch.where(inrange, gid, torch.full((), g, dtype=gid.dtype,
                                                device=gid.device))
    ones = torch.ones_like(slot)
    plan = []
    for kind, v in zip(kinds, ins):
        if kind == "count":
            src = ones
        elif kind == "sumf" or v.dtype.is_floating_point:
            src = v.to(torch.float64)
        elif kind == "sum":
            src = v.to(torch.int64)
        else:
            src = v
        plan.append((kind, src, torch.zeros(g + 1, dtype=src.dtype,
                                            device=src.device)))
    present = torch.zeros(g + 1, dtype=torch.int64, device=gid.device)

    def run():
        for kind, src, out in plan:
            if kind in ("min", "max"):
                out.scatter_reduce_(0, slot, src,
                                    "amin" if kind == "min" else "amax")
            else:
                out.index_add_(0, slot, src)
        present.index_add_(0, slot, ones)
    return run


def lloyd_yardstick(torch, a):
    """The Lloyd update's yardstick on the recorded arguments `a`:
    index_add_ of the rows and of the counts into outputs allocated
    here, with the keys made here (two calls, not one library call)."""
    vecs, valid, assign, _cents, nlist = a[:5]
    keys = torch.where(valid, assign.to(torch.int64),
                       torch.full((), nlist, dtype=torch.int64,
                                  device=vecs.device))
    ones = torch.ones(vecs.shape[0], dtype=torch.float32, device=vecs.device)
    sums = torch.zeros(nlist + 1, vecs.shape[1], dtype=torch.float32,
                       device=vecs.device)
    counts = torch.zeros(nlist + 1, dtype=torch.float32, device=vecs.device)
    return lambda: (sums.index_add_(0, keys, vecs),
                    counts.index_add_(0, keys, ones))


def k4_branch(K, a) -> str:
    """The K4 branch of the recorded call `a` (its first launch)."""
    return K4_BRANCHES[K._lib().otbt_grouped_agg_dense_branch(
        a[0].shape[0], int(a[3]), min(len(a[4]), 32))]


def k4_split(torch, K, calls, card):
    """K4's device-only and host times, nodes a call and yardstick on
    Q1's eager calls, the one-group call of eager Q6 and the cluster
    program's Q1 calls (recorded outside capture): {label: split}."""
    out = {}
    for label, cs in calls.items():
        say(f"kernel grouped_agg_dense on {label}: " + "; ".join(
            f"{a[0].shape[0]} rows, {int(a[3])} groups, {len(a[4])} "
            f"aggregates ({k4_branch(K, a)})" for a, _kw in cs))
        out[label] = device_split(
            torch, K, "grouped_agg_dense", cs, card,
            library=lambda a: k4_yardstick(torch, a), lib_key="yardstick",
            lib_label=K4_YARDSTICK)
    return out


def device_split(torch, K, name, calls, card, wrapper=None, library=None,
                 lib_key="torch", lib_label=None):
    """Kernel `name` over its timed calls: device-only ms (device_host_ms:
    a CUDA graph of the calls) and host ms a wrapper call, and the same
    two times of its library call (`library(a)` builds it, by default
    _library_fn: semi_mask's `counts > 0`, join_probe_counts' two
    searchsorted; for anti_mask the two calls `probe_valid & (counts ==
    0)`; none for compact, whose `x[mask]` syncs with the host and cannot
    be captured).  `wrapper` is the kernel's wrapper where it is not
    ops/kernels.py's; a yardstick of several PyTorch calls in place of
    the library call is recorded under `lib_key` and printed as
    `lib_label`."""
    wrapper = wrapper or wrapper_of(K, name)
    dev = host = ldev = lhost = 0.0
    lib_ok = True
    for a, kw in calls:
        d, h = device_host_ms(torch, lambda: wrapper(*a, **kw))
        dev += d
        host += h
        fn = library(a) if library else _library_fn(torch, K, name, a)
        if name == "anti_mask":
            fn = (lambda a=a: a[1] & (a[0] == 0))
        if name == "compact":
            fn = None   # x[mask] reads its size on the host: no capture
        if fn is None:
            lib_ok = False
            continue
        d, h = device_host_ms(torch, fn)
        ldev += d
        lhost += h
    rec = {"device_ms": dev, "host_ms": host,
           f"{lib_key}_device_ms": ldev if lib_ok else None,
           f"{lib_key}_host_ms": lhost if lib_ok else None}
    if name in SPLIT_NODES:
        types = [graph_nodes(torch, lambda a=a, kw=kw: wrapper(*a, **kw))
                 for a, kw in calls]
        rec["nodes_a_call"] = [[t.get(_CU_GRAPH_NODE_KERNEL, 0),
                                t.get(_CU_GRAPH_NODE_MEMSET, 0)]
                               for t in types]
        say(f"kernel {name}: kernel + memset nodes of each call, captured: "
            + ", ".join(f"{a} + {b}" for a, b in rec["nodes_a_call"]))
    label = lib_label or ("probe_valid & (counts == 0)"
                          if name == "anti_mask" else "library")
    lib = f"{ldev:.4f} ms, host {lhost:.4f} ms" if lib_ok else "-"
    say(f"kernel {name} split: device-only (CUDA graph) {dev:.4f} ms, host "
        f"{host:.4f} ms over the calls ({', '.join(_call_names(name, calls))}"
        f"); {label} device-only {lib} [{card}]")
    return rec


def _call_names(name, calls):
    """Each recorded call's function (K13b) or the kernel's name."""
    return [a[0] if isinstance(a[0], str) else name for a, _kw in calls]


# ---------------------------------------------------------------------------
# slice 6: TPC-DS and window functions (K13)
# ---------------------------------------------------------------------------

WINDOW_KERNELS = ("window_bounds", "window_frame_reduce", "range_minmax")
# TPC-DS at the size of its SF1 fact table: the specification (v3.2,
# clause 3.4, Table 3-2) gives store_sales 2,880,404 rows at SF1; the
# repository's generator (tpcds/datagen.py: store_sales = 4000 sf) gives
# 2,880,400 at sf 720.1
TPCDS_SF = 720.1
TPCDS_WINDOW = (12, 20, 44, 53, 63, 67, 89, 98)
# slice 15: the 23 set-operation queries (UNION [ALL], ROLLUP through its
# UNION ALL expansion, and the INTERSECT / EXCEPT of TPCDS_SETOP_SETOP)
TPCDS_SETOP = (2, 4, 5, 11, 14, 18, 22, 33, 36, 38, 49, 56, 60, 66, 70, 71,
               74, 75, 76, 77, 80, 86, 87)
TPCDS_SETOP_SETOP = (14, 38, 87)
TPCDS_NOT_IN_SLICE = (16, 28, 94, 95)   # DISTINCT aggregates
TPCDS_PLAIN = tuple(q for q in range(1, 100) if q not in TPCDS_WINDOW
                    and q not in TPCDS_SETOP and q not in TPCDS_NOT_IN_SLICE)
# plain queries the port on the CPU checks at SF1 (the rest in a second
# load at a tenth of the scale)
TPCDS_CPU_SF1 = (3, 7, 19, 42, 43, 52, 55, 96)
# q85 joins web_returns and store_returns on the item key alone: under
# the generator's Zipf(1.3) item skew its pairs grow with the square of
# the scale (2^21 at sf 7.2, 2^25 at 28.8, measured on the CPU), about
# 2e10 at sf 720.1, over 300 GB of pair indices: on the card it runs in
# the second load only
TPCDS_CHECK_ONLY = (85,)
# two window statements besides the queries: a moving min / max and a lag
# over a grouped aggregate, and rank plus a ROWS-frame min over every
# store_sales row (K13 at the fact table's size; the 8 queries use no
# min/max window)
TPCDS_EXTRA = {
    "dsx1": "select i_category, d_moy, sum(ss_ext_sales_price) rev, "
            "min(sum(ss_ext_sales_price)) over (partition by i_category "
            "order by d_moy rows between 2 preceding and current row) mn, "
            "max(sum(ss_ext_sales_price)) over (partition by i_category) mx, "
            "lag(sum(ss_ext_sales_price), 1) over (partition by i_category "
            "order by d_moy) prev "
            "from store_sales, item, date_dim where ss_item_sk = i_item_sk "
            "and ss_sold_date_sk = d_date_sk and d_year = 1999 "
            "group by i_category, d_moy order by i_category, d_moy",
    "dsx2": "select ss_store_sk, count(*), sum(rk), sum(mn) from ("
            "select ss_store_sk, rank() over (partition by ss_store_sk "
            "order by ss_net_profit desc) rk, min(ss_net_profit) over "
            "(partition by ss_store_sk order by ss_ticket, ss_item_sk rows "
            "between 10 preceding and current row) mn from store_sales) z "
            "where rk <= 100 group by ss_store_sk order by ss_store_sk",
}
TPCDS_RTOL = SUMF_RTOL       # f64 outputs: the card's kernels add in
                             # another order than the CPU's plain sums


def rows_close(got, want, what):
    """Rows equal, f64 values within TPCDS_RTOL (NaN = NaN)."""
    check(len(got) == len(want), f"{what}: {len(got)} rows, want "
          f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check(len(g) == len(w), f"{what} row {i}: arity")
        for j, (a, b) in enumerate(zip(g, w)):
            if isinstance(a, float) and isinstance(b, float):
                ok = (a != a and b != b) or a == b \
                    or abs(a - b) <= TPCDS_RTOL * abs(b)
            else:
                ok = a == b
            check(ok, f"{what} row {i} col {j}: {a!r} != {b!r}")


def _cpu_twin(node):
    """A CPU node over the same catalog, stores and timestamps: the
    port's plain versions answer there."""
    from opentenbase_tpu_torch.exec.session import LocalNode
    cpu = LocalNode(device="cpu")
    cpu.catalog, cpu.stores, cpu.gts = node.catalog, node.stores, node.gts
    return cpu


def _tpcds_load(torch, sf, tables=None, cluster=False):
    """(session, data, load s): TPC-DS at `sf` in a new LocalNode (or a
    new Cluster(2)) on the card; prints each table's rows and seconds."""
    from opentenbase_tpu_torch.exec.dist_session import ClusterSession
    from opentenbase_tpu_torch.exec.session import LocalNode, Session
    from opentenbase_tpu_torch.parallel.cluster import Cluster
    from opentenbase_tpu_torch.tpcds import datagen
    from opentenbase_tpu_torch.tpcds.schema import SCHEMA
    t0 = time.perf_counter()
    data = datagen.generate(sf=sf)
    say(f"TPC-DS datagen sf={sf}: {time.perf_counter() - t0:.1f} s")
    if cluster:
        c = Cluster(n_datanodes=2)
        check(c.device.type == DEVICE, f"cluster on {c.device}")
        s = ClusterSession(c)
    else:
        node = LocalNode()
        check(node.device.type == DEVICE, f"node on {node.device}")
        s = Session(node)
    s.execute(SCHEMA)
    t_load = 0.0
    for tname in tables or datagen.TABLES:
        t0 = time.perf_counter()
        if cluster:
            datagen.load_into_cluster(s, data, (tname,))
        else:
            datagen.load_into(s, data, (tname,))
        dt = time.perf_counter() - t0
        t_load += dt
        say(f"TPC-DS load {'Cluster(2) ' if cluster else ''}{tname}: "
            f"{dt:.1f} s ({len(next(iter(data[tname].values())))} rows)")
    return s, data, t_load


def tpcds_path(torch, K, card, sf):
    """Slice 6: TPC-DS at store_sales' SF1 size through Session.query on
    the card's default (fused) tier: the 8 window queries, 2 more window
    statements and the plain queries but q85, the launch counters set to 0
    before the path and read after it (and per query), the K13 calls
    recorded; the window statements and TPCDS_CPU_SF1 against the port
    on the CPU over the same stores, the other plain queries and the
    set-operation queries the same way in a second load at sf / 10; the
    4 queries outside the slice raise; the 8 window queries on
    Cluster(2) against the single node; slice 15's set-operation queries
    (tpcds_setop_path); warm ms of each window query, eager against the
    default tier, in turns, and the window queries' busy share."""
    from opentenbase_tpu_torch.exec import executor as X, fused
    from opentenbase_tpu_torch.exec import mesh_exec as ME
    from opentenbase_tpu_torch.exec.session import Session
    from opentenbase_tpu_torch.tpcds.queries import Q
    for q, sql in Q.items():
        for pre in ("ds", "dsk", "dsc"):
            Q_TEXT[f"{pre}{q}"] = sql
    Q_TEXT.update(TPCDS_EXTRA)
    X.Executor._fuse = True
    s, data, t_load = _tpcds_load(torch, sf)
    n_ss = len(data["store_sales"]["ss_item_sk"])
    check(n_ss == int(round(4000 * sf)), f"store_sales has {n_ss} rows")
    wq = [f"ds{q}" for q in TPCDS_WINDOW] + list(TPCDS_EXTRA)
    pq = [f"ds{q}" for q in TPCDS_PLAIN if q not in TPCDS_CHECK_ONLY]
    dec0 = fused.declines_snapshot().get("window", 0)
    got, cold, calls, launches, per_q = run_path(torch, K, s, wq + pq,
                                                 WINDOW_KERNELS)
    say(f"slice 6 path launches (TPC-DS sf={sf}: {len(wq)} window "
        f"statements + {len(pq)} plain queries): {json.dumps(launches)}")
    for n in WINDOW_KERNELS + ("sort_rows",):
        check(launches[n] > 0, f"kernel {n} was not launched on slice 6's "
              "path")
    for q in wq:
        pl = per_q[q]
        check(pl["window_bounds"] > 0 and pl["window_frame_reduce"] > 0
              and pl["sort_rows"] >= pl["window_bounds"],
              f"{_qname(q)}: its windows did not run on K10 + K13")
        say(f"{_qname(q)}: {len(got[q])} rows, cold {cold[q]:.1f} ms; "
            "launches " + ", ".join(f"{n} {pl[n]}" for n in
                                    WINDOW_KERNELS + ("sort_rows",)))
    check(fused.declines_snapshot().get("window", 0) > dec0,
          "the fused tier did not decline a Window")
    check(all(len(got[q]) > 0 for q in wq), "a window statement returned "
          "no rows")
    say("cold ms of the plain queries: " + ", ".join(
        f"q{q[2:]} {cold[q]:.0f}" for q in pq))
    for q in TPCDS_NOT_IN_SLICE:
        try:
            s.query(Q[q])
        except NotImplementedError:
            continue
        raise SmokeFailure(f"TPC-DS q{q} is outside the slice and ran")
    say(f"the {len(TPCDS_NOT_IN_SLICE)} queries outside the slice raise "
        "NotImplementedError")
    # the port on the CPU over the same stores
    cs_cpu = Session(_cpu_twin(s.node))
    t0 = time.perf_counter()
    for q in wq + [f"ds{q}" for q in TPCDS_CPU_SF1]:
        rows_close(got[q], cs_cpu.query(Q_TEXT[q]),
                   f"{_qname(q)} (card vs the port on the CPU)")
    say(f"{len(wq) + len(TPCDS_CPU_SF1)} statements at sf={sf} on the card "
        f"= the port on the CPU ({time.perf_counter() - t0:.1f} s)")
    # the other plain queries at a tenth of the scale: card against CPU
    check_sf = round(sf / 10, 6)
    sk, _dk, t_load_k = _tpcds_load(torch, check_sf)
    kq = [f"dsk{q}" for q in TPCDS_PLAIN if q not in TPCDS_CPU_SF1] \
        + [f"dsk{q}" for q in TPCDS_SETOP]
    got_k, _cold, _calls, launches_k, _pq = run_path(torch, K, sk, kq,
                                                     WINDOW_KERNELS)
    ck_cpu = Session(_cpu_twin(sk.node))
    t0 = time.perf_counter()
    for q in kq:
        rows_close(got_k[q], ck_cpu.query(Q_TEXT[q]),
                   f"{_qname(q)} (card vs the port on the CPU)")
    say(f"{len(kq)} plain and set-operation queries at sf={check_sf} on the "
        f"card = the port on the CPU ({time.perf_counter() - t0:.1f} s)")
    del sk, ck_cpu, got_k
    # the window queries on Cluster(2), against the single node
    tables = ("date_dim", "item", "store", "store_sales", "catalog_sales",
              "web_sales")
    cs, _dc, t_load_c = _tpcds_load(torch, sf, tables, cluster=True)
    cq = [f"dsc{q}" for q in TPCDS_WINDOW]
    tiers, seen = {}, [_mesh_lookups()]

    def tier_of(q):
        # the tier each query's DataNode side took: a program (the
        # default) or the eager tier
        tiers[q] = "program" if _mesh_lookups() > seen[0] else "eager"
        seen[0] = _mesh_lookups()
    check(ME.MeshRunner._capture, "the cluster program is off")
    got_c, _cold, calls_c, launches_c, per_qc = run_path(
        torch, K, cs, cq, WINDOW_KERNELS, tier_of)
    say("cluster TPC-DS tiers: " + ", ".join(
        f"q{q[3:]} {tiers[q]}" for q in cq))
    check(all(t == "program" for t in tiers.values()),
          "a cluster TPC-DS window query did not run as a program")
    for q in TPCDS_WINDOW:
        rows_close(got_c[f"dsc{q}"], got[f"ds{q}"],
                   f"cluster TPC-DS q{q} vs the single node")
        check(per_qc[f"dsc{q}"]["window_bounds"] > 0,
              f"cluster TPC-DS q{q}: no window kernel launched")
    check(cs.tier_counts.get("mesh", 0) >= len(cq) and cs.fallbacks == [],
          "a cluster TPC-DS query left the device tier")
    say(f"the {len(cq)} window queries on Cluster(2) (device tier) = the "
        f"single node; launches {json.dumps(launches_c)}")
    del cs
    # slice 15 after the check load and the cluster: its measurements hold
    # the set operations' inputs while they run (q85 at sf 72.01 needs the
    # card's memory)
    sp = tpcds_setop_path(torch, K, card, s)
    # warm ms, eager tier against the default tier, in turns
    warm = {}
    for q in TPCDS_WINDOW:
        ms = {True: [], False: []}
        for r in range(REPS):
            for fuse in ((False, True) if r % 2 == 0 else (True, False)):
                X.Executor._fuse = fuse
                ms[fuse].append(_wall(torch, lambda: s.query(Q[q])))
        warm[q] = (statistics.median(ms[False]), statistics.median(ms[True]))
        say(f"TPC-DS q{q} warm median: eager {warm[q][0]:.3f} ms, default "
            f"(fused) tier {warm[q][1]:.3f} ms, {REPS} a side in turns "
            f"[{card}]")
    X.Executor._fuse = True
    # the profiler's first window in a process carries its start-up on the
    # host clock, not on the device's: discard one window
    busy_share(torch, lambda: s.query(Q[TPCDS_WINDOW[0]]))
    wall, busy = busy_share(torch, lambda: [s.query(Q[q])
                                            for q in TPCDS_WINDOW])
    say(f"window queries' busy share (the 8, warm, default tier): "
        f"{busy_text(wall, busy)} [{card}]")
    return {"session": s, "calls": calls, "calls_c": calls_c,
            "launches": launches, "launches_k": launches_k,
            "launches_c": launches_c, "per_q": per_q,
            "launches_s": sp["launches"], "setop_err": sp["err"],
            "setop_records": sp["records"],
            "load_s": t_load + t_load_k + t_load_c}


def window_measure(torch, K, tp, card):
    """Each K13 kernel's device ms and bound summed over each window
    statement's calls, with its launches on that statement; K13b's
    device-only ms (device_host_ms: a CUDA graph of the calls)."""
    for q, qcalls in tp["calls"].items():
        if not any(qcalls[n] for n in WINDOW_KERNELS):
            continue
        parts = []
        for n in WINDOW_KERNELS:
            ms = by = 0.0
            for a, kw in qcalls[n]:
                out = getattr(K, n)(*a, **kw)
                ms += time_fn(torch, lambda: getattr(K, n)(*a, **kw), reps=5)
                by += window_bytes_ops(n, a, kw, out)[0]
            parts.append(f"{n} {ms:.4f} ms (bound "
                         f"{by / HBM_BYTES_PER_S * 1e3:.4f}, "
                         f"{tp['per_q'][q][n]} launches)")
        calls = qcalls["window_frame_reduce"]
        dev = sum(device_host_ms(torch, lambda: K.window_frame_reduce(
            *a, **kw), reps=5)[0] for a, kw in calls)
        say(f"K13 on {_qname(q)}: " + "; ".join(parts) +
            f"; window_frame_reduce device-only (CUDA graph) {dev:.4f} ms ("
            f"{', '.join(_call_names('window_frame_reduce', calls))}) "
            f"[{card}]")


_WFR_PARAMS = ("func", "bounds", "frame", "s_iota", "s_valid", "a_s",
               "anm_s", "offset", "dflt_s", "dnull_s", "has_default",
               "scale", "table")   # window_frame_reduce's parameters


def window_bytes_ops(name, a, kw, out):
    """(bytes: each input the function reads read once, each output
    written once; ops) of one K13 call."""
    if name == "window_bounds":
        # word 0 (~valid) is never compared: the key words and s_valid
        # read, the five bounds written
        words, _np, _fw, s_valid = a
        w, n = words.shape
        return (w - 1) * 8 * n + nbytes(s_valid) + 5 * 8 * n, n * (w + 12)
    if name == "range_minmax":
        a_s, contrib = a[0], a[1]
        return nbytes(a_s) + nbytes(contrib) + nbytes(out), out.numel()
    # window_frame_reduce: s_iota, p_start and what the function and its
    # frame read; min / max read two words of the sparse table a row
    from opentenbase_tpu_torch.ops.kernels import WIN_BOUNDS
    p = dict(zip(_WFR_PARAMS, a))
    p.update(kw)
    func, s_iota, s_valid = p["func"], p["s_iota"], p["s_valid"]
    a_s, anm_s = p.get("a_s"), p.get("anm_s")
    p_start, peer_start, peer_end_v, p_end, ob_cum = p["bounds"]
    n = s_iota.shape[0]
    ins = [s_iota, p_start]
    extra = 0
    if func == "rank":
        ins.append(peer_start)
    elif func == "dense_rank":
        ins.append(ob_cum)
    elif func in ("lag", "lead"):
        ins += [s_valid, a_s, anm_s]
        if p.get("has_default"):
            ins += [p.get("dflt_s"), p.get("dnull_s")]
    elif func != "row_number":
        mode, sbk, _so, ebk, _eo, has_order = p["frame"]
        ins += [p_end, s_valid, anm_s]
        if mode == 0 and has_order:
            ins.append(peer_end_v)
        elif mode == 2:
            if sbk != WIN_BOUNDS["unbounded_preceding"]:
                ins.append(peer_start)
            if ebk != WIN_BOUNDS["unbounded_following"]:
                ins.append(peer_end_v)
        if func in ("min", "max"):
            extra = 2 * n * p["table"].element_size()
        elif func != "count":
            ins.append(a_s)
    val, nul = out
    by = sum(nbytes(t) for t in ins if t is not None) + extra \
        + nbytes(val) + (nbytes(nul) if nul is not None else 0)
    return by, 12 * n


# ---------------------------------------------------------------------------
# slice 15: Append and set operations
# ---------------------------------------------------------------------------

# the fused tier's int32 min / max over no rows (ROADMAP queue 3): K14
# keeps them in int64 with the int64 identities; the output is the INT /
# DATE dtype's own identities, as in the reference
FAULT_DDL = ("create table fe (k bigint, x int)",
             "create table fw (k bigint, x int, d date)",
             "insert into fw values (1, 5, date '1995-01-01'), "
             "(2, -7, date '1996-01-01'), (3, 9, date '1997-01-01')")
FAULT_SQL = (
    ("select min(x), max(x) from fe", [(2147483647, -2147483648)]),
    ("select count(*), sum(x), min(x) from fw where k > 100",
     [(0, 0, 2147483647)]),
    ("select min(x), max(x), min(d), max(d) from fw where k > 100",
     [(2147483647, -2147483648, "5881580-07-11", "-5877641-06-23")]),
    ("select min(x), max(x), count(*) from fw where k > 1", [(-7, 9, 2)]))

# tests/test_sql_surface.py's set-operation and grouping-set statements
# over its tables (t; u, sharded), and TEXT branches with different
# dictionaries (a, b); each with whether its rows come in a defined order
SETOP_DDL = (
    "create table t (g varchar(2), x bigint, v decimal(6,1))",
    "insert into t values ('a',1,10.0),('a',2,20.0),('a',2,30.0),"
    "('b',5,1.5),('b',7,2.5),(null, null, null)",
    "create table u (k bigint primary key, g varchar(2), x bigint, "
    "v decimal(6,1)) distribute by shard(k)",
    "insert into u values " + ", ".join(
        f"({i}, 'g{i % 3}', {i % 7}, {i}.5)" for i in range(30)),
    "create table a (k bigint, s varchar(4), n int) distribute by shard(k)",
    "insert into a values (1, 'p', 10), (2, 'q', 20), (3, 'zz', null), "
    "(4, 'p', 40)",
    "create table b (k bigint, s varchar(4), n int) distribute by shard(k)",
    "insert into b values (5, 'a', 1), (6, 'q', 2), (7, null, 3), "
    "(8, 'mm', null)")
SETOP_SQL = (
    ("select x from t where g = 'a' intersect select x from t order by x",
     True),
    ("select x from t intersect all select x from t order by x", True),
    ("select x from t except select x from t where g = 'a' order by x",
     True),
    ("select x from t except all select x from t where x = 2 order by x",
     True),
    ("select g from t intersect select g from t where g is null", False),
    ("select x from t where x = 1 union select x from t where x = 2 "
     "intersect select x from t where x = 2 order by x", True),
    ("select k from u where k < 10 except select k from u where k < 5 "
     "order by k", True),
    ("select g, x, sum(v) as s from t group by rollup (g, x) "
     "order by g nulls last, x nulls last", True),
    ("select g, x, count(*) as n from t group by cube (g, x)", False),
    ("select g, count(*) as n from u group by rollup (g) "
     "order by g nulls last", True),
    ("select s, count(*), sum(n) from (select s, n from a union all "
     "select s, n from b) z group by s order by s", True),
    ("select s from a union select s from b order by 1 desc", True),
    ("select s from a except all select s from b order by s", True))

# the executor's set-operation steps and the kernels they launch
SETOP_STEPS = ("_concat", "_pack", "_set_rows")
SETOP_KERNELS = ("grouped_agg_sort", "join_expand", "compose_index",
                 "compact")
SETOP_REPLACES = {"exec_setop": "opentenbase_tpu/exec/executor.py:968",
                  "exec_append": "opentenbase_tpu/exec/executor.py:1040"}


def _sorted_rows(rows):
    return sorted(rows, key=lambda r: tuple(
        (v is None, str(type(v)), v if v is not None and v == v else 0)
        for v in r))


def setop_check(torch, K):
    """The fused tier's int32 min / max over no rows on the card (each
    statement one fused_scan_agg launch at least, rows = the reference's
    answer), then SETOP_SQL through the port's Session on the card
    (eager and default tiers) against the port on the CPU, and on
    Cluster(2) on the card as cluster programs: the first call captures
    its program (or hits one captured for another statement of the same
    shape), every warm call is one graph replay with one ladder read,
    rows = the single node on the card."""
    from opentenbase_tpu_torch.exec import executor as X
    from opentenbase_tpu_torch.exec import mesh_exec as ME
    from opentenbase_tpu_torch.exec.dist_session import ClusterSession
    from opentenbase_tpu_torch.exec.session import LocalNode, Session
    from opentenbase_tpu_torch.parallel.cluster import Cluster
    s = Session(LocalNode())
    check(s.node.device.type == DEVICE, f"node on {s.node.device}")
    for stmt in FAULT_DDL:
        s.execute(stmt)
    fuse, capture = X.Executor._fuse, ME.MeshRunner._capture
    X.Executor._fuse = True
    try:
        for sql, want in FAULT_SQL:
            for _ in range(2):    # the first call captures, the second replays
                before = K.LAUNCHES["fused_scan_agg"]
                rows = s.query(sql)
                torch.cuda.synchronize()
                check(K.LAUNCHES["fused_scan_agg"] > before,
                      f"{sql}: not on the fused scan-aggregate kernel")
                check(rows == want, f"fused tier on the card: {sql} gave "
                      f"{rows}, want {want}")
        say(f"int32 / date min and max over no rows on the card's fused tier "
            f"(K14, {len(FAULT_SQL)} statements, captured and replayed) = "
            "the reference's identities: ok")
        cpu = Session(LocalNode(device="cpu"))
        cs = ClusterSession(Cluster(2))
        for stmt in SETOP_DDL:
            s.execute(stmt)
            cpu.execute(stmt)
            cs.execute(stmt)
        single = {}
        for sql, ordered in SETOP_SQL:
            want = cpu.query(sql)
            for fused in (False, True):
                X.Executor._fuse = fused
                got = s.query(sql)
                torch.cuda.synchronize()
                if not ordered:
                    got, want = _sorted_rows(got), _sorted_rows(want)
                tier = "default" if fused else "eager"
                check(got == want, f"{sql} on the card ({tier} tier) gave "
                      f"{got}, the CPU {want}")
            single[sql] = got
        say(f"{len(SETOP_SQL)} set-operation statements on the card's "
            "Session (eager and default tiers) = the port on the CPU: ok")
        X.Executor._fuse = True
        ME.MeshRunner._capture = True
        captured = 0
        for sql, ordered in SETOP_SQL:
            cap0, lr0, rp0, hit0 = _mesh_counters(K)
            rows = cs.query(sql)
            torch.cuda.synchronize()
            cap1, lr1, rp1, hit1 = _mesh_counters(K)
            check(cs.last_tier == "mesh" and cs.fallbacks == [],
                  f"Cluster(2) {sql}: tier {cs.last_tier}")
            check(rp1 == rp0 and (cap1 - cap0 == 1 or hit1 - hit0 == 1),
                  f"Cluster(2) {sql}: {cap1 - cap0} captures, {rp1 - rp0} "
                  f"replays, {hit1 - hit0} program hits on the first call")
            captured += cap1 - cap0
            want = single[sql]
            for _ in range(2):
                got = cs.query(sql)
                check((got if ordered else _sorted_rows(got)) == want,
                      f"Cluster(2) {sql} gave {got}, the single node {want}")
            torch.cuda.synchronize()
            cap2, lr2, rp2, _hit2 = _mesh_counters(K)
            check(cap2 == cap1 and rp2 - rp1 == 2 and lr2 - lr1 == 2,
                  f"Cluster(2) {sql}: {cap2 - cap1} captures, {rp2 - rp1} "
                  f"replays, {lr2 - lr1} ladder reads in 2 warm calls")
        say(f"{len(SETOP_SQL)} set-operation statements on Cluster(2) on the "
            f"card as cluster programs ({captured} captured; each warm call "
            "one replay and one ladder read) = the single node: ok")
    finally:
        X.Executor._fuse, ME.MeshRunner._capture = fuse, capture


class OpTally:
    """Every call of the executor's set-operation steps while installed:
    `_concat` (the device concat of an Append or a SetOp's sides, K9's
    TEXT remap), `_pack` (the eager Append's K3) and `_set_rows` (SetOp's
    K5 + K8 + K9).  For each: the query it ran for, its arguments (and a
    concat's output), whether it ran traced, and its kernel launches
    (LAUNCHES read before and after it: its inputs exist before it
    starts, so every launch in between is its own); and the kernel calls
    made inside the
    steps, by query (for the checks against the plain versions).  A step
    recorded into a CUDA graph under capture launches nothing and is not
    kept."""

    def __init__(self, torch, X, K):
        self.torch, self.X, self.K = torch, X, K
        self.query = None
        self.steps: list = []
        self.kcalls: dict = {}
        self._inside = False
        self._orig = {}
        for step in SETOP_STEPS:
            fn = getattr(X.Executor, step)
            self._orig[("X", step)] = fn
            setattr(X.Executor, step, self._step(step, fn))
        for n in SETOP_KERNELS:
            attr = WRAPPERS.get(n, n)
            fn = getattr(K, attr)
            self._orig[("K", attr)] = fn
            setattr(K, attr, self._kernel(n, fn))

    def _step(self, step, fn):
        def run(ex, *a):
            capturing = self.torch.cuda.is_current_stream_capturing()
            before = dict(self.K.LAUNCHES)
            prev, self._inside = self._inside, not capturing
            try:
                out = fn(ex, *a)
            finally:
                self._inside = prev
            if not capturing:
                self.steps.append({
                    "step": step, "query": self.query, "ex": ex, "args": a,
                    "out": out if step == "_concat" else None,
                    "traced": ex._traced,
                    "launches": {n: self.K.LAUNCHES[n] - before[n]
                                 for n in SETOP_KERNELS}})
            return out
        return run

    def _kernel(self, n, fn):
        def run(*a, **kw):
            if self._inside:
                self.kcalls.setdefault(self.query, {}).setdefault(
                    n, []).append((a, kw))
            return fn(*a, **kw)
        return run

    def restore(self):
        for (where, name), fn in self._orig.items():
            setattr(self.X.Executor if where == "X" else self.K, name, fn)

    def original(self, step):
        return self._orig[("X", step)]

    def units(self, kind, queries):
        """(concat step, pack or set_rows step) of every eager Append
        ("exec_append") or SetOp ("exec_setop") of `queries`: the step
        whose input is the concat's output."""
        step = "_pack" if kind == "exec_append" else "_set_rows"
        concats = {id(c["out"]): c for c in self.steps
                   if c["step"] == "_concat"}
        out = []
        for c in self.steps:
            if c["step"] == step and c["query"] in queries:
                b = c["args"][0] if step == "_pack" else c["args"][1]
                out.append((concats[id(b)], c))
        return out


def _has_text(b) -> bool:
    from opentenbase_tpu_torch.catalog.types import TypeKind
    return any(t.kind == TypeKind.TEXT for t in b.types.values())


def setop_launch_check(tally, queries, per_q):
    """Per query: each SetOp launched K5, K8 and K9 (one K9 for its keys,
    one more where its columns hold TEXT), each eager Append's pack one
    K3 (one a set of 128 columns) and each concat one K9 where its
    columns hold TEXT and none where they do not; the 3 INTERSECT /
    EXCEPT queries ran a SetOp, the other 20 an eager Append."""
    lines = []
    for q in queries:
        steps = [c for c in tally.steps if c["query"] == q]
        sets = [c for c in steps if c["step"] == "_set_rows"]
        packs = [c for c in steps if c["step"] == "_pack"]
        concats = [c for c in steps if c["step"] == "_concat"]
        num = int(q.lstrip("dsk"))
        op = "SetOp" if num in TPCDS_SETOP_SETOP else "Append"
        check(len(sets if op == "SetOp" else packs) > 0,
              f"{_qname(q)}: no {op} ran")
        for c in sets:
            ln = c["launches"]
            check(ln["grouped_agg_sort"] >= 1 and ln["join_expand"] == 1
                  and ln["compose_index"] == 1 and ln["compact"] == 0,
                  f"{_qname(q)}: a SetOp launched {ln}")
        for c in packs:
            ln = c["launches"]
            check(ln["compact"] >= 1 and sum(ln.values()) == ln["compact"],
                  f"{_qname(q)}: an Append's pack launched {ln}")
        for c in concats:
            ln = c["launches"]
            want = 1 if _has_text(c["out"]) else 0
            check(ln["compose_index"] == want
                  and sum(ln.values()) == want,
                  f"{_qname(q)}: a concat launched {ln}, want {want} K9")
        tot = {n: sum(c["launches"][n] for c in steps) for n in SETOP_KERNELS}
        lines.append(f"{_qname(q)} {len(sets)} SetOp + {len(packs)} Append "
                     f"({len(concats)} concats): K5 {tot['grouped_agg_sort']}"
                     f", K8 {tot['join_expand']}, K9 {tot['compose_index']}, "
                     f"K3 {tot['compact']} of the query's "
                     f"{per_q[q]['grouped_agg_sort']} / "
                     f"{per_q[q]['join_expand']} / "
                     f"{per_q[q]['compose_index']} / {per_q[q]['compact']}")
    say("set-operation launches by query (inside Append / SetOp, of the "
        "query's K5 / K8 / K9 / K3): " + "; ".join(lines))


class plain_kernels:
    """Within the block the set-operation kernels are their plain
    versions (on the card's tensors)."""

    def __init__(self, K):
        self.K = K

    def __enter__(self):
        self.saved = {}
        for n in SETOP_KERNELS:
            attr = WRAPPERS.get(n, n)
            self.saved[attr] = getattr(self.K, attr)
            setattr(self.K, attr, getattr(self.K, attr + "_plain"))

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.K, attr, fn)


def _batch_tensors(b):
    return list(b.cols.values()) + [b.valid] + list(b.nulls.values())


def _batch_err(torch, got, want) -> float:
    """0.0 when the two batches are the same bits, else the count of
    differing entries (f64 compared as their bit patterns)."""
    err = 0.0
    check(list(got.cols) == list(want.cols)
          and list(got.nulls) == list(want.nulls)
          and got.dicts == want.dicts, "batch layouts differ")
    for g, w in zip(_batch_tensors(got), _batch_tensors(want)):
        if g.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        check(g.shape == w.shape, "batch shapes differ")
        err += float((g != w).sum())
    return err


def _unit_run(tally, unit):
    """The set operation of one recorded unit: its concat, then its pack
    or its rows."""
    concat, last = unit
    fn_c = tally.original("_concat")
    fn_l = tally.original(last["step"])
    b = fn_c(concat["ex"], *concat["args"])
    if last["step"] == "_pack":
        return fn_l(last["ex"], b)
    return fn_l(last["ex"], last["args"][0], b, last["args"][2])


def _append_yardstick(torch, parts):
    """The Append's concat in PyTorch calls: torch.cat of every column,
    null mask and valid, and each TEXT column's codes through its LUT
    with index_select."""
    from opentenbase_tpu_torch.catalog.types import TypeKind
    from opentenbase_tpu_torch.exec import executor as X
    first = parts[0]
    dev = first.valid.device
    text = [n for n in first.cols if first.types[n].kind == TypeKind.TEXT]
    luts = {}
    for n in text:
        _vals, ls = X._union_dict(tuple(p.dicts.get(n, ()) for p in parts))
        luts[n] = [torch.from_numpy(x).to(dev) for x in ls]

    def run():
        out = []
        for n, a in first.cols.items():
            if n in luts:
                out.append(torch.cat([lut.index_select(0, torch.clamp(
                    p.cols[n].long(), 0, lut.shape[0] - 1))
                    for lut, p in zip(luts[n], parts)]))
            else:
                out.append(torch.cat([p.cols[n] for p in parts]))
        for n in dict.fromkeys(m for p in parts for m in p.nulls):
            out.append(torch.cat([p.nulls.get(n, torch.zeros(
                p.padded, dtype=torch.bool, device=dev)) for p in parts]))
        out.append(torch.cat([p.valid for p in parts]))
        return out
    return run


def setop_records(torch, K, tally, queries, card):
    """The kernel line's exec_setop and exec_append records: every unit of
    the path run again through the kernels and through their plain
    versions on the same inputs (the same bits, or the check fails);
    launches = the kernel launches inside the operators on the path;
    ms, plain ms and the bound on the unit with the most input rows (the
    bound: its inputs read once and its output written once at 3.35 TB/s);
    library ms for the Append: its concat in PyTorch calls (a yardstick,
    several calls)."""
    records = []
    for kind in ("exec_setop", "exec_append"):
        units = tally.units(kind, queries)
        check(units, f"no {kind} ran on the path")
        err = 0.0
        for unit in units:
            got = _unit_run(tally, unit)
            with plain_kernels(K):
                want = _unit_run(tally, unit)
            torch.cuda.synchronize()
            err = max(err, _batch_err(torch, got, want))
        check(err == 0.0, f"{kind} differs from its plain version ({err})")
        launches = sum(sum(c["launches"].values()) for u in units
                       for c in u)
        unit = max(units, key=lambda u: u[0]["out"].padded)
        ms = time_fn(torch, lambda: _unit_run(tally, unit), reps=5)
        with plain_kernels(K):
            pms = time_fn(torch, lambda: _unit_run(tally, unit), reps=5)
        parts = unit[0]["args"][0]
        out = _unit_run(tally, unit)
        by = sum(nbytes(t) for p in parts for t in _batch_tensors(p)) \
            + sum(nbytes(t) for t in _batch_tensors(out))
        lib = None
        if kind == "exec_append":
            lib = time_fn(torch, _append_yardstick(torch, parts), reps=5)
        bound = by / HBM_BYTES_PER_S * 1e3
        rows = [p.padded for p in parts]
        lib_text = "-" if lib is None else \
            f"{lib:.4f} ms (yardstick: torch.cat + index_select)"
        say(f"{kind} on {_qname(unit[0]['query'])} (inputs of {rows} rows, "
            f"output {out.padded}): {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bound:.4f} ms ({by / 1e6:.1f} MB), library {lib_text}; "
            f"{len(units)} on the path, {launches} kernel launches inside "
            f"them, max err {err:g} [{card}]")
        records.append({
            "name": kind, "route": "cuda",
            "source": "opentenbase_tpu_torch/exec/executor.py",
            "replaces": SETOP_REPLACES[kind], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib,
            "timed_on": _qname(unit[0]["query"]),
            "kernels": "K5 + K8 + K9" if kind == "exec_setop"
            else "K9 + K3"})
    return records


def tpcds_setop_path(torch, K, card, s):
    """Slice 15 on TPC-DS at store_sales' SF1 size (`s`, tpcds_path's
    session): the 23 set-operation queries through Session.query on the
    default tier, the launch counters set to 0 before the path and read
    after it; per query, the launches inside its Append / SetOp steps
    (OpTally); rows against the port on the CPU over the same stores;
    cold ms, and warm ms eager against default in turns; the kernel
    calls made inside the steps against their plain versions, and the
    exec_setop / exec_append records, before the steps' inputs are
    dropped."""
    from opentenbase_tpu_torch.exec import executor as X
    from opentenbase_tpu_torch.exec.session import Session
    sq = [f"ds{q}" for q in TPCDS_SETOP]
    X.Executor._fuse = True
    tally = OpTally(torch, X, K)
    tally.query = sq[0]
    order = iter(sq[1:] + [None])

    def on_query(_q):
        tally.query = next(order)
    try:
        got, cold, _calls, launches, per_q = run_path(torch, K, s, sq, (),
                                                      on_query)
    finally:
        tally.restore()
    say(f"slice 15 path launches (the 23 TPC-DS set-operation queries at "
        f"store_sales' SF1 size, default tier): {json.dumps(launches)}")
    for n in SETOP_KERNELS:
        check(launches[n] > 0, f"kernel {n} was not launched on slice 15's "
              "path")
    setop_launch_check(tally, sq, per_q)
    check(sum(len(got[q]) for q in sq) > 0, "the set-operation queries "
          "returned no rows")
    say("set-operation queries, rows and cold ms: " + ", ".join(
        f"q{q[2:]} {len(got[q])} {cold[q]:.1f}" for q in sq))
    cpu = Session(_cpu_twin(s.node))
    t0 = time.perf_counter()
    for q in sq:
        rows_close(got[q], cpu.query(Q_TEXT[q]),
                   f"{_qname(q)} (card vs the port on the CPU)")
    say(f"the {len(sq)} set-operation queries on the card = the port on the "
        f"CPU over the same stores ({time.perf_counter() - t0:.1f} s)")
    warm = []
    for q in sq:
        ms = {True: [], False: []}
        for r in range(REPS):
            for fuse in ((False, True) if r % 2 == 0 else (True, False)):
                X.Executor._fuse = fuse
                ms[fuse].append(_wall(torch, lambda: s.query(Q_TEXT[q])))
        warm.append(f"q{q[2:]} {statistics.median(ms[False]):.3f} / "
                    f"{statistics.median(ms[True]):.3f}")
    X.Executor._fuse = True
    say(f"set-operation queries' warm medians, eager / default tier, ms, "
        f"{REPS} a side in turns: {', '.join(warm)} [{card}]")
    plain, err = plain_versions(K), {}
    for qcalls in tally.kcalls.values():
        for n, calls in qcalls.items():
            for a, kw in calls:
                err[n] = max(err.get(n, 0.0),
                             compare_call(torch, K, plain, n, a, kw))
    say("the kernel calls inside the set-operation steps = their plain "
        "versions: " + ", ".join(
            f"{n} {sum(len(c.get(n, ())) for c in tally.kcalls.values())}"
            for n in SETOP_KERNELS))
    tally.kcalls.clear()
    records = setop_records(torch, K, tally, sq, card)
    tally.steps.clear()
    return {"launches": launches, "err": err, "records": records}

if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
