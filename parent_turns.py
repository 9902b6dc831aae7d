#!/usr/bin/env python3
"""Time this tree's K7 (join_probe_counts), K8 (join_expand), K5
(grouped_agg_sort), K15c (assign_clusters), K12 fixed (exchange_fixed),
K15b (topk_nearest), K4 (grouped_agg_dense) and the K15c Lloyd update
(lloyd_update) against another checkout of the port, in turns in one
process, each side through its own tree's wrappers.

Run from the repository root, on one CUDA card, with the other tree
unpacked into a git-ignored directory:

    mkdir -p smoke_tree/parent
    git archive <commit> | tar -x -C smoke_tree/parent
    python3 parent_turns.py smoke_tree/parent [--sf 1.0] [--rounds 2]
        [--only k4,lloyd]

The other tree's package is loaded under another name, so its wrappers,
its C interface and its kernel library (built from its own sources) are
its own.  K7 and K8 are timed on TPC-H Q5's calls, K5 on Q3's call and
on Q13's calls: Q5, Q3 and Q13 at --sf run once on this tree's eager
executor with the calls recorded.  K15c at the vector
path's shape: 1 M x 128 f32 rows (chip_smoke.py vector_data, seed 11)
against 1000 of them as centroids, l2.  Each side's results are held
against this tree's plain versions first; the other tree's K15c is also
run on chip_smoke.py's NaN / inf / tie cases and the rows where it
differs from jnp.argmax's rule are printed (a record, not a check).
K12 fixed is timed on the exchange_fixed calls of TPC-H Q5 as a cluster
program on Cluster(2) and on Cluster(4) at --sf (recorded on this tree,
outside capture, on the first call); K15b on the vector path's three
calls over chip_smoke.py's vector data, padded to 2^20 rows: the exact
query's (k = 10 over the l2 distances, with the valid mask), and the
IVF query's two (k = 125 over 1000 centroid distances, k = 10 over the
probe scan's output, 7/8 of it +inf).  The other tree's K15b is also
run on the NaN cases of chip_smoke.py's vector edge check, and whether
it keeps the NaN rule is printed (a record, not a check).
K4 is timed on Q1's eager call and on Q6's (one group), recorded with
K7, K8 and K5's calls, and on four dense-key calls of 2^22 rows at 64,
512, 2048 and 4096 groups (an int64 sum, an f64 sum, a count); the Lloyd update on every step of one index build
at the vector path's shape (1 M x 128 rows from chip_smoke.py
vector_data, seed 11, 1000 lists, the initial centroids as kmeans takes
them), each step's largest and median cluster printed.
Then, in turns (other, this, this, other, ...): event-loop ms (CUDA
events around the wrapper calls), device-only ms (the calls captured
into a CUDA graph) and, for K8 and K5, host ms (the host clock around
calls that are not waited for), and the kernel and memset nodes of one
call.  A K5 call of a tree whose eager form reads the device from the
host cannot be captured: its device-only ms and nodes are those of its
traced form (the same launches but the host read).  The last line is
one JSON object with every number.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_tree(root: str, alias: str):
    """The port's package of another checkout, imported as `alias`."""
    pkg = os.path.join(os.path.abspath(root), "opentenbase_tpu_torch")
    if not os.path.isfile(os.path.join(pkg, "__init__.py")):
        raise SystemExit(f"parent_turns: no port package under {root}")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{alias}.ops.kernels"),
            importlib.import_module(f"{alias}.ops.ann"))


def in_turns(sides: dict, measure, rounds: int) -> dict:
    """{side: [measure(fn) each time]}, the sides in turns: a b b a, ..."""
    out = {k: [] for k in sides}
    names = list(sides)
    for _ in range(rounds):
        for k in names + names[::-1]:
            out[k].append(measure(sides[k]))
    return out


RECORDED = ("join_probe_counts", "join_expand", "grouped_agg_sort",
            "grouped_agg_dense")
PARTS = ("k7", "k8", "k5", "k15c", "k12", "k15b", "k4", "lloyd")


def recorded_calls(torch, K, sf: float):
    """{kernel: {query: [args]}} of RECORDED on TPC-H Q5, Q3, Q13, Q1 and
    Q6 at `sf` on this tree's eager executor."""
    import chip_smoke as S
    from opentenbase_tpu_torch.exec import executor as X
    from opentenbase_tpu_torch.exec.session import LocalNode, Session
    from opentenbase_tpu_torch.tpch import datagen
    from opentenbase_tpu_torch.tpch.queries import Q
    from opentenbase_tpu_torch.tpch.schema import SCHEMA
    X.Executor._fuse = False
    data = datagen.generate(sf=sf)
    s = Session(LocalNode())
    s.execute(SCHEMA)
    datagen.load_into(s, data, datagen.TABLES)
    out = {n: {} for n in RECORDED}
    for q in (5, 3, 13, 1, 6):
        calls, restore = S.record_calls(K, list(RECORDED))
        try:
            s.query(Q[q])
            torch.cuda.synchronize()
        finally:
            restore()
        for n in RECORDED:
            out[n][q] = calls[n]
    return out


def host_ms(torch, fn, reps=20):
    """Host ms a call of `fn`: the host clock around `reps` calls that
    are not waited for (a call that reads the device waits inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def nodes_a_call(torch, fn):
    """(kernel nodes, memset nodes) of one call captured in a CUDA graph."""
    import chip_smoke as S
    types = S.graph_nodes(torch, fn)
    return (types.get(S._CU_GRAPH_NODE_KERNEL, 0),
            types.get(S._CU_GRAPH_NODE_MEMSET, 0))


def timed_sides(torch, S, sides, captured, calls, rounds, result, key,
                card):
    """Event-loop, device-only and host ms of each side over `calls`, in
    turns; `captured[side]` is the function captured for device-only ms
    and nodes (the side's own, or its traced form)."""
    def over(timer, pick):
        return lambda side: sum(timer(torch, lambda a=a, kw=kw:
                                      pick(side)(*a, **kw))
                                for a, kw in calls)
    result[f"{key}_ms"] = in_turns(
        {k: k for k in sides}, over(S.time_fn, sides.get), rounds)
    result[f"{key}_device_ms"] = in_turns(
        {k: k for k in sides}, over(S.graph_device_ms, captured.get), rounds)
    result[f"{key}_host_ms"] = in_turns(
        {k: k for k in sides}, over(host_ms, sides.get), rounds)
    a, kw = calls[0]
    result[f"{key}_nodes_a_call"] = {
        k: nodes_a_call(torch, lambda fn=fn: fn(*a, **kw))
        for k, fn in captured.items()}
    for m in ("ms", "device_ms", "host_ms"):
        S.say(f"{key}_{m}: " + "; ".join(
            f"{k} {' '.join(f'{x:.4f}' for x in v)}"
            for k, v in result[f"{key}_{m}"].items()) + f" [{card}]")
    S.say(f"{key} kernel + memset nodes a call: "
          f"{json.dumps(result[f'{key}_nodes_a_call'])}")


def k5_turns(torch, S, K, PK, rec, rounds, result, card):
    """K5 on Q3's call and on Q13's calls; the other tree's device-only
    time and nodes through its traced form."""
    group = {"other": PK.grouped_agg_sort, "this": K.grouped_agg_sort}
    group_captured = {
        "other": lambda *a, **kw: PK.grouped_agg_sort(
            *a, **{**kw, "traced": True}),
        "this": K.grouped_agg_sort}
    for q in (3, 13):
        gcalls = rec["grouped_agg_sort"][q]
        S.say(f"Q{q}'s K5 calls: " + "; ".join(
            f"{a[1].shape[0]} rows ({int(a[1].sum())} valid), {len(a[0])} "
            f"keys, max_groups {int(a[3])}" for a, _kw in gcalls))
        for side, fn in group.items():
            for a, kw in gcalls:
                S.compare_group(torch, fn(*a, **kw),
                                K.grouped_agg_sort_plain(*a, **kw), a[4],
                                f"{side} tree, Q{q}'s calls")
        timed_sides(torch, S, group, group_captured, gcalls, rounds,
                    result, f"k5_q{q}", card)
        # K10's share: this tree's sort alone on the words of the calls
        words = [K._group_words_traced_plain(K._sortable_ints(a[0]), a[1])
                 for a, _kw in gcalls]
        result[f"k5_q{q}_sort_device_ms"] = sum(
            S.graph_device_ms(torch, lambda w=w: K.sort_perm(w))
            for w in words)
        S.say(f"k5_q{q}: K10's sort alone on the same words, device-only "
              f"{result[f'k5_q{q}_sort_device_ms']:.4f} ms [{card}]")


K4_DENSE_GROUPS = (64, 512, 2048, 4096)


def k4_dense_calls(torch, np, dev):
    """{label: [(args, {})]}: one dense-key call for each of
    K4_DENSE_GROUPS, 2^22 rows (90% valid) with uniform group ids and
    the aggregates of a grouped total, an int64 sum, an f64 sum and a
    count (seed 4)."""
    rng = np.random.default_rng(4)
    n = 1 << 22
    t = lambda x: torch.from_numpy(x).to(dev)
    valid = t(rng.random(n) < 0.9)
    ins = (t(rng.integers(-10**9, 10**9, n)), t(rng.normal(0, 1e3, n)),
           t(np.zeros(n, np.int64)))
    return {f"dense{g}": [((t(rng.integers(0, g, n)), valid, ins, g,
                            ("sum", "sumf", "count")), {})]
            for g in K4_DENSE_GROUPS}


def k4_turns(torch, S, np, K, PK, rec, rounds, result, card):
    """K4 on Q1's eager call, on Q6's (one group) and on k4_dense_calls."""
    dense = {"other": PK.grouped_agg_dense, "this": K.grouped_agg_dense}
    sets = {f"q{q}": rec["grouped_agg_dense"][q] for q in (1, 6)}
    sets.update(k4_dense_calls(torch, np, torch.device("cuda")))
    for q, calls in sets.items():
        S.say(f"{q}'s K4 calls: " + "; ".join(
            f"{a[0].shape[0]} rows, {int(a[3])} groups, {len(a[4])} "
            f"aggregates ({S.k4_branch(K, a)})" for a, _kw in calls))
        for side, fn in dense.items():
            for a, kw in calls:
                S.compare_agg(fn(*a, **kw), K.grouped_agg_dense_plain(*a, **kw),
                              a[4], f"{side} tree, {q}'s calls")
        timed_sides(torch, S, dense, dense, calls, rounds, result,
                    f"k4_{q}", card)


def lloyd_turns(torch, S, np, ANN, PANN, dev, rounds, result, card):
    """The Lloyd update on every step of one index build at the vector
    path's shape: 1 M x 128 rows (chip_smoke.py vector_data, seed 11),
    1000 lists, the initial centroids as ops/ann.py kmeans takes them,
    this tree's assignments; each step's largest and median cluster."""
    import inspect
    vecs = torch.from_numpy(S.vector_data(torch, np, 1_000_000, 11)).to(dev)
    n = vecs.shape[0]
    pick = np.random.default_rng(17).choice(n, S.VEC_LISTS, replace=False)
    cents = vecs[torch.from_numpy(pick).to(dev)].contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    update = {"other": PANN.lloyd_update, "this": ANN.lloyd_update}
    iters = inspect.signature(ANN.kmeans).parameters["iters"].default
    sizes = []
    for step in range(1, iters + 1):
        assign = ANN.assign_clusters(vecs, cents)
        a = (vecs, valid, assign, cents, S.VEC_LISTS)
        want = ANN.lloyd_update_plain(*a)
        for side, fn in update.items():
            S.lloyd_close(torch, fn(*a), want, vecs,
                          f"{side} tree's ann_lloyd_update, step {step}")
        counts = torch.bincount(assign.long(), minlength=S.VEC_LISTS)
        sizes.append((int(counts.max()), float(counts.median())))
        S.say(f"lloyd step {step}: largest cluster {sizes[-1][0]}, median "
              f"{sizes[-1][1]:g}")
        timed_sides(torch, S, update, update, [(a, {})], rounds, result,
                    f"lloyd_step{step}", card)
        cents = ANN.lloyd_update(*a)
    result["lloyd_sizes"] = sizes


def k15c_turns(torch, S, np, ANN, PANN, dev, rounds, result, card):
    """K15c at the vector path's shape: 1 M x 128 rows against 1000 of
    them as centroids, l2."""
    vecs = torch.from_numpy(S.vector_data(torch, np, 1_000_000, 11)).to(dev)
    pick = np.random.default_rng(11).choice(vecs.shape[0], S.VEC_LISTS,
                                            replace=False)
    cents = vecs[torch.from_numpy(pick).to(dev)].contiguous()
    assign = {"other": lambda: PANN.assign_clusters(vecs, cents, "l2"),
              "this": lambda: ANN.assign_clusters(vecs, cents, "l2")}
    want = ANN.assign_clusters_plain(vecs, cents, "l2")
    for side, fn in assign.items():
        S.assign_close(torch, fn(), want, vecs, cents, "l2",
                       f"{side} tree's ann_assign")
    result["k15c_ms"] = in_turns(
        assign, lambda fn: S.time_fn(torch, fn, reps=3), rounds)
    result["k15c_device_ms"] = in_turns(
        assign, lambda fn: S.graph_device_ms(torch, fn, reps=3), rounds)
    for key in ("k15c_ms", "k15c_device_ms"):
        S.say(f"{key}: " + "; ".join(
            f"{k} {' '.join(f'{x:.4f}' for x in v)}"
            for k, v in result[key].items()) + f" [{card}]")


def exchange_calls(torch, S, K, sf: float):
    """{DataNodes: [(args, kwargs)]} of exchange_fixed in TPC-H Q5 as a
    cluster program on Cluster(2) and Cluster(4) at `sf`: the first
    call's traced run, outside capture."""
    from opentenbase_tpu_torch.exec import mesh_exec as ME
    from opentenbase_tpu_torch.exec.dist_session import ClusterSession
    from opentenbase_tpu_torch.parallel.cluster import Cluster
    from opentenbase_tpu_torch.tpch import datagen
    from opentenbase_tpu_torch.tpch.queries import Q
    from opentenbase_tpu_torch.tpch.schema import SCHEMA
    data = datagen.generate(sf=sf)
    ME.MeshRunner._capture = True
    out = {}
    for ndn in (2, 4):
        cs = ClusterSession(Cluster(n_datanodes=ndn))
        cs.execute(SCHEMA)
        datagen.load_into_cluster(cs, data)
        calls, restore = S.record_calls(K, ["exchange_fixed"])
        try:
            cs.query(Q[5])
            torch.cuda.synchronize()
        finally:
            restore()
        out[ndn] = calls["exchange_fixed"]
        S.exchange_shapes(torch, K, out[ndn],
                          "m5" if ndn == 2 else "m5c4")
    return out


def k12_turns(torch, S, K, PK, sf, rounds, result, card):
    """K12 fixed on cluster program Q5's calls on 2 and 4 DataNodes."""
    xcalls = exchange_calls(torch, S, K, sf)
    fixed = {"other": PK.exchange_fixed, "this": K.exchange_fixed}
    for ndn, calls in xcalls.items():
        for side, fn in fixed.items():
            for a, kw in calls:
                S.compare_exchange_fixed(
                    torch, fn(*a, **kw), K.exchange_fixed_plain(*a, **kw),
                    f"{side} tree, cluster program Q5 on {ndn} DataNodes")
        timed_sides(torch, S, fixed, fixed, calls, rounds, result,
                    f"k12_q5_dn{ndn}", card)


def k15b_turns(torch, S, np, ANN, PANN, dev, rounds, result, card):
    """K15b on the vector path's calls (the exact query's, the IVF
    query's two), and the other tree on the NaN rule's cases."""
    n = 1_000_000
    vecs = torch.from_numpy(S.vector_data(torch, np, n, 11)).to(dev)
    rng = np.random.default_rng(11)
    padded = torch.zeros((1 << 20, vecs.shape[1]), dtype=torch.float32,
                         device=dev)
    padded[:n] = vecs
    valid = torch.arange(1 << 20, device=dev) < n
    q = (vecs[int(rng.integers(n))]
         + 0.5 * torch.randn(vecs.shape[1], device=dev)).contiguous()
    pick = rng.choice(n, S.VEC_LISTS, replace=False)
    cents = vecs[torch.from_numpy(pick).to(dev)].contiguous()
    assign = ANN.assign_clusters(padded, cents, "l2")
    dc = ANN.distances(cents, q, "l2")
    probed = ANN._probed(cents, q, S.VEC_LISTS // 8, "l2", ANN.distances,
                         ANN.topk_nearest)
    scan = ANN.probe_scan(padded, assign, probed, valid, q, "l2")
    calls = {"exact": [((ANN.distances(padded, q, "l2"), valid, S.VEC_K),
                        {})],
             "ivf_lists": [((dc, None, S.VEC_LISTS // 8), {})],
             "ivf_rows": [((scan, None, S.VEC_K), {})]}
    topk = {"other": PANN.topk_nearest, "this": ANN.topk_nearest}
    for label, cs in calls.items():
        for side, fn in topk.items():
            for a, kw in cs:
                gi, gd = fn(*a, **kw)
                wi, wd = ANN.topk_nearest_plain(*a, **kw)
                S.check(torch.equal(gi, wi) and torch.equal(gd, wd),
                        f"{side} tree's ann_topk differs ({label})")
        timed_sides(torch, S, topk, topk, cs, rounds, result,
                    f"k15b_{label}", card)
    neg_nan = np.copysign(np.float32(np.nan), np.float32(-1))
    d = np.asarray([3, np.nan, 1, neg_nan, np.inf, 2, -0.0, 0.0], np.float32)
    got = PANN.topk_nearest(torch.from_numpy(d).to(dev), None, 8)[0]
    result["k15b_nan_rule_other"] = got.tolist()
    S.say(f"other tree's ann_topk on [3, nan, 1, -nan, inf, 2, -0.0, 0.0],"
          f" k 8: rows {got.tolist()} (the NaN rule: "
          f"{S.nan_topk_oracle(np, d, None, 8).tolist()})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default=",".join(PARTS),
                    help="comma-separated parts to time, of "
                    f"{', '.join(PARTS)} (default: all)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(PARTS):
        ap.error(f"--only: unknown part in {args.only}")
    import torch
    if not torch.cuda.is_available():
        print("parent_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as S
    from opentenbase_tpu_torch.ops import ann as ANN
    from opentenbase_tpu_torch.ops import kernels as K
    card = S.setup(torch)
    t0 = time.perf_counter()
    PK, PANN = load_tree(args.other, "other_port")
    PK._lib()
    S.say(f"other tree {args.other}: kernel library ready in "
          f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")

    result = {"card": card, "sf": args.sf}
    if "k15c" in only:
        # the other tree's K15c on the cases that decide jnp.argmax's rule
        nan_rule = {}
        for label, rows, cents in S.assign_special_cases(
                np, np.random.default_rng(1)):
            v, c = (torch.from_numpy(x).to(dev) for x in (rows, cents))
            for metric in ("l2", "cosine", "ip"):
                got = PANN.assign_clusters(v, c, metric)
                want = ANN.assign_clusters_plain(v, c, metric)
                nan_rule[f"{label}, {metric}"] = int((got != want).sum())
        S.say(f"other tree's ann_assign, rows that differ from jnp.argmax's "
              f"rule: {json.dumps(nan_rule)}")
        result["nan_rule_other"] = nan_rule

    if only & {"k7", "k8", "k5", "k4"}:
        rec = recorded_calls(torch, K, args.sf)
    if "k7" in only:
        calls = [a for a, _kw in rec["join_probe_counts"][5]]
        S.say(f"Q5's K7 calls: {S.probe_shapes([(a, {}) for a in calls])}")
        probe = {"other": PK.join_probe_counts, "this": K.join_probe_counts}
        for side, fn in probe.items():
            for a in calls:
                S.compare_probe(torch, fn(*a), K.join_probe_counts_plain(*a),
                                f"{side} tree, Q5's calls")
        timed_sides(torch, S, probe, probe, rec["join_probe_counts"][5],
                    args.rounds, result, "k7", card)
    if "k8" in only:
        # K8 on Q5's calls
        expand = {"other": PK.join_expand, "this": K.join_expand}
        ecalls = rec["join_expand"][5]
        for side, fn in expand.items():
            for a, kw in ecalls:
                S.compare_expand(torch, fn(*a, **kw),
                                 K.join_expand_plain(*a, **kw),
                                 f"{side} tree, Q5's calls")
        timed_sides(torch, S, expand, expand, ecalls, args.rounds, result,
                    "k8", card)
    if "k5" in only:
        k5_turns(torch, S, K, PK, rec, args.rounds, result, card)
    if "k15c" in only:
        k15c_turns(torch, S, np, ANN, PANN, dev, args.rounds, result, card)
    if "k12" in only:
        k12_turns(torch, S, K, PK, args.sf, args.rounds, result, card)
    if "k15b" in only:
        k15b_turns(torch, S, np, ANN, PANN, dev, args.rounds, result, card)
    if "k4" in only:
        k4_turns(torch, S, np, K, PK, rec, args.rounds, result, card)
    if "lloyd" in only:
        lloyd_turns(torch, S, np, ANN, PANN, dev, args.rounds, result, card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
