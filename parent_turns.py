#!/usr/bin/env python3
"""Time this tree's K7 (join_probe_counts) and K15c (assign_clusters)
against another checkout of the port, in turns in one process, each
side through its own tree's wrappers.

Run from the repository root, on one CUDA card, with the other tree
unpacked into a git-ignored directory:

    mkdir -p smoke_tree/parent
    git archive <commit> | tar -x -C smoke_tree/parent
    python3 parent_turns.py smoke_tree/parent [--sf 1.0] [--rounds 2]

The other tree's package is loaded under another name, so its wrappers,
its C interface and its kernel library (built from its own sources) are
its own.  K7 is timed on TPC-H Q5's calls: Q5 at --sf run once on this
tree's eager executor with the calls recorded.  K15c at the vector
path's shape: 1 M x 128 f32 rows (chip_smoke.py vector_data, seed 11)
against 1000 of them as centroids, l2.  Each side's results are held
against this tree's plain versions first; the other tree's K15c is also
run on chip_smoke.py's NaN / inf / tie cases and the rows where it
differs from jnp.argmax's rule are printed (a record, not a check).
Then, in turns (other, this, this, other, ...): event-loop ms (CUDA
events around the wrapper calls) and device-only ms (the calls captured
into a CUDA graph), and the kernel nodes of one call.  The last line is
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


def q5_probe_calls(torch, K, sf: float):
    """The K7 calls of TPC-H Q5 at `sf` on this tree's eager executor."""
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
    calls, restore = S.record_calls(K, ["join_probe_counts"])
    try:
        s.query(Q[5])
        torch.cuda.synchronize()
    finally:
        restore()
    return [a for a, _kw in calls["join_probe_counts"]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
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

    calls = q5_probe_calls(torch, K, args.sf)
    S.say(f"Q5's K7 calls: {S.probe_shapes([(a, {}) for a in calls])}")
    probe = {"other": PK.join_probe_counts, "this": K.join_probe_counts}
    for side, fn in probe.items():
        for a in calls:
            S.compare_probe(torch, fn(*a), K.join_probe_counts_plain(*a),
                            f"{side} tree, Q5's calls")

    def over_calls(timer):
        return lambda fn: sum(timer(torch, lambda a=a: fn(*a))
                              for a in calls)
    result = {"card": card, "sf": args.sf, "nan_rule_other": nan_rule}
    result["k7_ms"] = in_turns(probe, over_calls(S.time_fn), args.rounds)
    result["k7_device_ms"] = in_turns(probe, over_calls(S.graph_device_ms),
                                      args.rounds)
    result["k7_nodes_a_call"] = {
        k: S.graph_nodes(torch, lambda fn=fn: fn(*calls[0])).get(
            S._CU_GRAPH_NODE_KERNEL, 0) for k, fn in probe.items()}

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
        assign, lambda fn: S.time_fn(torch, fn, reps=3), args.rounds)
    result["k15c_device_ms"] = in_turns(
        assign, lambda fn: S.graph_device_ms(torch, fn, reps=3), args.rounds)
    for key in ("k7_ms", "k7_device_ms", "k15c_ms", "k15c_device_ms"):
        S.say(f"{key}: " + "; ".join(
            f"{k} {' '.join(f'{x:.4f}' for x in v)}"
            for k, v in result[key].items()) + f" [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
