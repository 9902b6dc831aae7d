"""Vector ANN kernels — the pgvector analog (K15), hand-written in CUDA.

The counterpart of opentenbase_tpu/ops/ann.py, with its names: exact
distances, top-k nearest, IVFFlat cluster assignment, the Lloyd step and
the host-driven k-means of the index build, and the IVF probe search.
Each wrapper launches a kernel of ../csrc/ann.cu or ../csrc/kmeans.cu on
a CUDA tensor (or raises) and takes its plain PyTorch version (`*_plain`)
only for tensors that lie on the CPU, as ops/kernels.py's wrappers do;
each launch adds one to ops/kernels.py LAUNCHES under its kernel's name:

- ann_distances: `distances` (l2 / cosine / ip, f32, the reference's
  epilogue term for term);
- ann_topk: `topk_nearest` (ascending distance, ties to the lower row,
  masked rows as +inf, every NaN after +inf: lax.top_k(-masked, k)'s
  order but for a NaN, which PostgreSQL ranks above every value); one
  launch of a threshold select; above MAX_TOPK the order comes from the
  sort kernel (K10 sort_rows);
- ann_assign: `assign_clusters` (a register-blocked f32 product fed by
  asynchronous copies, with jnp.argmax's arg-best fused behind it; the
  (n, nlist) score matrix is never made);
- ann_lloyd_update: `lloyd_update`, the centroid update of `_lloyd_step`
  (rows ordered by cluster with the sort kernel, then fixed-order sums
  over equal tiles of the sorted rows, pieces of the runs that cross a
  tile edge added in tile order: the same rows build the same centroids
  bit for bit);
- ann_probe_scan: `probe_scan`, the row pass of `ivf_search` (distances
  only for valid rows of probed lists, +inf elsewhere).

Everything computes in f32, as the reference does; SQL widens distances
to f64 afterwards.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels as K

METRICS = ("l2", "cosine", "ip")
_METRIC = {m: i for i, m in enumerate(METRICS)}
#: largest k the top-k kernel takes (csrc/ann.cu kMaxK); above it the
#: order comes from the sort kernel
MAX_TOPK = 1024
#: rows per chunk of assign_clusters_plain (bounds its score matrix)
PLAIN_CHUNK = 1 << 14
#: sorted positions a warp of the Lloyd update sums (csrc/kmeans.cu
#: kLloydTile): a cluster's run that crosses a tile edge leaves a piece
LLOYD_TILE = 256


def _metric(metric: str) -> int:
    m = _METRIC.get(metric)
    if m is None:
        raise ValueError(f"unknown vector metric {metric!r}")
    return m


def _check2(t: torch.Tensor, name: str, d: int | None = None):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, want float32")
    if t.dim() != 2 or (d is not None and t.shape[1] != d):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want (n, {d})")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _vec4(vecs: torch.Tensor) -> int:
    return int(vecs.shape[1] % 4 == 0 and vecs.data_ptr() % 16 == 0)


# ---------------------------------------------------------------------------
# K15a distances (reference: ops/ann.py:21)
# ---------------------------------------------------------------------------

def distances_plain(vecs, q, metric: str = "l2"):
    """vecs (n, d), q (d,) -> (n,) f32 distances, the reference's
    formulas (l2 from the expanded form, not sum((v - q)^2))."""
    _metric(metric)
    vecs = vecs.to(torch.float32)
    q = q.to(torch.float32)
    dots = vecs @ q
    if metric == "ip":
        return -dots
    if metric == "cosine":
        vn = torch.sqrt(torch.sum(vecs * vecs, dim=1))
        qn = torch.sqrt(torch.sum(q * q))
        return 1.0 - dots / torch.clamp_min(vn * qn, 1e-30)
    vn2 = torch.sum(vecs * vecs, dim=1)
    qn2 = torch.sum(q * q)
    return torch.sqrt(torch.clamp_min(vn2 - 2.0 * dots + qn2, 0.0))


def distances(vecs, q, metric: str = "l2"):
    """vecs (n, d) f32, q (d,) f32 -> (n,) f32 distances."""
    m = _metric(metric)
    if K._on_cpu(vecs, q):
        return distances_plain(vecs, q, metric)
    _check2(vecs, "vecs")
    n, d = vecs.shape
    K._check(q, "q", (torch.float32,), d)
    out = torch.empty(n, dtype=torch.float32, device=vecs.device)
    rc = K._lib().otbt_ann_distances(K._ptr(vecs), K._ptr(q), n, d, m,
                                     _vec4(vecs), K._ptr(out), K._stream())
    K._ok(rc, "ann_distances")
    K._count("ann_distances")
    return out


# ---------------------------------------------------------------------------
# K15b top-k nearest (reference: ops/ann.py:39)
# ---------------------------------------------------------------------------

def _masked(dists, valid):
    if valid is None:
        return dists
    return torch.where(valid, dists, torch.full((), float("inf"),
                                                dtype=dists.dtype,
                                                device=dists.device))


def topk_nearest_plain(dists, valid, k: int):
    """The k smallest masked distances -> (rows int64, distances f32),
    by a stable sort of (masked distance, row): -0.0 ranks as 0.0, +inf
    slots go to the lowest masked rows, every NaN (either sign) after
    +inf, in row order (PostgreSQL's float order; the reference's
    lax.top_k ranks a sign-set NaN first).  `valid` None: every row."""
    masked = _masked(dists, valid)
    key = torch.where(masked == 0, torch.zeros((), dtype=masked.dtype,
                                               device=masked.device),
                      masked)
    idx = torch.sort(key, stable=True).indices[:k]
    return idx, masked[idx]


def topk_nearest(dists, valid, k: int):
    """Smallest-k by distance among valid rows -> (rows, distances).
    k must not exceed the row count (lax.top_k's contract)."""
    n = dists.shape[0]
    if k > n:
        raise ValueError(f"top-k of {n} rows with k = {k}")
    if K._on_cpu(dists, *(() if valid is None else (valid,))):
        return topk_nearest_plain(dists, valid, k)
    K._check(dists, "dists", (torch.float32,))
    if valid is not None:
        K._check(valid, "valid", (torch.bool,), n)
    dev = dists.device
    if k <= 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.float32, device=dev))
    if k > MAX_TOPK:
        # the order of the sort kernel: (masked distance, row)
        masked = _masked(dists, valid)
        words = K._float_word(masked, False).unsqueeze(0).contiguous()
        idx = K.sort_perm(words)[:k]
        return idx, masked.index_select(0, idx)
    lib = K._lib()
    # one allocation: the rows, the distances, then the kernel's scratch
    sb = lib.otbt_ann_topk_scratch_bytes(n, k)
    ob = (4 * k + 7) // 8 * 8
    buf = torch.empty(8 * k + ob + sb, dtype=torch.uint8, device=dev)
    idx = buf[:8 * k].view(torch.int64)
    out = buf[8 * k:8 * k + 4 * k].view(torch.float32)
    rc = lib.otbt_ann_topk(K._ptr(dists),
                           None if valid is None else K._ptr(valid), n, k,
                           K._ptr(buf) + 8 * k + ob, sb, K._ptr(idx),
                           K._ptr(out), K._stream())
    K._ok(rc, "ann_topk")
    K._count("ann_topk")
    return idx, out


# ---------------------------------------------------------------------------
# K15c assignment and the Lloyd step (reference: ops/ann.py:47, :65)
# ---------------------------------------------------------------------------

def assign_clusters_plain(vecs, centroids, metric: str = "l2"):
    """(n, d), (nlist, d) -> (n,) int32 nearest-centroid ids (first index
    on ties), chunked over rows so no (n, nlist) matrix is made."""
    _metric(metric)
    c = centroids.to(torch.float32)
    n = vecs.shape[0]
    cn2 = torch.sum(c * c, dim=1)
    cn = torch.sqrt(cn2)
    out = torch.empty(n, dtype=torch.int32, device=vecs.device)
    for lo in range(0, n, PLAIN_CHUNK):
        v = vecs[lo:lo + PLAIN_CHUNK].to(torch.float32)
        dots = v @ c.T
        if metric == "ip":
            scores = dots
        elif metric == "cosine":
            vn = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
            scores = dots / torch.clamp_min(vn * cn[None, :], 1e-30)
        else:
            scores = 2.0 * dots - cn2[None, :]
        out[lo:lo + PLAIN_CHUNK] = torch.argmax(scores, dim=1).to(
            torch.int32)
    return out


def assign_clusters(vecs, centroids, metric: str = "l2"):
    """(n, d) f32, (nlist, d) f32 -> (n,) int32 nearest-centroid ids:
    jnp.argmax of the metric's score, so a NaN score wins (the first
    NaN), ties go to the lower centroid and a row of -inf scores gives
    0.  On the card one prep launch (the centroids transposed, their
    norms), the rows' norms for cosine, and one register-blocked tile
    product with the arg-best fused behind it (csrc/kmeans.cu)."""
    m = _metric(metric)
    if K._on_cpu(vecs, centroids):
        return assign_clusters_plain(vecs, centroids, metric)
    _check2(vecs, "vecs")
    n, d = vecs.shape
    _check2(centroids, "centroids", d)
    nlist = centroids.shape[0]
    dev = vecs.device
    lib = K._lib()
    nbytes = lib.otbt_ann_assign_scratch_bytes(n, nlist, d, m)
    if nbytes < 0:
        raise ValueError(f"ann_assign: no centroid or no dimension "
                         f"({nlist} x {d})")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.otbt_ann_assign(K._ptr(vecs), n, K._ptr(centroids), nlist, d, m,
                             K._ptr(scratch), nbytes, K._ptr(out),
                             K._stream())
    K._ok(rc, "ann_assign")
    K._count("ann_assign")
    return out


def lloyd_update_plain(vecs, valid, assign, centroids, nlist: int):
    """New centroids: per-cluster sums of the valid rows over their
    counts (index_add_); an empty cluster keeps its previous centroid."""
    a = torch.where(valid, assign.to(torch.int64),
                    torch.full((), nlist, dtype=torch.int64,
                               device=assign.device))
    ones = valid.to(torch.float32)
    d = vecs.shape[1]
    counts = torch.zeros(nlist + 1, dtype=torch.float32,
                         device=vecs.device).index_add_(0, a, ones)
    sums = torch.zeros(nlist + 1, d, dtype=torch.float32,
                       device=vecs.device).index_add_(
        0, a, vecs.to(torch.float32) * ones[:, None])
    new = sums[:nlist] / torch.clamp_min(counts[:nlist, None], 1.0)
    return torch.where(counts[:nlist, None] > 0, new,
                       centroids.to(torch.float32))


def lloyd_update(vecs, valid, assign, centroids, nlist: int):
    """The update of one Lloyd step: rows ordered by (cluster, row) with
    the sort kernel (which also writes the sorted keys), then the update
    kernels' fixed-order sums (`lloyd_update_sorted`)."""
    if K._on_cpu(vecs, valid, assign, centroids):
        return lloyd_update_plain(vecs, valid, assign, centroids, nlist)
    _check2(vecs, "vecs")
    n, d = vecs.shape
    _check2(centroids, "centroids", d)
    K._check(valid, "valid", (torch.bool,), n)
    K._check(assign, "assign", (torch.int32,), n)
    if centroids.shape[0] != nlist:
        raise ValueError(f"centroids: {centroids.shape[0]} rows, want "
                         f"{nlist}")
    keys = torch.where(valid, assign.to(torch.int64),
                       torch.full((), nlist, dtype=torch.int64,
                                  device=vecs.device))
    perm, skeys = K._sort_launch(keys.unsqueeze(0), "sort_rows", first=True)
    K._count("sort_rows")
    return lloyd_update_sorted(vecs, skeys, perm, centroids, nlist)


def lloyd_update_sorted(vecs, skeys, perm, centroids, nlist: int):
    """The update after the sort, on the card: `skeys` the rows' keys
    (cluster, nlist for an invalid row) in sorted order, `perm` the rows
    in that order.  Two launches (csrc/kmeans.cu): tiles of LLOYD_TILE
    sorted positions a warp, then each cluster's pieces in tile order."""
    n, d = vecs.shape
    lib = K._lib()
    nbytes = lib.otbt_ann_lloyd_scratch_bytes(n, d, nlist)
    if nbytes < 0:
        raise ValueError(f"ann_lloyd_update: no list or no dimension "
                         f"({nlist} x {d})")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=vecs.device)
    out = torch.empty_like(centroids)
    rc = lib.otbt_ann_lloyd_update(K._ptr(vecs), n, d, K._ptr(skeys),
                                   K._ptr(perm), nlist, K._ptr(centroids),
                                   K._ptr(out), K._ptr(scratch), nbytes,
                                   K._stream())
    K._ok(rc, "ann_lloyd_update")
    K._count("ann_lloyd_update")
    return out


def _lloyd_step_plain(vecs, valid, centroids, nlist: int):
    # the reference assigns with l2 whatever the index's metric
    assign = assign_clusters_plain(vecs, centroids)
    return lloyd_update_plain(vecs, valid, assign, centroids, nlist)


def _lloyd_step(vecs, valid, centroids, nlist: int):
    """One Lloyd iteration: l2 assignment (the reference's, whatever the
    index's metric), then the centroid update."""
    assign = assign_clusters(vecs, centroids)
    return lloyd_update(vecs, valid, assign, centroids, nlist)


def kmeans(vecs: np.ndarray, nlist: int, iters: int = 8, seed: int = 17,
           device=None) -> np.ndarray:
    """Lloyd k-means for the IVF coarse quantizer: the reference's
    initial centroids from the same generator calls, the rows uploaded
    once, the steps on `device` (the card unless the caller names
    another), the centroids read back once."""
    from ..exec.session import resolve_device
    n = len(vecs)
    rng = np.random.default_rng(seed)
    init = vecs[rng.choice(n, size=min(nlist, n), replace=False)]
    if len(init) < nlist:   # fewer rows than lists
        init = np.concatenate(
            [init, rng.normal(size=(nlist - len(init), vecs.shape[1]))
             .astype(np.float32)])
    dev = resolve_device(device)
    c = torch.from_numpy(np.ascontiguousarray(init, dtype=np.float32)).to(dev)
    v = torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(iters):
        c = _lloyd_step(v, valid, c, nlist)
    return c.cpu().numpy()


# ---------------------------------------------------------------------------
# K15d the IVF probe search (reference: ops/ann.py:98)
# ---------------------------------------------------------------------------

def _in_probe(probed, assign):
    nlist = probed.shape[0] - 1
    return probed[torch.clamp(assign.to(torch.int64), 0, nlist)]


def probe_scan_plain(vecs, assign, probed, valid, q, metric: str = "l2"):
    """Distances of the valid rows of probed lists, +inf elsewhere (the
    reference's mask over every row's distance)."""
    d = distances_plain(vecs, q, metric)
    return _masked(d, valid & _in_probe(probed, assign))


def probe_scan(vecs, assign, probed, valid, q, metric: str = "l2"):
    """The IVF row pass: probed (nlist + 1,) bool with the last entry
    false; reads a row's vector only when it is ranked."""
    m = _metric(metric)
    if K._on_cpu(vecs, assign, probed, valid, q):
        return probe_scan_plain(vecs, assign, probed, valid, q, metric)
    _check2(vecs, "vecs")
    n, d = vecs.shape
    K._check(q, "q", (torch.float32,), d)
    K._check(assign, "assign", (torch.int32,), n)
    K._check(valid, "valid", (torch.bool,), n)
    K._check(probed, "probed", (torch.bool,))
    out = torch.empty(n, dtype=torch.float32, device=vecs.device)
    rc = K._lib().otbt_ann_probe_scan(
        K._ptr(vecs), K._ptr(q), K._ptr(assign), K._ptr(probed),
        probed.shape[0] - 1, K._ptr(valid), n, d, m, _vec4(vecs),
        K._ptr(out), K._stream())
    K._ok(rc, "ann_probe_scan")
    K._count("ann_probe_scan")
    return out


def _probed(centroids, q, nprobe: int, metric: str, dist_fn, topk_fn):
    cd = dist_fn(centroids, q, metric)
    probe, _ = topk_fn(cd, None, nprobe)
    probed = torch.zeros(centroids.shape[0] + 1, dtype=torch.bool,
                         device=centroids.device)
    probed[probe] = True
    return probed


def ivf_search_plain(vecs, assign, centroids, q, valid, nprobe: int, k: int,
                     metric: str = "l2"):
    """The reference's masked form: every row's distance, rows of
    unprobed lists masked to +inf, top-k."""
    probed = _probed(centroids, q, nprobe, metric, distances_plain,
                     topk_nearest_plain)
    d = distances_plain(vecs, q, metric)
    return topk_nearest_plain(d, valid & _in_probe(probed, assign), k)


def ivf_search(vecs, assign, centroids, q, valid, nprobe: int, k: int,
               metric: str = "l2"):
    """Probe the nprobe nearest lists, rank their valid rows, top-k:
    distances and top-k over the centroids, the probed bitmap, the probe
    scan, top-k over its output (each step a wrapper above)."""
    probed = _probed(centroids, q, nprobe, metric, distances, topk_nearest)
    d = probe_scan(vecs, assign, probed, valid, q, metric)
    return topk_nearest(d, None, k)
