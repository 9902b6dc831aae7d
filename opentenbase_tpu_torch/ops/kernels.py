"""Device kernels of the scan / join / aggregate / sort path and of the
cluster tier's exchanges, hand-written in CUDA.

The counterpart of opentenbase_tpu/ops/kernels.py.  Each kernel here has
three parts:

- a CUDA C++ kernel in ../csrc/ (built for sm_90a by ops/build.py and
  called through ctypes), whose source notes which reference kernel it
  replaces, what bounds it on an H100 and how its design answers that;
- a wrapper with the reference's signature, which checks device, dtype,
  shape and contiguity, allocates the outputs, launches on PyTorch's
  current stream, raises on a nonzero CUDA status, and adds one to
  LAUNCHES[name] per launch (_count: a launch recorded into a CUDA
  graph under capture is not a launch; the fused tier and the cluster
  program add a captured graph's launches at every replay, exec/fused.py
  and exec/mesh_exec.py, the latter also one "mesh_program" a replay);
- a plain PyTorch version (`*_plain`) of the same function.  The wrapper
  takes it only for tensors that lie on the CPU (the tests run there);
  for a CUDA tensor it launches the kernel or raises.

Padded batches: every kernel takes whole padded columns; padding rows
are masked by the caller's validity mask.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from . import build as _build
from ..storage.batch import next_pow2
from ..utils.dtypes import device_float, float_word
from ..utils.hashing import (bucket_ids_plain, hash_columns_plain,
                             route_dest_plain)

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"visibility_mask": 0, "decode_column": 0, "cmp_on_codes": 0,
            "grouped_agg_dense": 0, "grouped_agg_sort": 0, "join_build": 0,
            "join_probe_counts": 0, "join_expand": 0, "compose_index": 0,
            "semi_mask": 0, "anti_mask": 0, "sort_rows": 0,
            "hash_columns": 0, "bucket_ids": 0, "route_dest": 0,
            "exchange": 0, "exchange_fixed": 0, "compact": 0,
            "fused_scan_agg": 0,
            "ann_distances": 0, "ann_topk": 0, "ann_assign": 0,
            "ann_lloyd_update": 0, "ann_probe_scan": 0,
            "window_bounds": 0, "window_frame_reduce": 0,
            "range_minmax": 0, "mesh_program": 0}
_LAUNCH_LOCK = threading.Lock()
_CAPTURE = threading.local()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str, n: int = 1) -> None:
    """Count `n` launches of kernel `name`; under capture_launches()
    they go to this thread's capture tally instead."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + n
        return
    with _LAUNCH_LOCK:
        LAUNCHES[name] += n


def add_launches(tally: dict) -> None:
    """Count a replayed CUDA graph's kernel launches."""
    with _LAUNCH_LOCK:
        for k, v in tally.items():
            LAUNCHES[k] += v


class capture_launches:
    """Within the block, this thread's launches are recorded into the
    dict it yields (a CUDA graph under capture launches nothing)."""

    def __enter__(self) -> dict:
        self.prev = getattr(_CAPTURE, "tally", None)
        _CAPTURE.tally = {}
        return _CAPTURE.tally

    def __exit__(self, *exc):
        _CAPTURE.tally = self.prev


def _lib():
    return _build.lib()


def _on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU (the plain path); raises
    when they are split across devices or lie on something else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(t: torch.Tensor, name: str, dtypes, n: int | None = None):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 1 or (n is not None and t.shape[0] != n):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _stream() -> int:
    """The current device's current stream as a raw handle.  torch's
    private _cuda_getCurrentRawStream gives it without building a Stream
    object on every launch; a torch without it takes the public
    torch.cuda.current_stream().cuda_stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream().cuda_stream
    return raw(torch.cuda.current_device())


def _ok(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _llarr(vals) -> ctypes.Array:
    """A host array of int64 for a C entry (at least one entry)."""
    vals = list(vals)
    return (ctypes.c_longlong * max(len(vals), 1))(*vals)


def _iarr(vals) -> ctypes.Array:
    """A host array of int32 for a C entry (at least one entry)."""
    vals = list(vals)
    return (ctypes.c_int * max(len(vals), 1))(*vals)


# ---------------------------------------------------------------------------
# K1 visibility (reference: ops/kernels.py:40; HeapTupleSatisfiesMVCC)
# ---------------------------------------------------------------------------

def visibility_mask_plain(xmin_ts, xmax_ts, xmin_txid, xmax_txid,
                          snap_ts, my_txid, aborted_ts):
    ins = (xmin_ts <= snap_ts) | ((xmin_txid == my_txid)
                                  & (xmin_ts != aborted_ts))
    dele = (xmax_ts <= snap_ts) | (xmax_txid == my_txid)
    return ins & ~dele


def visibility_mask(xmin_ts, xmax_ts, xmin_txid, xmax_txid,
                    snap_ts, my_txid, aborted_ts):
    """GTS MVCC visibility over the four decoded int64 system columns:
    (xmin_ts <= snap or own insert not aborted) and not (xmax_ts <= snap
    or own delete).  snap_ts and my_txid are ints, or 0-d int64 tensors
    on the columns' device: the kernel then reads them from device
    memory, so a captured program can change them between replays."""
    cols = (xmin_ts, xmax_ts, xmin_txid, xmax_txid)
    on_dev = isinstance(snap_ts, torch.Tensor)
    if on_dev != isinstance(my_txid, torch.Tensor):
        raise TypeError("snap_ts and my_txid: both ints or both tensors")
    aborted_ts = int(aborted_ts)
    if not on_dev:
        snap_ts, my_txid = int(snap_ts), int(my_txid)
    if _on_cpu(*cols, *((snap_ts, my_txid) if on_dev else ())):
        return visibility_mask_plain(*cols, snap_ts, my_txid, aborted_ts)
    n = xmin_ts.shape[0]
    for nm, t in zip(("xmin_ts", "xmax_ts", "xmin_txid", "xmax_txid"), cols):
        _check(t, nm, (torch.int64,), n)
    out = torch.empty(n, dtype=torch.bool, device=xmin_ts.device)
    if on_dev:
        for nm, t in (("snap_ts", snap_ts), ("my_txid", my_txid)):
            if t.dtype != torch.int64 or t.numel() != 1:
                raise ValueError(f"{nm}: want one int64")
        rc = _lib().otbt_visibility_mask_dev(
            *(_ptr(t) for t in cols), _ptr(snap_ts), _ptr(my_txid),
            aborted_ts, _ptr(out), n, _stream())
    else:
        rc = _lib().otbt_visibility_mask(
            *(_ptr(t) for t in cols), snap_ts, my_txid, aborted_ts,
            _ptr(out), n, _stream())
    _ok(rc, "visibility_mask")
    _count("visibility_mask", 1)
    return out


# ---------------------------------------------------------------------------
# K2 codec decode / compare on codes (reference: ops/kernels.py:55, :69)
# ---------------------------------------------------------------------------

_FAMILY = {"pack": 0, "for": 1, "dict": 2}
_CMP_OPS = {"=": 0, "<>": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
_CODE_BITS = {torch.uint8: 8, torch.uint16: 16, torch.uint32: 32}
_OUT_BITS = {torch.int32: 32, torch.int64: 64}


def _dtype_min(dt: torch.dtype) -> int:
    return torch.iinfo(dt).min


def _value_plain(codes, aux, family: str, pad_select: bool):
    # torch has no arithmetic on uint32 and reads a uint8 index as a
    # mask, so the codes widen to int64 before any add or gather
    c = codes.to(torch.int64)
    if family == "pack":
        return c.to(aux.dtype)
    if family == "for":
        v = c.to(aux.dtype) + aux[0]
        if pad_select:
            v = torch.where(c == 0, torch.zeros((), dtype=aux.dtype,
                                                device=v.device), v)
        return v
    cap = aux.shape[0]
    got = aux[c.clamp(max=cap - 1)]
    return torch.where(c < cap, got,
                       torch.full((), _dtype_min(aux.dtype), dtype=aux.dtype,
                                  device=got.device))


def decode_column_plain(codes, aux, family: str):
    return _value_plain(codes, aux, family, True)


def _check_codec(codes, aux, family: str):
    if family not in _FAMILY:
        raise ValueError(f"unknown codec family {family!r}")
    _check(codes, "codes", tuple(_CODE_BITS))
    _check(aux, "aux", tuple(_OUT_BITS))
    if aux.shape[0] < 1:
        raise ValueError("aux: empty")


def decode_column(codes, aux, family: str):
    """Encoded staged column -> original values (dtype of `aux`).  Code 0
    is the padding sentinel of for/dict and decodes to exactly 0."""
    if _on_cpu(codes, aux):
        return decode_column_plain(codes, aux, family)
    _check_codec(codes, aux, family)
    n = codes.shape[0]
    out = torch.empty(n, dtype=aux.dtype, device=codes.device)
    rc = _lib().otbt_decode_column(
        _ptr(codes), _CODE_BITS[codes.dtype], _ptr(aux), _OUT_BITS[aux.dtype],
        _FAMILY[family], aux.shape[0], _ptr(out), n, _stream())
    _ok(rc, "decode_column")
    _count("decode_column", 1)
    return out


def _lit_for(lit, dtype: torch.dtype) -> int:
    v = int(lit)
    info = torch.iinfo(dtype)
    if not info.min <= v <= info.max:
        raise OverflowError(f"literal {v} out of range for {dtype}")
    return v


def cmp_on_codes_plain(codes, aux, family: str, op: str, lit):
    if op not in _CMP_OPS:
        return None
    lhs = _value_plain(codes, aux, family, False)
    rhs = torch.tensor(_lit_for(lit, aux.dtype), dtype=aux.dtype,
                       device=lhs.device)
    return {"=": torch.eq, "<>": torch.ne, "<": torch.lt, "<=": torch.le,
            ">": torch.gt, ">=": torch.ge}[op](lhs, rhs)


def cmp_on_codes(codes, aux, family: str, op: str, lit):
    """`decoded <op> lit` computed on the codes, without the padding
    select (padding rows are masked by the scan's row-count belt).
    Returns None for an op outside = <> < <= > >=."""
    if _on_cpu(codes, aux):
        return cmp_on_codes_plain(codes, aux, family, op, lit)
    if op not in _CMP_OPS:
        return None
    _check_codec(codes, aux, family)
    n = codes.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=codes.device)
    rc = _lib().otbt_cmp_on_codes(
        _ptr(codes), _CODE_BITS[codes.dtype], _ptr(aux), _OUT_BITS[aux.dtype],
        _FAMILY[family], aux.shape[0], _CMP_OPS[op],
        _lit_for(lit, aux.dtype), _ptr(out), n, _stream())
    _ok(rc, "cmp_on_codes")
    _count("cmp_on_codes", 1)
    return out


# ---------------------------------------------------------------------------
# K4 dense grouped aggregation (reference: ops/kernels.py:133)
# ---------------------------------------------------------------------------

_AGG_KINDS = ("sum", "count", "min", "max", "sumf")
_MAX_AGGS = 32          # csrc/grouped_agg.cu kMaxAggs
_K_SUM_INT, _K_SUM_FLOAT, _K_MIN, _K_MAX, _K_COUNT = range(5)
_DT = {torch.int32: 0, torch.int64: 1, torch.float64: 2, torch.bool: 3}


def _is_float(dt: torch.dtype) -> bool:
    return dt.is_floating_point


def _fill(kind: str, dt: torch.dtype):
    """Identity of min/max in the input's own dtype (what an empty
    group reports, as segment_min/segment_max do)."""
    if _is_float(dt):
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dt)
    return info.max if kind == "min" else info.min


def grouped_agg_dense_plain(group_id, valid, agg_inputs: tuple,
                            num_groups: int, agg_kinds: tuple):
    inrange = valid & (group_id >= 0) & (group_id < num_groups)
    dev = group_id.device
    gid = torch.where(inrange, group_id,
                      torch.full((), num_groups, dtype=group_id.dtype,
                                 device=dev))
    slots = num_groups + 1
    outs = []
    for kind, vals in zip(agg_kinds, agg_inputs):
        if kind == "count":
            vals = inrange.to(torch.int64)
        elif kind == "sumf":
            vals = vals.to(device_float())
        elif kind == "sum" and not _is_float(vals.dtype):
            vals = vals.to(torch.int64)   # SQL widens sum(int4) -> bigint
        if kind in ("min", "max"):
            o = torch.full((slots,), _fill(kind, vals.dtype),
                           dtype=vals.dtype, device=dev)
            o = o.scatter_reduce(0, gid, vals,
                                 "amin" if kind == "min" else "amax",
                                 include_self=True)
        else:
            vals = torch.where(inrange, vals,
                               torch.zeros((), dtype=vals.dtype, device=dev))
            o = torch.zeros(slots, dtype=vals.dtype,
                            device=dev).index_add(0, gid, vals)
        outs.append(o[:num_groups])
    present = torch.zeros(slots, dtype=torch.int64, device=dev).index_add(
        0, gid, inrange.to(torch.int64))[:num_groups]
    return tuple(outs), present


def _agg_code(kind: str, dt: torch.dtype) -> tuple[int, int]:
    """(kernel kind, identity bit pattern) of one aggregate."""
    if kind == "count":
        return _K_COUNT, 0
    if kind == "sumf" or (kind == "sum" and _is_float(dt)):
        return _K_SUM_FLOAT, 0
    if kind == "sum":
        return _K_SUM_INT, 0
    if dt == torch.bool:
        raise TypeError(f"{kind} over bool is not supported")
    code = _K_MIN if kind == "min" else _K_MAX
    f = _fill(kind, dt)
    if _is_float(dt):
        return code, int(np.asarray([f], np.float64).view(np.int64)[0])
    return code, f


def grouped_agg_dense(group_id, valid, agg_inputs: tuple,
                      num_groups: int, agg_kinds: tuple):
    """Aggregate with a precomputed dense group id in [0, num_groups):
    returns (per-aggregate [num_groups] outputs, present counts).
    Kinds: sum (ints widen to int64), sumf (f64), count, min, max; an
    empty group's min/max is the dtype's max/min.  On the card one
    allocation a set of 32 aggregates holds the outputs (8-byte regions
    of num_groups words, an int32 min/max in the first half of its own),
    present and the kernel's scratch; the outputs are views of it, and
    the kernel writes every word of them (csrc/grouped_agg.cu)."""
    num_groups = int(num_groups)
    if any(k not in _AGG_KINDS for k in agg_kinds):
        raise ValueError(f"unknown aggregate kinds {agg_kinds}")
    if _on_cpu(group_id, valid, *agg_inputs):
        return grouped_agg_dense_plain(group_id, valid, agg_inputs,
                                       num_groups, agg_kinds)
    n = group_id.shape[0]
    _check(group_id, "group_id", (torch.int64,), n)
    _check(valid, "valid", (torch.bool,), n)
    if num_groups < 1:
        raise ValueError("num_groups must be >= 1")
    for v in agg_inputs:
        _check(v, "agg input", tuple(_DT), n)
    lib = _lib()
    outs, present = [], None
    g = num_groups
    # one launch per 32 aggregates
    for lo in range(0, max(len(agg_kinds), 1), _MAX_AGGS):
        kinds = agg_kinds[lo:lo + _MAX_AGGS]
        ins = agg_inputs[lo:lo + _MAX_AGGS]
        codes = [_agg_code(k, v.dtype) for k, v in zip(kinds, ins)]
        k = len(kinds)
        nbytes = lib.otbt_grouped_agg_dense_scratch_bytes(n, g, k)
        if nbytes < 0:
            raise RuntimeError("CUDA kernel grouped_agg_dense: the card's "
                               "attributes could not be read")
        buf = torch.empty((k + 1) * g + (nbytes + 7) // 8,
                          dtype=torch.int64, device=group_id.device)
        rc = lib.otbt_grouped_agg_dense(
            _ptr(group_id), _ptr(valid), n, g, k,
            _llarr(_ptr(v) for v in ins), _iarr(c for c, _ in codes),
            _iarr(_DT[v.dtype] for v in ins), _llarr(i for _, i in codes),
            _ptr(buf), _ptr(buf) + 8 * (k + 1) * g, nbytes, _stream())
        _ok(rc, "grouped_agg_dense")
        _count("grouped_agg_dense", 1)
        for a, ((code, _i), v) in enumerate(zip(codes, ins)):
            row = buf[a * g:(a + 1) * g]
            if code == _K_SUM_FLOAT or (code in (_K_MIN, _K_MAX)
                                        and _is_float(v.dtype)):
                row = row.view(torch.float64)
            elif code in (_K_MIN, _K_MAX) and v.dtype == torch.int32:
                row = row.view(torch.int32)[:g]
            outs.append(row)
        if present is None:
            present = buf[k * g:(k + 1) * g]
    return tuple(outs), present


# ---------------------------------------------------------------------------
# K10 sort (reference: ops/kernels.py:488 sort_rows, :476 _order_key)
# ---------------------------------------------------------------------------

def _float_word(x: torch.Tensor, desc: bool) -> torch.Tensor:
    """Order-preserving int64 image of a float key: DESC negates, then
    utils.dtypes.float_word (-0.0 becomes 0.0 and every NaN +NaN, so
    NaNs sort last either way: the reference's lax.sort
    canonicalisation)."""
    x = x.to(torch.float64)
    return float_word(-x if desc else x)


def order_words(key_cols: tuple, valid, descs: tuple) -> torch.Tensor:
    """[1 + len(keys), n] int64 order words: ~valid first (valid rows
    lead), then one word per key (ints widen, DESC by bitwise not;
    floats via _float_word).  Rows compare lexicographically by word,
    then by row index."""
    words = [(~valid).to(torch.int64)]
    for k, d in zip(key_cols, descs):
        if k.dtype.is_floating_point:
            words.append(_float_word(k, d))
        else:
            w = k.to(torch.int64)
            words.append(~w if d else w)
    return torch.stack(words)


def sort_perm_plain(words: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic order of the word rows (row index last)."""
    n = words.shape[1]
    perm = torch.arange(n, dtype=torch.int64, device=words.device)
    for w in reversed(list(words)):
        perm = perm[torch.argsort(w[perm], stable=True)]
    return perm


def _sort_launch(words: torch.Tensor, name: str, first: bool = False):
    """K10's radix sort of [w, n] int64 words on the card: (perm, word 0
    in sorted order or None).  The scratch comes from torch, so under
    capture it lands in the graph's pool."""
    if words.dtype != torch.int64 or words.dim() != 2 \
            or not words.is_contiguous():
        raise ValueError("words: want a contiguous [w, n] int64 tensor")
    w, n = words.shape
    dev = words.device
    lib = _lib()
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    out0 = torch.empty(n, dtype=torch.int64, device=dev) if first else None
    nbytes = lib.otbt_sort_scratch_bytes(w, n)
    if nbytes < 0:
        raise RuntimeError(f"CUDA kernel {name}: the card's occupancy "
                           "query failed")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) \
        if nbytes else None
    _ok(lib.otbt_sort_perm(_ptr(words), w, n,
                           None if scratch is None else _ptr(scratch),
                           nbytes, _ptr(perm),
                           None if out0 is None else _ptr(out0),
                           _stream()), name)
    return perm, out0


def sort_perm(words: torch.Tensor) -> torch.Tensor:
    """Sorted row order of `order_words` output: K10's stable LSD radix
    sort on the card (csrc/sort.cu), sort_perm_plain on the CPU."""
    if _on_cpu(words):
        return sort_perm_plain(words)
    perm, _ = _sort_launch(words, "sort_rows")
    _count("sort_rows", 1)
    return perm


def _sort_rows(key_cols, valid, payload_cols, descs, limit, perm_fn):
    words = order_words(key_cols, valid, descs)
    perm = perm_fn(words)
    payload = tuple(p.index_select(0, perm) for p in payload_cols)
    s_valid = valid.index_select(0, perm)
    if limit is not None:
        payload = tuple(p[:limit] for p in payload)
        s_valid = s_valid[:limit]
    return payload, s_valid


def sort_rows_plain(key_cols: tuple, valid, payload_cols: tuple,
                    descs: tuple, limit: int | None = None):
    return _sort_rows(key_cols, valid, payload_cols, descs, limit,
                      sort_perm_plain)


def sort_rows(key_cols: tuple, valid, payload_cols: tuple,
              descs: tuple, limit: int | None = None):
    """Lexicographic multi-key sort; invalid rows last; optional limit.
    TEXT keys must be pre-mapped to order-preserving ranks by the
    operator (dictionary codes are not ordered).  The order comes from
    the sort kernel; building the order words and gathering the payload
    are elementwise glue."""
    return _sort_rows(key_cols, valid, payload_cols, descs, limit,
                      sort_perm)


# ---------------------------------------------------------------------------
# K5 sort-based grouped aggregation (reference: ops/kernels.py:178)
# ---------------------------------------------------------------------------

def _sortable_ints(key_cols: tuple) -> torch.Tensor:
    """[k, n] int64 equality-preserving images of the key columns: ints
    and bools widen; floats ride their f64 bit pattern with -0.0 made
    0.0 and NaNs left as they are (grouping needs equality, not order:
    unlike K10, no NaN canonicalisation)."""
    out = []
    for k in key_cols:
        if k.dtype.is_floating_point:
            k = k.to(torch.float64)
            k = torch.where(k == 0, torch.zeros((), dtype=k.dtype,
                                                device=k.device), k)
            out.append(k.view(torch.int64))
        else:
            out.append(k.to(torch.int64))
    return torch.stack(out).contiguous()


def _pack_gate(mins, maxs, n: int):
    """The reference's single-word pack test (ops/kernels.py:217-226),
    in float32 as there: sum of log2(span + 2) over the keys plus
    log2(n + 2) under 62 bits, spans measured as uint64.  Returns
    (fast, top): top = product of the key ranges, the word every
    invalid row packs to (above every valid row's)."""
    bits = np.float32(0)
    top = 1
    for mn, mx in zip(mins, maxs):
        span = int(mx) - int(mn) if mx >= mn else 0
        top *= span + 1
        bits = np.float32(bits + np.log2(np.float32(span) + np.float32(2)))
    bits = np.float32(bits + np.log2(np.float32(n + 2)))
    fast = bool(bits < np.float32(62.0))
    return fast, (top if fast else 0)


def _wrap64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def _group_words_plain(ints, valid, mins, maxs, fast: bool, top: int):
    """Sort words of the two reference branches.  fast: one word, the
    keys packed as acc = acc * range + (k - min), invalid rows = top.
    exact: [invalid, packed (wrapping int64), ints...] (the packed word
    only for more than one key)."""
    k, n = ints.shape
    dev = ints.device
    if fast:
        acc = torch.zeros(n, dtype=torch.int64, device=dev)
        for c in range(k):
            mn, mx = int(mins[c]), int(maxs[c])
            rng = (mx - mn if mx >= mn else 0) + 1
            acc = acc * rng + torch.clamp(ints[c] - mn, 0, rng - 1)
        word = torch.where(valid, acc, torch.full((), top, dtype=torch.int64,
                                                  device=dev))
        return word.unsqueeze(0).contiguous()
    words = [(~valid).to(torch.int64)]
    if k > 1:
        packed = torch.zeros(n, dtype=torch.int64, device=dev)
        for c in range(k):
            mn, mx = int(mins[c]), int(maxs[c])
            packed = packed * _wrap64(mx - mn + 1) + torch.where(
                valid, ints[c] - mn, torch.zeros((), dtype=torch.int64,
                                                 device=dev))
        words.append(packed)
    words.extend(ints)
    return torch.stack(words).contiguous()


def _group_words_traced_plain(ints, valid):
    """The traced form's words without a host read (csrc/groupsort.cu
    group_words, which both forms run on the card): the pack test in
    float32 tensors, both branches' words, the fast branch padded with
    zero words to the exact branch's 1 + [k > 1] + k."""
    k, n = ints.shape
    dev = ints.device
    i64 = torch.iinfo(torch.int64)
    mins = torch.where(valid, ints, i64.max).amin(dim=1)
    maxs = torch.where(valid, ints, i64.min).amax(dim=1)
    two = torch.tensor(2.0, dtype=torch.float32)
    bits = torch.zeros((), dtype=torch.float32)
    top = torch.ones((), dtype=torch.int64)
    fast_acc = torch.zeros(n, dtype=torch.int64, device=dev)
    exact_packed = torch.zeros(n, dtype=torch.int64, device=dev)
    for c in range(k):
        mn, mx = mins[c], maxs[c]
        span = torch.where(mx >= mn, mx - mn, torch.zeros_like(mn))
        # span as uint64 (a wrapped int64 difference), then to float32
        span_f = span.to(torch.float64) + torch.where(
            span < 0, torch.tensor(2.0 ** 64, dtype=torch.float64),
            torch.tensor(0.0, dtype=torch.float64))
        top = top * (span + 1)
        bits = bits + torch.log2(span_f.to(torch.float32) + two)
        rng = span + 1
        fast_acc = fast_acc * rng + torch.clamp(ints[c] - mn,
                                                torch.zeros_like(mn),
                                                rng - 1)
        exact_packed = exact_packed * (mx - mn + 1) + torch.where(
            valid, ints[c] - mn, torch.zeros((), dtype=torch.int64,
                                             device=dev))
    bits = bits + torch.log2(torch.tensor(float(n + 2),
                                          dtype=torch.float32))
    fast = bool(bits < 62.0)
    w_all = 1 + (1 if k > 1 else 0) + k
    if fast:
        words = torch.zeros((w_all, n), dtype=torch.int64, device=dev)
        words[0] = torch.where(valid, fast_acc, top.to(dev))
        return words
    rows = [(~valid).to(torch.int64)]
    if k > 1:
        rows.append(exact_packed)
    rows.extend(ints)
    return torch.stack(rows).contiguous()


def grouped_agg_sort_plain(key_cols: tuple, valid, agg_inputs: tuple,
                           max_groups: int, agg_kinds: tuple,
                           traced: bool = False):
    ints = _sortable_ints(key_cols)
    k, n = ints.shape
    dev = ints.device
    if traced:
        perm = sort_perm_plain(_group_words_traced_plain(ints, valid))
    else:
        i64 = torch.iinfo(torch.int64)
        mins = torch.where(valid, ints, i64.max).amin(dim=1).tolist()
        maxs = torch.where(valid, ints, i64.min).amax(dim=1).tolist()
        fast, top = _pack_gate(mins, maxs, n)
        perm = sort_perm_plain(_group_words_plain(ints, valid, mins, maxs,
                                                  fast, top))
    s_valid = valid[perm]
    s_ints = ints[:, perm]
    differs = (s_ints != torch.roll(s_ints, 1, dims=1)).any(dim=0)
    first = torch.arange(n, device=dev) == 0
    boundary = s_valid & (first | differs)
    n_groups = boundary.sum()
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    gid_row = torch.empty(n, dtype=torch.int64, device=dev)
    gid_row[perm] = torch.where(s_valid, gid, torch.full(
        (), max_groups, dtype=torch.int64, device=dev))
    outs, _ = grouped_agg_dense_plain(gid_row, valid, agg_inputs,
                                      max_groups, agg_kinds)
    starts = torch.nonzero(boundary).flatten()[:max_groups]
    take = perm[:1].repeat(max_groups)
    take[:starts.shape[0]] = perm[starts]
    gkeys = tuple(kc.index_select(0, take) for kc in key_cols)
    return gkeys, outs, n_groups


#: key column dtypes the K5 kernels read as they are (csrc/groupsort.cu
#: KeyDt); a key of another dtype is widened to int64 or float64 first
_KEY_DT = {torch.int8: 0, torch.uint8: 1, torch.bool: 1, torch.int16: 2,
           torch.int32: 3, torch.int64: 4, torch.float64: 5}
_MAX_KEYS = 64          # csrc/groupsort.cu kMaxKeys


def _agg_out_dtype(code: int, dt: torch.dtype) -> torch.dtype:
    """The output dtype of one aggregate (as grouped_agg_dense_plain's):
    int64 for counts and int sums, f64 for float sums, the input's own
    for min and max."""
    if code in (_K_COUNT, _K_SUM_INT):
        return torch.int64
    if code == _K_SUM_FLOAT:
        return device_float()
    return dt


def grouped_agg_sort(key_cols: tuple, valid, agg_inputs: tuple,
                     max_groups: int, agg_kinds: tuple, traced: bool = False):
    """General grouped aggregation: sort on the keys (invalid rows
    last), mark group boundaries, number the groups, reduce each group.
    Returns (group key columns [max_groups], aggregate outputs
    [max_groups], n_groups).  Groups come in the reference's order: the
    order of the packed key word when the pack fits 62 bits, else of
    [packed (wrapping), keys...].  Groups at or past max_groups are
    counted in n_groups and dropped; slots past n_groups hold sums and
    counts of 0, min / max identities and the keys of the first sorted
    row.

    On the card, with no host read: two launches (csrc/groupsort.cu: the
    key statistics, then the pack test on the device and the sort words,
    the fast branch's one word padded with zero words to the exact
    branch's 1 + [k > 1] + k), K10's sort, and one launch a set of 32
    aggregates that numbers the groups, reduces every aggregate in
    sorted order (no float atomics: f64 sums are the same bits every
    run) and writes the keys, the filler and n_groups.  `traced` (the
    form a captured fragment program runs) takes the same launches; it
    selects the plain version's form on the CPU."""
    max_groups = int(max_groups)
    if any(k not in _AGG_KINDS for k in agg_kinds):
        raise ValueError(f"unknown aggregate kinds {agg_kinds}")
    if not key_cols:
        raise ValueError("grouped_agg_sort needs at least one key")
    if _on_cpu(valid, *key_cols, *agg_inputs):
        return grouped_agg_sort_plain(key_cols, valid, agg_inputs,
                                      max_groups, agg_kinds, traced)
    lib = _lib()
    n = valid.shape[0]
    _check(valid, "valid", (torch.bool,), n)
    if n < 1:
        raise ValueError("grouped_agg_sort: no rows")
    if max_groups < 1:
        raise ValueError("max_groups must be >= 1")
    if len(key_cols) > _MAX_KEYS:
        raise ValueError(f"grouped_agg_sort: at most {_MAX_KEYS} keys")
    keys = []
    for kc in key_cols:
        if kc.dim() != 1 or kc.shape[0] != n:
            raise ValueError("key columns: want [n] tensors")
        if kc.dtype not in _KEY_DT:
            kc = kc.to(torch.float64 if kc.dtype.is_floating_point
                       else torch.int64)
        keys.append(kc.contiguous())
    for v in agg_inputs:
        _check(v, "agg input", tuple(_DT), n)
    codes = [_agg_code(k, v.dtype) for k, v in zip(agg_kinds, agg_inputs)]
    dev = valid.device
    k, a = len(keys), len(codes)
    nbytes = lib.otbt_group_scratch_bytes(n, k, a)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    kptr = _llarr(_ptr(c) for c in keys)
    kdt = _iarr(_KEY_DT[c.dtype] for c in keys)
    words = torch.empty((1 + k + (1 if k > 1 else 0), n), dtype=torch.int64,
                        device=dev)
    _ok(lib.otbt_group_words(kptr, kdt, k, n, _ptr(valid), a, _ptr(scratch),
                             nbytes, _ptr(words), _stream()),
        "grouped_agg_sort")
    perm, _ = _sort_launch(words, "grouped_agg_sort")
    gkeys = [torch.empty(max_groups, dtype=c.dtype, device=dev) for c in keys]
    outs = [torch.empty(max_groups, dtype=_agg_out_dtype(c, v.dtype),
                        device=dev)
            for (c, _i), v in zip(codes, agg_inputs)]
    n_groups = torch.empty((), dtype=torch.int64, device=dev)
    _ok(lib.otbt_group_reduce(
        kptr, kdt, _llarr(_ptr(g) for g in gkeys), k, n, _ptr(valid),
        _ptr(perm), max_groups, a, _llarr(_ptr(v) for v in agg_inputs),
        _iarr(c for c, _i in codes), _iarr(_DT[v.dtype] for v in agg_inputs),
        _llarr(i for _c, i in codes), _llarr(_ptr(o) for o in outs),
        _ptr(n_groups), _ptr(scratch), nbytes, _stream()),
        "grouped_agg_sort")
    _count("grouped_agg_sort", 1)
    gkeys = tuple(g if g.dtype == kc.dtype else g.to(kc.dtype)
                  for g, kc in zip(gkeys, key_cols))
    return gkeys, tuple(outs), n_groups


# ---------------------------------------------------------------------------
# K6-K9 hash join: sort the build side, count matches per probe row,
# expand pairs, compose indices (reference: ops/kernels.py:306-468)
# ---------------------------------------------------------------------------

def _build_gate_plain(build_keys, build_valid):
    """The reference's join_build gate (ops/kernels.py:317-327): (fast,
    min, rng) from the valid keys' span, in float32 as there."""
    n = build_keys.shape[0]
    if n == 0 or not bool(build_valid.any()):
        return False, 0, 0
    i64 = torch.iinfo(torch.int64)
    mn = int(torch.where(build_valid, build_keys, i64.max).min())
    mx = int(torch.where(build_valid, build_keys, i64.min).max())
    fast, rng = _pack_gate([mn], [mx], n)
    return fast, mn, rng


def join_build_plain(build_keys, build_valid):
    fast, mn, rng = _build_gate_plain(build_keys, build_valid)
    if fast:
        # one word: the key's offset, an invalid row above every valid one
        acc = torch.where(build_valid, torch.clamp(build_keys - mn, 0,
                                                   rng - 1), rng)
        perm = sort_perm_plain(acc.unsqueeze(0))
        acc_s = acc[perm]
        return torch.where(acc_s >= rng, INT64_MAX, acc_s + mn), perm
    keys = torch.where(build_valid, build_keys, INT64_MAX)
    perm = sort_perm_plain(keys.unsqueeze(0))
    return keys[perm], perm


def join_build(build_keys, build_valid):
    """Sort the build side: (sorted keys, perm), invalid rows as key
    INT64_MAX, stable (ties keep row order), by the reference's two
    branches: when the valid keys' span times n fits 62 bits (its
    float32 gate) the one word acc = key - min (rng = span + 1 for an
    invalid row, after every valid row), else the masked key.  On the
    card: the key stats, the gate and the word are kernels of join.cu,
    the order is K10's radix sort, whose sorted word becomes the sorted
    keys in one elementwise epilogue; no host read."""
    if _on_cpu(build_keys, build_valid):
        return join_build_plain(build_keys, build_valid)
    n = build_keys.shape[0]
    _check(build_keys, "build_keys", (torch.int64,), n)
    _check(build_valid, "build_valid", (torch.bool,), n)
    dev = build_keys.device
    lib = _lib()
    nbytes = lib.otbt_join_scratch_bytes(n)
    if nbytes < 0:
        raise RuntimeError("CUDA kernel join_build: the card's occupancy "
                           "query failed")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    sorted_keys = torch.empty(n, dtype=torch.int64, device=dev)
    rc = lib.otbt_join_build(_ptr(build_keys), _ptr(build_valid), n,
                             _ptr(scratch), nbytes, _ptr(perm),
                             _ptr(sorted_keys), _stream())
    _ok(rc, "join_build")
    _count("join_build", 1)
    return sorted_keys, perm


def join_probe_counts_plain(sorted_keys, probe_keys, probe_valid):
    nb, np_ = sorted_keys.shape[0], probe_keys.shape[0]
    dev = probe_keys.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if not nb:
        return (torch.zeros(np_, dtype=torch.int64, device=dev),
                torch.zeros(np_, dtype=torch.int64, device=dev))
    pk = torch.where(probe_valid, probe_keys,
                     torch.full((), INT64_MAX - 1, dtype=torch.int64,
                                device=dev))
    usable = probe_valid & (probe_keys != INT64_MAX)
    live = sorted_keys != INT64_MAX
    nlive = int(live.sum())
    T = max(2 * nb, np_)
    mn = int(sorted_keys[0])
    if nlive and int(sorted_keys[nlive - 1]) - mn < T:
        idx = torch.arange(nb, dtype=torch.int64, device=dev)
        cell = torch.where(live, torch.clamp(sorted_keys - mn, 0, T - 1),
                           torch.full((), T, dtype=torch.int64, device=dev))
        lo_tab = torch.full((T + 1,), nb, dtype=torch.int64,
                            device=dev).scatter_reduce(0, cell, idx, "amin")
        cnt_tab = torch.zeros(T + 1, dtype=torch.int64, device=dev) \
            .index_add(0, cell, torch.ones_like(idx))
        off = pk - mn
        inb = usable & (off >= 0) & (off < T)
        loc = torch.clamp(off, 0, T - 1)
        cnt = torch.where(inb, cnt_tab[loc], zero)
        return torch.where(cnt > 0, lo_tab[loc], zero), cnt
    lo = torch.searchsorted(sorted_keys, pk)
    hi = torch.searchsorted(sorted_keys, pk, right=True)
    hit = sorted_keys[torch.clamp(lo, max=nb - 1)] == pk
    return lo, torch.where(usable & hit, hi - lo, zero)


#: build rows from which K7's table slots are int64 (a row index no
#: longer fits an int32)
PROBE_WIDE_ROWS = 1 << 31


def join_probe_counts(sorted_keys, probe_keys, probe_valid):
    """(lo, count) per probe row: the build rows sorted_keys[lo:lo +
    count] carry the probe row's key.  Two strategies, as the reference:
    a direct-address table over [min, min + T) with T = max(2 nb, np)
    when the live build keys span less than T (uint64 span), else binary
    search.  Invalid probe rows and keys equal to INT64_MAX count 0.
    `lo` of a row with count 0 is unspecified (the reference's branches
    differ there).

    On the card: two launches, no atomics and no host read.  The fill
    writes each run's first row into its key's slot (one writer a slot:
    the keys are sorted), the branch record and the splitter keys; the
    probe checks the slot's row against its key and gallops to the run's
    end, or in the search branch brackets the lower bound with the
    splitters in shared memory.  One scratch allocation (the table) and
    one output, lo and count the two rows of one (2, np) int64 tensor;
    lo is 0 where the count is 0."""
    if _on_cpu(sorted_keys, probe_keys, probe_valid):
        return join_probe_counts_plain(sorted_keys, probe_keys, probe_valid)
    return probe_counts_cuda(sorted_keys, probe_keys, probe_valid,
                             sorted_keys.shape[0] >= PROBE_WIDE_ROWS)


def probe_counts_cuda(sorted_keys, probe_keys, probe_valid, wide: bool):
    """join_probe_counts' launch on CUDA tensors, with int64 table slots
    when `wide` (join_probe_counts sets it from PROBE_WIDE_ROWS build
    rows on; a check may set it to reach that path at a small size)."""
    nb, np_ = sorted_keys.shape[0], probe_keys.shape[0]
    _check(sorted_keys, "sorted_keys", (torch.int64,), nb)
    _check(probe_keys, "probe_keys", (torch.int64,), np_)
    _check(probe_valid, "probe_valid", (torch.bool,), np_)
    dev = probe_keys.device
    if not nb:
        return (torch.zeros(np_, dtype=torch.int64, device=dev),
                torch.zeros(np_, dtype=torch.int64, device=dev))
    T = max(2 * nb, np_)
    lib = _lib()
    nbytes = lib.otbt_probe_table_bytes(T, int(wide))
    table = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty((2, np_), dtype=torch.int64, device=dev)
    rc = lib.otbt_join_probe_counts(
        _ptr(sorted_keys), nb, _ptr(probe_keys), _ptr(probe_valid), np_, T,
        _ptr(table), nbytes, int(wide), _ptr(out), _stream())
    _ok(rc, "join_probe_counts")
    _count("join_probe_counts", 1)
    return out[0], out[1]


def join_expand_plain(lo, counts, perm, out_size: int,
                      left_outer: bool = False, probe_valid=None):
    n, nb = counts.shape[0], perm.shape[0]
    dev = counts.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if left_outer:
        eff = torch.clamp(counts, min=1)
        if probe_valid is not None:
            eff = torch.where(probe_valid, eff, zero)
    else:
        eff = counts
    csum = torch.cumsum(eff, 0)
    total = csum[-1] if n else zero
    j = torch.arange(out_size, dtype=torch.int64, device=dev)
    valid = j < total
    p = torch.clamp(torch.searchsorted(csum, j, right=True), 0,
                    max(n - 1, 0))
    if nb:
        bpos = torch.clamp(lo[p] + j - (csum[p] - eff[p]), 0, nb - 1)
        build_idx = perm[bpos]
    else:
        build_idx = torch.zeros(out_size, dtype=torch.int64, device=dev)
    if left_outer:
        build_idx = torch.where(counts[p] == 0, -1, build_idx)
    return (torch.where(valid, p, zero), torch.where(valid, build_idx, zero),
            total)


def join_expand(lo, counts, perm, out_size: int, left_outer: bool = False,
                probe_valid=None):
    """(probe_idx, build_idx, total): the matching pairs, probe-major,
    build rows in `perm` order, packed as a prefix of out_size rows.
    With left_outer each valid probe row without a match (probe_valid
    keeps padding rows out) emits one pair with build_idx -1.  Rows at
    or past total hold (0, 0) and are invalid downstream (the reference
    leaves other values there).

    On the card: one memset of the control words and one launch
    (csrc/join.cu expand_tiles): tiles of probe rows scan their pair
    counts in a single pass chained by the decoupled look-back, each
    tile writes its own pairs (adjacent threads on adjacent slots), and
    padding blocks write (0, 0) past the total.  One allocation holds
    both outputs, the total and the scratch."""
    out_size = int(out_size)
    ts = (lo, counts, perm) + (() if probe_valid is None else (probe_valid,))
    if _on_cpu(*ts):
        return join_expand_plain(lo, counts, perm, out_size, left_outer,
                                 probe_valid)
    lib = _lib()
    n, nb = counts.shape[0], perm.shape[0]
    _check(lo, "lo", (torch.int64,), n)
    _check(counts, "counts", (torch.int64,), n)
    _check(perm, "perm", (torch.int64,), nb)
    if probe_valid is not None:
        _check(probe_valid, "probe_valid", (torch.bool,), n)
    if out_size < 0:
        raise ValueError("join_expand: out_size must be >= 0")
    sbytes = lib.otbt_join_expand_scratch_bytes(n)
    buf = torch.empty(2 * out_size + 1 + (sbytes + 7) // 8,
                      dtype=torch.int64, device=counts.device)
    at = _ptr(buf)
    rc = lib.otbt_join_expand(
        _ptr(lo), _ptr(counts), _ptr(perm),
        None if probe_valid is None else _ptr(probe_valid), n, nb,
        int(left_outer), at, at + 8 * out_size, out_size,
        at + 16 * out_size, at + 8 * (2 * out_size + 1), sbytes, _stream())
    _ok(rc, "join_expand")
    _count("join_expand", 1)
    return buf[:out_size], buf[out_size:2 * out_size], buf[2 * out_size]


def _jax_take(x, take):
    """x gathered at take as a JAX gather reads it: a negative index
    counts from the end, then every index is clamped into range."""
    n = x.shape[0]
    t = torch.where(take < 0, take + n, take)
    return x[torch.clamp(t, 0, n - 1)]


def compose_indices_plain(priors: tuple, take, masks: tuple = ()):
    return (tuple(_jax_take(p, take) for p in priors),
            tuple(_jax_take(m, take) for m in masks))


_MAX_COMPOSE = 48   # csrc/join.cu kMaxCompose: priors (and masks) a launch


def compose_indices(priors: tuple, take, masks: tuple = ()):
    """Late-materialization index composition for one join side: every
    prior index vector gathered at `take` (prior[take]: one int64 gather
    of len(take) whatever the number of columns riding each
    indirection), and the side's output-space null masks with them:
    (outs, mask_outs).  On the card one launch for up to 48 priors and
    48 masks (csrc/join.cu compose_kernel), one launch a set of 48 for
    more."""
    priors, masks = tuple(priors), tuple(masks)
    if _on_cpu(take, *priors, *masks):
        return compose_indices_plain(priors, take, masks)
    n = take.shape[0]
    _check(take, "take", (torch.int64,))
    for p in priors:
        _check(p, "prior", (torch.int64,))
        if p.shape[0] < 1:
            raise ValueError("prior: empty")
    for m in masks:
        _check(m, "mask", (torch.bool,))
        if m.shape[0] < 1:
            raise ValueError("mask: empty")
    dev = take.device
    outs = tuple(torch.empty(n, dtype=torch.int64, device=dev)
                 for _ in priors)
    mouts = tuple(torch.empty(n, dtype=torch.bool, device=dev)
                  for _ in masks)
    if n == 0 or not (priors or masks):
        return outs, mouts
    lib, arr = _lib(), ctypes.c_longlong * _MAX_COMPOSE
    for lo in range(0, max(len(priors), len(masks)), _MAX_COMPOSE):
        ps, pos = priors[lo:lo + _MAX_COMPOSE], outs[lo:lo + _MAX_COMPOSE]
        ms, mos = masks[lo:lo + _MAX_COMPOSE], mouts[lo:lo + _MAX_COMPOSE]
        _ok(lib.otbt_compose_indices(
            arr(*(p.data_ptr() for p in ps)), arr(*(p.shape[0] for p in ps)),
            arr(*(o.data_ptr() for o in pos)), len(ps),
            arr(*(x.data_ptr() for x in ms)), arr(*(x.shape[0] for x in ms)),
            arr(*(o.data_ptr() for o in mos)), len(ms),
            take.data_ptr(), n, _stream()), "compose_index")
        _count("compose_index")
    return outs, mouts


def compose_index_plain(prior, take):
    return compose_indices_plain((prior,), take)[0][0]


def compose_index(prior, take):
    """The reference's signature: prior[take], compose_indices of one
    prior."""
    return compose_indices((prior,), take)[0][0]


def semi_mask_plain(counts):
    return counts > 0


def anti_mask_plain(counts, probe_valid):
    return probe_valid & (counts == 0)


def _join_mask(counts, probe_valid, anti: bool, name: str):
    n = counts.shape[0]
    _check(counts, "counts", (torch.int64,), n)
    if anti:
        _check(probe_valid, "probe_valid", (torch.bool,), n)
    out = torch.empty(n, dtype=torch.bool, device=counts.device)
    rc = _lib().otbt_join_mask(_ptr(counts),
                               _ptr(probe_valid) if anti else None, n,
                               int(anti), _ptr(out), _stream())
    _ok(rc, name)
    _count(name)
    return out


def semi_mask(counts):
    """Probe rows with at least one match."""
    if _on_cpu(counts):
        return semi_mask_plain(counts)
    return _join_mask(counts, None, False, "semi_mask")


def anti_mask(counts, probe_valid):
    """Valid probe rows without a match."""
    if _on_cpu(counts, probe_valid):
        return anti_mask_plain(counts, probe_valid)
    return _join_mask(counts, probe_valid, True, "anti_mask")


# ---------------------------------------------------------------------------
# K11 row hash (reference: utils/hashing.py:70 hash_columns_jax)
# ---------------------------------------------------------------------------

def hash_columns(cols):
    """splitmix64 row hash of one or more integer columns, combined
    column by column as hash_columns_np does; returns the uint64 hash's
    bit pattern as int64.  The plain version is utils/hashing.py's
    hash_columns_plain; the kernel's entry refuses more columns than it
    holds (csrc/hash.cu kMaxCols)."""
    cols = list(cols)
    if not cols:
        raise ValueError("hash_columns needs at least one column")
    if _on_cpu(*cols):
        return hash_columns_plain(cols)
    n = cols[0].shape[0]
    cols = [c.to(torch.int64).contiguous() for c in cols]
    for c in cols:
        _check(c, "hash column", (torch.int64,), n)
    out = torch.empty(n, dtype=torch.int64, device=cols[0].device)
    k = len(cols)
    rc = _lib().otbt_hash_columns(
        (ctypes.c_longlong * k)(*(_ptr(c) for c in cols)), k, n, _ptr(out),
        _stream())
    _ok(rc, "hash_columns")
    _count("hash_columns", 1)
    return out


# ---------------------------------------------------------------------------
# K11 routing (reference: ops/kernels.py:509 bucket_ids; exec/mesh_exec.py
# :581 _route_hash + the shard-map lookup)
# ---------------------------------------------------------------------------

def _route_launch(key_cols, null_masks, text_luts, valid, shard_map,
                  ndn: int, num_buckets: int):
    """The route kernel (csrc/hash.cu) on CUDA tensors: (int32 per row,
    the CUDA status)."""
    k = len(key_cols)
    n = key_cols[0].shape[0]
    keys = [c.to(torch.int64).contiguous() for c in key_cols]
    for c in keys:
        _check(c, "key column", (torch.int64,), n)
    nulls = list(null_masks) if null_masks is not None else [None] * k
    luts = list(text_luts) if text_luts is not None else [None] * k
    for m in nulls:
        if m is not None:
            _check(m, "null mask", (torch.bool,), n)
    for lut in luts:
        if lut is not None:
            _check(lut, "text LUT", (torch.int64,))
            if lut.shape[0] < 1:
                raise ValueError("text LUT: empty")
    if valid is not None:
        _check(valid, "valid", (torch.bool,), n)
    if shard_map is not None:
        _check(shard_map, "shard_map", (torch.int32,), int(num_buckets))
    out = torch.empty(n, dtype=torch.int32, device=keys[0].device)
    arr = ctypes.c_longlong * k
    rc = _lib().otbt_route_dest(
        arr(*(_ptr(c) for c in keys)),
        arr(*(0 if m is None else _ptr(m) for m in nulls)),
        arr(*(0 if t is None else _ptr(t) for t in luts)),
        arr(*(0 if t is None else t.shape[0] for t in luts)), k, n,
        None if valid is None else _ptr(valid),
        None if shard_map is None else _ptr(shard_map), int(num_buckets),
        int(ndn), _ptr(out), _stream())
    return out, rc


def bucket_ids(key_cols: tuple, num_buckets: int):
    """hash_columns(keys) % num_buckets as int32: the bucket of every
    row (csrc/hash.cu's route kernel without a shard map)."""
    key_cols = tuple(key_cols)
    if not key_cols:
        raise ValueError("bucket_ids needs at least one key column")
    if _on_cpu(*key_cols):
        return bucket_ids_plain(key_cols, num_buckets)
    out, rc = _route_launch(key_cols, None, None, None, None, 0,
                            num_buckets)
    _ok(rc, "bucket_ids")
    _count("bucket_ids", 1)
    return out


def route_dest(key_cols, null_masks, text_luts, valid, shard_map,
               ndn: int, num_buckets: int = 4096):
    """Destination DataNode of every row of a batch: shard_map[route_hash
    % num_buckets], the placement the locator stored rows with (or the
    bucket itself when shard_map is None), and `ndn` for a row that is
    not valid.  route_hash (utils/hashing.py route_hash_plain): a key
    whose null mask is set hashes as 0, a key with a text LUT hashes its
    dictionary value, then splitmix64 over the keys.  Returns int32."""
    key_cols = list(key_cols)
    if not key_cols:
        raise ValueError("route_dest needs at least one key column")
    ts = [t for t in (*key_cols, valid, *(null_masks or ()),
                      *(text_luts or ()), shard_map) if t is not None]
    if _on_cpu(*ts):
        return route_dest_plain(key_cols, null_masks, text_luts, valid,
                                shard_map, ndn, num_buckets)
    out, rc = _route_launch(key_cols, null_masks, text_luts, valid,
                            shard_map, ndn, num_buckets)
    _ok(rc, "route_dest")
    _count("route_dest", 1)
    return out


# ---------------------------------------------------------------------------
# K12 exchange (reference: exec/mesh_exec.py:610 _a2a_batch, :673
# _broadcast_batch; parallel/mesh.py:72 _pack_for_a2a, :97 redistribute)
# ---------------------------------------------------------------------------

def _exchange_args(cols, dest, valid, ndn_dst: int):
    """Validate the per-source arguments; returns (sources' rows, the
    column count, the columns' dtypes)."""
    valid = list(valid)
    cols = [tuple(c) for c in cols]
    nsrc = len(valid)
    if nsrc < 1 or len(cols) != nsrc or (dest is not None
                                         and len(dest) != nsrc):
        raise ValueError(f"exchange: {len(cols)} column sets, {nsrc} valid "
                         "masks and the destinations do not name the same "
                         "sources")
    if ndn_dst < 1:
        raise ValueError(f"exchange: {ndn_dst} destinations")
    k = len(cols[0])
    rows = []
    dtypes: list = [None] * k
    for s, (cs, v) in enumerate(zip(cols, valid)):
        if v.dim() != 1:
            raise ValueError(f"exchange: valid of source {s} is not 1-D")
        n = v.shape[0]
        rows.append(n)
        if len(cs) != k:
            raise ValueError(f"exchange: source {s} has {len(cs)} columns, "
                             f"want {k}")
        for j, c in enumerate(cs):
            if c is None:
                continue
            if c.dim() != 1 or c.shape[0] != n:
                raise ValueError(f"exchange: column shape "
                                 f"{tuple(c.shape)}, want ({n},)")
            if dtypes[j] is None:
                dtypes[j] = c.dtype
            elif c.dtype != dtypes[j]:
                raise TypeError(f"exchange: column {j} is {c.dtype} in "
                                f"source {s}, {dtypes[j]} before")
        if dest is not None and (dest[s] is None or dest[s].dim() != 1
                                 or dest[s].shape[0] != n):
            raise ValueError(f"exchange: destinations of source {s} do not "
                             f"cover its {n} rows")
    if any(dt is None for dt in dtypes):
        raise ValueError("exchange: a column no source gives")
    return rows, k, dtypes


_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _take_rows(c, idx):
    """c[idx] for any staged dtype (torch has no CPU gather for uint16 /
    uint32: those ride their signed view, bit for bit)."""
    sv = _SIGNED_VIEW.get(c.dtype)
    if sv is None:
        return c.index_select(0, idx)
    return c.view(sv).index_select(0, idx).view(c.dtype)


def _region(counts: np.ndarray) -> int:
    """Rows of each destination's share of the output: the largest
    destination's row count, to the executor's next power of two."""
    return next_pow2(max(int(counts.sum(axis=0).max()), 1))


def _exchange_slots_plain(cols, dest, valid, ndn_dst: int):
    """The exchange's routing, as the plain versions compute it: (rows,
    k, dtypes, the [nsrc, ndn_dst] int64 count matrix, the global row of
    each live row in destination order (stable: source order, then row
    order), its destination, its rank within the destination)."""
    rows, k, dtypes = _exchange_args(cols, dest, valid, ndn_dst)
    dev = valid[0].device
    n = sum(rows)
    v = torch.cat(list(valid))
    if dest is None:
        d = torch.zeros(n, dtype=torch.int64, device=dev)
    else:
        d = torch.cat([x.to(torch.int64) for x in dest])
    live = v & (d >= 0) & (d < ndn_dst)
    d = torch.where(live, d, torch.full((), ndn_dst, dtype=torch.int64,
                                        device=dev))
    src = torch.repeat_interleave(
        torch.arange(len(rows), device=dev),
        torch.tensor(rows, device=dev))
    counts = torch.zeros((len(rows), ndn_dst + 1), dtype=torch.int64,
                         device=dev)
    counts.index_put_((src, d), torch.ones(n, dtype=torch.int64,
                                           device=dev), accumulate=True)
    # a stable sort by destination keeps row order within each one
    order = torch.argsort(d, stable=True)
    sd = d[order]
    start = torch.searchsorted(sd, torch.arange(ndn_dst + 1, device=dev))
    rank = torch.arange(n, device=dev) - start[sd]
    keep = sd < ndn_dst
    return (rows, k, dtypes, counts[:, :ndn_dst], order[keep], sd[keep],
            rank[keep])


def _scatter_plain(cols, rows, k, dtypes, slot, take, size: int, dev):
    """Zero-filled [size] output columns with the rows `take` (global
    row space) at `slot`, and the valid mask of the slots."""
    out_valid = torch.zeros(size, dtype=torch.bool, device=dev)
    out_valid[slot] = True
    outs = []
    for j in range(k):
        dt = dtypes[j]
        c = torch.cat([cs[j] if cs[j] is not None
                       else torch.zeros(r, dtype=dt, device=dev)
                       for cs, r in zip(cols, rows)])
        o = torch.zeros(size, dtype=dt, device=dev)
        sv = _SIGNED_VIEW.get(dt, dt)
        o.view(sv)[slot] = _take_rows(c, take).view(sv)
        outs.append(o)
    return tuple(outs), out_valid


def exchange_plain(cols, dest, valid, ndn_dst: int):
    rows, k, dtypes, counts, take, sd, rank = _exchange_slots_plain(
        cols, dest, valid, ndn_dst)
    cm = counts.cpu().numpy()
    region = _region(cm)
    outs, out_valid = _scatter_plain(cols, rows, k, dtypes,
                                     sd * region + rank, take,
                                     ndn_dst * region, valid[0].device)
    return outs, out_valid, cm, region


class _XchgArgs:
    """The exchange kernels' arguments on CUDA tensors, checked: the
    host pointer arrays of the sources' destinations, valid masks and
    row counts."""

    def __init__(self, name: str, cols, dest, valid, ndn_dst: int):
        self.rows, self.k, self.dtypes = _exchange_args(cols, dest, valid,
                                                        ndn_dst)
        self.lib = lib = _lib()
        self.nsrc = nsrc = len(self.rows)
        max_dn = lib.otbt_exchange_max_dn()
        if nsrc > max_dn or ndn_dst > max_dn:
            raise ValueError(f"{name}: {nsrc} sources, {ndn_dst} "
                             f"destinations (1..{max_dn} each)")
        for s in range(nsrc):
            _check(valid[s], "valid", (torch.bool,), self.rows[s])
            if dest is not None:
                _check(dest[s], "dest", (torch.int32,), self.rows[s])
            for c in cols[s]:
                if c is not None and not c.is_contiguous():
                    raise ValueError(f"{name}: column not contiguous")
        for dt in self.dtypes:
            if dt.itemsize not in (1, 2, 4, 8):
                raise TypeError(f"{name}: unsupported dtype {dt}")
        self.cols = cols
        self.dev = dev = valid[0].device
        arr = ctypes.c_longlong * nsrc
        self.dptrs = arr(*([0] * nsrc if dest is None else map(_ptr, dest)))
        self.vptrs = arr(*(_ptr(v) for v in valid))
        self.nrows = arr(*self.rows)

    def columns(self, outs, out_ptrs=None):
        """(source column pointers, output column pointers, widths):
        the host arrays of the scatter (0 where a source lacks a
        column); `out_ptrs` the outputs' addresses where the caller has
        them."""
        nsrc, k = self.nsrc, self.k
        kk = max(k, 1)
        ins_p = (ctypes.c_longlong * (nsrc * kk))(
            *[0 if c is None else c.data_ptr() for cs in self.cols
              for c in cs],
            *([0] * (nsrc * kk - nsrc * k)))
        outs_p = (ctypes.c_longlong * kk)(
            *(out_ptrs or [o.data_ptr() for o in outs]))
        widths = (ctypes.c_int * kk)(*(dt.itemsize for dt in self.dtypes))
        return ins_p, outs_p, widths


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def _xchg_inputs(cols, dest, valid):
    cols = [tuple(c) for c in cols]
    valid = list(valid)
    dest = None if dest is None else list(dest)
    ts = [c for cs in cols for c in cs if c is not None] + valid \
        + [d for d in (dest or ()) if d is not None]
    return cols, dest, valid, _on_cpu(*ts)


def exchange(cols, dest, valid, ndn_dst: int):
    """Move the live rows of one or more source batches to `ndn_dst`
    destinations, each source read in place.  cols: one tuple of column
    tensors per source, the same columns in every source (an entry may
    be None where a source lacks the column, a null mask it never set:
    its rows get zeros there); valid: one bool mask per source; dest:
    one int32 tensor per source (from route_dest) naming each row's
    destination, or None to send every live row to destination 0 (the
    broadcast and gather form).  A row is live when it is valid and its
    destination is in range.  Destination d receives its live rows in
    source order, then in row order, as rows [d * region, d * region +
    R_d) of each output column (zeros beyond), with the output valid
    mask set there.

    Returns (output columns, output valid, the ndn_src x ndn_dst numpy
    count matrix, region).  One host read: the count matrix, which
    sizes the outputs (region = next_pow2 of the largest destination's
    rows).  On the card: csrc/exchange.cu (tile histograms, their scan,
    the slot of every row, the scatter of every source's columns)."""
    cols, dest, valid, on_cpu = _xchg_inputs(cols, dest, valid)
    if on_cpu:
        return exchange_plain(cols, dest, valid, ndn_dst)
    x = _XchgArgs("exchange", cols, dest, valid, ndn_dst)
    tiles = x.lib.otbt_exchange_tiles(max(x.rows))
    scratch = torch.empty(2 * x.nsrc * tiles * ndn_dst + x.nsrc * ndn_dst
                          + max(sum(x.rows), 1), dtype=torch.int64,
                          device=x.dev)
    tile_counts, tile_base, counts, pos = torch.split(
        scratch, [x.nsrc * tiles * ndn_dst] * 2
        + [x.nsrc * ndn_dst, max(sum(x.rows), 1)])
    _ok(x.lib.otbt_exchange_count(x.dptrs, x.vptrs, x.nrows, x.nsrc,
                                  ndn_dst, tiles, _ptr(tile_counts),
                                  _ptr(tile_base), _ptr(counts),
                                  _stream()), "exchange")
    cm = counts.view(x.nsrc, ndn_dst).cpu().numpy()
    region = _region(cm)
    out_valid = torch.zeros(ndn_dst * region, dtype=torch.bool,
                            device=x.dev)
    outs = tuple(torch.zeros(ndn_dst * region, dtype=dt, device=x.dev)
                 for dt in x.dtypes)
    ins_p, outs_p, widths = x.columns(outs)
    _ok(x.lib.otbt_exchange_scatter(x.dptrs, x.vptrs, x.nrows, x.nsrc,
                                    ndn_dst, tiles, _ptr(tile_base),
                                    region, _ptr(pos), _ptr(out_valid),
                                    ins_p, outs_p, widths, x.k, _stream()),
        "exchange")
    _count("exchange", 1)
    return outs, out_valid, cm, region


def exchange_fixed_plain(cols, dest, valid, ndn_dst: int, region: int):
    rows, k, dtypes, counts, take, sd, rank = _exchange_slots_plain(
        cols, dest, valid, ndn_dst)
    fit = rank < region
    outs, out_valid = _scatter_plain(cols, rows, k, dtypes,
                                     sd[fit] * region + rank[fit],
                                     take[fit], ndn_dst * int(region),
                                     valid[0].device)
    over = torch.clamp(counts.sum(dim=0) - int(region), min=0)
    return outs, out_valid, counts, over


def exchange_fixed(cols, dest, valid, ndn_dst: int, region: int):
    """The exchange in its fixed-capacity form (the reference's static
    all_to_all buckets, exec/mesh_exec.py:610): as `exchange`, but the
    caller gives each destination's `region`, and nothing is read back
    to the host.  Destination d receives its live rows in source order,
    then in row order, in rows [d * region, d * region + min(R_d,
    region)) of each output column; a row beyond its destination's
    region is dropped.  The output valid mask is written in full; the
    output columns only where it is set (the plain version zero-fills
    them).

    Returns (output columns, output valid, the [nsrc, ndn_dst] int64
    count matrix, the [ndn_dst] int64 overflow: rows beyond each
    region), all on the device, views of one allocation.  On the card:
    csrc/exchange.cu otbt_exchange_fixed, one memset of look-back
    control words and one launch (one more a set of 64 columns beyond
    the first, fewer with many sources), capturable into a CUDA graph."""
    region = int(region)
    if region < 1:
        raise ValueError("exchange_fixed: region must be >= 1")
    cols, dest, valid, on_cpu = _xchg_inputs(cols, dest, valid)
    if on_cpu:
        return exchange_fixed_plain(cols, dest, valid, ndn_dst, region)
    x = _XchgArgs("exchange_fixed", cols, dest, valid, ndn_dst)
    nsrc = x.nsrc
    sb = x.lib.otbt_exchange_fixed_scratch_bytes(x.nrows, nsrc, ndn_dst)
    if sb < 0:
        raise ValueError(f"exchange_fixed: {sum(x.rows)} rows in {nsrc} "
                         "sources is beyond the kernel's tile count")
    # one allocation: the count matrix, totals and overflow, the valid
    # mask, the columns (a block of each dtype, every column 16-byte
    # aligned), then the kernel's scratch; a few views of it
    size = ndn_dst * region
    head = 8 * (nsrc + 2) * ndn_dst
    vat = _up16(head)
    at = vat + _up16(size)
    blocks = {}
    for j, dt in enumerate(x.dtypes):
        blocks.setdefault(dt, []).append(j)
    layout = []
    for dt, js in blocks.items():
        stride = _up16(size * dt.itemsize)
        layout.append((dt, js, at, stride))
        at += len(js) * stride
    buf = torch.empty(at + sb, dtype=torch.uint8, device=x.dev)
    base = buf.data_ptr()
    heads = buf[:head].view(torch.int64).view(nsrc + 2, ndn_dst)
    counts, totals, over = heads[:nsrc], heads[nsrc], heads[nsrc + 1]
    out_valid = buf[vat:vat + size].view(torch.bool)
    outs, out_ptrs = [None] * x.k, [0] * x.k
    for dt, js, o, stride in layout:
        cols_dt = buf[o:o + len(js) * stride].view(dt).view(
            len(js), stride // dt.itemsize)[:, :size]
        for i, (j, c) in enumerate(zip(js, cols_dt.unbind(0))):
            outs[j] = c
            out_ptrs[j] = base + o + i * stride
    outs = tuple(outs)
    ins_p, outs_p, widths = x.columns(outs, out_ptrs)
    _ok(x.lib.otbt_exchange_fixed(x.dptrs, x.vptrs, x.nrows, nsrc, ndn_dst,
                                  region, base, base + 8 * nsrc * ndn_dst,
                                  base + 8 * (nsrc + 1) * ndn_dst,
                                  base + vat, ins_p, outs_p, widths, x.k,
                                  base + at, sb, _stream()),
        "exchange_fixed")
    _count("exchange_fixed", 1)
    return outs, out_valid, counts, over


# ---------------------------------------------------------------------------
# K3 compaction (reference: ops/kernels.py:103 compact; exec/mesh_exec.py
# :853 _compact_local)
# ---------------------------------------------------------------------------

def _col_ptrs(ins, outs):
    k = len(ins)
    arr = ctypes.c_longlong * max(k, 1)
    return (arr(*(_ptr(c) for c in ins)), arr(*(_ptr(c) for c in outs)),
            (ctypes.c_int * max(k, 1))(*(c.element_size() for c in ins)), k)


def compact_plain(mask, cols: tuple, out_size: int):
    out_size = int(out_size)
    idx = torch.nonzero(mask).flatten()[:out_size]
    take = torch.zeros(out_size, dtype=torch.int64, device=mask.device)
    take[:idx.shape[0]] = idx
    return mask.sum(), tuple(_take_rows(c, take) for c in cols)


#: rows and output slots up to which compact() takes the one-block form
#: (csrc/compact.cu compact_one; above it, look-back tiles and a memset)
COMPACT_ONE_ROWS = 16384
_CMP_TILE = 4096     # csrc/compact.cu kTileRows: a look-back tile's rows
_CMP_PASS = 16384    # csrc/compact.cu kPassRows: a one-block pass's rows
_CMP_MAX_COLS = 128  # csrc/compact.cu kMaxCols: columns a launch


def compact(mask, cols: tuple, out_size: int):
    """(count, gathered columns): the live rows of `mask` first, in row
    order, in [out_size] columns; padding rows repeat row 0 and are
    masked by count downstream.  The count (an int64 0-d tensor) stays
    on the device.  On the card: csrc/compact.cu, one launch for up to
    128 columns (one a set of 128 for more), with a memset of the
    look-back's control words before it above COMPACT_ONE_ROWS rows or
    slots."""
    out_size = int(out_size)
    cols = tuple(cols)
    if out_size < 1:
        raise ValueError("compact: out_size must be >= 1")
    if _on_cpu(mask, *cols):
        return compact_plain(mask, cols, out_size)
    n = mask.shape[0]
    _check(mask, "mask", (torch.bool,), n)
    for c in cols:
        if c.dim() != 1 or c.shape[0] != n or not c.is_contiguous():
            raise ValueError(f"compact: column shape {tuple(c.shape)}, "
                             f"want contiguous ({n},)")
        if c.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"compact: unsupported dtype {c.dtype}")
    if n < 1:
        raise ValueError("compact: no rows (padding repeats row 0)")
    dev, lib, one = mask.device, _lib(), int(COMPACT_ONE_ROWS)
    count = torch.empty(1, dtype=torch.int64, device=dev)
    sbytes = lib.otbt_compact_scratch_bytes(n, out_size, one)
    scratch = torch.empty(sbytes, dtype=torch.uint8, device=dev) \
        if sbytes else None
    outs = tuple(torch.empty(out_size, dtype=c.dtype, device=dev)
                 for c in cols)
    for lo in range(0, max(len(cols), 1), _CMP_MAX_COLS):
        ins_p, outs_p, widths, k = _col_ptrs(cols[lo:lo + _CMP_MAX_COLS],
                                             outs[lo:lo + _CMP_MAX_COLS])
        _ok(lib.otbt_compact(_ptr(mask), n, out_size, one,
                             None if scratch is None else _ptr(scratch),
                             sbytes, _ptr(count), ins_p, outs_p, widths, k,
                             _stream()), "compact")
        _count("compact", 1)
    return count[0], outs


# ---------------------------------------------------------------------------
# K14 fused scan-aggregate with a query axis (reference: exec/fused.py:511
# _build_program, :563 run_batch, for scan -> qual -> aggregate fragments)
# ---------------------------------------------------------------------------

#: register-program op codes (csrc/fused.cu enum Op)
FUSED_OPS = {name: i for i, name in enumerate((
    "LDCOL", "LDLIT", "CONST", "IADD", "ISUB", "IMUL", "IDIV", "IMOD",
    "INEG", "WRAP32", "IMIN", "IMAX", "FADD", "FSUB", "FMUL", "FDIV", "FNEG",
    "I2F", "IEQ", "INE", "ILT", "ILE", "IGT", "IGE", "FEQ", "FNE", "FLT",
    "FLE", "FGT", "FGE", "AND", "OR", "NOT"))}
#: aggregate kinds of the fused kernel (csrc/fused.cu enum Agg)
FUSED_SUM, FUSED_COUNT, FUSED_MIN, FUSED_MAX = range(4)
#: the kernel's limits (csrc/fused.cu kMax*)
FUSED_LIMITS = {"cols": 24, "instrs": 160, "consts": 48, "aggs": 24,
                "regs": 64}
_FAMILY_RAW = -1


@dataclasses.dataclass
class ScanAggSpec:
    """A fused scan-aggregate program (exec/expr_compile.py
    emit_scan_agg builds it).  Every register holds an int64 word (an
    f64 as its bit pattern).  instrs[:n_shared] compute the aggregate
    inputs, the group id and the four MVCC columns once per row;
    instrs[n_shared:] compute the qual of one query from its literal row
    (LDLIT a = literal column a).  aggs: (kind, register) pairs."""
    instrs: list
    n_shared: int
    consts: list
    aggs: list
    gid_reg: int
    qual_reg: int
    n_groups: int
    mv_regs: tuple
    n_lits: int


def _agg_ident(kind: int) -> int:
    if kind == FUSED_MIN:
        return INT64_MAX
    if kind == FUSED_MAX:
        return INT64_MIN
    return 0


def _col_kind(t: torch.Tensor) -> int:
    if t.dtype == torch.float64:
        return 2
    if t.dtype in (torch.bool, torch.uint8, torch.uint16, torch.uint32):
        return 1
    return 0


def _fused_spec(spec: ScanAggSpec, cols, n_rows: int,
                aborted_ts: int) -> list:
    """The flat int64 spec csrc/fused.cu otbt_fused_scan_agg parses."""
    hdr = [len(cols), spec.n_shared, len(spec.instrs) - spec.n_shared,
           len(spec.aggs), spec.gid_reg, spec.qual_reg, spec.n_groups,
           spec.n_lits, len(spec.consts), *spec.mv_regs, int(aborted_ts),
           int(n_rows), 0]
    flat = list(hdr)
    for data, aux, fam in cols:
        if fam is None:
            flat += [_ptr(data), 0, 0, data.element_size(), _FAMILY_RAW,
                     _col_kind(data), 64]
        else:
            flat += [_ptr(data), _ptr(aux), aux.shape[0], data.element_size(),
                     _FAMILY[fam], 1, _OUT_BITS[aux.dtype]]
    for ins in spec.instrs:
        flat += list(ins)
    flat += [int(c) for c in spec.consts]
    for kind, reg in spec.aggs:
        flat += [kind, reg, _agg_ident(kind)]
    return flat


def _check_fused(spec: ScanAggSpec, cols, lits, snaps, txids):
    lim = FUSED_LIMITS
    if len(cols) > lim["cols"] or len(spec.instrs) > lim["instrs"] \
            or len(spec.consts) > lim["consts"] \
            or len(spec.aggs) > lim["aggs"]:
        raise ValueError("fused_scan_agg: program over the kernel's limits")
    k = snaps.shape[0]
    _check(snaps, "snaps", (torch.int64,), k)
    _check(txids, "txids", (torch.int64,), k)
    if lits.dtype != torch.int64 or lits.dim() != 2 \
            or tuple(lits.shape) != (k, spec.n_lits) \
            or not lits.is_contiguous():
        raise ValueError(f"lits: want a contiguous ({k}, {spec.n_lits}) "
                         "int64 tensor")
    n = None
    for data, aux, fam in cols:
        if data.dim() != 1 or not data.is_contiguous():
            raise ValueError("fused_scan_agg: columns must be contiguous 1-D")
        if n is not None and data.shape[0] != n:
            raise ValueError("fused_scan_agg: columns differ in length")
        n = data.shape[0]
        if fam is not None:
            _check_codec(data, aux, fam)
        elif data.dtype not in (torch.int32, torch.int64, torch.float64,
                                torch.bool, torch.uint8, torch.int16,
                                torch.int8):
            raise TypeError(f"fused_scan_agg: column dtype {data.dtype}")
    return k


def _fused_col_plain(data, aux, fam):
    if fam is None:
        if data.dtype == torch.float64:
            return data.view(torch.int64)
        return data.to(torch.int64)
    return _value_plain(data, aux, fam, True).to(torch.int64)


def _fused_run_plain(spec: ScanAggSpec, lo: int, hi: int, regs: dict,
                     vals: list, lits):
    """Instructions [lo, hi) over int64 word tensors: [n] in the shared
    part, [K, n] once a literal ([K, 1]) enters."""
    ops = FUSED_OPS
    f64 = torch.float64
    reads_reg = lambda op: op not in (ops["LDCOL"], ops["LDLIT"],  # noqa
                                      ops["CONST"])
    # the last instruction reading each register written here: [K, n]
    # temporaries die as soon as they are dead
    keep = {spec.qual_reg, spec.gid_reg, *spec.mv_regs,
            *(r for _k, r in spec.aggs)}
    last: dict = {}
    for p, (op, _d, a, b) in enumerate(spec.instrs[lo:]):
        if reads_reg(op):
            last[a] = last[b] = p
    written = {d for _o, d, _a, _b in spec.instrs[lo:hi]}

    def fl(t):
        return t.view(f64)

    for p, (op, dst, a, b) in enumerate(spec.instrs[lo:hi]):
        if op == ops["LDCOL"]:
            v = vals[a]
        elif op == ops["LDLIT"]:
            v = lits[:, a:a + 1]
        elif op == ops["CONST"]:
            v = torch.tensor(int(spec.consts[a]), dtype=torch.int64)
        else:
            x = regs.get(a)
            y = regs.get(b)
            if op == ops["IADD"]:
                v = x + y
            elif op == ops["ISUB"]:
                v = x - y
            elif op == ops["IMUL"]:
                v = x * y
            elif op in (ops["IDIV"], ops["IMOD"]):
                zero = y == 0
                ys = torch.where(zero, torch.ones_like(y), y)
                q = torch.div(x, ys, rounding_mode="floor") \
                    if op == ops["IDIV"] else torch.fmod(x, ys)
                v = torch.where(zero, torch.zeros_like(q), q)
            elif op == ops["INEG"]:
                v = -x
            elif op == ops["WRAP32"]:
                v = x.to(torch.int32).to(torch.int64)
            elif op == ops["IMIN"]:
                v = torch.minimum(x, y)
            elif op == ops["IMAX"]:
                v = torch.maximum(x, y)
            elif op == ops["FADD"]:
                v = (fl(x) + fl(y)).view(torch.int64)
            elif op == ops["FSUB"]:
                v = (fl(x) - fl(y)).view(torch.int64)
            elif op == ops["FMUL"]:
                v = (fl(x) * fl(y)).view(torch.int64)
            elif op == ops["FDIV"]:
                v = (fl(x) / fl(y)).view(torch.int64)
            elif op == ops["FNEG"]:
                v = (-fl(x)).view(torch.int64)
            elif op == ops["I2F"]:
                v = x.to(f64).view(torch.int64)
            elif op in (ops["IEQ"], ops["INE"], ops["ILT"], ops["ILE"],
                        ops["IGT"], ops["IGE"], ops["FEQ"], ops["FNE"],
                        ops["FLT"], ops["FLE"], ops["FGT"], ops["FGE"]):
                name = next(k for k, c in ops.items() if c == op)
                if name[0] == "F":
                    x, y = fl(x), fl(y)
                cmp = {"EQ": torch.eq, "NE": torch.ne, "LT": torch.lt,
                       "LE": torch.le, "GT": torch.gt, "GE": torch.ge}
                v = cmp[name[1:]](x, y).to(torch.int64)
            elif op == ops["AND"]:
                v = ((x != 0) & (y != 0)).to(torch.int64)
            elif op == ops["OR"]:
                v = ((x != 0) | (y != 0)).to(torch.int64)
            elif op == ops["NOT"]:
                v = (x == 0).to(torch.int64)
            else:
                raise ValueError(f"fused_scan_agg: unknown op {op}")
        regs[dst] = v
        if reads_reg(op):
            for r in {a, b}:
                if last.get(r) == p and r in written and r not in keep:
                    regs.pop(r, None)


def fused_scan_agg_plain(spec: ScanAggSpec, cols, n_rows: int, lits, snaps,
                         txids, aborted_ts: int):
    """The same register program evaluated over whole columns, the
    literals broadcast as [K, 1]: the [K, A + 1, G] int64 table
    (aggregate rows, then the per-group row count)."""
    k = snaps.shape[0]
    n_rows = int(n_rows)
    dev = snaps.device
    vals = [_fused_col_plain(d[:n_rows], a, f) for d, a, f in cols]
    regs: dict = {}
    _fused_run_plain(spec, 0, spec.n_shared, regs, vals, lits)
    g_n = spec.n_groups
    n_aggs = len(spec.aggs)
    gid = regs[spec.gid_reg] if spec.gid_reg >= 0 else \
        torch.zeros(n_rows, dtype=torch.int64, device=dev)
    gid = gid.expand(n_rows)
    xmin, xmax, xmin_tx, xmax_tx = (regs[r].expand(n_rows)
                                    for r in spec.mv_regs)
    snap = snaps.unsqueeze(1)
    tx = txids.unsqueeze(1)
    ins = (xmin <= snap) | ((xmin_tx == tx) & (xmin != int(aborted_ts)))
    dele = (xmax <= snap) | (xmax_tx == tx)
    ok = ins & ~dele & ((gid >= 0) & (gid < g_n))
    if spec.qual_reg >= 0:
        _fused_run_plain(spec, spec.n_shared, len(spec.instrs), regs, vals,
                         lits)
        ok = ok & (regs[spec.qual_reg] != 0)
    ok = ok.expand(k, n_rows)
    slots = k * g_n
    idx = torch.arange(k, dtype=torch.int64, device=dev).unsqueeze(1) * g_n \
        + torch.clamp(gid, 0, g_n - 1)
    idx = torch.where(ok, idx, torch.full((), slots, dtype=torch.int64,
                                          device=dev)).reshape(-1)
    out = torch.empty((n_aggs + 1, slots + 1), dtype=torch.int64, device=dev)
    for a, (kind, reg) in enumerate(spec.aggs):
        v = torch.ones(n_rows, dtype=torch.int64, device=dev) \
            if kind == FUSED_COUNT else regs[reg].expand(n_rows)
        v = v.expand(k, n_rows).reshape(-1)
        row = torch.full((slots + 1,), _agg_ident(kind), dtype=torch.int64,
                         device=dev)
        if kind in (FUSED_SUM, FUSED_COUNT):
            row = row.index_add(0, idx, v)
        else:
            row = row.scatter_reduce(0, idx, v, "amin" if kind == FUSED_MIN
                                     else "amax", include_self=True)
        out[a] = row
    out[n_aggs] = torch.zeros(slots + 1, dtype=torch.int64,
                              device=dev).index_add(
        0, idx, torch.ones_like(idx))
    return out[:, :slots].reshape(n_aggs + 1, k, g_n).transpose(0, 1) \
        .contiguous()


def fused_scan_agg(spec: ScanAggSpec, cols, n_rows: int, lits, snaps, txids,
                   aborted_ts: int):
    """K queries' scan -> visibility -> qual -> dense aggregate over one
    table in one pass (csrc/fused.cu).  cols: (data, aux, family) per
    column slot (family None for a raw column), the first n_rows rows
    live; lits: [K, n_lits] int64 literal rows (f64 as bits); snaps,
    txids: [K] int64.  Returns the [K, A + 1, G] int64 table: row a < A
    the aggregate spec.aggs[a] of each group (sums as int64, count,
    min, max), row A the group's row count.  Identities where a group
    has no row."""
    cols = [tuple(c) for c in cols]
    ts = [t for d, a, _f in cols for t in (d, a) if t is not None]
    if _on_cpu(lits, snaps, txids, *ts):
        return fused_scan_agg_plain(spec, cols, n_rows, lits, snaps, txids,
                                    aborted_ts)
    k = _check_fused(spec, cols, lits, snaps, txids)
    n_aggs, g_n = len(spec.aggs), spec.n_groups
    ws = torch.zeros((k, n_aggs + 1, g_n), dtype=torch.int64,
                     device=snaps.device)
    for a, (kind, _r) in enumerate(spec.aggs):
        ident = _agg_ident(kind)
        if ident:
            ws[:, a].fill_(ident)
    flat = _fused_spec(spec, cols, n_rows, aborted_ts)
    rc = _lib().otbt_fused_scan_agg(
        (ctypes.c_longlong * len(flat))(*flat), len(flat), _ptr(lits),
        _ptr(snaps), _ptr(txids), k, _ptr(ws), _stream())
    _ok(rc, "fused_scan_agg")
    _count("fused_scan_agg")
    return ws


# ---------------------------------------------------------------------------
# K13 window functions (reference: exec/executor.py:1523 _exec_window,
# :1733 _frame_bounds, :1765 _range_minmax).  The sort is K10's
# (order_words + sort_perm); these three kernels run on the sorted rows.
# ---------------------------------------------------------------------------

#: K13b function codes (csrc/window.cu enum Func)
WIN_FUNCS = {name: i for i, name in enumerate((
    "row_number", "rank", "dense_rank", "lag", "lead", "count", "sum",
    "avg", "first_value", "last_value", "min", "max"))}
#: frame bound kinds (csrc/window.cu enum Bound)
WIN_BOUNDS = {name: i for i, name in enumerate((
    "unbounded_preceding", "preceding", "current", "following",
    "unbounded_following"))}
_WIN_TILE = 1024          # csrc/window.cu kTile: rows per K13a scan tile
_WFR_TILE = 4096          # csrc/window.cu kLbTile: rows per K13b scan tile
_INF_WORD = 0x7FF0000000000000   # _float_word(+inf); a NaN's word is above


def window_frame(frame, has_order: bool) -> tuple:
    """(mode, start kind, start offset, end kind, end offset, has_order)
    of a WindowCall frame: mode 0 is the default frame, 1 ROWS, 2 RANGE
    (only unbounded / current-row bounds, as the reference reads it)."""
    if frame is None:
        return (0, 0, 0, 0, 0, int(has_order))
    mode, (sk, so), (ek, eo) = frame
    return (1 if mode == "rows" else 2, WIN_BOUNDS[sk], int(so or 0),
            WIN_BOUNDS[ek], int(eo or 0), int(has_order))


def window_bounds_plain(words, n_part: int, float_words: tuple, s_valid):
    """Partition and peer bounds of sorted rows.  words: the sorted
    order words [w, n] (order_words rows: ~valid, then n_part partition
    words, then the order words); float_words: the rows that hold float
    keys (a NaN is never its neighbour's peer, as in the reference's
    float compare); s_valid: the sorted validity.  Returns (p_start,
    peer_start, peer_end_v, p_end, ob_cum), int64 [n]: p_end is the last
    valid row of the partition (-1 if none), peer_end_v the peer group's
    last row clipped to it, ob_cum the inclusive count of order
    boundaries."""
    w, n = words.shape
    iota = torch.arange(n, dtype=torch.int64, device=words.device)
    p_bound = iota == 0
    o_bound = p_bound.clone()
    for r in range(1, w):
        x = words[r]
        d = x != torch.roll(x, 1)
        if r in float_words:
            d = d | (x > _INF_WORD)
        if r <= n_part:
            p_bound = p_bound | d
        else:
            o_bound = o_bound | d
    o_bound = o_bound | p_bound
    zero = torch.zeros((), dtype=torch.int64, device=words.device)
    p_start = torch.cummax(torch.where(p_bound, iota, zero), 0).values
    peer_start = torch.cummax(torch.where(o_bound, iota, zero), 0).values
    ob_cum = torch.cumsum(o_bound.to(torch.int64), 0)
    end = torch.full((1,), n, dtype=torch.int64, device=words.device)

    def next_bound(flag):
        nb = torch.where(flag, iota, torch.full_like(iota, n))
        nxt = torch.flip(torch.cummin(torch.flip(nb, (0,)), 0).values, (0,))
        return torch.cat([nxt[1:], end]) - 1

    peer_end = next_bound(o_bound)
    part_last = next_bound(p_bound)
    gv = torch.cummax(torch.where(s_valid, iota, torch.full_like(iota, -1)),
                      0).values[part_last]
    p_end = torch.where(gv >= p_start, gv, torch.full_like(gv, -1))
    return p_start, peer_start, torch.minimum(peer_end, p_end), p_end, ob_cum


def window_bounds(words, n_part: int, float_words: tuple, s_valid):
    """K13a (csrc/window.cu): window_bounds_plain's outputs from the
    neighbour-compare flags and six block scans (four forward, two
    backward)."""
    if _on_cpu(words, s_valid):
        return window_bounds_plain(words, n_part, float_words, s_valid)
    if words.dtype != torch.int64 or words.dim() != 2 \
            or not words.is_contiguous():
        raise ValueError("words: want a contiguous [w, n] int64 tensor")
    w, n = words.shape
    _check(s_valid, "s_valid", (torch.bool,), n)
    if n < 1 or not 0 <= n_part < w or w > 64:
        raise ValueError(f"window_bounds: n={n}, n_part={n_part}, w={w}")
    mask = 0
    for r in float_words:
        mask |= 1 << r
    if mask >= 1 << 63:
        mask -= 1 << 64
    dev = words.device
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    tmp = torch.empty((3, n), dtype=torch.int64, device=dev)
    tiles = torch.empty(max((n + _WIN_TILE - 1) // _WIN_TILE, 1),
                        dtype=torch.int64, device=dev)
    outs = torch.empty((5, n), dtype=torch.int64, device=dev)
    rc = _lib().otbt_window_bounds(
        _ptr(words), w, n_part, mask, n, _ptr(s_valid), _ptr(flags),
        _ptr(tmp[0]), _ptr(tmp[1]), _ptr(tmp[2]), _ptr(tiles),
        *(_ptr(o) for o in outs), _stream())
    _ok(rc, "window_bounds")
    _count("window_bounds")
    return tuple(outs)


def _frame_plain(frame, iota, p_start, p_end, peer_start, peer_end_v):
    """Per-row inclusive [fs, fe] of a window_frame() code (reference
    _frame_bounds)."""
    mode, sbk, so, ebk, eo, has_order = frame
    if mode == 0:
        return (p_start, peer_end_v) if has_order else (p_start, p_end)
    if mode == 1:
        def rows_bound(kind, k):
            return (p_start, iota - k, iota, iota + k, p_end)[kind]
        return (torch.maximum(rows_bound(sbk, so), p_start),
                torch.minimum(rows_bound(ebk, eo), p_end))
    fs = p_start if sbk == WIN_BOUNDS["unbounded_preceding"] else peer_start
    fe = p_end if ebk == WIN_BOUNDS["unbounded_following"] else peer_end_v
    return fs, fe


def _minmax_plain(lo, hi, is_min: bool):
    return torch.minimum(lo, hi) if is_min else torch.maximum(lo, hi)


def window_frame_reduce_plain(func: str, bounds, frame, s_iota, s_valid,
                              a_s=None, anm_s=None, offset: int = 1,
                              dflt_s=None, dnull_s=None,
                              has_default: bool = False, scale: int = 0,
                              table=None):
    """One window function over sorted rows, scattered back to input
    order by s_iota.  bounds: window_bounds' outputs; frame: a
    window_frame() code (frame functions only); a_s: the sorted argument
    (int64 or float64) and anm_s its null mask; lag/lead take offset and
    (has_default) the sorted default dflt_s with its null mask dnull_s;
    avg divides by 10**scale; min/max read `table`, range_minmax's sparse
    table.  Returns (values, null mask or None), both in input order."""
    p_start, peer_start, peer_end_v, p_end, ob_cum = bounds
    n = s_iota.shape[0]
    dev = s_iota.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    nul = None
    if func == "row_number":
        res = iota - p_start + 1
    elif func == "rank":
        res = peer_start - p_start + 1
    elif func == "dense_rank":
        res = ob_cum - ob_cum[p_start] + 1
    elif func in ("lag", "lead"):
        src = iota - offset if func == "lag" else iota + offset
        srcc = torch.clamp(src, 0, n - 1)
        inside = (src >= 0) & (src < n) & (p_start[srcc] == p_start) \
            & s_valid[srcc]
        res = a_s[srcc]
        src_null = anm_s[srcc] if anm_s is not None else \
            torch.zeros(n, dtype=torch.bool, device=dev)
        if has_default:
            res = torch.where(inside, res, dflt_s)
            nul = inside & src_null
            if dnull_s is not None:
                nul = nul | (~inside & dnull_s)
        else:
            nul = ~inside | src_null
    else:
        contrib = s_valid if anm_s is None else (s_valid & ~anm_s)
        fs, fe = _frame_plain(frame, iota, p_start, p_end, peer_start,
                              peer_end_v)
        fsc = torch.clamp(fs, 0, n - 1)
        fec = torch.clamp(fe, 0, n - 1)
        empty = (fe < fs) | ~s_valid
        cvals = contrib.to(torch.int64)
        ccum = torch.cumsum(cvals, 0)
        rcount = torch.where(empty, torch.zeros_like(ccum),
                             ccum[fec] - (ccum - cvals)[fsc])
        if func == "count":
            res = rcount
        elif func in ("first_value", "last_value"):
            pos = fsc if func == "first_value" else fec
            res = a_s[pos]
            nul = empty if anm_s is None else (empty | anm_s[pos])
        elif func in ("min", "max"):
            levels = table.shape[0]
            length = torch.clamp(fec - fsc + 1, min=1)
            j = torch.clamp(63 - _clz64(length), 0, levels - 1)
            span = torch.ones_like(j) << j
            lo = table[j, fsc]
            hi = table[j, torch.clamp(fec - span + 1, min=0)]
            res = _minmax_plain(lo, hi, func == "min")
            nul = rcount == 0
        elif func == "sum" and not a_s.dtype.is_floating_point:
            # integer sums: one wrapping int64 prefix, exact in any order
            av = torch.where(contrib, a_s, torch.zeros((), dtype=a_s.dtype,
                                                       device=dev))
            scum = torch.cumsum(av, 0)
            res = torch.where(empty, torch.zeros((), dtype=av.dtype,
                                                 device=dev),
                              scum[fec] - (scum - av)[fsc])
            nul = rcount == 0
        elif func in ("sum", "avg"):
            rsum = _f64_frame_sum(a_s, contrib, p_start, fsc, fec, empty)
            if func == "avg":
                res = torch.where(
                    rcount > 0,
                    rsum / torch.clamp(rcount, min=1) / float(10 ** scale),
                    torch.zeros((), dtype=torch.float64, device=dev))
            else:
                res = rsum
            nul = rcount == 0
        else:
            raise ValueError(f"window function {func} unsupported")
    out = torch.empty_like(res).index_put_((s_iota,), res)
    if nul is not None:
        nul = torch.empty_like(nul).index_put_((s_iota,), nul)
    return out, nul


def _segmented_prefix(v, p_start):
    """Inclusive prefix sums of v restarted at every partition start (row
    i's partition starts at p_start[i]), by log-step doubling: step d
    adds the partial sum d rows up when that row is in the partition."""
    n = v.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=v.device)
    s = v
    d = 1
    while d < n:
        src = iota - d
        prev = s[torch.clamp(src, min=0)]
        s = torch.where(src >= p_start, prev + s, s)
        d <<= 1
    return s


def _f64_frame_sum(a_s, contrib, p_start, fsc, fec, empty):
    """Each frame's f64 sum of the contributing rows.  Only finite values
    enter the sum, a prefix restarted at each partition start (so a NaN,
    an infinity or a huge value in one partition leaves the others
    alone); an f64 argument also counts its NaN, +inf and -inf rows
    (integer prefixes): a frame with a NaN or with both infinities is
    NaN, one with one infinity that infinity.  Integer and decimal
    arguments (avg) are finite."""
    dev = a_s.device
    av = a_s.to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    fin = contrib & torch.isfinite(av)
    v = torch.where(fin, av, zero)
    incl = _segmented_prefix(v, p_start)
    rsum = torch.where(empty, zero, incl[fec] - (incl[fsc] - v[fsc]))
    if not a_s.dtype.is_floating_point:
        return rsum

    def frame_has(flag):
        c = torch.cumsum(flag.to(torch.int64), 0)
        return ~empty & (c[fec] - (c - flag.to(torch.int64))[fsc] > 0)
    nan = frame_has(contrib & torch.isnan(av))
    pinf = frame_has(contrib & (av == float("inf")))
    minf = frame_has(contrib & (av == float("-inf")))
    inf = torch.full((), float("inf"), dtype=torch.float64, device=dev)
    rsum = torch.where(pinf, inf, torch.where(minf, -inf, rsum))
    return torch.where(nan | (pinf & minf),
                       torch.full((), float("nan"), dtype=torch.float64,
                                  device=dev), rsum)


def _clz64(x):
    """Leading zero bits of positive int64 values."""
    bits = torch.zeros_like(x)
    for sh in (32, 16, 8, 4, 2, 1):
        big = (x >> sh) > 0
        bits = bits + torch.where(big, sh, 0)
        x = torch.where(big, x >> sh, x)
    return 63 - bits


def window_frame_reduce(func: str, bounds, frame, s_iota, s_valid,
                        a_s=None, anm_s=None, offset: int = 1,
                        dflt_s=None, dnull_s=None,
                        has_default: bool = False, scale: int = 0,
                        table=None):
    """K13b (csrc/window.cu): window_frame_reduce_plain's result.  A
    frame function is one memset and two launches: one single-pass scan
    writes the prefix count of the contributing rows (with an f64
    argument's NaN, +inf and -inf counts) and, for sum / avg, their
    prefix sum (f64 sums over the finite values, restarted at each
    partition start), then one kernel computes each row's frame, its
    function and the scatter to input order; the ranks, lag / lead and
    first / last value are the second launch alone."""
    opt = [t for t in (a_s, anm_s, dflt_s, dnull_s, table)
           if t is not None]
    if _on_cpu(s_iota, s_valid, *bounds, *opt):
        return window_frame_reduce_plain(func, bounds, frame, s_iota,
                                         s_valid, a_s, anm_s, offset,
                                         dflt_s, dnull_s, has_default,
                                         scale, table)
    code = WIN_FUNCS[func]
    n = s_iota.shape[0]
    _check(s_iota, "s_iota", (torch.int64,), n)
    _check(s_valid, "s_valid", (torch.bool,), n)
    for i, t in enumerate(bounds):
        _check(t, f"bounds[{i}]", (torch.int64,), n)
    for t, nm in ((a_s, "a_s"), (dflt_s, "dflt_s")):
        if t is not None:
            _check(t, nm, (torch.int64, torch.float64), n)
    for t, nm in ((anm_s, "anm_s"), (dnull_s, "dnull_s")):
        if t is not None:
            _check(t, nm, (torch.bool,), n)
    ranks = func in ("row_number", "rank", "dense_rank")
    if a_s is None and func not in ("count",) and not ranks:
        raise ValueError(f"window_frame_reduce: {func} needs an argument")
    if has_default and (dflt_s is None or dflt_s.dtype != a_s.dtype):
        raise ValueError("window_frame_reduce: default must match a_s")
    levels = 0
    if func in ("min", "max"):
        if table is None or table.dim() != 2 or table.shape[1] != n \
                or table.dtype != a_s.dtype or not table.is_contiguous():
            raise ValueError("window_frame_reduce: bad sparse table")
        levels = table.shape[0]
    fr = frame if frame is not None else (0, 0, 0, 0, 0, 0)
    a_float = int(a_s is not None and a_s.dtype == torch.float64)
    if ranks or func == "count":
        out_dtype = torch.int64
    elif func == "avg":
        out_dtype = torch.float64
    else:
        out_dtype = a_s.dtype
    dev = s_iota.device
    out = torch.empty(n, dtype=out_dtype, device=dev)
    out_null = None if ranks or func == "count" else \
        torch.empty(n, dtype=torch.bool, device=dev)
    if n >= (1 << 31) - 1:
        raise ValueError(f"window_frame_reduce: {n} rows (the count "
                         "prefix is int32)")
    lib = _lib()
    sbytes = lib.otbt_window_scratch_bytes(n, code, a_float)
    scratch = torch.empty(sbytes, dtype=torch.uint8, device=dev) \
        if sbytes else None

    def p(t):
        return None if t is None else _ptr(t)

    rc = lib.otbt_window_frame_reduce(
        code, n, *(_ptr(t) for t in bounds), _ptr(s_iota), _ptr(s_valid),
        p(a_s), a_float, p(anm_s), int(offset), p(dflt_s), p(dnull_s),
        int(bool(has_default)), float(10 ** scale), p(table), levels,
        *(int(x) for x in fr), p(scratch), sbytes, _ptr(out),
        p(out_null), _stream())
    _ok(rc, "window_frame_reduce")
    _count("window_frame_reduce")
    return out, out_null


def _minmax_neutral(dtype, is_min: bool):
    if dtype == torch.float64:
        return float("inf") if is_min else float("-inf")
    return INT64_MAX if is_min else INT64_MIN


def range_minmax_plain(a_s, contrib, is_min: bool):
    """The reference's log-doubling sparse table, [floor(log2 n) + 1, n]:
    level 0 is a_s with non-contributing rows at the neutral element,
    level j + 1 the min (max) of level j at i and i + 2^j."""
    n = a_s.shape[0]
    neutral = torch.full((), _minmax_neutral(a_s.dtype, is_min),
                         dtype=a_s.dtype, device=a_s.device)
    levels = [torch.where(contrib, a_s, neutral)]
    j = 0
    while (1 << (j + 1)) <= n:
        half = 1 << j
        prev = levels[-1]
        shifted = torch.cat([prev[half:], neutral.expand(half)])
        levels.append(_minmax_plain(prev, shifted, is_min))
        j += 1
    return torch.stack(levels)


def range_minmax(a_s, contrib, is_min: bool):
    """K13c (csrc/window.cu): range_minmax_plain's table, one launch per
    level; window_frame_reduce's min/max query it."""
    if _on_cpu(a_s, contrib):
        return range_minmax_plain(a_s, contrib, is_min)
    n = a_s.shape[0]
    _check(a_s, "a_s", (torch.int64, torch.float64), n)
    _check(contrib, "contrib", (torch.bool,), n)
    if n < 1:
        raise ValueError("range_minmax: no rows")
    levels = n.bit_length()
    table = torch.empty((levels, n), dtype=a_s.dtype, device=a_s.device)
    rc = _lib().otbt_range_minmax(_ptr(a_s), int(a_s.dtype == torch.float64),
                                  _ptr(contrib), n, levels, int(is_min),
                                  _ptr(table), _stream())
    _ok(rc, "range_minmax")
    _count("range_minmax")
    return table
