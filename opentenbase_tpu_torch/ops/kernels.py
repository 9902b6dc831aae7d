"""Device kernels of the scan / aggregate / sort path, hand-written in CUDA.

The counterpart of opentenbase_tpu/ops/kernels.py.  Each kernel here has
three parts:

- a CUDA C++ kernel in ../csrc/ (built for sm_90a by ops/build.py and
  called through ctypes), whose source notes which reference kernel it
  replaces, what bounds it on an H100 and how its design answers that;
- a wrapper with the reference's signature, which checks device, dtype,
  shape and contiguity, allocates the outputs, launches on PyTorch's
  current stream, raises on a nonzero CUDA status, and adds one to
  LAUNCHES[name] per launch;
- a plain PyTorch version (`*_plain`) of the same function.  The wrapper
  takes it only for tensors that lie on the CPU (the tests run there);
  for a CUDA tensor it launches the kernel or raises.

Padded batches: every kernel takes whole padded columns; padding rows
are masked by the caller's validity mask.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.dtypes import device_float

INT64_MAX = (1 << 63) - 1

#: kernel name -> launches since the last reset_launches()
LAUNCHES = {"visibility_mask": 0, "decode_column": 0, "cmp_on_codes": 0,
            "grouped_agg_dense": 0, "sort_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from .build import lib
    return lib()


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
    return torch.cuda.current_stream().cuda_stream


def _ok(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: error {rc}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


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
    or own delete)."""
    cols = (xmin_ts, xmax_ts, xmin_txid, xmax_txid)
    snap_ts, my_txid, aborted_ts = int(snap_ts), int(my_txid), \
        int(aborted_ts)
    if _on_cpu(*cols):
        return visibility_mask_plain(*cols, snap_ts, my_txid, aborted_ts)
    n = xmin_ts.shape[0]
    for nm, t in zip(("xmin_ts", "xmax_ts", "xmin_txid", "xmax_txid"), cols):
        _check(t, nm, (torch.int64,), n)
    out = torch.empty(n, dtype=torch.bool, device=xmin_ts.device)
    rc = _lib().otbt_visibility_mask(
        *(_ptr(t) for t in cols), snap_ts, my_txid, aborted_ts, _ptr(out),
        n, _stream())
    _ok(rc, "visibility_mask")
    LAUNCHES["visibility_mask"] += 1
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
    LAUNCHES["decode_column"] += 1
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
    LAUNCHES["cmp_on_codes"] += 1
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
    empty group's min/max is the dtype's max/min."""
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
    outs, present = [], None
    for lo in range(0, max(len(agg_kinds), 1), _MAX_AGGS):
        kinds = agg_kinds[lo:lo + _MAX_AGGS]
        ins = agg_inputs[lo:lo + _MAX_AGGS]
        codes = [_agg_code(k, v.dtype) for k, v in zip(kinds, ins)]
        k = len(kinds)
        # the workspace starts at each accumulator's identity: 0 for the
        # sums, counts and present row, dtype max/min for min/max rows;
        # set on the card so the query path makes no host copy
        ws = torch.zeros((k + 1, num_groups), dtype=torch.int64,
                         device=group_id.device)
        for a, (_c, idv) in enumerate(codes):
            if idv:
                ws[a].fill_(idv)
        ws = ws.reshape(-1)
        rc = _lib().otbt_grouped_agg_dense(
            _ptr(group_id), _ptr(valid), n, num_groups, k,
            (ctypes.c_longlong * max(k, 1))(*(_ptr(v) for v in ins)),
            (ctypes.c_int * max(k, 1))(*(c for c, _ in codes)),
            (ctypes.c_int * max(k, 1))(*(_DT[v.dtype] for v in ins)),
            (ctypes.c_longlong * max(k, 1))(*(i for _, i in codes)),
            _ptr(ws), _stream())
        _ok(rc, "grouped_agg_dense")
        LAUNCHES["grouped_agg_dense"] += 1
        ws = ws.view(k + 1, num_groups)
        for a, ((code, _i), v) in enumerate(zip(codes, ins)):
            row = ws[a]
            if code == _K_SUM_FLOAT or (code in (_K_MIN, _K_MAX)
                                        and _is_float(v.dtype)):
                row = row.view(torch.float64)
            if code in (_K_MIN, _K_MAX) and row.dtype != v.dtype:
                row = row.to(v.dtype)
            outs.append(row)
        if present is None:
            present = ws[k]
    return tuple(outs), present


# ---------------------------------------------------------------------------
# K10 sort (reference: ops/kernels.py:488 sort_rows, :476 _order_key)
# ---------------------------------------------------------------------------

def _float_word(x: torch.Tensor, desc: bool) -> torch.Tensor:
    """Order-preserving int64 image of a float key: DESC negates, -0.0
    becomes 0.0 and every NaN becomes +NaN, so NaNs sort last either
    way (the reference's lax.sort canonicalisation)."""
    x = x.to(torch.float64)
    if desc:
        x = -x
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device),
                    x)
    x = torch.where(torch.isnan(x), torch.full((), float("nan"),
                                               dtype=x.dtype,
                                               device=x.device), x)
    b = x.view(torch.int64)
    return torch.where(b >= 0, b, b ^ INT64_MAX)


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


def sort_perm(words: torch.Tensor) -> torch.Tensor:
    """Sorted row order of `order_words` output: the bitonic kernel on
    the card, sort_perm_plain on the CPU."""
    if _on_cpu(words):
        return sort_perm_plain(words)
    if words.dtype != torch.int64 or words.dim() != 2 \
            or not words.is_contiguous():
        raise ValueError("words: want a contiguous [w, n] int64 tensor")
    w, n = words.shape
    m = 1
    while m < n:
        m <<= 1
    perm = torch.empty(m, dtype=torch.int64, device=words.device)
    rc = _lib().otbt_sort_perm(_ptr(words), w, n, _ptr(perm), m, _stream())
    _ok(rc, "sort_rows")
    LAUNCHES["sort_rows"] += 1
    return perm[:n]


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
