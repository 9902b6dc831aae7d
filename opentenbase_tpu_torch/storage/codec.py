"""Columnar codecs: compressed device residency for staged columns.

A copy of the reference's host encode side.  Every staged device
tensor carries the narrowest integer representation its values provably
fit, and the executor computes on the codes: decode and compare-on-codes
are one elementwise CUDA kernel (ops/kernels.py decode_column /
cmp_on_codes), so a filter-only column is never widened in device
memory.

Three codec families, chosen per column at stage time from the actual
values:

- pack (uint8/16/32): direct downcast, proven 0 <= v <= 2^w - 1.
  Zero-padding decodes to 0 exactly (matches raw staging).
- for (frame-of-reference, uint8/16/32): code = v - lo + 1 with the
  reference `lo` from the proven min.  Code 0 is RESERVED as the
  padding sentinel so zero-padded rows decode to exactly 0 — MVCC
  visibility (ops/kernels.py visibility_mask) depends on padded
  __xmax_ts staying 0.  The reference rides the staged dict as a
  shape-(1,) aux tensor (`__enc.for.<col>`, value lo - 1).
- dict (uint8/16): append-only dictionary for low-cardinality ints.
  Codes are index + 1; slot 0 of the LUT is the 0 sentinel for
  padding.  The LUT is a pow2-capacity aux tensor (`__enc.dict.<col>`).

The per-(table, column) descriptor ladder is process-global so every
holder of a table encodes with one descriptor.  A value outside the
proven range re-chooses the descriptor (monotone widening).  The ladder
follows the reference's choices step for step, so both packages stage
each column in the same family and width (tests/test_torch_slice.py
holds them equal); it lives in this module only, so a process holding
both packages shares no codec state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import locks
from .batch import lut_capacity

#: staged-namespace prefix for codec aux arrays: FOR references and
#: dictionary LUTs ride the staged dict beside the code columns.
ENC_PREFIX = "__enc."

_STATE_LOCK = locks.RLock("storage.codec._STATE_LOCK")
_WIDTHS = (8, 16, 32)
_DICT_SAMPLE = 1 << 16    # probe rows before an exact unique() pass
_DICT_MAX_CARD = 1 << 12  # beyond this, dictionary residency stops paying


@dataclasses.dataclass(frozen=True)
class Enc:
    """One column's encoding descriptor.  family/width/cap choose the
    code layout (codec_class); `lo` and the dictionary values are data,
    shipped to the card in the aux arrays."""
    family: str   # "pack" | "for" | "dict"
    width: int    # 8 | 16 | 32 — code dtype is uint{width}
    orig: str     # original staged dtype str ("int64", "int32", ...)
    lo: int = 0   # for: reference (code = v - lo + 1; 0 = padding)
    cap: int = 0  # dict: pow2 LUT capacity incl the sentinel slot

    @property
    def code_dtype(self):
        return np.dtype(f"uint{self.width}")


class _ColState:
    """Ladder entry for one (table, column): the descriptor plus append-only dictionary state.  guarded_by: _STATE_LOCK"""
    __slots__ = ("enc", "values", "index")

    def __init__(self, enc, values=None):
        self.enc = enc                    # Enc | None (None = raw pin)
        self.values = list(values or [])  # dict family: code-1 -> value
        self.index = {v: i + 1 for i, v in enumerate(self.values)}


#: (table, col) -> _ColState
_LADDER: dict = {}     # guarded_by: _STATE_LOCK


def eligible(name: str, h) -> bool:
    """Encodable staged arrays: 1-D integers wider than a byte — value
    columns, MVCC sys columns, TEXT dict codes.  Null masks (bool),
    floats and vector payloads stage raw."""
    return (not name.startswith(ENC_PREFIX)
            and h.ndim == 1 and h.dtype.kind in "iu"
            and h.dtype.itemsize > 1)


# -- codec class ---------------------------------------------------------
def codec_class(enc) -> str:
    """A column's codec-class token: family + width, plus the pow2 LUT
    capacity for dictionaries (the aux array's shape).  It names the
    layout the decode kernel reads, and is what the parity test holds
    equal to the reference's choice."""
    if enc is None:
        return "raw"
    if enc.family == "dict":
        return f"dict{enc.width}/{enc.cap}"
    return f"{enc.family}{enc.width}"


def invalidate_ladder(table: str) -> None:
    """Drop a table's ladder entries (the DDL-drop invalidation edge:
    a re-created table must re-learn its descriptors, not inherit the
    dead table's value distribution)."""
    with _STATE_LOCK:
        for key in [k for k in _LADDER if k[0] == table]:
            del _LADDER[key]


# -- descriptor choice / validation -------------------------------------
def _range_width(span: int):
    """Narrowest enum width whose code space holds `span` values plus
    the padding sentinel."""
    for w in _WIDTHS:
        if span <= (1 << w) - 2:
            return w
    return None


def _choose_locked(h, prev=None) -> _ColState:
    """Choose a descriptor from the actual values.  `prev` is the
    outgrown state, if any — an outgrown DICTIONARY extends its
    append-only value list into a larger capacity (codes already
    resident elsewhere stay valid) instead of rebuilding."""
    orig = str(h.dtype)
    if h.size == 0:
        # nothing provable yet: stage raw WITHOUT pinning, so the
        # first real load still gets to choose
        return _ColState(None)
    vmin, vmax = int(h.min()), int(h.max())
    itemsize = h.dtype.itemsize

    if prev is not None and prev.enc is not None \
            and prev.enc.family == "dict":
        u = np.unique(h)
        new = [int(v) for v in u if int(v) not in prev.index]
        nvals = len(prev.values) + len(new)
        if nvals <= _DICT_MAX_CARD:
            cap, width = _dict_geometry(nvals)
            if width is not None and width // 8 < itemsize:
                st = _ColState(
                    Enc("dict", width, orig, cap=cap), prev.values)
                for v in new:
                    st.index[v] = len(st.values) + 1
                    st.values.append(v)
                return st

    pack_w = _range_width(vmax) if vmin >= 0 else None
    for_w = None
    if vmin > np.iinfo(h.dtype).min:  # lo - 1 must be representable
        for_w = _range_width(vmax - vmin)
        if for_w is not None and vmin >= (1 << 40):
            # wall-clock-scale reference (MVCC timestamps): appends
            # drift forward forever, so a width proven on today's span
            # would promote on every batch — start at 32 bits (still
            # 2x narrower than the int64 original)
            for_w = max(for_w, 32)
    best = None
    for fam, w in (("pack", pack_w), ("for", for_w)):
        if w is not None and w // 8 < itemsize \
                and (best is None or w < best[1]):
            best = (fam, w)

    if best is None or best[1] > 8:
        st = _dict_choose(h, itemsize, orig,
                          best[1] if best else 8 * itemsize)
        if st is not None:
            return st
    if best is None:
        return _ColState(None)
    fam, w = best
    lo = vmin if fam == "for" else 0
    return _ColState(Enc(fam, w, orig, lo=lo))


def _dict_geometry(nvals: int):
    """(cap, width) for a dictionary of `nvals` values: pow2 capacity
    with headroom, clamped to the width's code space."""
    width = 8 if nvals + 1 <= (1 << 8) else 16
    if nvals + 1 > (1 << 16):
        return 0, None
    cap = min(lut_capacity(nvals + 1 + (nvals >> 2) + 1), 1 << width)
    return cap, width


def _dict_choose(h, itemsize: int, orig: str, beat_width: int):
    """Try the dictionary family: cheap sample probe first, exact
    unique() only when the sample looks low-cardinality."""
    sample = h if h.size <= _DICT_SAMPLE \
        else h[::max(1, h.size // _DICT_SAMPLE)]
    if np.unique(sample).size > _DICT_MAX_CARD:
        return None
    u = np.unique(h)
    if u.size > _DICT_MAX_CARD:
        return None
    cap, width = _dict_geometry(int(u.size))
    if width is None or width >= beat_width or width // 8 >= itemsize:
        return None
    return _ColState(Enc("dict", width, orig, cap=cap),
                     [int(v) for v in u])


# -- encode --------------------------------------------------------------
def _encode_locked(st: _ColState, h):
    """Encode under the existing descriptor, or None on a range/dtype
    violation.  Dictionary encode extends the append-only LUT within
    capacity (the caller re-uploads the aux array afterwards)."""
    enc = st.enc
    if str(h.dtype) != enc.orig:
        return None
    if h.size == 0:
        return np.zeros(0, enc.code_dtype)
    vmin, vmax = int(h.min()), int(h.max())
    if enc.family == "pack":
        if vmin < 0 or vmax > (1 << enc.width) - 1:
            return None
        return h.astype(enc.code_dtype)
    if enc.family == "for":
        if vmin < enc.lo or vmax - enc.lo > (1 << enc.width) - 2:
            return None
        return (h.astype(np.int64)
                - np.int64(enc.lo - 1)).astype(enc.code_dtype)
    u, inv = np.unique(h, return_inverse=True)
    new = [int(v) for v in u if int(v) not in st.index]
    if len(st.values) + len(new) + 1 > enc.cap:
        return None
    for v in new:
        st.index[v] = len(st.values) + 1
        st.values.append(v)
    ucodes = np.asarray([st.index[int(v)] for v in u],
                        dtype=enc.code_dtype)
    return ucodes[np.asarray(inv)]


def encode_staged(table: str, name: str, h):
    """Validate-or-choose the ladder's descriptor for this column
    against the full staged values and encode.  Returns
    (codes, enc, aux_host) or None to stage raw.  A misfit (an append
    drifted out of the proven range) re-chooses the descriptor, widening
    monotonically."""
    if not eligible(name, h):
        return None
    h = np.ascontiguousarray(h)
    with _STATE_LOCK:
        key = (table, name)
        st = _LADDER.get(key)
        if st is not None and st.enc is None:
            return None               # proven-raw pin: stays raw
        codes = _encode_locked(st, h) if st is not None else None
        if codes is None:
            st = _choose_locked(h, prev=st)
            _LADDER[key] = st
            if st.enc is None:
                return None
            codes = _encode_locked(st, h)
            assert codes is not None, (table, name, st.enc)
        return codes, st.enc, _aux_locked(st)


# -- aux arrays ----------------------------------------------------------
def aux_name(name: str, enc: Enc) -> str:
    """Staged-dict key of a column's aux array; the FAMILY rides the
    name so a staged dict is self-describing (enc_names)."""
    return f"{ENC_PREFIX}{enc.family}.{name}"


def _aux_locked(st: _ColState) -> np.ndarray:
    enc = st.enc
    od = np.dtype(enc.orig)
    if enc.family == "pack":
        # dtype marker only: decode target dtype = aux dtype
        return np.zeros(1, od)
    if enc.family == "for":
        return np.asarray([enc.lo - 1], od)
    lut = np.zeros(enc.cap, od)
    if st.values:
        lut[1:1 + len(st.values)] = np.asarray(st.values, od)
    return lut


# -- staged-dict introspection ------------------------------------------
def enc_names(arrs: dict) -> dict:
    """{col: aux_key} for every encoded column of a staged dict."""
    out = {}
    for k in arrs:
        if k.startswith(ENC_PREFIX):
            _fam, col = k[len(ENC_PREFIX):].split(".", 1)
            out[col] = k
    return out


def family_of(aux_key: str) -> str:
    return aux_key[len(ENC_PREFIX):].split(".", 1)[0]


def padded_of(arrs: dict) -> int:
    """Padded row count of a staged dict, skipping aux arrays (aux
    shapes are (1,) / (cap,), not the padded row geometry)."""
    for k, a in arrs.items():
        if not k.startswith(ENC_PREFIX):
            return int(a.shape[0])
    return 0

