"""Locator — maps rows/values to shards and datanodes.

Reference analog: src/backend/pgxc/locator/locator.c (`GetRelationNodes`
locator.c:2148, per-type routing :111-158) + the shard map evaluation
`EvaluateShardId` (pgxc/shard/shardmap.c:2231).  The TPU-first difference:
routing is *vectorized* — one hash over whole column batches (feeding the
device-side `all_to_all` bucketing) instead of the reference's per-tuple
`GetDataRouting` loop (executor/execFragment.c:2360,2404).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..catalog.catalog import Catalog
from ..catalog.schema import DistType, NUM_SHARDS, TableDef
from ..catalog.types import TypeKind
from ..utils.hashing import hash_columns_np, hash_string


def shard_of_hash(h: np.ndarray) -> np.ndarray:
    """uint64 hash -> shard id in [0, 4096)."""
    return (h % np.uint64(NUM_SHARDS)).astype(np.int32)


def _canon_bulk(col, arr: np.ndarray) -> np.ndarray:
    """Canonical uint64 hash input for one dist-key column of raw
    values.  The SAME canonical form is used by FQS point routing
    (_canon_point), so `where key = literal` pins to the node the
    insert path chose: TEXT -> string hash; DECIMAL -> scaled int at
    the COLUMN scale (the storage representation); DATE -> epoch days;
    FLOAT -> zero-normalized bit pattern; ints -> int64."""
    k = col.type.kind
    if k == TypeKind.TEXT:
        if arr.dtype.kind not in "UO":
            raise ValueError(
                f"TEXT distribution key {col.name!r} must be routed on "
                f"raw strings, not dictionary codes (dtype {arr.dtype})")
        return np.asarray([hash_string(str(s)) for s in arr],
                          dtype=np.uint64)
    if k == TypeKind.DECIMAL:
        from ..catalog.types import decimal_to_int
        from ..storage.loader import _PreScaled
        if isinstance(arr, _PreScaled):
            # bulk-loader columns arrive already in storage scale
            return np.asarray(arr).astype(np.int64).view(np.uint64)
        if arr.dtype.kind in "iu":
            return (arr.astype(np.int64)
                    * np.int64(10 ** col.type.scale)).view(np.uint64)
        if arr.dtype.kind == "f":
            return np.round(arr * 10 ** col.type.scale).astype(
                np.int64).view(np.uint64)
        return np.asarray([decimal_to_int(str(v), col.type.scale)
                           for v in arr], dtype=np.int64).view(np.uint64)
    if k == TypeKind.DATE and arr.dtype.kind in "UO":
        from ..catalog.types import date_to_days
        return np.asarray([date_to_days(str(v)) for v in arr],
                          dtype=np.int64).view(np.uint64)
    if k == TypeKind.FLOAT64:
        f = np.asarray([float(x) for x in arr], dtype=np.float64)
        f = np.where(f == 0.0, 0.0, f)  # -0.0 == +0.0
        return f.view(np.uint64)
    return arr.astype(np.int64).view(np.uint64)


def _canon_point(col, v) -> Optional[np.ndarray]:
    """Canonical uint64 (len-1) for one FQS literal — accepts raw python
    values or binder literals (E.Lit, whose DECIMAL values are already
    scaled at the LITERAL's scale).  None = the value cannot exist at
    the column's scale (the query matches nothing on this node set)."""
    from ..plan import exprs as E
    k = col.type.kind
    lit_t = None
    if isinstance(v, E.Lit):
        lit_t, v = v.lit_type, v.value
    if k == TypeKind.TEXT:
        return np.asarray([hash_string(str(v))], dtype=np.uint64)
    if k == TypeKind.DECIMAL:
        cs = col.type.scale
        if lit_t is not None and lit_t.kind == TypeKind.DECIMAL:
            diff = cs - lit_t.scale
            if diff >= 0:
                sv = int(v) * 10 ** diff
            elif int(v) % 10 ** (-diff) == 0:
                sv = int(v) // 10 ** (-diff)
            else:
                return None  # finer than the column can store
        elif isinstance(v, (int, np.integer)):
            sv = int(v) * 10 ** cs
        else:
            from ..catalog.types import decimal_to_int
            sv = decimal_to_int(str(v), cs)
        return np.asarray([sv], dtype=np.int64).view(np.uint64)
    if k == TypeKind.DATE and isinstance(v, str):
        from ..catalog.types import date_to_days
        v = date_to_days(v)
    if k == TypeKind.FLOAT64:
        if lit_t is not None and lit_t.kind == TypeKind.DECIMAL:
            v = int(v) / 10 ** lit_t.scale
        f = np.asarray([float(v)], dtype=np.float64)
        f = np.where(f == 0.0, 0.0, f)
        return f.view(np.uint64)
    return np.asarray([int(v)], dtype=np.int64).view(np.uint64)


def _dist_key_arrays(td: TableDef,
                     columns: dict[str, np.ndarray]) -> list[np.ndarray]:
    """Normalize distribution-key columns to uint64 hash inputs (see
    _canon_bulk for the canonical forms).  asanyarray keeps the
    loader's _PreScaled marker subclass intact."""
    return [_canon_bulk(td.column(name), np.asanyarray(columns[name]))
            for name in td.distribution.dist_cols]


def shard_ids_for_columns(cols: Sequence[np.ndarray]) -> np.ndarray:
    return shard_of_hash(hash_columns_np(list(cols)))


class Locator:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self._rr_counter: dict[str, int] = {}

    def n_datanodes(self) -> int:
        return max(1, len(self.catalog.datanodes()))

    # ------------------------------------------------------------------
    # batch routing (write path / redistribution)
    # ------------------------------------------------------------------
    def route_rows(self, td: TableDef, columns: dict[str, np.ndarray],
                   nrows: int) -> np.ndarray:
        """Return per-row datanode index (int32 array of len nrows).

        For REPLICATED tables every node stores every row; callers handle
        that case (we return all-zeros and they fan out).
        """
        ndn = self.n_datanodes()
        dt = td.distribution.dist_type
        if dt == DistType.REPLICATED or dt == DistType.SINGLE:
            return np.zeros(nrows, dtype=np.int32)
        if dt == DistType.ROUNDROBIN:
            start = self._rr_counter.get(td.name, 0)
            idx = (np.arange(start, start + nrows) % ndn).astype(np.int32)
            self._rr_counter[td.name] = (start + nrows) % ndn
            return idx
        if dt == DistType.MODULO:
            key = np.asarray(columns[td.distribution.dist_cols[0]])
            return (key.astype(np.int64) % ndn).astype(np.int32)
        if dt == DistType.RANGE:
            col = td.column(td.distribution.dist_cols[0])
            vals = _canon_bulk(col, np.asanyarray(
                columns[td.distribution.dist_cols[0]])).view(np.int64)
            bounds = np.asarray(td.distribution.range_bounds,
                                np.int64)
            return np.minimum(np.searchsorted(bounds, vals,
                                              side="right"),
                              ndn - 1).astype(np.int32)
        keys = _dist_key_arrays(td, columns)
        if dt == DistType.HASH:
            return (hash_columns_np(keys) % np.uint64(ndn)).astype(np.int32)
        if dt == DistType.SHARD:
            sid = shard_ids_for_columns(keys)
            return np.asarray(self.catalog.shard_map_for_group(
                td.distribution.group))[sid]
        raise ValueError(f"unroutable distribution {dt}")

    def shard_ids_for_rows(self, td: TableDef,
                           columns: dict[str, np.ndarray]) -> Optional[np.ndarray]:
        """Per-row shard id (stored with every tuple, like the reference's
        HeapTupleHeader t_shardid, include/access/htup_details.h:191)."""
        if td.distribution.dist_type != DistType.SHARD:
            return None
        return shard_ids_for_columns(_dist_key_arrays(td, columns))

    # ------------------------------------------------------------------
    # point routing (FQS: single-shard queries)
    # ------------------------------------------------------------------
    def node_for_values(self, td: TableDef, values: Sequence) -> Optional[int]:
        """Datanode index answering dist-key = literal, or None if the
        query cannot be pinned to one node (the FQS shippability test,
        reference optimizer/util/pgxcship.c:2431)."""
        dt = td.distribution.dist_type
        ndn = self.n_datanodes()
        if dt in (DistType.REPLICATED, DistType.SINGLE):
            return 0  # any node; preferred-node = 0 (locator.c:178)
        if dt == DistType.ROUNDROBIN:
            return None
        arrs = []
        for v, colname in zip(values, td.distribution.dist_cols):
            a = _canon_point(td.column(colname), v)
            if a is None:
                return None  # literal unrepresentable: not pinnable
            arrs.append(a)
        if dt == DistType.MODULO:
            return int(arrs[0].view(np.int64)[0] % ndn)
        if dt == DistType.HASH:
            return int(hash_columns_np(arrs)[0] % np.uint64(ndn))
        if dt == DistType.SHARD:
            sid = int(shard_of_hash(hash_columns_np(arrs))[0])
            return int(np.asarray(self.catalog.shard_map_for_group(
                td.distribution.group))[sid])
        if dt == DistType.RANGE:
            v = int(arrs[0].view(np.int64)[0])
            bounds = list(td.distribution.range_bounds)
            import bisect
            return min(bisect.bisect_right(bounds, v), ndn - 1)
        return None

    def nodes_for_table(self, td: TableDef) -> list[int]:
        """All datanode indexes holding any data of this table."""
        ndn = self.n_datanodes()
        dt = td.distribution.dist_type
        if dt == DistType.SINGLE:
            return [0]
        if dt == DistType.REPLICATED:
            return list(range(ndn))
        if dt == DistType.SHARD:
            m = self.catalog.shard_map_for_group(td.distribution.group)
            return sorted(set(int(x) for x in np.unique(m)))
        return list(range(ndn))
