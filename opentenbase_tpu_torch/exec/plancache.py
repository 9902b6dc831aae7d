"""Program cache: captured fragment programs and reusable plans.

The counterpart of opentenbase_tpu/exec/plancache.py for the two tiers the
port has:

- ProgramCache: a bounded LRU keyed by canonical fragment signature
  (literal-masked plan structure + per-table components + join factors +
  batch class; exec/fused.py builds the keys).  The FUSED tier holds the
  whole-fragment programs of exec/fused.py.  On the card each program
  owns a captured CUDA graph and that graph's private memory pool, so the
  tier's live budget counts pool bytes (FUSED_POOL_BUDGET), where the
  reference counted live XLA executables.  Eviction releases the graph
  and its pool.  "compiles" counts captures.
- get_or_build: the exact-statement plan cache (the CachedPlanSource
  generic-plan arm) behind Session._plan_select, feeding the PLAN tier's
  hit and miss counters.

The reference's persistent XLA compilation cache, AOT warm-up thread and
retrace census have no counterpart: a CUDA graph is captured in the
process that replays it, so there is nothing to persist or warm ahead.
"""

from __future__ import annotations

import itertools
import time

from ..sql.fingerprint import fingerprint
from ..utils import locks

_LOCK = locks.RLock("exec.plancache._LOCK")
_SEQ = itertools.count()

#: bytes of captured-graph memory pools the FUSED tier may hold live
FUSED_POOL_BUDGET = 24 << 30


def _pool_bytes(value) -> int:
    return int(getattr(value, "pool_bytes", 0) or 0)


def _release(value) -> None:
    rel = getattr(value, "release", None)
    if rel is not None:
        rel()


class ProgramCache:
    """Bounded LRU keyed by canonical fragment signature.  With a
    `pool_budget` it holds captured programs and bounds their pool bytes
    too; the plan tier only feeds its counters."""

    def __init__(self, name: str, max_entries: int,
                 pool_budget: int | None = None):
        self.name = name
        self.max_entries = max_entries
        self.pool_budget = pool_budget
        self._d: dict = {}            # key -> [seq, value]
        self.hits = 0
        self.misses = 0
        self.compiles = 0             # captures (programs) / builds
        self.compile_ms = 0.0
        self.evictions = 0

    # -- lookup / insert ------------------------------------------------
    def get(self, key):
        with _LOCK:
            ent = self._d.get(key)
            if ent is None:
                self.misses += 1
                return None
            ent[0] = next(_SEQ)
            self.hits += 1
            return ent[1]

    def put(self, key, value):
        with _LOCK:
            try:
                self._d[key] = [next(_SEQ), value]
            except TypeError:
                return value          # unhashable key: just don't cache
            while len(self._d) > self.max_entries:
                self._evict_lru()
        self.trim()
        return value

    def pop(self, key):
        with _LOCK:
            ent = self._d.pop(key, None)
        if ent is not None:
            _release(ent[1])

    # -- accounting -----------------------------------------------------
    def record_capture(self, t0: float):
        """One program captured, `t0` the perf_counter at its start;
        re-checks the pool budget (the new graph's pool now counts)."""
        with _LOCK:
            self.compiles += 1
            self.compile_ms += (time.perf_counter() - t0) * 1e3
        self.trim()

    def live(self) -> int:
        """Captured programs currently held."""
        with _LOCK:
            return sum(1 for _s, v in self._d.values()
                       if getattr(v, "captured", False))

    def pool_bytes(self) -> int:
        with _LOCK:
            return sum(_pool_bytes(v) for _s, v in self._d.values())

    # -- eviction -------------------------------------------------------
    def _evict_lru(self):
        # caller holds _LOCK
        if not self._d:
            return
        key = min(self._d, key=lambda k: self._d[k][0])
        _s, value = self._d.pop(key)
        self.evictions += 1
        _release(value)

    def trim(self):
        """Evict least-recently used programs until their pools fit the
        budget (the newest entry always stays)."""
        if self.pool_budget is None:
            return
        with _LOCK:
            while len(self._d) > 1 and \
                    sum(_pool_bytes(v) for _s, v in self._d.values()) \
                    > self.pool_budget:
                self._evict_lru()


FUSED = ProgramCache("fused", max_entries=192,
                     pool_budget=FUSED_POOL_BUDGET)
PLAN = ProgramCache("plan", max_entries=256)


# ---------------------------------------------------------------------------
# exact-statement plan cache (the CachedPlanSource generic-plan arm)
# ---------------------------------------------------------------------------
_MAX = 256


def get_or_build(holder, attr: str, stmt, gen, build):
    """Return the cached object for (stmt, gen) on `holder.attr`, or
    build, insert and return it.  Keyed by the exact statement (literals
    included, sql/fingerprint.py unmasked mode) plus a generation tuple
    covering DDL.  Feeds the PLAN tier's hit and miss counters."""
    cache = getattr(holder, attr, None)
    if cache is None:
        cache = {}
        setattr(holder, attr, cache)
    try:
        fp = fingerprint(stmt, mask_literals=False)
    except Exception:
        return build()
    hit = cache.get(fp)
    if hit is not None and hit[0] == gen:
        with _LOCK:
            PLAN.hits += 1
        return hit[1]
    with _LOCK:
        PLAN.misses += 1
    obj = build()
    if obj is None:
        return obj
    try:
        cache[fp] = (gen, obj)
        while len(cache) > _MAX:
            cache.pop(next(iter(cache)))
    except (KeyError, RuntimeError):
        pass      # concurrent evictors raced; the cache stays bounded
    return obj
