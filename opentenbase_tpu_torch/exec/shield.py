"""Fault isolation for the serving tier: what exec/scheduler.py calls.

The counterpart of the parts of opentenbase_tpu/exec/shield.py the
scheduler reaches:

- repeat-offender quarantine: a coalesced batch is one program, so one
  bad query would fail every member; the scheduler bisects a failed batch
  (Scheduler._isolate) and records the failure here, and a signature that
  keeps failing batches is barred from coalescing for a cooldown
  (note_batch_failure, quarantined);
- fault classification: is_oom matches torch.cuda.OutOfMemoryError (the
  reference matched XLA's RESOURCE_EXHAUSTED);
- the fault surface every coalesced dispatch crosses before it launches
  (pre_dispatch) and its serial-lane slice (serial_guard): a poisoned
  literal (POISON_LITERALS, set by tests) fails the whole dispatch, or the
  one statement re-run alone;
- memory pressure: relieve() evicts the coldest buffer-cache entries so
  one retry can succeed, and batch_cap() shrinks a batch to the card's
  free memory before it is discovered on the device.

run_degraded needs the morsel and spill tiers, which are not ported yet.
Counters: stats_snapshot().
"""

from __future__ import annotations

import time

from ..utils import locks

#: batch failures of one signature within WINDOW_S that bar it
QUARANTINE_FAILS = 2
WINDOW_S = 30.0
#: how long a barred signature stays off the coalescing path
COOLDOWN_S = 30.0
#: per-member cost of a batch, as a fraction of one member's staged
#: input bytes (batch_cap)
MEMBER_COST = 0.25
#: literal values that fail any dispatch carrying them (fault injection)
POISON_LITERALS: set = set()

_LOCK = locks.Lock("exec.shield._LOCK")
_STATS: dict = {              # guarded_by: _LOCK
    "batch_failures": 0,      # coalesced dispatches that raised
    "isolated": 0,            # members re-routed by bisection/recovery
    "quarantined": 0,         # signatures barred from coalescing
    "quarantine_hits": 0,     # classifications bypassed by an active bar
    "oom_dispatches": 0,      # dispatches that hit a device OOM
    "oom_retries": 0,         # evict-coldest-and-retry passes
    "oom_evicted_bytes": 0,   # device bytes freed by pressure relief
    "shrunk_batches": 0,      # batch_cap cut a batch
}
_QUAR: dict = {}              # guarded_by: _LOCK — sig -> [fails, t0, until]


class InjectedFault(RuntimeError):
    """A poisoned literal reached a dispatch."""


def bump(field: str, n: int = 1):
    with _LOCK:
        _STATS[field] += n


def stats_snapshot() -> dict:
    with _LOCK:
        d = dict(_STATS)
        d["quarantine_active"] = sum(
            1 for e in _QUAR.values() if e[2] > time.monotonic())
    return d


def reset_stats():
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0
        _QUAR.clear()


# ---------------------------------------------------------------------------
# repeat-offender quarantine (cooldown keyed by the program signature)
# ---------------------------------------------------------------------------

def note_batch_failure(sig) -> bool:
    """Record one coalesced-dispatch failure of `sig`; True when the
    signature just crossed the threshold and is now barred."""
    if sig is None:
        return False
    now = time.monotonic()
    with _LOCK:
        _STATS["batch_failures"] += 1
        ent = _QUAR.get(sig)
        if ent is None or now - ent[1] > WINDOW_S:
            ent = _QUAR[sig] = [0, now, 0.0]
        ent[0] += 1
        barred = ent[0] >= QUARANTINE_FAILS and ent[2] <= now
        if barred:
            ent[2] = now + COOLDOWN_S
            _STATS["quarantined"] += 1
        if len(_QUAR) > 512:        # bounded: drop the stalest entry
            _QUAR.pop(next(iter(_QUAR)))
    return barred


def quarantined(sig) -> bool:
    """Is this signature currently barred from coalescing?"""
    if sig is None:
        return False
    now = time.monotonic()
    with _LOCK:
        ent = _QUAR.get(sig)
        if ent is None or ent[2] <= now:
            return False
        _STATS["quarantine_hits"] += 1
        return True


# ---------------------------------------------------------------------------
# fault classification and the dispatch fault surface
# ---------------------------------------------------------------------------

def is_oom(exc: BaseException) -> bool:
    """A device allocation failure?"""
    import torch
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return "out of memory" in str(exc).lower()


def _poisoned(values):
    for v in values:
        try:
            if v in POISON_LITERALS:
                return v
        except TypeError:
            continue
    return None


def pre_dispatch(info, queries):
    """Crossed by every coalesced dispatch before its program runs: a
    poisoned literal anywhere in the batch fails the whole dispatch,
    the blast radius the scheduler's bisection then narrows."""
    for q in queries:
        v = _poisoned(q[2])
        if v is not None:
            raise InjectedFault(f"poison-literal {v!r} (batched)")


def serial_guard(lits):
    """The serial lane's slice of the same surface: a poisoned statement
    keeps failing when run alone, so bisection pins it."""
    if not lits:
        return
    v = _poisoned([val for _n, val, _t in lits])
    if v is not None:
        raise InjectedFault(f"poison-literal {v!r}")


# ---------------------------------------------------------------------------
# memory pressure
# ---------------------------------------------------------------------------

def relieve(node) -> int:
    """Evict the coldest buffer-cache entries of `node` (about half the
    resident bytes) so one retry can succeed; returns the bytes freed."""
    freed = node.cache.shed_coldest(0.5)
    with _LOCK:
        _STATS["oom_retries"] += 1
        _STATS["oom_evicted_bytes"] += freed
    return freed


def estimate_bytes(info) -> int:
    """Staged-input bytes of one member: needed columns x padded rows x
    8 (the MVCC columns included)."""
    from ..storage.batch import size_class
    total = 0
    for table, need in info.need_by_table.items():
        rows = size_class(max(info.stores[table].row_count(), 1))
        total += rows * (len(need) + 4) * 8
    return total


def batch_cap(node, info, max_batch: int) -> int:
    """How many members of this signature one dispatch may hold, given
    the card's free memory: the full batch with headroom, fewer (down to
    1) as free memory shrinks.  The CPU has no device budget."""
    import torch
    dev = getattr(node, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return max_batch
    est = estimate_bytes(info)
    if est <= 0:
        return max_batch
    free, _total = torch.cuda.mem_get_info(torch.device(dev))
    per_member = max(int(est * MEMBER_COST), 1)
    cap = max(1, min(max_batch, int((free - est) // per_member)))
    if cap < max_batch:
        bump("shrunk_batches")
    return cap


def run_degraded(item) -> list:
    """The reference serves a member after dispatch-level memory pressure
    through the morsel stream or the spill tier."""
    raise NotImplementedError("degraded serving (the morsel and spill "
                              "tiers) is not yet ported")
