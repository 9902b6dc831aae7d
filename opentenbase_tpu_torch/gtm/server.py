"""GTM core: the global timestamp, txid and 2PC registry of a cluster.

The in-memory part of opentenbase_tpu/gtm/server.py's GtmCore: global
timestamps (GTS, microseconds of the wall clock, strictly increasing),
transaction ids, the catalog generation, sequences and the registry of
prepared two-phase transactions the cluster's implicit 2PC writes to.
The resource-queue slots the serving tier admits through (exec/scheduler.py)
are here too: per-group concurrency slots, each held by an owner under a
lease.  Not ported: persistence of the reserve window, the socket server
and its client, standby shipping and barriers.
"""

from __future__ import annotations

import time

from ..utils import locks


class GtmCore:
    """The clock + txid + sequence state machine of one cluster."""

    def __init__(self):
        self._lock = locks.Lock("gtm.server.GtmCore._lock")
        self._ts = 100
        self._txid = 1
        self._catalog_gen = 0
        self._sequences: dict[str, dict] = {}
        self._prepared: dict[str, dict] = {}   # gid -> info (2PC registry)
        self._resq: dict[str, list] = {}       # group -> [[owner, lease]]
        self._resq_stat = {"acquired": 0, "released": 0, "expired": 0}

    # ---- catalog generation (multi-coordinator DDL sync) ----
    def catalog_gen(self) -> int:
        with self._lock:
            return self._catalog_gen

    def bump_catalog_gen(self) -> int:
        with self._lock:
            self._catalog_gen += 1
            return self._catalog_gen

    # ---- timestamps and txids ----
    def next_gts(self) -> int:
        with self._lock:
            wall = int(time.time() * 1e6)
            self._ts = max(self._ts + 1, wall)
            return self._ts

    def next_txid(self) -> int:
        with self._lock:
            self._txid += 1
            return self._txid

    # ---- sequences ----
    def seq_next(self, name: str, cache: int = 1) -> int:
        with self._lock:
            s = self._sequences.setdefault(
                name, {"next": 1, "increment": 1})
            v = s["next"]
            s["next"] = v + s["increment"] * cache
            return v

    def seq_list(self) -> dict:
        with self._lock:
            return {n: dict(s) for n, s in self._sequences.items()}

    def seq_create(self, name: str, start: int = 1, increment: int = 1):
        with self._lock:
            self._sequences[name] = {"next": start, "increment": increment}

    def seq_drop(self, name: str):
        with self._lock:
            self._sequences.pop(name, None)

    # ---- resource-queue slots (reference: gtm/server.py resq_*) ----
    # Each group has a list of [owner, lease_deadline] slots.  A holder
    # that dies between acquire and release cannot leak its slot: an
    # expired lease is reaped at the next call, and resq_disconnect
    # frees every slot of an owner.
    def _resq_slots(self, group: str) -> list:
        # caller holds self._lock
        slots = self._resq.setdefault(group, [])
        now = time.monotonic()
        kept = [s for s in slots if s[1] > now]
        # a reaped lease is an acquire whose release never lands: count
        # it, or the acquired/released ledger silently diverges
        self._resq_stat["expired"] += len(slots) - len(kept)
        slots[:] = kept
        return slots

    def resq_acquire(self, group: str, cap: int, owner: str = "",
                     lease_s: float = 30.0) -> bool:
        with self._lock:
            slots = self._resq_slots(group)
            if cap > 0 and len(slots) >= cap:
                return False
            slots.append([owner,
                          time.monotonic() + max(float(lease_s), 0.001)])
            self._resq_stat["acquired"] += 1
            return True

    def resq_release(self, group: str, owner: str = "") -> None:
        with self._lock:
            slots = self._resq_slots(group)
            for i, s in enumerate(slots):
                if s[0] == owner:
                    del slots[i]
                    self._resq_stat["released"] += 1
                    return
            # an identity-less caller releases positionally; an
            # identified owner whose slot was already reaped must not
            # pop someone else's (the reap was counted as expired)
            if slots and not owner:
                del slots[0]
                self._resq_stat["released"] += 1

    def resq_disconnect(self, owner: str) -> int:
        """Free every slot held by `owner`; returns how many."""
        if not owner:
            return 0
        freed = 0
        with self._lock:
            for group in list(self._resq):
                slots = self._resq_slots(group)
                kept = [s for s in slots if s[0] != owner]
                freed += len(slots) - len(kept)
                slots[:] = kept
            # the owner's goodbye is its release
            self._resq_stat["released"] += freed
        return freed

    def resq_counts(self) -> dict:
        with self._lock:
            return {g: len(self._resq_slots(g)) for g in list(self._resq)}

    def resq_stats(self) -> dict:
        """Slot ledger: acquired == released + expired + live at any
        quiescent point."""
        with self._lock:
            for g in list(self._resq):
                self._resq_slots(g)     # fold pending expiries in
            st = dict(self._resq_stat)
        st["live"] = sum(self.resq_counts().values())
        return st

    # ---- 2PC registry ----
    def prepare_txn(self, gid: str, participants: list[str], txid: int):
        with self._lock:
            self._prepared[gid] = {"participants": participants,
                                   "txid": txid, "state": "prepared"}

    def commit_txn(self, gid: str, commit_ts: int):
        with self._lock:
            if gid in self._prepared:
                self._prepared[gid]["state"] = "committed"
                self._prepared[gid]["commit_ts"] = commit_ts

    def forget_txn(self, gid: str):
        with self._lock:
            self._prepared.pop(gid, None)

    def abort_txn(self, gid: str):
        with self._lock:
            if gid in self._prepared:
                self._prepared[gid]["state"] = "aborted"

    def txn_verdict(self, gid: str) -> str:
        """'committed', 'aborted', or 'unknown' (never prepared here)."""
        with self._lock:
            info = self._prepared.get(gid)
            return "unknown" if info is None else info["state"]

    def prepared_list(self) -> dict:
        with self._lock:
            return dict(self._prepared)
