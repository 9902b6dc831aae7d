"""GTM core: the global timestamp, txid and 2PC registry of a cluster.

The in-memory part of opentenbase_tpu/gtm/server.py's GtmCore: global
timestamps (GTS, microseconds of the wall clock, strictly increasing),
transaction ids, the catalog generation, sequences and the registry of
prepared two-phase transactions the cluster's implicit 2PC writes to.
Not ported: persistence of the reserve window, the socket server and its
client, standby shipping, resource-queue slots and barriers.
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
