"""System catalog.

Reference analog: src/backend/catalog (pg_class & friends) plus the pgxc_*
cluster catalogs (pgxc_node, pgxc_group, pgxc_class, pgxc_shard_map).  The
coordinator holds only metadata (reference README.md:10-14); here Catalog is
that metadata: tables, nodes, shard map, sequences.  Persisted as JSON — the
catalog is tiny and host-side; bulk data lives in the columnar shard stores.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np

from .schema import (ColumnDef, Distribution, DistType, NodeDef, NUM_SHARDS,
                     SequenceDef, TableDef)
from ..utils import locks


class CatalogError(Exception):
    pass


class Catalog:
    def __init__(self):
        self._lock = locks.RLock("catalog.catalog.Catalog._lock")
        self.tables: dict[str, TableDef] = {}
        self.nodes: dict[str, NodeDef] = {}
        self.sequences: dict[str, SequenceDef] = {}
        # shard map: shard id (0..4095) -> datanode index
        # (reference: pgxc_shard_map catalog + shmem map, shardmap.c:60-71)
        self.shard_map: np.ndarray = np.zeros(NUM_SHARDS, dtype=np.int32)
        # btree-equivalent index registry: table -> set of indexed
        # columns (reference: pg_index; the planner consults this for
        # index-scan eligibility, store-level structures live per DN)
        self.btree_cols: dict[str, set] = {}
        # global secondary indexes: table -> {col -> {"map": mapping
        # table, "name": index name, "unique": bool}} (reference:
        # cross-node global indexes, optimizer gate
        # indxpath.c:4331 allow_global_index_path; the mapping table is
        # the SHARD-distributed key->owner-shardid relation)
        self.global_indexes: dict[str, dict] = {}
        # named local (per-DN) indexes: name -> {"table", "cols",
        # "method"} so DROP INDEX can resolve them (reference: pg_index
        # names; structures live in each DN's store)
        self.local_indexes: dict[str, dict] = {}
        # ANALYZE output: table -> {"rows", "cols": {col: {"ndv", "min",
        # "max"}}} (reference: pg_statistic, consumed by costsize.c)
        self.stats: dict[str, dict] = {}
        # scheduled jobs: name -> {"interval_s","sql"} (reference:
        # pg_dbms_job catalog; run by parallel/jobs.JobScheduler)
        self.jobs: dict[str, dict] = {}
        # resource groups: name -> {"concurrency","staging_budget_rows",
        # "device_time_share"} (reference: pg_resgroup +
        # resgroup-ops-linux.c, re-designed TPU-native: concurrency is
        # GTM-coordinated cluster-wide, the staging budget bounds HBM
        # residency by routing over-budget queries to the spill tier,
        # and device time is accounted per group)
        self.resource_groups: dict[str, dict] = {}
        # column masks: name -> {"table","column","expr"}, applied as
        # a projection rewrite at bind time (reference: datamask.c) —
        # and FGA audit policies: name -> {"table","pred"} (reference:
        # audit_fga.c predicate-gated audit records)
        self.masks: dict[str, dict] = {}
        self.fga_policies: dict[str, dict] = {}
        # trigger functions: name -> {"body": stmt-list text} and
        # triggers: name -> {"table","timing","event","when","func"}
        # (reference: pg_proc + pg_trigger, fired by commands/trigger.c)
        self.functions: dict[str, dict] = {}
        self.triggers: dict[str, dict] = {}
        # views: name -> SELECT text, expanded at bind time (reference:
        # pg_rewrite view rules; text-stored so persistence is trivial)
        self.views: dict[str, str] = {}
        # declarative partitioning: parent -> {"method": range|list,
        # "key": col, "parts": [{"name", "from", "to"} | {"name",
        # "values"}]} (reference: pg_partitioned_table + pg_class
        # relispartition; pruning happens at bind time)
        self.partitioned: dict[str, dict] = {}
        # SPM plan baselines: statement fingerprint (literal-masked AST
        # hash) -> accepted join order (reference: optimizer/spm/spm.c
        # — capture once, replay for plan stability across stats churn)
        self.spm: dict[str, list] = {}
        # node groups: name -> member datanode indexes; sharded tables
        # with a non-default group place rows on members only via a
        # per-group shard map (reference: pgxc_group.h + nodemgr.c)
        self.node_groups: dict[str, list] = {}
        self.group_shard_maps: dict[str, list] = {}
        self._next_oid = 16384

    def create_node_group(self, name: str, members: list):
        import numpy as np
        with self._lock:
            if name in self.node_groups:
                raise CatalogError(f"node group {name!r} already exists")
            self.node_groups[name] = list(members)
            self.group_shard_maps[name] = (
                np.asarray(members, np.int32)[
                    np.arange(len(self.shard_map)) % len(members)]
                .tolist())

    def shard_map_for_group(self, group: str):
        import numpy as np
        m = self.group_shard_maps.get(group)
        if m is None:
            return self.shard_map
        return np.asarray(m, np.int32)

    # ---- tables ----
    def create_table(self, td: TableDef, if_not_exists: bool = False) -> TableDef:
        with self._lock:
            if td.name in self.tables:
                if if_not_exists:
                    return self.tables[td.name]
                raise CatalogError(f"table {td.name!r} already exists")
            if td.name in self.views:
                raise CatalogError(f"{td.name!r} is a view")
            seen = set()
            for c in td.columns:
                if c.name in seen:
                    raise CatalogError(f"duplicate column {c.name!r}")
                seen.add(c.name)
            for dc in td.distribution.dist_cols:
                if not td.has_column(dc):
                    raise CatalogError(
                        f"distribution column {dc!r} not in table {td.name!r}")
            grp = td.distribution.group
            if grp != "default_group" and grp not in self.node_groups:
                raise CatalogError(f"node group {grp!r} does not exist")
            td.oid = self._next_oid
            self._next_oid += 1
            self.tables[td.name] = td
            return td

    def drop_table(self, name: str, if_exists: bool = False):
        with self._lock:
            if name not in self.tables:
                if if_exists:
                    return
                raise CatalogError(f"table {name!r} does not exist")
            del self.tables[name]

    def table(self, name: str) -> TableDef:
        td = self.tables.get(name)
        if td is None:
            raise CatalogError(f"table {name!r} does not exist")
        return td

    # ---- views ----
    def create_view(self, name: str, text: str,
                    or_replace: bool = False):
        with self._lock:
            if name in self.tables:
                raise CatalogError(
                    f"{name!r} is a table, cannot be a view")
            if name in self.views and not or_replace:
                raise CatalogError(f"view {name!r} already exists")
            self.views[name] = text

    def drop_view(self, name: str, if_exists: bool = False):
        with self._lock:
            if name not in self.views:
                if if_exists:
                    return
                raise CatalogError(f"view {name!r} does not exist")
            del self.views[name]

    # ---- nodes / shard map ----
    def register_node(self, nd: NodeDef):
        with self._lock:
            self.nodes[nd.name] = nd

    def datanodes(self) -> list[NodeDef]:
        return sorted((n for n in self.nodes.values() if n.kind == "datanode"),
                      key=lambda n: n.index)

    def build_default_shard_map(self, n_datanodes: int):
        """Round-robin shards over datanodes — the reference populates
        pgxc_shard_map at CREATE GROUP time similarly (shardmap.c)."""
        with self._lock:
            self.shard_map = (np.arange(NUM_SHARDS, dtype=np.int32)
                              % max(1, n_datanodes))

    def move_shards(self, shard_ids, to_node_index: int):
        """Online shard move (reference: shard moves + ALTER TABLE ...
        redistribution, pgxc/locator/redistrib.c)."""
        with self._lock:
            self.shard_map[np.asarray(shard_ids, dtype=np.int64)] = to_node_index

    # ---- sequences (global, GTM-served in the reference) ----
    def create_sequence(self, sd: SequenceDef):
        with self._lock:
            if sd.name in self.sequences:
                raise CatalogError(f"sequence {sd.name!r} already exists")
            sd.next_value = sd.start
            self.sequences[sd.name] = sd

    # ---- persistence ----
    def save(self, path: str):
        with self._lock:
            blob = {
                "tables": [t.to_json() for t in self.tables.values()],
                "nodes": [n.to_json() for n in self.nodes.values()],
                "sequences": [s.to_json() for s in self.sequences.values()],
                "shard_map": self.shard_map.tolist(),
                "btree_cols": {t: sorted(cs)
                               for t, cs in self.btree_cols.items()},
                "global_indexes": self.global_indexes,
                "local_indexes": self.local_indexes,
                "stats": self.stats,
                "views": self.views,
                "functions": self.functions,
                "triggers": self.triggers,
                "masks": self.masks,
                "fga_policies": self.fga_policies,
                "resource_groups": self.resource_groups,
                "jobs": self.jobs,
                "partitioned": self.partitioned,
                "spm": self.spm,
                "node_groups": self.node_groups,
                "group_shard_maps": self.group_shard_maps,
                "next_oid": self._next_oid,
            }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Catalog":
        with open(path) as f:
            blob = json.load(f)
        cat = Catalog()
        for t in blob["tables"]:
            td = TableDef.from_json(t)
            cat.tables[td.name] = td
        for n in blob["nodes"]:
            nd = NodeDef.from_json(n)
            cat.nodes[nd.name] = nd
        for s in blob.get("sequences", []):
            sd = SequenceDef.from_json(s)
            cat.sequences[sd.name] = sd
        cat.shard_map = np.asarray(blob["shard_map"], dtype=np.int32)
        cat.btree_cols = {t: set(cs) for t, cs in
                          blob.get("btree_cols", {}).items()}
        cat.global_indexes = blob.get("global_indexes", {})
        cat.local_indexes = blob.get("local_indexes", {})
        cat.stats = blob.get("stats", {})
        cat.views = blob.get("views", {})
        cat.functions = blob.get("functions", {})
        cat.triggers = blob.get("triggers", {})
        cat.masks = blob.get("masks", {})
        cat.fga_policies = blob.get("fga_policies", {})
        cat.resource_groups = blob.get("resource_groups", {})
        cat.jobs = blob.get("jobs", {})
        cat.partitioned = blob.get("partitioned", {})
        cat.spm = blob.get("spm", {})
        cat.node_groups = blob.get("node_groups", {})
        cat.group_shard_maps = blob.get("group_shard_maps", {})
        cat._next_oid = blob.get("next_oid", 16384)
        return cat
