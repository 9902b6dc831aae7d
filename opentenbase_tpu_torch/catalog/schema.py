"""Table definitions + distribution descriptors.

Reference analog: pg_class/pg_attribute plus the XC additions —
`pgxc_class` (distribution type, dist columns, node group;
src/include/catalog/pgxc_class.h:17-29) and the locator type vocabulary
(src/include/pgxc/locator.h:20-56: REPLICATED, HASH, RANGE, RROBIN, MODULO,
SHARD, ...).  SHARD is the flagship strategy: dist-key hash -> one of 4096
shard groups -> owning node (shardmap.h:20-24); we keep that contract because
a fixed shard count keeps `all_to_all` bucket shapes static on device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from .types import SqlType, type_from_name  # noqa: F401  (re-export)


class DistType(enum.Enum):
    REPLICATED = "replicated"   # full copy on every node in the group
    SHARD = "shard"             # hash(dist cols) -> 4096 shard map -> node
    HASH = "hash"               # hash(dist cols) mod nodecount (legacy XC)
    MODULO = "modulo"           # dist col value mod nodecount
    ROUNDROBIN = "roundrobin"   # writer round-robins rows
    RANGE = "range"             # split points -> contiguous node ranges
    SINGLE = "single"           # un-distributed (catalog/CN-local)


NUM_SHARDS = 4096  # reference: SHARD_MAP_GROUP_NUM (shardmap.h:20-24)


@dataclasses.dataclass
class Distribution:
    dist_type: DistType
    dist_cols: list[str] = dataclasses.field(default_factory=list)
    group: str = "default_group"
    # RANGE distribution split points (storage-representation values):
    # node i holds [bounds[i-1], bounds[i]) — reference: LOCATOR_TYPE_RANGE,
    # locator.h:20-56
    range_bounds: list = dataclasses.field(default_factory=list)

    def to_json(self):
        return {"dist_type": self.dist_type.value,
                "dist_cols": self.dist_cols, "group": self.group,
                "range_bounds": list(self.range_bounds)}

    @staticmethod
    def from_json(d):
        return Distribution(DistType(d["dist_type"]), list(d["dist_cols"]),
                            d.get("group", "default_group"),
                            list(d.get("range_bounds", [])))


@dataclasses.dataclass
class ColumnDef:
    name: str
    type: SqlType
    nullable: bool = True

    def to_json(self):
        return {"name": self.name, "kind": self.type.kind.value,
                "precision": self.type.precision, "scale": self.type.scale,
                "max_len": self.type.max_len, "nullable": self.nullable}

    @staticmethod
    def from_json(d):
        from .types import SqlType, TypeKind
        t = SqlType(TypeKind(d["kind"]), d.get("precision", 0),
                    d.get("scale", 0), d.get("max_len", 0))
        return ColumnDef(d["name"], t, d.get("nullable", True))


@dataclasses.dataclass
class TableDef:
    name: str
    columns: list[ColumnDef]
    distribution: Distribution
    oid: int = 0
    # CHECK constraint expression texts (reference: pg_constraint 'c')
    checks: list = dataclasses.field(default_factory=list)
    # foreign keys: {"cols": [...], "ref_table": str, "ref_cols": [...]}
    fks: list = dataclasses.field(default_factory=list)

    def column(self, name: str) -> ColumnDef:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"table {self.name} has no column {name!r}")

    def has_column(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def to_json(self):
        return {"name": self.name, "oid": self.oid,
                "columns": [c.to_json() for c in self.columns],
                "distribution": self.distribution.to_json(),
                "checks": list(self.checks), "fks": list(self.fks)}

    @staticmethod
    def from_json(d):
        return TableDef(d["name"],
                        [ColumnDef.from_json(c) for c in d["columns"]],
                        Distribution.from_json(d["distribution"]),
                        d.get("oid", 0), list(d.get("checks", [])),
                        list(d.get("fks", [])))


@dataclasses.dataclass
class NodeDef:
    """Cluster membership entry — reference: pgxc_node catalog
    (src/include/catalog/pgxc_node.h) managed by
    src/backend/pgxc/nodemgr/nodemgr.c."""
    name: str
    kind: str              # 'coordinator' | 'datanode' | 'gtm'
    host: str = "localhost"
    port: int = 0
    index: int = 0         # dense datanode index used by the shard map
    # registered standby for auto-failover: {"host","port","datadir"}
    standby: dict = None
    # bumped at every failover of this slot: a coordinator holding a
    # connection to an older epoch's address must re-resolve (fencing)
    epoch: int = 0
    # hot-standby READ replicas (list of {"host","port","datadir"}):
    # the ReplicaRouter's rotation — distinct from `standby`, which is
    # the failover target (net/guard.py ReplicaRouter)
    standbys: list = None

    def to_json(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d):
        return NodeDef(**d)


@dataclasses.dataclass
class SequenceDef:
    """Global sequence — served by the GTS/GTM service so values are
    cluster-unique (reference: src/gtm/main/gtm_seq.c +
    access/transam/gtm.c:128-558)."""
    name: str
    start: int = 1
    increment: int = 1
    next_value: int = 1

    def to_json(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d):
        return SequenceDef(**d)
