"""Catalog state: tables and tablets, mutated only by replicated entries.

Reference analog: the sys-catalog row types (src/yb/master/catalog_manager.h
TableInfo/TabletInfo, master.proto SysTablesEntryPB/SysTabletsEntryPB).
Every mutation is an op dict replicated through the masters' Raft group and
applied here deterministically on each master.

The port's copy of the JAX package's ``master/catalog.py``. Its one
departure: a table's engine defaults to ``"gpu"`` (the JAX default
``"cpu"`` is not registered in the port; ROADMAP.md §1 item 16).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.utils.metrics import count_swallowed


@dataclass
class TabletInfo:
    tablet_id: str
    table_id: str
    partition_start: int
    partition_end: int
    replicas: list[str] = field(default_factory=list)  # intended node uuids


@dataclass
class TableInfo:
    table_id: str
    name: str
    schema: dict                       # Schema.to_dict()
    num_tablets: int
    tablet_ids: list[str] = field(default_factory=list)
    state: str = "RUNNING"
    engine: str = "gpu"
    # Secondary indexes ON this table: [{"name", "column", "index_table"}]
    # (reference: IndexInfo entries in SysTablesEntryPB, common/index.h).
    indexes: list[dict] = field(default_factory=list)


class CatalogState:
    """Deterministic state machine over replicated catalog ops."""

    def __init__(self):
        from yugabyte_db_tpu_torch.auth import RoleStore

        self._lock = threading.RLock()
        self.tables: dict[str, TableInfo] = {}
        self.tables_by_name: dict[str, str] = {}
        self.tablets: dict[str, TabletInfo] = {}
        # Roles/permissions ride the same replicated catalog pipeline
        # (reference: role records in the sys catalog, master.proto:1383).
        self.auth = RoleStore()
        # User-defined types: name -> [(field, dtype int)] (reference:
        # UDTypeInfo records in the sys catalog, pt_create_type.cc).
        self.types: dict[str, list] = {}
        # SQL views (name -> defining query) and sequences (name -> next
        # value) — replicated catalog records (reference: pg_rewrite /
        # sequence relations in the PG fork's catalog).
        self.views: dict[str, str] = {}
        self.sequences: dict[str, int] = {}
        # CQL keyspaces (reference: SysNamespaceEntryPB records in the
        # sys catalog) — shared across every connection/session.
        self.user_keyspaces: set[str] = set()
        # Cluster snapshots: id -> {"table", "state", "tablets"} —
        # master-coordinated registry over the per-tablet snapshot ops
        # (reference: SysSnapshotEntryPB states driven by
        # src/yb/tserver/backup.proto TabletSnapshotOp).
        self.snapshots: dict[str, dict] = {}
        # Tablet-split lineage: parent tablet_id -> {"table_id",
        # "split_hash", "children": [low_id, high_id], "state"
        # ("SPLITTING" until split_commit, then "COMMITTED")}. Kept
        # after commit for the /dashboards/tablets lineage view
        # (reference: the split_parent_tablet_id back-links of
        # SysTabletsEntryPB).
        self.splits: dict[str, dict] = {}

    def apply(self, op: dict) -> None:
        kind = op["op"]
        if kind.startswith("auth_"):
            # Replicas hold identical state at each log index, so a
            # validation failure here is the SAME no-op on every replica
            # (the leader pre-validates; this guards races + replays).
            try:
                self.auth.apply(op)
            except Exception as e:  # noqa: BLE001
                count_swallowed("catalog.auth_apply", e)
            return
        with self._lock:
            if kind == "create_view":
                self.views[op["name"]] = op["query"]
                return
            if kind == "drop_view":
                self.views.pop(op["name"], None)
                return
            if kind == "create_keyspace":
                self.user_keyspaces.add(op["name"])
                return
            if kind == "drop_keyspace":
                self.user_keyspaces.discard(op["name"])
                return
            if kind == "create_sequence":
                self.sequences.setdefault(op["name"], 1)
                return
            if kind == "drop_sequence":
                self.sequences.pop(op["name"], None)
                return
            if kind == "sequence_alloc":
                self.sequences[op["name"]] = \
                    self.sequences.get(op["name"], 1) + op["n"]
                return
            if kind == "snapshot_record":
                self.snapshots[op["snapshot_id"]] = {
                    "table": op["table"], "state": op["state"],
                    "tablets": list(op.get("tablets", ()))}
                return
            if kind == "snapshot_remove":
                self.snapshots.pop(op["snapshot_id"], None)
                return
            if kind == "create_type":
                self.types[op["name"]] = [tuple(f) for f in op["fields"]]
                return
            if kind == "drop_type":
                self.types.pop(op["name"], None)
                return
            if kind == "create_table":
                t = TableInfo(op["table_id"], op["name"], op["schema"],
                              op["num_tablets"], engine=op.get("engine", "gpu"))
                for td in op["tablets"]:
                    info = TabletInfo(td["tablet_id"], t.table_id,
                                      td["partition_start"],
                                      td["partition_end"],
                                      list(td["replicas"]))
                    self.tablets[info.tablet_id] = info
                    t.tablet_ids.append(info.tablet_id)
                self.tables[t.table_id] = t
                self.tables_by_name[t.name] = t.table_id
            elif kind == "delete_table":
                t = self.tables.pop(op["table_id"], None)
                if t is not None:
                    self.tables_by_name.pop(t.name, None)
                    for tid in t.tablet_ids:
                        self.tablets.pop(tid, None)
            elif kind == "set_tablet_replicas":
                info = self.tablets.get(op["tablet_id"])
                if info is not None:
                    info.replicas = list(op["replicas"])
            elif kind == "create_index":
                t = self.tables.get(op["table_id"])
                if t is not None and not any(
                        i["name"] == op["index"]["name"]
                        for i in t.indexes):
                    t.indexes.append(dict(op["index"]))
            elif kind == "drop_index":
                t = self.tables.get(op["table_id"])
                if t is not None:
                    t.indexes = [i for i in t.indexes
                                 if i["name"] != op["name"]]
            elif kind == "split_tablet":
                # Phase 2 of a tablet split: register BOTH children (with
                # their intended replica sets) and the lineage BEFORE any
                # child replica exists, so the heartbeat orphan-GC never
                # mistakes a freshly created child for a deleted tablet.
                # Children are NOT yet in table.tablet_ids: lookups keep
                # resolving to the parent until split_commit swaps them.
                t = self.tables.get(op["table_id"])
                if t is None or op["tablet_id"] not in self.tablets:
                    return  # replay after delete_table / double apply
                for cd in op["children"]:
                    if cd["tablet_id"] not in self.tablets:
                        self.tablets[cd["tablet_id"]] = TabletInfo(
                            cd["tablet_id"], t.table_id,
                            cd["partition_start"], cd["partition_end"],
                            list(cd["replicas"]))
                self.splits[op["tablet_id"]] = {
                    "table_id": t.table_id,
                    "split_hash": op["split_hash"],
                    "children": [cd["tablet_id"]
                                 for cd in op["children"]],
                    "state": "SPLITTING"}
            elif kind == "split_commit":
                # Phase 6: atomically swap parent -> children in the
                # table's serving list and drop the parent TabletInfo —
                # the next heartbeat's orphan-GC tombstones its replicas.
                t = self.tables.get(op["table_id"])
                parent_id = op["tablet_id"]
                if t is not None and parent_id in t.tablet_ids:
                    idx = t.tablet_ids.index(parent_id)
                    t.tablet_ids[idx:idx + 1] = [
                        c for c in op["children"]
                        if c not in t.tablet_ids]
                self.tablets.pop(parent_id, None)
                s = self.splits.get(parent_id)
                if s is not None:
                    s["state"] = "COMMITTED"
            elif kind == "alter_table":
                t = self.tables.get(op["table_id"])
                # versions only move forward (idempotent across replays)
                if t is not None and op["schema"].get("version", 0) > \
                        t.schema.get("version", 0):
                    t.schema = op["schema"]
            else:
                raise ValueError(f"unknown catalog op {kind!r}")

    # -- reads (soft, lock-protected) ---------------------------------------
    def table_by_name(self, name: str) -> TableInfo | None:
        with self._lock:
            tid = self.tables_by_name.get(name)
            return self.tables.get(tid) if tid else None

    def list_tables(self) -> list[TableInfo]:
        with self._lock:
            return list(self.tables.values())

    def tablets_of(self, table_id: str) -> list[TabletInfo]:
        with self._lock:
            t = self.tables.get(table_id)
            if t is None:
                return []
            return [self.tablets[tid] for tid in t.tablet_ids
                    if tid in self.tablets]

    def known_tablet_ids(self) -> set[str]:
        with self._lock:
            return set(self.tablets)

    def split_lineage(self) -> list[dict]:
        """Parent -> children rows for the tablets dashboard."""
        with self._lock:
            return [{"parent": pid, "table_id": s["table_id"],
                     "split_hash": s["split_hash"],
                     "children": list(s["children"]),
                     "state": s["state"]}
                    for pid, s in self.splits.items()]
