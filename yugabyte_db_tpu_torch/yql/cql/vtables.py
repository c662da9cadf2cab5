"""CQL system virtual tables — the driver-handshake surface.

Reference analog: the master's ~18 YQLVirtualTable implementations
(src/yb/master/yql_virtual_table.h:28; yql_local_vtable.cc,
yql_peers_vtable.cc, yql_keyspaces_vtable.cc, yql_tables_vtable.cc,
yql_columns_vtable.cc, ...) serving system.local / system.peers /
system_schema.* from catalog state through the same YQLStorageIf seam
as real tables. Stock Cassandra drivers read these on connect to build
cluster + schema metadata; without them no driver can handshake.

Rows are materialized from live processor/cluster state per query (the
reference regenerates vtable content per request too), then filtered by
the statement's WHERE conjuncts and projected.
"""

from __future__ import annotations

import uuid

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import ColumnKind
from yugabyte_db_tpu_torch.utils.metrics import count_swallowed
from yugabyte_db_tpu_torch.utils.status import InvalidArgument

# A stable fake host id per process (reference: the tserver's uuid).
_HOST_ID = str(uuid.uuid4())
_PARTITIONER = "org.apache.cassandra.dht.Murmur3Partitioner"

_CQL_TYPE_NAMES = {
    DataType.INT8: "tinyint", DataType.INT16: "smallint",
    DataType.INT32: "int", DataType.INT64: "bigint",
    DataType.STRING: "text", DataType.FLOAT: "float",
    DataType.DOUBLE: "double", DataType.BOOL: "boolean",
    DataType.BINARY: "blob", DataType.TIMESTAMP: "timestamp",
    DataType.COUNTER: "counter", DataType.JSONB: "jsonb",
    DataType.LIST: "list", DataType.SET: "set", DataType.MAP: "map",
}

VIRTUAL_TABLES = ("system.local", "system.peers",
                  "system_schema.keyspaces", "system_schema.tables",
                  "system_schema.columns", "system_schema.types")


def is_virtual(qualified: str) -> bool:
    return qualified in VIRTUAL_TABLES


def _local_rows(processor):
    return [{
        "key": "local",
        "bootstrapped": "COMPLETED",
        "broadcast_address": "127.0.0.1",
        "cluster_name": "local cluster",
        "cql_version": "3.4.4",
        "data_center": "datacenter1",
        "gossip_generation": 0,
        "host_id": _HOST_ID,
        "listen_address": "127.0.0.1",
        "native_protocol_version": "4",
        "partitioner": _PARTITIONER,
        "rack": "rack1",
        "release_version": "3.9-SNAPSHOT",
        "rpc_address": "127.0.0.1",
        "schema_version": _HOST_ID,
        "tokens": ["0"],
    }]


def _peers_rows(processor):
    """Other nodes. The in-process/local deployments serve everything
    from one address; a distributed ClientCluster reports its live
    tservers (reference: yql_peers_vtable.cc from TSDescriptors)."""
    rows = []
    client = getattr(processor.cluster, "client", None)
    if client is not None:
        try:
            tservers = client.list_tservers()
        except Exception:  # noqa: BLE001 — vtables degrade, never fail
            tservers = []
        for i, ts in enumerate(tservers[1:], start=2):
            addr = f"127.0.0.{i}"
            rows.append({
                "peer": addr, "data_center": "datacenter1",
                "host_id": str(uuid.uuid5(uuid.NAMESPACE_DNS,
                                          str(ts.get("uuid", i)))),
                "preferred_ip": addr, "rack": "rack1",
                "release_version": "3.9-SNAPSHOT", "rpc_address": addr,
                "schema_version": _HOST_ID, "tokens": [str(i)],
            })
    return rows


def _keyspace_names(processor) -> list[str]:
    names = set(processor.keyspaces)
    names.update({"system", "system_schema"})
    for t in processor.cluster.tables:
        if "." in t:
            names.add(t.split(".", 1)[0])
    return sorted(names)


def _keyspaces_rows(processor):
    return [{
        "keyspace_name": ks,
        "durable_writes": True,
        "replication": {
            "class": "org.apache.cassandra.locator.SimpleStrategy",
            "replication_factor": "3"},
    } for ks in _keyspace_names(processor)]


def _user_tables(processor):
    """(keyspace, table, schema) triples of real tables."""
    out = []
    for name in sorted(processor.cluster.tables):
        if "." not in name:
            continue
        ks, table = name.split(".", 1)
        try:
            schema = processor.cluster.table(name).schema
        except Exception as e:  # noqa: BLE001 — dropped concurrently
            count_swallowed("cql_vtables.table_schema", e)
            continue
        out.append((ks, table, schema))
    return out


def _tables_rows(processor):
    return [{
        "keyspace_name": ks, "table_name": table,
        "id": str(uuid.uuid5(uuid.NAMESPACE_DNS, f"{ks}.{table}")),
        "default_time_to_live": 0,
        "flags": ["compound"],
    } for ks, table, _schema in _user_tables(processor)]


def _columns_rows(processor):
    rows = []
    for ks, table, schema in _user_tables(processor):
        hash_cols = [c for c in schema.columns if c.kind == ColumnKind.HASH]
        range_cols = [c for c in schema.columns
                      if c.kind == ColumnKind.RANGE]
        for c in schema.columns:
            if c.kind == ColumnKind.HASH:
                kind, pos = "partition_key", hash_cols.index(c)
            elif c.kind == ColumnKind.RANGE:
                kind, pos = "clustering", range_cols.index(c)
            else:
                kind, pos = "regular", -1
            rows.append({
                "keyspace_name": ks, "table_name": table,
                "column_name": c.name,
                "clustering_order": ("asc" if kind == "clustering"
                                     else "none"),
                "column_name_bytes": c.name.encode(),
                "kind": kind, "position": pos,
                "type": _CQL_TYPE_NAMES.get(c.dtype, "text"),
            })
    return rows


def _types_rows(processor):
    """system_schema.types: the UDT registry, as stock drivers read it
    for schema metadata (reference: yql_types_vtable.cc)."""
    from yugabyte_db_tpu_torch.models.datatypes import DataType

    rows = []
    try:
        types = processor.cluster.list_types()
    except Exception:  # noqa: BLE001 — masterless moment: empty listing
        types = {}
    for name, fields in sorted((types or {}).items()):
        ks, _, tname = name.rpartition(".")
        rows.append({
            "keyspace_name": ks or "default",
            "type_name": tname or name,
            "field_names": [f[0] for f in fields],
            "field_types": [
                _CQL_TYPE_NAMES.get(DataType(f[1]), "text")
                for f in fields],
        })
    return rows


_BUILDERS = {
    "system.local": _local_rows,
    "system.peers": _peers_rows,
    "system_schema.keyspaces": _keyspaces_rows,
    "system_schema.tables": _tables_rows,
    "system_schema.columns": _columns_rows,
    "system_schema.types": _types_rows,
}

# Column order when a vtable has no rows to infer from (drivers break
# on RowDescription-less empty results).
_EMPTY_COLUMNS = {
    "system.peers": ["peer", "data_center", "host_id", "preferred_ip",
                     "rack", "release_version", "rpc_address",
                     "schema_version", "tokens"],
    "system_schema.types": ["keyspace_name", "type_name", "field_names",
                            "field_types"],
}


def _matches(row: dict, rel) -> bool:
    v = row.get(rel.column)
    rv = rel.value
    if rel.op == "=":
        return v == rv
    if rel.op == "!=":
        return v != rv
    if rel.op == "IN":
        return v in rv
    if v is None or rv is None:
        return False
    return {"<": v < rv, "<=": v <= rv, ">": v > rv,
            ">=": v >= rv}[rel.op]


def virtual_select(processor, stmt):
    """Execute a SELECT against a system vtable; returns a ResultSet.
    Raises InvalidArgument for projections of unknown columns."""
    from yugabyte_db_tpu_torch.yql.cql.processor import ResultSet

    qualified = processor._qualify(stmt.table)
    rows = _BUILDERS[qualified](processor)
    for rel in stmt.where:
        value = processor._resolve_marker(rel.value)
        rel = type(rel)(rel.column, rel.op, value)
        rows = [r for r in rows if _matches(r, rel)]
    if rows:
        all_cols = list(rows[0].keys())
    else:
        all_cols = _EMPTY_COLUMNS.get(qualified, [])
    if stmt.items is None:
        names = all_cols
    else:
        names = []
        for it in stmt.items:
            if it.agg_fn == "count" and it.column is None:
                return ResultSet(["count"], [(len(rows),)])
            if it.column is None or (rows and it.column not in rows[0]):
                raise InvalidArgument(
                    f"unknown column {it.column} in {qualified}")
            names.append(it.column)
    out = [tuple(r.get(n) for n in names) for r in rows]
    if stmt.limit is not None:
        out = out[:processor._require_nonneg_int(
            processor._resolve_marker(stmt.limit), "LIMIT")]
    return ResultSet(list(names), out)
