"""pg_catalog / information_schema virtual tables.

Reference capability: YSQL ships PostgreSQL's full system catalogs
(initdb populates pg_catalog; src/postgres/src/backend/catalog). Here
the introspection surface drivers and ORMs actually query is served
from live cluster state, the same approach as the CQL system vtables
(yql/cql/vtables.py): rows materialize per query, then ride the
executor's normal projection/WHERE/ORDER BY machinery.

Served: pg_catalog.{pg_tables, pg_class, pg_namespace, pg_database,
pg_roles}, information_schema.{tables, columns}. Bare names resolve
too (PG search_path behavior for pg_catalog).
"""

from __future__ import annotations

import uuid

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.utils.metrics import count_swallowed

_PG_TYPE_NAMES = {
    DataType.INT8: "smallint", DataType.INT16: "smallint",
    DataType.INT32: "integer", DataType.INT64: "bigint",
    DataType.STRING: "text", DataType.FLOAT: "real",
    DataType.DOUBLE: "double precision", DataType.BOOL: "boolean",
    DataType.BINARY: "bytea", DataType.TIMESTAMP: "timestamp",
    DataType.COUNTER: "bigint", DataType.JSONB: "jsonb",
    DataType.LIST: "jsonb", DataType.SET: "jsonb", DataType.MAP: "jsonb",
}

_CANONICAL = {
    "pg_tables": "pg_catalog.pg_tables",
    "pg_class": "pg_catalog.pg_class",
    "pg_namespace": "pg_catalog.pg_namespace",
    "pg_database": "pg_catalog.pg_database",
    "pg_roles": "pg_catalog.pg_roles",
}


def is_virtual(table: str) -> bool:
    return (table in _CANONICAL
            or table.startswith("pg_catalog.")
            or table.startswith("information_schema."))


def _oid(name: str) -> int:
    return int(uuid.uuid5(uuid.NAMESPACE_DNS, name).hex[:6], 16)


def _user_tables(processor):
    out = []
    for name in sorted(processor.cluster.tables):
        try:
            schema = processor.cluster.table(name).schema
        except Exception as e:  # noqa: BLE001 — dropped concurrently
            count_swallowed("pg_vtables.table_schema", e)
            continue
        out.append((name, schema))
    return out


def _rows_for(processor, table: str) -> list[dict]:
    if table == "pg_catalog.pg_tables":
        return [{"schemaname": "public", "tablename": n,
                 "tableowner": "postgres", "hasindexes":
                 bool(getattr(processor.cluster.table(n), "indexes", []))}
                for n, _s in _user_tables(processor)]
    if table == "pg_catalog.pg_class":
        return [{"oid": _oid(n), "relname": n, "relkind": "r",
                 "relnamespace": _oid("public"),
                 "relnatts": len(s.columns)}
                for n, s in _user_tables(processor)]
    if table == "pg_catalog.pg_namespace":
        return [{"oid": _oid(ns), "nspname": ns}
                for ns in ("public", "pg_catalog", "information_schema")]
    if table == "pg_catalog.pg_database":
        return [{"datname": "yugabyte", "encoding": 6}]
    if table == "pg_catalog.pg_roles":
        store = getattr(processor.cluster, "auth_store", None)
        if store is None:
            return []
        return [{"rolname": r.name, "rolsuper": r.superuser,
                 "rolcanlogin": r.can_login}
                for r in store().list_roles()]
    if table == "information_schema.tables":
        return [{"table_catalog": "yugabyte", "table_schema": "public",
                 "table_name": n, "table_type": "BASE TABLE"}
                for n, _s in _user_tables(processor)]
    if table == "information_schema.columns":
        rows = []
        for n, s in _user_tables(processor):
            for i, c in enumerate(s.columns, start=1):
                rows.append({
                    "table_catalog": "yugabyte",
                    "table_schema": "public", "table_name": n,
                    "column_name": c.name, "ordinal_position": i,
                    "data_type": _PG_TYPE_NAMES.get(c.dtype, "text"),
                    "is_nullable": "YES" if c.nullable else "NO",
                })
        return rows
    from yugabyte_db_tpu_torch.utils.status import NotFound

    raise NotFound(f"relation {table} does not exist")


class _VCol:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name


class _VSchema:
    def __init__(self, names):
        self.columns = [_VCol(n) for n in names]


class _VHandle:
    def __init__(self, names):
        self.schema = _VSchema(names)


_COLUMN_ORDER = {
    "pg_catalog.pg_tables": ["schemaname", "tablename", "tableowner",
                             "hasindexes"],
    "pg_catalog.pg_class": ["oid", "relname", "relkind", "relnamespace",
                            "relnatts"],
    "pg_catalog.pg_namespace": ["oid", "nspname"],
    "pg_catalog.pg_database": ["datname", "encoding"],
    "pg_catalog.pg_roles": ["rolname", "rolsuper", "rolcanlogin"],
    "information_schema.tables": ["table_catalog", "table_schema",
                                  "table_name", "table_type"],
    "information_schema.columns": ["table_catalog", "table_schema",
                                   "table_name", "column_name",
                                   "ordinal_position", "data_type",
                                   "is_nullable"],
}


def virtual_select(processor, stmt):
    """Run a (join-free) SELECT against one catalog vtable through the
    executor's host projection pipeline."""
    table = _CANONICAL.get(stmt.table, stmt.table)
    dicts = _rows_for(processor, table)
    # Uncorrelated [NOT] EXISTS conjuncts fold once: a false one leaves
    # no rows, and an aggregate over them is PG's one zero-row
    # aggregate row (a departure from the JAX module, whose filter
    # below read the EXISTS conjunct as a column and raised).
    where, ok = processor._fold_exists(stmt.where)
    if not ok:
        dicts = []
    # WHERE: plain predicate filtering over the dict rows.
    where = processor._resolved_where(where)
    for rel in where:
        col = rel.column.split(".")[-1]

        def keep(d, rel=rel, col=col):
            v = d.get(col)
            rv = rel.value
            if rel.op == "IN":
                return v in rv
            if v is None or rv is None:
                return False
            return {"=": v == rv, "!=": v != rv, "<": v < rv,
                    "<=": v <= rv, ">": v > rv, ">=": v >= rv}[rel.op]
        dicts = [d for d in dicts if keep(d)]
    alias = stmt.alias or table
    handle = _VHandle(_COLUMN_ORDER[table])
    # The host pipeline's '*' expansion emits alias-qualified refs.
    for d in dicts:
        for k in list(d):
            d[f"{alias}.{k}"] = d[k]
    return processor._finish_select(stmt, dicts, [(alias, handle)],
                                    {alias: handle})