"""Index schema derivation and write-path mutation computation.

An index on columns (C1..Cn) of base table T — optionally COVERING
columns (X1..Xm) — is itself a table:

    hash keys:  C1..Cn (the indexed columns, compound hash)
    range keys: T's primary key columns, in order
    values:     the covered columns (INCLUDE list)

so an equality lookup on all indexed columns is a hash-routed scan of
the index table whose rows decode straight back into base-table primary
keys — and, when the query only touches indexed + key + covered
columns, the index table answers it WITHOUT reading the base table
(reference: IndexInfo's indexed + covered column mapping,
src/yb/common/index.h).

Maintenance (Tablet::UpdateQLIndexes, tablet.cc:1015): on a base-table
write the leader compares old vs new indexed/covered values; a changed
indexed tuple yields a tombstone for the old index row and an insert of
the new one; a covered-only change rewrites the entry in place. A row
has an index entry only while EVERY indexed column is non-NULL.

The port's copy of the JAX package's ``index/maintenance.py``, whole.
"""

from __future__ import annotations

from yugabyte_db_tpu_torch.models.partition import compute_hash_code
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema, Schema
from yugabyte_db_tpu_torch.storage.row_version import RowVersion


def normalize_index(idx: dict) -> dict:
    """Canonical descriptor: {"name", "columns": [...], "include": [...],
    "index_table"}; accepts the legacy single-"column" form (older
    catalog/WAL records)."""
    columns = list(idx.get("columns") or
                   ([idx["column"]] if idx.get("column") else []))
    out = dict(idx)
    out["columns"] = columns
    out["include"] = list(idx.get("include") or [])
    if columns and "column" not in out:
        out["column"] = columns[0]  # legacy readers
    return out


def index_table_name(base_table: str, columns, index_name=None) -> str:
    if isinstance(columns, str):
        columns = [columns]
    if index_name:
        if "." in base_table and "." not in index_name:
            ks = base_table.rsplit(".", 1)[0]
            return f"{ks}.{index_name}"
        return index_name
    return f"{base_table}__idx__{'_'.join(columns)}"


def index_schema(base_schema: Schema, columns, index_table: str,
                 include=()) -> Schema:
    """Derive the index table's schema from the base schema."""
    if isinstance(columns, str):
        columns = [columns]
    cols = []
    for name in columns:
        c = base_schema.column(name)
        if c.is_key:
            raise ValueError(f"cannot index key column {name}")
        cols.append(ColumnSchema(name, c.dtype, ColumnKind.HASH))
    for kc in base_schema.key_columns:
        cols.append(ColumnSchema(kc.name, kc.dtype, ColumnKind.RANGE))
    for name in include:
        c = base_schema.column(name)
        if c.is_key or name in columns:
            raise ValueError(f"cannot cover column {name}")
        cols.append(ColumnSchema(name, c.dtype))
    return Schema(cols, table_id=index_table)


def index_entry(index_schema_: Schema, indexed_values,
                base_key_values: dict, covered: dict | None = None):
    """An index row for (values, base PK) — backfill's unit.
    ``indexed_values``: one value (legacy) or a list matching the
    index's hash columns; ``covered``: {name: value} for INCLUDE cols."""
    if not isinstance(indexed_values, (list, tuple)):
        indexed_values = [indexed_values]
    return _entry(index_schema_, list(indexed_values), base_key_values,
                  tombstone=False, covered=covered or {})


def _entry(index_schema_: Schema, indexed_values: list,
           base_key_values: dict, tombstone: bool,
           covered: dict | None = None) -> tuple[int, RowVersion]:
    """One index-table row: returns (hash_code, RowVersion)."""
    kv = {c.name: v for c, v in zip(index_schema_.hash_columns,
                                    indexed_values)}
    kv.update(base_key_values)
    hash_code = compute_hash_code(index_schema_, kv)
    key = index_schema_.encode_primary_key(kv, hash_code)
    if tombstone:
        return hash_code, RowVersion(key, ht=0, tombstone=True)
    columns = {}
    for c in index_schema_.value_columns:
        if covered and c.name in covered:
            columns[c.col_id] = covered[c.name]
    return hash_code, RowVersion(key, ht=0, liveness=True,
                                 columns=columns)


def index_mutations(base_schema: Schema, indexes: list[dict],
                    base_key_values: dict, old_values: dict | None,
                    new_row: RowVersion):
    """Index-table writes for one base-table write.

    ``old_values``: the row's current merged column values by NAME (None
    if the row didn't exist); ``new_row``: the incoming base write.
    Yields (index_table, index_schema, hash_code, RowVersion)."""
    col_by_id = {c.col_id: c.name for c in base_schema.value_columns}
    new_by_name = {col_by_id[cid]: v for cid, v in new_row.columns.items()
                   if cid in col_by_id}

    def merged(name):
        if new_row.tombstone:
            return None
        if name in new_by_name:
            return new_by_name[name]
        return (old_values or {}).get(name)

    for idx in indexes:
        idx = normalize_index(idx)
        columns = idx["columns"]
        include = idx["include"]
        ischema = index_schema(base_schema, columns,
                               idx["index_table"], include)
        old_t = ([(old_values or {}).get(c) for c in columns]
                 if old_values is not None else None)
        new_t = [merged(c) for c in columns]
        old_valid = old_t is not None and all(v is not None for v in old_t)
        new_valid = (not new_row.tombstone
                     and all(v is not None for v in new_t))
        old_cov = {c: (old_values or {}).get(c) for c in include}
        new_cov = {c: merged(c) for c in include}
        if old_valid and (not new_valid or old_t != new_t):
            hc, rv = _entry(ischema, old_t, base_key_values,
                            tombstone=True)
            yield idx["index_table"], ischema, hc, rv
        if new_valid and (not old_valid or old_t != new_t
                          or old_cov != new_cov):
            hc, rv = _entry(ischema, new_t, base_key_values,
                            tombstone=False, covered=new_cov)
            yield idx["index_table"], ischema, hc, rv
