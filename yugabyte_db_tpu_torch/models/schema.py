"""Table schema: columns, key structure, ids.

Reference analog: src/yb/common/schema.h (Schema, ColumnSchema, ColumnId).
A schema is hash columns + range columns (together the primary key) +
regular value columns; key encoding order is hash cols then range cols
(models.encoding.encode_doc_key).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.encoding import encode_doc_key


class ColumnKind(enum.IntEnum):
    HASH = 0
    RANGE = 1
    REGULAR = 2
    STATIC = 3  # YCQL static columns (per-partition); stored as regular for now


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: DataType
    kind: ColumnKind = ColumnKind.REGULAR
    nullable: bool = True
    # Column ids are stable across ALTER TABLE (reference schema.h ColumnId);
    # assigned by Schema/catalog.
    col_id: int = -1
    # User-defined type name when this column is a (frozen) UDT; the
    # storage dtype is MAP, the declared type rides here for literal
    # validation + driver metadata (reference: QLType::udtype_field_names,
    # src/yb/yql/cql/ql/ptree/pt_create_type.cc).
    udt: str | None = None

    @property
    def is_key(self) -> bool:
        return self.kind in (ColumnKind.HASH, ColumnKind.RANGE)


class Schema:
    """Immutable table schema.

    Column order: hash columns, then range columns, then regular columns —
    the same normalized layout the reference keeps (schema.h: key columns
    first).
    """

    def __init__(self, columns: list[ColumnSchema], table_id: str = "",
                 version: int = 0, next_col_id: int | None = None):
        hash_cols = [c for c in columns if c.kind == ColumnKind.HASH]
        range_cols = [c for c in columns if c.kind == ColumnKind.RANGE]
        value_cols = [c for c in columns if not c.is_key]
        ordered = hash_cols + range_cols + value_cols
        # Assign stable column ids if unset (first schema version).
        self.columns: list[ColumnSchema] = []
        next_id = 10  # start above 0 to catch id/index confusion in tests
        used = {c.col_id for c in ordered if c.col_id >= 0}
        for c in ordered:
            if c.col_id < 0:
                while next_id in used:
                    next_id += 1
                c = ColumnSchema(c.name, c.dtype, c.kind, c.nullable,
                                 next_id, c.udt)
                used.add(next_id)
                next_id += 1
            self.columns.append(c)
        self.table_id = table_id
        self.version = version
        # Monotonic id allocator for ALTER TABLE ADD: never reuses a
        # DROPPED column's id (old row versions still carry it — a reused
        # id would resurrect their values under the new column).
        self.next_col_id = next_col_id if next_col_id is not None else \
            (max(used) + 1 if used else 10)
        self._by_name = {c.name: i for i, c in enumerate(self.columns)}
        if len(self._by_name) != len(self.columns):
            raise ValueError("duplicate column names")
        self.num_hash = len(hash_cols)
        self.num_range = len(range_cols)

    # -- structure ---------------------------------------------------------
    @property
    def hash_columns(self) -> list[ColumnSchema]:
        return self.columns[: self.num_hash]

    @property
    def range_columns(self) -> list[ColumnSchema]:
        return self.columns[self.num_hash: self.num_hash + self.num_range]

    @property
    def key_columns(self) -> list[ColumnSchema]:
        return self.columns[: self.num_hash + self.num_range]

    @property
    def value_columns(self) -> list[ColumnSchema]:
        return self.columns[self.num_hash + self.num_range:]

    def column_index(self, name: str) -> int:
        if name not in self._by_name:
            raise KeyError(f"no column {name!r}")
        return self._by_name[name]

    def column(self, name: str) -> ColumnSchema:
        return self.columns[self.column_index(name)]

    def has_column(self, name: str) -> bool:
        return name in self._by_name

    # -- key encoding ------------------------------------------------------
    def encode_primary_key(self, key_values: dict, hash_code: int) -> bytes:
        """Encode the DocKey for a row given its key column values."""
        hashed = [(key_values[c.name], c.dtype) for c in self.hash_columns]
        ranges = [(key_values[c.name], c.dtype) for c in self.range_columns]
        return encode_doc_key(hash_code if self.num_hash else None, hashed, ranges)

    # -- evolution (ALTER TABLE; reference: schema evolution keyed by
    # stable ColumnIds + a schema version, catalog_manager AlterTable) ---
    def with_added_column(self, name: str, dtype: DataType) -> "Schema":
        if self.has_column(name):
            raise ValueError(f"column {name} already exists")
        new = ColumnSchema(name, dtype, ColumnKind.REGULAR, True,
                           self.next_col_id)
        return Schema(self.columns + [new], self.table_id,
                      self.version + 1, self.next_col_id + 1)

    def with_dropped_column(self, name: str) -> "Schema":
        col = self.column(name)
        if col.is_key:
            raise ValueError(f"cannot drop key column {name}")
        cols = [c for c in self.columns if c.name != name]
        return Schema(cols, self.table_id, self.version + 1,
                      self.next_col_id)

    def with_renamed_column(self, old: str, new: str) -> "Schema":
        if self.has_column(new):
            raise ValueError(f"column {new} already exists")
        col = self.column(old)  # raises if absent
        cols = [ColumnSchema(new, c.dtype, c.kind, c.nullable, c.col_id)
                if c.name == old else c for c in self.columns]
        return Schema(cols, self.table_id, self.version + 1,
                      self.next_col_id)

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{c.name}:{c.dtype.name}:{c.kind.name}" for c in self.columns)
        return f"Schema[{cols}]"

    def to_dict(self) -> dict:
        return {
            "table_id": self.table_id,
            "version": self.version,
            "next_col_id": self.next_col_id,
            "columns": [
                {"name": c.name, "dtype": int(c.dtype), "kind": int(c.kind),
                 "nullable": c.nullable, "col_id": c.col_id,
                 **({"udt": c.udt} if c.udt else {})}
                for c in self.columns
            ],
        }

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        cols = [
            ColumnSchema(c["name"], DataType(c["dtype"]), ColumnKind(c["kind"]),
                         c["nullable"], c["col_id"], c.get("udt"))
            for c in d["columns"]
        ]
        return Schema(cols, d.get("table_id", ""), d.get("version", 0),
                      d.get("next_col_id"))
