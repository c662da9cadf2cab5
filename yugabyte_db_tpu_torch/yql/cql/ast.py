"""CQL parse-tree nodes.

Reference analog: the PT* node hierarchy of src/yb/yql/cql/ql/ptree/
(pt_select.h, pt_insert.h, pt_update.h, pt_delete.h, pt_create_table.h,
pt_create_keyspace.h, ...). Statements parse into these dataclasses, the
processor's binder resolves names against the catalog, and the executor
lowers them to storage operations.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.models.datatypes import DataType


@dataclass(frozen=True)
class BindMarker:
    """A ``?`` placeholder; resolved against execute-time params by
    position (reference: PTBindVar, src/yb/yql/cql/ql/ptree/pt_expr.h)."""

    index: int


@dataclass
class ColumnDef:
    name: str
    dtype: DataType
    is_static: bool = False
    udt: str | None = None         # declared user-defined type name


@dataclass
class CreateKeyspace:
    name: str
    if_not_exists: bool = False


@dataclass
class DropKeyspace:
    name: str
    if_exists: bool = False


@dataclass
class UseKeyspace:
    name: str


@dataclass
class CreateRole:
    """CREATE ROLE r [WITH PASSWORD = '..' [AND LOGIN = b] [AND
    SUPERUSER = b]] (reference: PTCreateRole / master CreateRole RPC,
    src/yb/master/master.proto:1383)."""

    name: str
    password: str | None = None
    can_login: bool = False
    superuser: bool = False
    if_not_exists: bool = False


@dataclass
class AlterRole:
    name: str
    password: str | None = None
    can_login: bool | None = None
    superuser: bool | None = None


@dataclass
class DropRole:
    name: str
    if_exists: bool = False


@dataclass
class GrantRevokeRole:
    """GRANT r TO m / REVOKE r FROM m (master.proto:1386)."""

    grant: bool
    role: str
    member: str


@dataclass
class GrantRevokePermission:
    """GRANT/REVOKE <perm> ON <resource> TO/FROM role
    (master.proto:1388). resource uses the hierarchical form of
    yugabyte_db_tpu_torch.auth ("data", "data/ks", "data/ks/t", "roles",
    "roles/r")."""

    grant: bool
    permission: str            # ALL or one of auth.PERMISSIONS
    resource: str
    role: str


@dataclass
class ListRoles:
    pass


@dataclass
class ListPermissions:
    pass


@dataclass
class CreateTable:
    name: str                      # possibly keyspace-qualified "ks.t"
    columns: list[ColumnDef]
    hash_keys: list[str]
    range_keys: list[str]
    if_not_exists: bool = False
    properties: dict = field(default_factory=dict)  # WITH k = v (tablets=N)


@dataclass
class Batch:
    """BEGIN [UNLOGGED] BATCH ... APPLY BATCH: a client-grouped list of
    DML statements (per-tablet atomicity, reference: exec of PTListNode
    batches in executor.cc)."""

    statements: list
    logged: bool = True


@dataclass
class AlterTable:
    """ALTER TABLE t ADD col type | DROP col | RENAME a TO b."""

    name: str
    action: str                    # "add" | "drop" | "rename"
    column: str | None = None
    dtype: object = None           # DataType for "add"
    new_name: str | None = None    # for "rename"


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class CreateIndex:
    name: str                      # index name
    table: str                     # base table (possibly qualified)
    columns: list                  # indexed columns (compound hash)
    if_not_exists: bool = False
    include: list = field(default_factory=list)  # covered columns


@dataclass
class CreateType:
    """CREATE TYPE name (field type, ...) — reference:
    src/yb/yql/cql/ql/ptree/pt_create_type.cc."""

    name: str
    fields: list                   # [(field_name, DataType)]
    if_not_exists: bool = False


@dataclass
class DropType:
    name: str
    if_exists: bool = False


@dataclass
class DropIndex:
    name: str
    if_exists: bool = False


@dataclass
class Relation:
    """column <op> literal (op: = != < <= > >= IN)."""

    column: str
    op: str
    value: object


@dataclass
class SelectItem:
    """A projection item: a column, or an aggregate over a column/'*'/
    an arithmetic expression (storage.expr tree) — the TPC-H
    sum(price * (1 - disc)) shape."""

    column: str | None          # None for fn(*) / expression aggregates
    agg_fn: str | None = None   # count/sum/min/max/avg or None for plain col
    alias: str | None = None
    expr: object = None         # storage.expr tree for fn(<arith expr>)

    @property
    def output_name(self) -> str:
        if self.alias:
            return self.alias
        if self.agg_fn:
            return f"{self.agg_fn}({self.column or ('<expr>' if self.expr else '*')})"
        return self.column


@dataclass
class Select:
    table: str
    items: list[SelectItem] | None   # None = '*'
    where: list[Relation] = field(default_factory=list)
    limit: int | None = None
    allow_filtering: bool = False
    group_by: list[str] = field(default_factory=list)
    order_by: list[tuple] = field(default_factory=list)  # (name, desc)


@dataclass
class Insert:
    table: str
    columns: list[str]
    values: list[object]
    ttl_seconds: int | None = None
    if_not_exists: bool = False


@dataclass
class CollectionOp:
    """UPDATE SET rhs that edits a collection in place:
    v = v + [...], v = [...] + v (prepend), v = v - {...},
    v[idx_or_key] = x. Evaluated read-modify-write at the executor
    (the reference writes per-element subdocuments without a read —
    the observable end state matches for serialized writers)."""

    op: str            # "append" | "prepend" | "remove" | "setelem"
    operand: object    # the literal collection / element value
    index: object = None  # for "setelem": list index or map key


@dataclass
class Update:
    table: str
    assignments: list[tuple[str, object]]
    where: list[Relation]
    ttl_seconds: int | None = None


@dataclass
class Delete:
    table: str
    where: list[Relation]
    columns: list[str] | None = None   # DELETE col[, col] FROM — col deletes
