"""QLProcessor: parse -> bind -> execute CQL against tablets.

Reference analog: ql::QLProcessor (src/yb/yql/cql/ql/ql_processor.h:55) with
its Prepare (parse+analyze) and Execute phases; execution lowers statements
to per-tablet read/write operations the way exec/executor.cc builds
QLReadRequestPB/QLWriteRequestPB and routes them through the client
(Batcher groups ops per tablet, src/yb/client/batcher.h:80).

The storage seam here is the ``Cluster`` protocol (create/drop/route/scan);
``LocalCluster`` runs tablets in-process (the MiniCluster test shape), and
the distributed client implements the same surface on top of the master
catalog + tserver RPCs.

The port's copy of the JAX package's ``yql/cql/processor.py``. Its one
departure: ``LocalCluster``'s engine defaults to ``"gpu"`` (the JAX
default ``"cpu"`` is not registered in the port, and naming it raises
``ValueError`` at construction, as ``make_engine`` does; ROADMAP.md §1
item 16). ``engine_options`` reaches every tablet: without it they run
on the card, with ``{"device": "cpu"}`` on the plain versions.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.encoding import (encode_doc_key_prefix,
                                             encode_key_component,
                                             prefix_successor)
from yugabyte_db_tpu_torch.models.partition import (PartitionSchema,
                                              compute_hash_code)
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema, Schema
from yugabyte_db_tpu_torch.storage.engine import require_engine
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT, RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import AggSpec, Predicate, ScanSpec
from yugabyte_db_tpu_torch.tablet.tablet import Tablet, TabletMetadata
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridClock
from yugabyte_db_tpu_torch.utils.metrics import count_swallowed
from yugabyte_db_tpu_torch.utils.status import (AlreadyPresent, InvalidArgument,
                                          NotFound)
from yugabyte_db_tpu_torch.yql.cql import ast
from yugabyte_db_tpu_torch.yql.cql.parser import parse_statement


@dataclass
class ResultSet:
    """Rows returned to the driver (reference: QLRowBlock serialized into
    the CQL RESULT message)."""

    columns: list[str] = field(default_factory=list)
    rows: list[tuple] = field(default_factory=list)
    # Continuation token when a page filled before the scan finished
    # (reference: QLPagingStatePB riding the RESULT message).
    paging_state: bytes | None = None
    # Wire path: when set, the result is pre-serialized CQL cell bytes
    # (wire_rows rows) the server forwards verbatim — rows stays empty
    # (the rows_data contract, src/yb/common/ql_rowblock.h:66).
    wire_data: bytes | None = None
    wire_rows: int = 0

    def __iter__(self):
        return iter(self.rows)

    def dicts(self) -> list[dict]:
        return [dict(zip(self.columns, r)) for r in self.rows]


# -- cluster seam ------------------------------------------------------------

@dataclass
class TableHandle:
    name: str
    schema: Schema
    partition_schema: PartitionSchema
    tablets: list[Tablet]
    indexes: list = field(default_factory=list)  # [{"name","column","index_table"}]


class LocalCluster:
    """In-process tablet host: every table is num_tablets Tablets in one
    process (reference test shape: MiniCluster,
    src/yb/integration-tests/mini_cluster.h:92)."""

    def __init__(self, data_root: str | None = None, num_tablets: int = 4,
                 engine: str = "gpu", fsync: bool = False,
                 engine_options: dict | None = None):
        self._own_dir = data_root is None
        self.data_root = data_root or tempfile.mkdtemp(prefix="yb_tpu_")
        self.num_tablets = num_tablets
        self.engine = engine
        self.engine_options = engine_options
        self.fsync = fsync
        self.clock = HybridClock()
        self.tables: dict[str, TableHandle] = {}
        # User-defined types: name -> [(field, dtype int)].
        self.types: dict[str, list] = {}
        # SQL views (name -> defining query SQL) and sequences
        # (name -> next value) — in-process registries; the distributed
        # seam replicates them through the master catalog.
        self.views: dict[str, str] = {}
        self.sequences: dict[str, int] = {}
        # CQL keyspaces — cluster-wide (shared by every session; the
        # distributed seam replicates them through the master catalog).
        self.user_keyspaces: set[str] = set()
        self._seq_lock = __import__("threading").Lock()
        from yugabyte_db_tpu_torch.auth import RoleStore

        self._auth = RoleStore()
        require_engine(engine)

    def auth_store(self):
        return self._auth

    def auth_op(self, op: dict) -> None:
        self._auth.apply(op)

    # -- keyspaces (shared across sessions) ---------------------------------
    def create_keyspace(self, name: str) -> None:
        from yugabyte_db_tpu_torch.utils.status import AlreadyPresent

        if name in self.user_keyspaces:
            raise AlreadyPresent(f"keyspace {name} exists")
        self.user_keyspaces.add(name)

    def drop_keyspace(self, name: str) -> None:
        self.user_keyspaces.discard(name)

    def list_keyspaces(self) -> set:
        return set(self.user_keyspaces)

    def create_table(self, name: str, schema: Schema,
                     num_tablets: int | None = None) -> TableHandle:
        if name in self.tables:
            raise AlreadyPresent(f"table {name} exists")
        n = num_tablets or self.num_tablets
        pschema = PartitionSchema(n, hash_partitioned=schema.num_hash > 0)
        tablets = []
        for i, part in enumerate(pschema.create_partitions()):
            meta = TabletMetadata(
                tablet_id=f"{name}-t{i:04d}", table_name=name, schema=schema,
                partition_start=part.start, partition_end=part.end,
                engine=self.engine)
            tablets.append(Tablet.create(
                meta, os.path.join(self.data_root, name), clock=self.clock,
                fsync=self.fsync, engine_options=self.engine_options))
        handle = TableHandle(name, schema, pschema, tablets)
        self.tables[name] = handle
        return handle

    def drop_table(self, name: str) -> None:
        handle = self.tables.pop(name, None)
        if handle is None:
            raise NotFound(f"table {name} not found")
        for t in handle.tablets:
            t.close()
        shutil.rmtree(os.path.join(self.data_root, name), ignore_errors=True)

    def table(self, name: str) -> TableHandle:
        if name not in self.tables:
            raise NotFound(f"table {name} not found")
        return self.tables[name]

    def tablet_for_hash(self, handle: TableHandle, hash_code: int) -> Tablet:
        idx = handle.partition_schema.partition_index_for_hash(hash_code)
        return handle.tablets[idx]

    def create_index(self, base: TableHandle, name: str,
                     columns, include=()) -> str:
        from yugabyte_db_tpu_torch.index import index_schema, index_table_name

        if isinstance(columns, str):
            columns = [columns]

        itable = index_table_name(base.name, columns, name)
        ischema = index_schema(base.schema, columns, itable, include)
        self.create_table(itable, ischema, num_tablets=len(base.tablets))
        base.indexes.append({"name": name, "column": columns[0],
                             "columns": list(columns),
                             "include": list(include),
                             "index_table": itable})
        return itable

    def drop_index(self, base: TableHandle, name: str) -> None:
        idx = next(i for i in base.indexes if i["name"] == name)
        base.indexes.remove(idx)
        self.drop_table(idx["index_table"])

    # -- user-defined types -------------------------------------------------
    def create_type(self, name: str, fields: list) -> None:
        self.types[name] = [tuple(f) for f in fields]

    def drop_type(self, name: str) -> None:
        for h in self.tables.values():
            for c in h.schema.columns:
                if c.udt == name:
                    raise InvalidArgument(
                        f"type {name} in use by table {h.name}")
        self.types.pop(name, None)

    def get_type(self, name: str):
        return self.types.get(name)

    def list_types(self) -> dict:
        return dict(self.types)

    # -- views / sequences --------------------------------------------------
    def create_view(self, name: str, query_sql: str,
                    replace: bool = False) -> None:
        if not replace and name in self.views:
            raise AlreadyPresent(f"view {name} exists")
        self.views[name] = query_sql

    def drop_view(self, name: str) -> None:
        if name not in self.views:
            raise NotFound(f"view {name} not found")
        del self.views[name]

    def get_view(self, name: str):
        return self.views.get(name)

    def create_sequence(self, name: str) -> None:
        with self._seq_lock:
            if name in self.sequences:
                raise AlreadyPresent(f"sequence {name} exists")
            self.sequences[name] = 1

    def drop_sequence(self, name: str) -> None:
        with self._seq_lock:
            if name not in self.sequences:
                raise NotFound(f"sequence {name} not found")
            del self.sequences[name]

    def sequence_next(self, name: str, n: int = 1) -> int:
        """Allocate ``n`` values; returns the first (PG nextval blocks
        may leave holes — same contract)."""
        with self._seq_lock:
            if name not in self.sequences:
                raise NotFound(f"sequence {name} not found")
            base = self.sequences[name]
            self.sequences[name] = base + n
            return base

    def alter_table(self, handle: TableHandle, new_schema: Schema) -> None:
        for t in handle.tablets:
            t.alter_schema(new_schema)
        handle.schema = new_schema

    def maintain_indexes(self, handle: TableHandle, base_key_values: dict,
                         old_values: dict | None, row) -> None:
        """Apply index mutations for one base write (the LocalCluster
        analog of the tserver leader's Tablet::UpdateQLIndexes hook)."""
        from yugabyte_db_tpu_torch.index import index_mutations

        for itable, _is, hc, rv in index_mutations(
                handle.schema, handle.indexes, base_key_values,
                old_values, row):
            ih = self.table(itable)
            self.tablet_for_hash(ih, hc).write([rv])

    def close(self) -> None:
        for h in list(self.tables.values()):
            for t in h.tablets:
                t.close()
        self.tables.clear()
        if self._own_dir:
            shutil.rmtree(self.data_root, ignore_errors=True)


# -- the processor -----------------------------------------------------------

class Unauthorized(Exception):
    """Role lacks the permission a statement requires (fails closed;
    reference: UnauthorizedException from the CQL analyzer)."""


@dataclass
class _SelectPlan:
    """Planned SELECT routing: one tablet (hash fully bound) or fanout,
    plus the pushdown payload."""

    single: bool
    hash_code: int | None
    lower: bytes
    upper: bytes
    predicates: list
    projection: list | None
    aggregates: list
    group_by: list


@dataclass
class _PointStmtPlan:
    """Params-independent half of a prepared point SELECT's plan, cached
    per statement for the request-batch serving path: the '='-bound key
    relations (values still carry the bind markers), the projection, and
    the resolved handle. Per frame only coerce + encode + route remain."""

    stmt: object          # pins the statement so id() can't alias
    schema: object        # replan sentinel: compared by identity
    handle: object
    hash_rels: list       # [(ColumnSchema, ast.Relation)] hash order
    range_rels: list      # [(ColumnSchema, ast.Relation)] prefix order
    projection: list
    names: list


@dataclass
class _PointBounds:
    """Per-frame output of the cached point plan — the fields the batch
    serving loop reads (duck-typed subset of _SelectPlan)."""

    lower: bytes
    upper: bytes
    predicates: list


class QLProcessor:
    """One CQL session: keyspace state + statement execution.

    ``login_role`` is the authenticated role (set by the wire server's
    auth handshake). Enforcement is active when the
    ``use_cassandra_authentication`` flag is on: every statement then
    requires the matching permission on its resource, checked against
    the cluster's replicated role store (fails closed; reference:
    enforcement in the CQL analyzer against the auth vtables)."""

    _BUILTIN_KEYSPACES = frozenset({"default", "system"})

    def __init__(self, cluster: LocalCluster, login_role: str | None = None):
        self.cluster = cluster
        self.keyspace = "default"
        self.login_role = login_role
        # Structural plan cache for the request-batch serving path:
        # (id(stmt), keyspace) -> _PointStmtPlan. Statements live in the
        # server's prepared cache, so ids are stable; each entry pins its
        # stmt anyway so a collected id can never alias.
        self._point_stmt_cache: dict = {}

    @property
    def keyspaces(self) -> set:
        """All known keyspaces: the built-ins plus the cluster-wide
        registry (shared across connections — the reference keeps
        namespaces in the master sys catalog)."""
        return set(self._BUILTIN_KEYSPACES) | self.cluster.list_keyspaces()

    # -- entry points ------------------------------------------------------
    def execute(self, sql, params: list | None = None,
                page_size: int | None = None,
                paging_state: bytes | None = None,
                wire_results: bool = False) -> ResultSet | None:
        """Run one statement. ``sql`` may be a string or a pre-parsed AST
        (the prepared-statement cache passes ASTs). ``params`` binds ``?``
        markers by position; ``page_size``/``paging_state`` drive SELECT
        paging (reference: QLProcessor::RunAsync with a paged
        StatementParameters, ql_processor.h:86). ``wire_results=True``
        (the CQL socket server) lets eligible SELECTs return
        pre-serialized cell bytes (ResultSet.wire_data) instead of row
        tuples — the rows_data contract."""
        stmt = parse_statement(sql) if isinstance(sql, str) else sql
        self._params = params or []
        self._page_size = page_size
        self._paging_state = paging_state
        self._wire_results = wire_results
        self._enforce(stmt)
        fn = {
            ast.CreateKeyspace: self._exec_create_keyspace,
            ast.DropKeyspace: self._exec_drop_keyspace,
            ast.UseKeyspace: self._exec_use,
            ast.CreateTable: self._exec_create_table,
            ast.DropTable: self._exec_drop_table,
            ast.AlterTable: self._exec_alter_table,
            ast.CreateIndex: self._exec_create_index,
            ast.DropIndex: self._exec_drop_index,
            ast.CreateType: self._exec_create_type,
            ast.DropType: self._exec_drop_type,
            ast.Insert: self._exec_insert,
            ast.Update: self._exec_update,
            ast.Delete: self._exec_delete,
            ast.Select: self._exec_select,
            ast.Batch: self._exec_batch,
            ast.CreateRole: self._exec_create_role,
            ast.AlterRole: self._exec_alter_role,
            ast.DropRole: self._exec_drop_role,
            ast.GrantRevokeRole: self._exec_grant_revoke_role,
            ast.GrantRevokePermission: self._exec_grant_revoke_perm,
            ast.ListRoles: self._exec_list_roles,
            ast.ListPermissions: self._exec_list_permissions,
        }[type(stmt)]
        return fn(stmt)

    # -- authorization -----------------------------------------------------
    def _table_resource(self, name: str) -> str:
        ks, table = self._qualify(name).split(".", 1)
        return f"data/{ks}/{table}"

    def _stmt_permission(self, stmt):
        """(permission, resource) a statement requires, or None."""
        if isinstance(stmt, ast.Select):
            from yugabyte_db_tpu_torch.yql.cql import vtables

            # Any authenticated role may read the system vtables (the
            # driver handshake path; Cassandra behaves the same).
            if vtables.is_virtual(self._qualify(stmt.table)):
                return None
            return ("SELECT", self._table_resource(stmt.table))
        if isinstance(stmt, (ast.Insert, ast.Update, ast.Delete)):
            return ("MODIFY", self._table_resource(stmt.table))
        if isinstance(stmt, ast.Batch):
            for s in stmt.statements:
                self._check_perm(*self._stmt_permission(s))
            return None
        if isinstance(stmt, ast.CreateTable):
            ks = self._qualify(stmt.name).split(".", 1)[0]
            return ("CREATE", f"data/{ks}")
        if isinstance(stmt, ast.DropTable):
            return ("DROP", self._table_resource(stmt.name))
        if isinstance(stmt, ast.AlterTable):
            return ("ALTER", self._table_resource(stmt.name))
        if isinstance(stmt, ast.CreateIndex):
            return ("ALTER", self._table_resource(stmt.table))
        if isinstance(stmt, ast.DropIndex):
            return ("ALTER", "data")
        if isinstance(stmt, ast.CreateKeyspace):
            return ("CREATE", "data")
        if isinstance(stmt, ast.DropKeyspace):
            return ("DROP", f"data/{stmt.name}")
        if isinstance(stmt, (ast.CreateRole, ast.AlterRole, ast.DropRole,
                             ast.GrantRevokeRole,
                             ast.GrantRevokePermission)):
            return ("AUTHORIZE", "roles")
        return None  # USE, LIST: any authenticated role

    def _enforce(self, stmt) -> None:
        from yugabyte_db_tpu_torch.utils.flags import FLAGS

        if not FLAGS.get("use_cassandra_authentication"):
            return
        if self.login_role is None:
            raise Unauthorized("not authenticated")
        need = self._stmt_permission(stmt)
        if need is not None:
            self._check_perm(*need)

    def _check_perm(self, perm: str, resource: str) -> None:
        if not self.cluster.auth_store().authorize(
                self.login_role, perm, resource):
            raise Unauthorized(
                f"role {self.login_role} has no {perm} permission on "
                f"{resource}")

    # -- role DDL ----------------------------------------------------------
    def _exec_create_role(self, stmt: ast.CreateRole):
        from yugabyte_db_tpu_torch import auth as A

        op = {"op": "auth_create_role", "name": stmt.name,
              "can_login": stmt.can_login, "superuser": stmt.superuser,
              "salted_hash": (A.hash_password(stmt.password)
                              if stmt.password is not None else "")}
        try:
            self.cluster.auth_op(op)
        except (AlreadyPresent, InvalidArgument):
            if not stmt.if_not_exists:
                raise
        return None

    def _exec_alter_role(self, stmt: ast.AlterRole):
        from yugabyte_db_tpu_torch import auth as A

        op = {"op": "auth_alter_role", "name": stmt.name}
        if stmt.password is not None:
            op["salted_hash"] = A.hash_password(stmt.password)
        if stmt.can_login is not None:
            op["can_login"] = stmt.can_login
        if stmt.superuser is not None:
            op["superuser"] = stmt.superuser
        self.cluster.auth_op(op)
        return None

    def _exec_drop_role(self, stmt: ast.DropRole):
        try:
            self.cluster.auth_op({"op": "auth_drop_role",
                                  "name": stmt.name})
        except (NotFound, InvalidArgument):
            if not stmt.if_exists:
                raise
        return None

    def _exec_grant_revoke_role(self, stmt: ast.GrantRevokeRole):
        self.cluster.auth_op({
            "op": "auth_grant_role" if stmt.grant else "auth_revoke_role",
            "role": stmt.role, "member": stmt.member})
        return None

    def _exec_grant_revoke_perm(self, stmt: ast.GrantRevokePermission):
        resource = stmt.resource
        if resource.startswith("data//"):
            # unqualified table: resolve against the session keyspace
            resource = f"data/{self.keyspace}/{resource[len('data//'):]}"
        self.cluster.auth_op({
            "op": "auth_grant_perm" if stmt.grant else "auth_revoke_perm",
            "role": stmt.role, "resource": resource,
            "perm": stmt.permission})
        return None

    def _exec_list_roles(self, _stmt):
        rows = [(r.name, r.can_login, r.superuser,
                 sorted(r.member_of))
                for r in self.cluster.auth_store().list_roles()]
        return ResultSet(["role", "can_login", "is_superuser",
                          "member_of"], rows)

    def _exec_list_permissions(self, _stmt):
        return ResultSet(["role", "resource", "permission"],
                         self.cluster.auth_store().list_perms())

    # -- name resolution ---------------------------------------------------
    def _qualify(self, name: str) -> str:
        return name if "." in name else f"{self.keyspace}.{name}"

    # -- DDL ---------------------------------------------------------------
    def _exec_create_keyspace(self, stmt: ast.CreateKeyspace):
        if stmt.name in self.keyspaces:
            if not stmt.if_not_exists:
                raise AlreadyPresent(f"keyspace {stmt.name} exists")
            return None
        try:
            self.cluster.create_keyspace(stmt.name)
        except AlreadyPresent:
            # Lost a create race: same end state.
            if not stmt.if_not_exists:
                raise
        return None

    def _exec_drop_keyspace(self, stmt: ast.DropKeyspace):
        if stmt.name in self._BUILTIN_KEYSPACES:
            raise InvalidArgument(
                f"keyspace {stmt.name} cannot be dropped")
        if stmt.name not in self.keyspaces:
            if not stmt.if_exists:
                raise NotFound(f"keyspace {stmt.name} not found")
            return None
        in_use = [t for t in self.cluster.tables
                  if t.startswith(stmt.name + ".")]
        if in_use:
            raise InvalidArgument(f"keyspace {stmt.name} is not empty")
        try:
            self.cluster.drop_keyspace(stmt.name)
        except NotFound:
            # Lost a drop race: same end state.
            if not stmt.if_exists:
                raise
        return None

    def _exec_use(self, stmt: ast.UseKeyspace):
        if stmt.name not in self.keyspaces:
            raise NotFound(f"keyspace {stmt.name} not found")
        self.keyspace = stmt.name
        return None

    def _exec_create_table(self, stmt: ast.CreateTable):
        name = self._qualify(stmt.name)
        if name in self.cluster.tables:
            if stmt.if_not_exists:
                return None
            raise AlreadyPresent(f"table {name} exists")
        by_name = {c.name: c for c in stmt.columns}
        for k in stmt.hash_keys + stmt.range_keys:
            if k not in by_name:
                raise InvalidArgument(f"primary key column {k} not defined")
        cols = []
        for c in stmt.columns:
            if c.name in stmt.hash_keys:
                kind = ColumnKind.HASH
            elif c.name in stmt.range_keys:
                kind = ColumnKind.RANGE
            elif c.is_static:
                kind = ColumnKind.STATIC
            else:
                kind = ColumnKind.REGULAR
            if kind in (ColumnKind.HASH, ColumnKind.RANGE) and \
                    c.dtype in (DataType.FLOAT, DataType.DOUBLE):
                raise InvalidArgument(
                    f"floating-point column {c.name} cannot be a key column")
            udt = None
            if getattr(c, "udt", None):
                udt = self._qualify(c.udt) if "." not in c.udt else c.udt
                if self.cluster.get_type(udt) is None:
                    raise InvalidArgument(f"unknown type {c.udt}")
                if kind != ColumnKind.REGULAR:
                    raise InvalidArgument(
                        f"UDT column {c.name} cannot be a key column")
            cols.append(ColumnSchema(c.name, c.dtype, kind,
                                     nullable=kind == ColumnKind.REGULAR,
                                     udt=udt))
        schema = Schema(cols, table_id=name)
        num_tablets = stmt.properties.get("tablets")
        self.cluster.create_table(name, schema, num_tablets)
        return None

    def _exec_alter_table(self, stmt: ast.AlterTable):
        """Schema evolution by stable column ids (reference:
        catalog_manager AlterTable -> tablet AlterSchema). ADD columns are
        NULL for existing rows; DROP retires the id (never reused);
        RENAME touches no data."""
        from yugabyte_db_tpu_torch.yql.common import evolve_schema

        handle = self.cluster.table(self._qualify(stmt.name))
        self.cluster.alter_table(handle, evolve_schema(
            handle, stmt.action, stmt.column, stmt.dtype, stmt.new_name))
        return None

    def _exec_batch(self, stmt: ast.Batch):
        """Execute a BATCH's statements in order. Statements grouped per
        tablet are atomic per tablet; cross-tablet batches are not atomic
        (the reference's non-transactional batches behave the same)."""
        for sub in stmt.statements:
            self.execute(sub, params=self._params)
        return None

    def _exec_drop_table(self, stmt: ast.DropTable):
        name = self._qualify(stmt.name)
        try:
            self.cluster.drop_table(name)
        except NotFound:
            if not stmt.if_exists:
                raise
        return None

    # -- secondary indexes --------------------------------------------------
    # -- user-defined types -------------------------------------------------
    def _exec_create_type(self, stmt: ast.CreateType):
        name = self._qualify(stmt.name)
        if self.cluster.get_type(name) is not None:
            if stmt.if_not_exists:
                return None
            raise AlreadyPresent(f"type {name} exists")
        seen = set()
        for fname, _dt in stmt.fields:
            if fname in seen:
                raise InvalidArgument(f"duplicate field {fname}")
            seen.add(fname)
        self.cluster.create_type(
            name, [(f, int(dt)) for f, dt in stmt.fields])
        return None

    def _exec_drop_type(self, stmt: ast.DropType):
        name = self._qualify(stmt.name)
        if self.cluster.get_type(name) is None:
            if stmt.if_exists:
                return None
            raise NotFound(f"type {name} not found")
        self.cluster.drop_type(name)
        return None

    def _exec_create_index(self, stmt: ast.CreateIndex):
        handle = self.cluster.table(self._qualify(stmt.table))
        if any(i["name"] == stmt.name
               for i in getattr(handle, "indexes", [])):
            if stmt.if_not_exists:
                return None
            raise AlreadyPresent(f"index {stmt.name} exists")
        if len(set(stmt.columns)) != len(stmt.columns):
            raise InvalidArgument("duplicate indexed column")
        for col in list(stmt.columns) + list(stmt.include):
            if not handle.schema.has_column(col):
                raise InvalidArgument(f"unknown column {col}")
            if handle.schema.column(col).is_key:
                raise InvalidArgument(f"cannot index key column {col}")
        for col in stmt.include:
            if col in stmt.columns:
                raise InvalidArgument(
                    f"covered column {col} is already indexed")
        itable = self.cluster.create_index(handle, stmt.name,
                                           list(stmt.columns),
                                           list(stmt.include))
        self._backfill_index(handle, list(stmt.columns), itable,
                             list(stmt.include))
        return None

    def _exec_drop_index(self, stmt: ast.DropIndex):
        for name in list(self.cluster.tables):
            try:
                handle = self.cluster.table(name)
            except NotFound:
                continue
            for idx in getattr(handle, "indexes", []):
                if idx["name"] == stmt.name:
                    self.cluster.drop_index(handle, stmt.name)
                    return None
        if not stmt.if_exists:
            raise NotFound(f"index {stmt.name} not found")
        return None

    def _backfill_index(self, handle: TableHandle, columns,
                        itable: str, include=()) -> None:
        """Populate the index from existing base rows. Writes land
        through the normal index-table write path; concurrent base
        writes during the scan are covered by their own maintenance."""
        from yugabyte_db_tpu_torch.index import index_entry

        if isinstance(columns, str):
            columns = [columns]
        include = list(include)
        ih = self.cluster.table(itable)
        key_names = [c.name for c in handle.schema.key_columns]
        nk = len(key_names)
        proj = key_names + list(columns) + include
        for tablet in handle.tablets:
            spec = ScanSpec(read_ht=tablet.read_time().value,
                            projection=proj)
            res = tablet.scan(spec)
            for row in res.rows:
                values = list(row[nk:nk + len(columns)])
                if any(v is None for v in values):
                    continue
                base_kv = dict(zip(key_names, row[:nk]))
                covered = dict(zip(include, row[nk + len(columns):]))
                hc, rv = index_entry(ih.schema, values, base_kv, covered)
                self.cluster.tablet_for_hash(ih, hc).write([rv])

    def _index_for_predicates(self, handle, predicates):
        """(index info, [eq preds in index-column order]) when EVERY
        indexed column is '='-bound (compound-hash lookups need the full
        hash tuple; reference: index selection in pt_select.cc)."""
        from yugabyte_db_tpu_torch.index import normalize_index

        eq = {p.column: p for p in predicates if p.op == "="}
        for idx in getattr(handle, "indexes", []):
            ni = normalize_index(idx)
            if ni["columns"] and all(c in eq for c in ni["columns"]):
                return ni, [eq[c] for c in ni["columns"]]
        return None, None

    def _run_index_lookup(self, handle, stmt, plan, idx, preds):
        """Index-driven SELECT: hash-routed scan of the index table for
        base PKs, then base-row point reads re-verifying predicates (a
        stale index entry — possible while an index write has landed but
        its base write failed — filters out here). A COVERED query —
        projection and remaining predicates within indexed + key +
        INCLUDE columns — is answered from the index table alone, never
        touching the base table (reference: index-only scans over
        IndexInfo's covered columns, src/yb/common/index.h; SELECT
        planning in src/yb/yql/cql/ql/ptree/pt_select.cc). Contract
        note: the reference maintains indexes transactionally, so
        index-only results are always consistent; here maintenance is
        index-write-first best-effort, so a covered read can briefly
        surface an entry whose base write failed mid-flight — the
        non-covered path's base re-verification filters those, covered
        reads trade that window for never touching the base table."""
        ih = self.cluster.table(idx["index_table"])
        ischema = ih.schema
        values = [self._coerce(handle.schema.column(p.column), p.value)
                  for p in preds]
        kv = {p.column: v for p, v in zip(preds, values)}
        hc = compute_hash_code(ischema, kv)
        prefix = encode_doc_key_prefix(
            hc, [(kv[c.name], c.dtype) for c in ischema.hash_columns], [])
        key_names = [c.name for c in handle.schema.key_columns]

        projection = plan.projection or [c.name for c in
                                         handle.schema.columns]
        names = ([it.output_name for it in stmt.items] if stmt.items
                 else list(projection))
        limit = self._coerce_limit(stmt.limit)
        itablet = self.cluster.tablet_for_hash(ih, hc)

        eq_cols = {p.column for p in preds}
        index_cols = {c.name for c in ischema.columns}
        residual = [p for p in plan.predicates if p.column not in eq_cols]
        covered = (set(projection) <= index_cols and
                   all(p.column in index_cols for p in residual))
        if covered:
            ires = itablet.scan(ScanSpec(
                lower=prefix, upper=prefix_successor(prefix),
                read_ht=itablet.read_time().value,
                predicates=residual, projection=list(projection),
                limit=limit))
            out = ResultSet(columns=names)
            out.rows.extend(ires.rows)
            return out

        ires = itablet.scan(ScanSpec(
            lower=prefix, upper=prefix_successor(prefix),
            read_ht=itablet.read_time().value, projection=key_names))
        out = ResultSet(columns=names)
        for irow in ires.rows:
            base_kv = dict(zip(key_names, irow))
            bkey, btablet = self._key_and_tablet(handle, base_kv)
            bres = btablet.scan(ScanSpec(
                lower=bkey, upper=bkey + b"\x00",
                read_ht=btablet.read_time().value,
                predicates=plan.predicates, projection=projection,
                limit=1))
            out.rows.extend(bres.rows)
            if limit is not None and len(out.rows) >= limit:
                break
        return out

    # -- bind markers --------------------------------------------------------
    def _resolve_marker(self, value):
        """BindMarker -> the positional param; other values pass through."""
        if isinstance(value, ast.BindMarker):
            try:
                return self._params[value.index]
            except IndexError:
                raise InvalidArgument(
                    f"bind marker ${value.index} has no value "
                    f"({len(self._params)} params supplied)") from None
        return value

    @staticmethod
    def _require_nonneg_int(value, what: str):
        if value is not None and (not isinstance(value, int)
                                  or isinstance(value, bool) or value < 0):
            raise InvalidArgument(f"{what} must be a non-negative integer")
        return value

    # -- writes ------------------------------------------------------------
    def _coerce(self, col: ColumnSchema, value):
        from yugabyte_db_tpu_torch.yql.common import coerce_udt, coerce_value

        value = self._resolve_marker(value)
        if col.udt:
            fields = self.cluster.get_type(col.udt)
            if fields is None:
                raise InvalidArgument(f"unknown type {col.udt}")
            return coerce_udt(col, value, fields)
        return coerce_value(col, value)

    def _key_and_tablet(self, handle: TableHandle, key_values: dict):
        from yugabyte_db_tpu_torch.yql.common import key_and_tablet

        return key_and_tablet(self.cluster, handle, key_values)

    def _expire_ht(self, ttl_seconds):
        ttl_seconds = self._require_nonneg_int(
            self._resolve_marker(ttl_seconds), "TTL")
        if ttl_seconds is None:
            return MAX_HT
        now = self.cluster.clock.now()
        from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
        return HybridTime.from_micros(
            now.physical_micros + ttl_seconds * 1_000_000,
            now.logical).value

    def _exec_insert(self, stmt: ast.Insert):
        handle = self.cluster.table(self._qualify(stmt.table))
        schema = handle.schema
        provided = dict(zip(stmt.columns, stmt.values))
        for cname in provided:
            if not schema.has_column(cname):
                raise InvalidArgument(f"unknown column {cname}")
        key_values, columns = {}, {}
        for c in schema.key_columns:
            if c.name not in provided or provided[c.name] is None:
                raise InvalidArgument(f"missing key column {c.name}")
            key_values[c.name] = self._coerce(c, provided[c.name])
        for c in schema.value_columns:
            if c.name in provided:
                columns[c.col_id] = self._coerce(c, provided[c.name])
        key, tablet = self._key_and_tablet(handle, key_values)
        if stmt.if_not_exists:
            # Conditional insert: CQL returns an [applied] row. (The
            # reference runs this as a read-modify-write inside the tablet,
            # cql_operation.cc QLWriteOperation::ApplyForRegularColumns.)
            spec = ScanSpec(lower=key, upper=key + b"\xff",
                            read_ht=tablet.read_time().value, limit=1)
            if tablet.scan(spec).rows:
                return ResultSet(columns=["[applied]"], rows=[(False,)])
            self._write_row(handle, key_values, key, tablet, RowVersion(
                key, ht=0, liveness=True, columns=columns,
                expire_ht=self._expire_ht(stmt.ttl_seconds)))
            return ResultSet(columns=["[applied]"], rows=[(True,)])
        self._write_row(handle, key_values, key, tablet, RowVersion(
            key, ht=0, liveness=True, columns=columns,
            expire_ht=self._expire_ht(stmt.ttl_seconds)))
        return None

    def _bound_key_values(self, schema: Schema, where: list[ast.Relation],
                          require_full_key: bool) -> tuple[dict, list]:
        """Split WHERE into full-PK equality bindings + leftover relations."""
        key_values, leftover = {}, []
        key_names = {c.name for c in schema.key_columns}
        for rel in where:
            if rel.column in key_names and rel.op == "=" and \
                    rel.column not in key_values:
                key_values[rel.column] = rel.value
            else:
                leftover.append(rel)
        if require_full_key:
            missing = key_names - set(key_values)
            if missing:
                raise InvalidArgument(
                    f"DML requires the full primary key; missing {sorted(missing)}")
            if leftover:
                raise InvalidArgument(
                    "non-key relations not allowed in UPDATE/DELETE WHERE")
        coerced = {}
        for c in schema.key_columns:
            if c.name in key_values:
                coerced[c.name] = self._coerce(c, key_values[c.name])
        return coerced, leftover

    def _exec_update(self, stmt: ast.Update):
        handle = self.cluster.table(self._qualify(stmt.table))
        schema = handle.schema
        key_values, _ = self._bound_key_values(schema, stmt.where, True)

        def is_counter_op(col, v):
            return (isinstance(v, ast.CollectionOp)
                    and col.dtype.is_integer
                    and v.op in ("append", "remove")
                    and isinstance(self._resolve_marker(v.operand), int))

        # Collection edits (v = v + [...], v[k] = x) are read-modify-write
        # against the current row state; counter increments are NOT — they
        # ship as deltas the tablet leader resolves atomically under its
        # write serialization lock (Tablet.resolve_increments).
        coll_cols = [cname for cname, v in stmt.assignments
                     if isinstance(v, ast.CollectionOp)
                     and not is_counter_op(schema.column(cname), v)]
        old_row = {}
        if coll_cols:
            key0, tablet0 = self._key_and_tablet(handle, key_values)
            res = tablet0.scan(ScanSpec(
                lower=key0, upper=key0 + b"\x00",
                read_ht=tablet0.read_time().value, projection=coll_cols,
                limit=1))
            if res.rows:
                old_row = dict(zip(res.columns, res.rows[0]))
        columns = {}
        increments = {}
        for cname, value in stmt.assignments:
            if not schema.has_column(cname):
                raise InvalidArgument(f"unknown column {cname}")
            col = schema.column(cname)
            if col.is_key:
                raise InvalidArgument(f"cannot SET key column {cname}")
            if is_counter_op(col, value):
                delta = self._resolve_marker(value.operand)
                increments[col.col_id] = (
                    delta if value.op == "append" else -delta)
            elif isinstance(value, ast.CollectionOp):
                columns[col.col_id] = self._apply_collection_op(
                    col, old_row.get(cname), value)
            else:
                columns[col.col_id] = self._coerce(col, value)
        key, tablet = self._key_and_tablet(handle, key_values)
        # CQL UPDATE is an upsert of the SET columns (no liveness marker:
        # the row exists only while some column is live — reference
        # semantics of UPDATE vs INSERT in DocDB).
        self._write_row(handle, key_values, key, tablet, RowVersion(
            key, ht=0, columns=columns, increments=increments,
            expire_ht=self._expire_ht(stmt.ttl_seconds)))
        return None

    def _apply_collection_op(self, col: ColumnSchema, old,
                             op: ast.CollectionOp):
        """Evaluate one collection edit against the row's current value
        (reference: per-element subdocument writes in cql_operation.cc;
        the observable end state is the same for serialized writers)."""
        dt = col.dtype
        operand = self._resolve_marker(op.operand)
        if op.op == "setelem":
            idx = self._resolve_marker(op.index)
            if dt == DataType.MAP:
                m = dict(old or {})
                m[idx] = operand
                return dict(sorted(m.items()))
            if dt == DataType.LIST:
                if old is None or not isinstance(idx, int) or \
                        not 0 <= idx < len(old):
                    raise InvalidArgument(
                        f"list index {idx!r} out of bounds for {col.name}")
                out = list(old)
                out[idx] = operand
                return out
            raise InvalidArgument(f"{col.name} is not a list or map")
        if op.op == "prepend":
            if dt != DataType.LIST:
                raise InvalidArgument(f"can only prepend to a list")
            return list(operand) + list(old or [])
        if op.op == "append":
            if dt == DataType.LIST:
                return list(old or []) + list(operand)
            if dt == DataType.SET:
                return sorted(set(old or []) | set(operand))
            if dt == DataType.MAP:
                return dict(sorted({**(old or {}), **operand}.items()))
        if op.op == "remove":
            if dt == DataType.LIST:
                drop = set(operand)
                return [v for v in (old or []) if v not in drop]
            if dt == DataType.SET:
                return sorted(set(old or []) - set(operand))
            if dt == DataType.MAP:
                keys = set(operand if not isinstance(operand, dict)
                           else operand.keys())
                return dict(sorted((k, v) for k, v in (old or {}).items()
                                   if k not in keys))
        raise InvalidArgument(
            f"unsupported collection op on {col.name} ({dt.name})")

    def _exec_delete(self, stmt: ast.Delete):
        handle = self.cluster.table(self._qualify(stmt.table))
        schema = handle.schema
        key_values, _ = self._bound_key_values(schema, stmt.where, True)
        key, tablet = self._key_and_tablet(handle, key_values)
        if stmt.columns:
            columns = {}
            for cname in stmt.columns:
                if not schema.has_column(cname):
                    raise InvalidArgument(f"unknown column {cname}")
                col = schema.column(cname)
                if col.is_key:
                    raise InvalidArgument(f"cannot DELETE key column {cname}")
                columns[col.col_id] = None   # column tombstone
            self._write_row(handle, key_values, key, tablet,
                            RowVersion(key, ht=0, columns=columns))
        else:
            self._write_row(handle, key_values, key, tablet,
                            RowVersion(key, ht=0, tombstone=True))
        return None

    def _write_row(self, handle, key_values: dict, key: bytes, tablet,
                   row: RowVersion) -> None:
        """Write one row, maintaining secondary indexes when the cluster
        seam does maintenance locally (LocalCluster); the distributed
        seam's tserver leaders maintain indexes in their own write path."""
        if getattr(handle, "indexes", None) and \
                getattr(self.cluster, "maintain_indexes", None):
            from yugabyte_db_tpu_torch.index import normalize_index

            indexed_cids = set()
            for i in handle.indexes:
                ni = normalize_index(i)
                for cname in ni["columns"] + ni["include"]:
                    indexed_cids.add(handle.schema.column(cname).col_id)
            if row.tombstone or (indexed_cids & row.columns.keys()):
                # Local maintenance only runs over real in-process
                # Tablets, which own the canonical old-state read.
                old = tablet.current_row_values(key)
                self.cluster.maintain_indexes(handle, key_values, old, row)
        tablet.write([row])

    # -- reads -------------------------------------------------------------
    def _exec_select(self, stmt: ast.Select):
        from yugabyte_db_tpu_torch.yql.cql import vtables

        if vtables.is_virtual(self._qualify(stmt.table)):
            return vtables.virtual_select(self, stmt)
        handle = self.cluster.table(self._qualify(stmt.table))
        schema = handle.schema
        plan = self._plan_select(handle, stmt)
        ordered = bool(getattr(stmt, "order_by", None))
        if ordered and self._page_size:
            raise InvalidArgument("ORDER BY cannot combine with paging")
        if plan.aggregates:
            return self._run_aggregate(handle, stmt, plan)
        # SQL order of operations: ORDER BY sorts the FULL result, LIMIT
        # truncates afterwards — so an ordered select scans unlimited and
        # slices post-sort.
        import dataclasses as _dc
        scan_stmt = _dc.replace(stmt, limit=None) if ordered else stmt
        if not plan.single:
            idx, pred = self._index_for_predicates(handle, plan.predicates)
            if idx is not None:
                res = self._apply_order_by(stmt, self._run_index_lookup(
                    handle, scan_stmt, plan, idx, pred))
                return self._slice_limit(stmt, res) if ordered else res
        if not ordered and getattr(self, "_wire_results", False) and \
                self._wire_eligible(handle, stmt, plan):
            return self._run_rows(handle, scan_stmt, plan, wire=True)
        res = self._apply_order_by(
            stmt, self._run_rows(handle, scan_stmt, plan))
        return self._slice_limit(stmt, res) if ordered else res

    def _wire_eligible(self, handle, stmt, plan) -> bool:
        """Plain row SELECTs whose projection is scalar columns ride the
        wire path: tablets return serialized CQL cell bytes the server
        forwards verbatim (reference: rows_data,
        src/yb/common/ql_rowblock.h:66 -> cql_processor.cc). Aggregates,
        ORDER BY, aliased/rewritten items, and opaque-typed columns
        (collections/UDTs serialize driver-specifically) take the row
        path."""
        if plan.aggregates or getattr(stmt, "order_by", None):
            return False
        schema = handle.schema
        projection = plan.projection or [c.name for c in schema.columns]
        if stmt.items and [it.output_name for it in stmt.items] != \
                list(projection):
            return False  # aliases: names differ from engine columns
        for name in projection:
            col = schema.column(name)
            dt = col.dtype
            if not dt.is_fixed_width and dt not in (DataType.STRING,
                                                    DataType.BINARY):
                return False
            if getattr(col, "udt", None):
                return False
        # Route capability: both seams' tablet objects expose scan_wire;
        # probe one representative instead of resolving the target set
        # (which _run_rows resolves again right after).
        ts = handle.tablets
        return bool(ts) and hasattr(ts[0], "scan_wire")

    def _slice_limit(self, stmt, rs: ResultSet) -> ResultSet:
        limit = self._coerce_limit(stmt.limit)
        if limit is not None:
            rs.rows = rs.rows[:limit]
        return rs

    def _plan_select(self, handle: TableHandle, stmt: ast.Select):
        schema = handle.schema
        hash_names = [c.name for c in schema.hash_columns]
        range_cols = schema.range_columns

        eq = {}
        rest: list[ast.Relation] = []
        for rel in stmt.where:
            col = rel.column
            if not schema.has_column(col):
                raise InvalidArgument(f"unknown column {col} in WHERE")
            if rel.op == "=" and col not in eq and (
                    col in hash_names or
                    col in [c.name for c in range_cols]):
                eq[col] = self._coerce(schema.column(col), rel.value)
            else:
                rest.append(rel)

        # Single-tablet point/range plan when every hash column is '='-bound.
        single = all(name in eq for name in hash_names) and schema.num_hash
        hash_code = None
        lower = b""
        upper = b""
        if single:
            hash_code = compute_hash_code(
                schema, {n: eq[n] for n in hash_names})
            hashed = [(eq[n], schema.column(n).dtype) for n in hash_names]
            # Extend the prefix with leading '='-bound range columns.
            bound_ranges = []
            i = 0
            while i < len(range_cols) and range_cols[i].name in eq:
                c = range_cols[i]
                bound_ranges.append((eq[c.name], c.dtype))
                i += 1
            prefix = encode_doc_key_prefix(hash_code, hashed, bound_ranges)
            lower, upper = prefix, prefix_successor(prefix)
            # '='-bound range columns past the first unbound one can't join
            # the prefix; re-emit them as row predicates.
            consumed = set(hash_names) | {c.name for c in range_cols[:i]}
            for name, v in eq.items():
                if name not in consumed:
                    rest.append(ast.Relation(name, "=", v))
            # One more range column may carry inequalities tightening bounds.
            if i < len(range_cols):
                nxt = range_cols[i]
                keep = []
                for rel in rest:
                    if rel.column != nxt.name or rel.op in ("IN", "!="):
                        keep.append(rel)
                        continue
                    v = self._coerce(nxt, rel.value)
                    comp = encode_key_component(v, nxt.dtype)
                    if rel.op in (">", ">="):
                        cand = prefix + (prefix_successor(comp)
                                         if rel.op == ">" else comp)
                        lower = max(lower, cand)
                    elif rel.op in ("<", "<="):
                        cand = prefix + (prefix_successor(comp)
                                         if rel.op == "<=" else comp)
                        if upper == b"" or (cand != b"" and cand < upper):
                            upper = cand
                    elif rel.op == "=":
                        lo = prefix + comp
                        lower = max(lower, lo)
                        cand = prefix + prefix_successor(comp)
                        if upper == b"" or (cand != b"" and cand < upper):
                            upper = cand
                rest = keep
        else:
            # eq bindings on range cols without hash bindings: filter later.
            for name, v in eq.items():
                rest.append(ast.Relation(name, "=", v))

        predicates = []
        for rel in rest:
            col = schema.column(rel.column)
            value = (tuple(self._coerce(col, v) for v in rel.value)
                     if rel.op == "IN" else self._coerce(col, rel.value))
            predicates.append(Predicate(rel.column, rel.op, value))

        group_by = list(getattr(stmt, "group_by", []) or [])
        for g in group_by:
            if not schema.has_column(g):
                raise InvalidArgument(f"unknown GROUP BY column {g}")
        aggregates = []
        if stmt.items and any(it.agg_fn for it in stmt.items):
            from yugabyte_db_tpu_torch.storage.expr import columns_of
            for it in stmt.items:
                if it.agg_fn:
                    continue
                if it.column not in group_by:
                    raise InvalidArgument(
                        "plain columns in an aggregate SELECT must appear "
                        "in GROUP BY")
            for it in stmt.items:
                if not it.agg_fn:
                    continue
                if it.column and not schema.has_column(it.column):
                    raise InvalidArgument(f"unknown column {it.column}")
                if it.expr is not None:
                    for cname in columns_of(it.expr):
                        if not schema.has_column(cname):
                            raise InvalidArgument(f"unknown column {cname}")
                aggregates.append(AggSpec(it.agg_fn, it.column,
                                          expr=it.expr,
                                          label=it.output_name))
        elif group_by:
            raise InvalidArgument("GROUP BY requires aggregate items")

        projection = None
        if stmt.items and not aggregates:
            for it in stmt.items:
                if not schema.has_column(it.column):
                    raise InvalidArgument(f"unknown column {it.column}")
            projection = [it.column for it in stmt.items]

        return _SelectPlan(bool(single), hash_code, lower, upper,
                           predicates, projection, aggregates, group_by)

    def _target_tablets(self, handle: TableHandle, plan):
        if plan.single and handle.schema.num_hash:
            return [self.cluster.tablet_for_hash(handle, plan.hash_code)]
        return handle.tablets

    def _run_rows(self, handle: TableHandle, stmt: ast.Select, plan,
                  wire: bool = False):
        from yugabyte_db_tpu_torch.utils import codec

        schema = handle.schema
        projection = plan.projection or [c.name for c in schema.columns]
        if stmt.items:
            names = [it.output_name for it in stmt.items]
        else:
            names = list(projection)
        out = ResultSet(columns=names)
        wire_parts: list[bytes] = []
        tablets = self._target_tablets(handle, plan)
        # Paging token: (tablet index, resume key, LIMIT budget left,
        # pinned read time) — the QLPagingStatePB shape
        # (next_partition_key + next_row_key + remaining limit +
        # read_time, so every page reads the same snapshot).
        start_idx = 0
        resume = plan.lower
        limit = self._coerce_limit(stmt.limit)
        read_ht = None
        if self._paging_state:
            start_idx, resume, limit, read_ht = codec.decode(
                self._paging_state)
        page_left = self._page_size

        def finish():
            if wire:
                out.wire_data = b"".join(wire_parts)
            return out

        for idx in range(start_idx, len(tablets)):
            tablet = tablets[idx]
            lower = resume if idx == start_idx else plan.lower
            while True:
                sub_limit = self._min_opt(limit, page_left)
                spec = ScanSpec(
                    lower=lower, upper=plan.upper,
                    read_ht=(read_ht if read_ht is not None
                             else tablet.read_time().value),
                    predicates=plan.predicates,
                    projection=projection, limit=sub_limit)
                if wire:
                    res = tablet.scan_wire(spec)
                    wire_parts.append(res.data)
                    out.wire_rows += res.nrows
                    n = res.nrows
                    resume_key = res.resume
                else:
                    res = tablet.scan(spec)
                    out.rows.extend(res.rows)
                    n = len(res.rows)
                    resume_key = res.resume_key
                if read_ht is None:
                    # Pin the first sub-scan's (server-chosen) read time
                    # for the rest of the scan and for later pages.
                    read_ht = getattr(res, "read_ht", None) or spec.read_ht
                if limit is not None:
                    limit -= n
                    if limit <= 0:
                        return finish()
                if page_left is not None:
                    page_left -= n
                    if page_left <= 0:
                        # Page full: remember where the scan resumes.
                        if resume_key is not None:
                            out.paging_state = codec.encode(
                                [idx, resume_key, limit, read_ht])
                        elif idx + 1 < len(tablets):
                            out.paging_state = codec.encode(
                                [idx + 1, plan.lower, limit, read_ht])
                        return finish()
                if resume_key is None:
                    break
                lower = resume_key
        return finish()

    def _coerce_limit(self, limit):
        return self._require_nonneg_int(self._resolve_marker(limit),
                                        "LIMIT")

    @staticmethod
    def _min_opt(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return min(a, b)

    def _point_stmt_plan(self, stmt):
        """Build (and cache) the params-independent plan of a prepared
        point SELECT: which columns the '='-bound WHERE covers, the
        projection, and wire eligibility. Returns None when the
        statement's shape can never ride the batch path. The per-frame
        remainder is just coerce + key encode + hash route."""
        from yugabyte_db_tpu_torch.yql.cql import vtables

        if type(stmt) is not ast.Select or stmt.limit is not None \
                or getattr(stmt, "order_by", None):
            return None
        if vtables.is_virtual(self._qualify(stmt.table)):
            return None
        handle = self.cluster.table(self._qualify(stmt.table))
        schema = handle.schema
        hash_cols = schema.hash_columns
        if not hash_cols:
            return None
        # Every relation must be '=' on a distinct key column, covering
        # all hash columns plus a PREFIX of the range columns — exactly
        # the shape _plan_select turns into [prefix, successor(prefix))
        # with no residual predicates and no bound tightening.
        by_col = {}
        for rel in stmt.where:
            if rel.op != "=" or rel.column in by_col:
                return None
            by_col[rel.column] = rel
        if any(c.name not in by_col for c in hash_cols):
            return None
        range_prefix = []
        rest = set(by_col) - {c.name for c in hash_cols}
        for c in schema.range_columns:
            if c.name not in rest:
                break
            rest.discard(c.name)
            range_prefix.append(c)
        if rest:
            return None
        probe = _SelectPlan(True, 0, b"", b"", [], None, [], [])
        projection = None
        if stmt.items:
            for it in stmt.items:
                if it.agg_fn or not schema.has_column(it.column):
                    return None
            projection = [it.column for it in stmt.items]
        probe.projection = projection
        if not self._wire_eligible(handle, stmt, probe):
            return None
        projection = projection or [c.name for c in schema.columns]
        names = ([it.output_name for it in stmt.items] if stmt.items
                 else list(projection))
        return _PointStmtPlan(
            stmt, schema, handle,
            [(c, by_col[c.name]) for c in hash_cols],
            [(c, by_col[c.name]) for c in range_prefix],
            projection, names)

    def execute_wire_point_batch(self, items: list) -> list:
        """Batched serving of prepared point SELECTs — the CQL side of
        the native request-batch serving path (docs/serving-path.md).

        Each item is (stmt, params, page_size, paging_state), one per
        pipelined EXECUTE frame. Frames whose plan is a single-tablet
        wire-eligible read with no predicates, aggregates, LIMIT, or
        paging are grouped per tablet and served through ONE
        scan_wire_many batch per tablet; every other frame gets None in
        its slot and the caller runs the canonical execute(). Replies
        are byte-identical to the per-op path: the bounds and specs
        below are exactly what _plan_select/_run_rows would build for
        these statements (limit None, page budget None), served by the
        same page server. The params-independent planning is cached per
        prepared statement (_point_stmt_plan); a schema change drops the
        entry and replans.
        """
        out: list = [None] * len(items)
        groups: dict = {}
        cache = self._point_stmt_cache
        for i, (stmt, params, page_size, paging_state) in enumerate(items):
            if page_size is not None or paging_state:
                continue
            ckey = (id(stmt), self.keyspace)
            try:
                sp = cache.get(ckey, False)
                if sp is not False and sp is not None and \
                        sp.schema is not self.cluster.table(
                            self._qualify(stmt.table)).schema:
                    sp = False  # schema changed: replan
                if sp is False:
                    sp = cache[ckey] = self._point_stmt_plan(stmt)
                if sp is None:
                    continue
                self._params = params or []
                self._page_size = None
                self._paging_state = None
                self._wire_results = True
                self._enforce(stmt)
                eq = {c.name: self._coerce(c, rel.value)
                      for c, rel in sp.hash_rels}
                hash_code = compute_hash_code(sp.schema, eq)
                prefix = encode_doc_key_prefix(
                    hash_code,
                    [(eq[c.name], c.dtype) for c, _rel in sp.hash_rels],
                    [(self._coerce(c, rel.value), c.dtype)
                     for c, rel in sp.range_rels])
                tablet = self.cluster.tablet_for_hash(sp.handle, hash_code)
                if not hasattr(tablet, "scan_wire_many"):
                    continue
            except Exception as e:  # noqa: BLE001 — the execute()
                # fallback re-raises this error canonically per frame.
                count_swallowed("cql.batch_plan", e)
                continue
            bounds = _PointBounds(prefix, prefix_successor(prefix), [])
            # RemoteTablet handles are constructed per lookup: group by
            # the underlying tablet id so one RPC serves the tablet.
            key = getattr(getattr(tablet, "loc", None), "tablet_id",
                          None) or id(tablet)
            g = groups.get(key)
            if g is None:
                g = groups[key] = (tablet, [])
            g[1].append((i, sp.names, sp.projection, bounds))

        for tablet, frames in groups.values():
            read_ht = tablet.read_time().value
            specs = [ScanSpec(lower=plan.lower, upper=plan.upper,
                              read_ht=read_ht,
                              predicates=plan.predicates,
                              projection=projection, limit=None)
                     for _i, _names, projection, plan in frames]
            try:
                pages = tablet.scan_wire_many(specs)
            except Exception as e:  # noqa: BLE001 — whole group falls
                count_swallowed("cql.batch_serve", e)  # back to execute()
                continue
            for (i, names, projection, plan), spec, page in zip(
                    frames, specs, pages):
                parts = [page.data]
                nrows = page.nrows
                resume = page.resume
                read_ht = getattr(page, "read_ht", None) or spec.read_ht
                try:
                    while resume is not None:
                        # Continuation pages pin the batch's read time —
                        # the same snapshot rule as _run_rows paging.
                        res = tablet.scan_wire(ScanSpec(
                            lower=resume, upper=plan.upper,
                            read_ht=read_ht, predicates=plan.predicates,
                            projection=projection, limit=None))
                        parts.append(res.data)
                        nrows += res.nrows
                        resume = res.resume
                except Exception as e:  # noqa: BLE001 — rerun this
                    count_swallowed("cql.batch_continue", e)  # frame
                    continue
                rs = ResultSet(columns=names)
                rs.wire_data = b"".join(parts)
                rs.wire_rows = nrows
                out[i] = rs
        return out

    def _run_aggregate(self, handle: TableHandle, stmt: ast.Select, plan):
        """Fan the aggregate out per tablet, combine partials host-side —
        grouped or not (reference: per-tablet partial agg merged above the
        scan, src/yb/docdb/pgsql_operation.cc:473 + exec/eval_aggr.cc).
        avg lowers to sum+count so the combine stays exact."""
        lowered: list[AggSpec] = []
        shape = []  # ("plain", idx) | ("avg", sum_idx, count_idx)
        for a in plan.aggregates:
            if a.fn == "avg":
                shape.append(("avg", len(lowered), len(lowered) + 1))
                lowered.append(AggSpec("sum", a.column, expr=a.expr))
                lowered.append(AggSpec("count", a.column, expr=a.expr))
            else:
                shape.append(("plain", len(lowered), None))
                lowered.append(a)

        gb = plan.group_by
        ngb = len(gb)
        groups: dict[tuple, list[list]] = {}
        for tablet in self._target_tablets(handle, plan):
            spec = ScanSpec(lower=plan.lower, upper=plan.upper,
                            read_ht=tablet.read_time().value,
                            predicates=plan.predicates, aggregates=lowered,
                            group_by=gb or None)
            for row in tablet.scan(spec).rows:
                gkey = tuple(row[:ngb])
                groups.setdefault(gkey, []).append(list(row[ngb:]))
        if not groups and not gb:
            groups[()] = []

        out_rows = []
        for gkey in sorted(groups, key=lambda g: tuple(
                (v is None, v) for v in g)):
            partials = groups[gkey]
            row = list(gkey)
            for kind, i, j in shape:
                if kind == "avg":
                    s = self._combine([p[i] for p in partials], "sum")
                    n = self._combine([p[j] for p in partials], "count")
                    row.append(None if not n else s / n)
                else:
                    fn = lowered[i].fn
                    row.append(self._combine([p[i] for p in partials], fn))
            out_rows.append(tuple(row))
        # Column order follows the SELECT items; group values prepend in
        # GROUP BY order, then reorder to the projection if it differs.
        names = gb + [it.output_name for it in stmt.items if it.agg_fn]
        rs = ResultSet(columns=names, rows=out_rows)
        rs = self._project_grouped(stmt, gb, rs)
        return self._slice_limit(stmt, self._apply_order_by(stmt, rs))

    @staticmethod
    def _project_grouped(stmt, gb, rs: ResultSet) -> ResultSet:
        """Reorder (group cols + aggs) into the SELECT item order."""
        if not stmt.items:
            return rs
        want = [it.output_name for it in stmt.items]
        if want == rs.columns:
            return rs
        try:
            idxs = [rs.columns.index(
                it.output_name if it.agg_fn else it.column)
                for it in stmt.items]
        except ValueError:
            return rs
        return ResultSet(columns=want,
                         rows=[tuple(r[i] for i in idxs) for r in rs.rows])

    def _apply_order_by(self, stmt, rs: ResultSet) -> ResultSet:
        order = list(getattr(stmt, "order_by", []) or [])
        if not order:
            return rs
        for name, _d in order:
            if name not in rs.columns:
                raise InvalidArgument(f"ORDER BY column {name} not in output")
        for name, desc in reversed(order):
            i = rs.columns.index(name)
            rs.rows.sort(key=lambda r: (r[i] is None, r[i]), reverse=desc)
        return rs

    @staticmethod
    def _combine(vals, fn):
        vals = [v for v in vals if v is not None]
        if fn == "count":
            return sum(vals) if vals else 0
        if not vals:
            return None
        if fn == "sum":
            return sum(vals)
        return max(vals) if fn == "max" else min(vals)
