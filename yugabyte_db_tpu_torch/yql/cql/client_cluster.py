"""ClientCluster: the QLProcessor's Cluster seam over the distributed
client — how the CQL proxy reaches real tservers.

Reference analog: the CQL server's embedded YBClient/YBSession path
(src/yb/yql/cql/ql/exec/executor.cc building ops routed through
src/yb/client/batcher.cc). The processor only needs: create/drop/table
lookup, hash->tablet routing, and per-tablet objects exposing
write(rows) / scan(spec) / read_time() — RemoteTablet implements those
as tserver RPCs through the client's MetaCache + TabletInvoker.

The port's copy of the JAX package's ``yql/cql/client_cluster.py``. Its
one departure: a table's engine defaults to ``"gpu"`` (the JAX default
``"cpu"`` is not registered in the port; ROADMAP.md §1 item 16)."""

from __future__ import annotations

from yugabyte_db_tpu_torch.client.client import YBClient
from yugabyte_db_tpu_torch.models.partition import PartitionSchema
from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.storage import wire
from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import ScanResult, ScanSpec
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridClock, HybridTime
from yugabyte_db_tpu_torch.utils.status import AlreadyPresent, NotFound


class RemoteTablet:
    """One tablet as seen through the client: the duck-type the
    QLProcessor drives (Tablet's read surface + write)."""

    def __init__(self, client: YBClient, table_name: str, loc):
        self.client = client
        self.table_name = table_name
        self.loc = loc

    def read_time(self) -> HybridTime:
        # The tserver picks its safe time when read_ht arrives as MAX
        # (tablet_server._h_ts_scan), exactly like a fresh scan.
        return HybridTime.max()

    def write(self, rows: list[RowVersion],
              if_not_exists: bool = False) -> None:
        from yugabyte_db_tpu_torch.client.client import TabletOpFailed

        payload = {"rows": wire.encode_rows(rows)}
        if if_not_exists:
            payload["if_not_exists"] = True
        try:
            self.client.tablet_rpc(self.table_name, self.loc, "ts.write",
                                   payload)
        except TabletOpFailed as e:
            if getattr(e, "resp", {}).get("code") == "duplicate_key":
                raise AlreadyPresent(
                    "duplicate key value violates unique constraint") \
                    from None
            raise

    def scan(self, spec: ScanSpec) -> ScanResult:
        resp = self.client.tablet_rpc(
            self.table_name, self.loc, "ts.scan",
            {"spec": wire.encode_spec(spec)})
        res = wire.decode_result(resp)
        # Expose the server-chosen read time so paged scans pin one
        # snapshot (processor._run_rows reads it off the result).
        res.read_ht = resp.get("read_ht")
        return res

    def scan_wire(self, spec: ScanSpec, fmt: str = "cql"):
        """Scan returning serialized page bytes the proxy forwards
        verbatim (rows_data contract; tserver _h_ts_scan_wire)."""
        from yugabyte_db_tpu_torch.storage.host_page import WirePage

        resp = self.client.tablet_rpc(
            self.table_name, self.loc, "ts.scan_wire",
            {"spec": wire.encode_spec(spec), "fmt": fmt})
        pg = WirePage(resp.get("columns"), resp["data"], resp["nrows"],
                      resp.get("resume"), 0)
        pg.read_ht = resp.get("read_ht")
        return pg

    def scan_wire_many(self, specs: list[ScanSpec], fmt: str = "cql"):
        """Batched wire scans in ONE ts.scan_wire_batch RPC — the read
        hop of the native request-batch serving path. Pages align with
        specs; the single server-chosen read time rides on each page."""
        from yugabyte_db_tpu_torch.storage.host_page import WirePage

        resp = self.client.tablet_rpc(
            self.table_name, self.loc, "ts.scan_wire_batch",
            {"specs": [wire.encode_spec(s) for s in specs], "fmt": fmt})
        pages = []
        for p in resp["pages"]:
            pg = WirePage(p.get("columns"), p["data"], p["nrows"],
                          p.get("resume"), 0)
            pg.read_ht = resp.get("read_ht")
            pages.append(pg)
        return pages


class RemoteTable:
    def __init__(self, client: YBClient, name: str, schema: Schema,
                 indexes: list | None = None):
        self.client = client
        self.name = name
        self.schema = schema
        self.indexes = list(indexes or [])
        self.partition_schema = PartitionSchema(
            1, hash_partitioned=schema.num_hash > 0)  # routing via MetaCache

    @property
    def tablets(self) -> list[RemoteTablet]:
        locs = self.client.meta_cache.locations(self.name)
        return [RemoteTablet(self.client, self.name, loc)
                for loc in locs.tablets]


class ClientCluster:
    """Cluster seam over YBClient (the distributed deployment)."""

    def __init__(self, client: YBClient, num_tablets: int = 4,
                 replication_factor: int = 3, engine: str = "gpu"):
        self.client = client
        self.num_tablets = num_tablets
        self.replication_factor = replication_factor
        self.engine = engine
        # TTL expiry hybrid times are computed proxy-side from this clock
        # (same shape as LocalCluster's shared clock).
        self.clock = HybridClock()
        self._tables: dict[str, RemoteTable] = {}
        self._auth_cache = None
        self._auth_cache_at = 0.0

    def auth_store(self):
        """Short-TTL mirror of the master's role store (the client-side
        caching the reference's CQL auth does against system_auth)."""
        import time as _t

        from yugabyte_db_tpu_torch.auth import RoleStore

        now = _t.monotonic()
        if self._auth_cache is None or now - self._auth_cache_at > 1.0:
            resp = self.client.master_rpc("master.get_auth", {})
            self._auth_cache = RoleStore.from_dict(resp["auth"])
            self._auth_cache_at = now
        return self._auth_cache

    def auth_op(self, op: dict) -> None:
        resp = self.client.master_rpc("master.auth_op", {"auth": op})
        if resp.get("code") != "ok":
            from yugabyte_db_tpu_torch.utils.status import InvalidArgument

            raise InvalidArgument(resp.get("message", "auth op failed"))
        self._auth_cache = None

    @property
    def tables(self) -> dict:
        """Existing table names (the processor's existence checks)."""
        return {t["name"]: t for t in self.client.list_tables()}

    def create_table(self, name: str, schema: Schema,
                     num_tablets: int | None = None) -> RemoteTable:
        try:
            self.client.create_table(
                name, list(schema.columns),
                num_tablets=num_tablets or self.num_tablets,
                replication_factor=self.replication_factor,
                engine=self.engine)
        except Exception as e:  # noqa: BLE001
            if "already_present" in str(e):
                raise AlreadyPresent(f"table {name} exists") from e
            raise
        t = RemoteTable(self.client, name, schema)
        self._tables[name] = t
        return t

    def drop_table(self, name: str) -> None:
        self._tables.pop(name, None)
        resp = self.client.master_rpc("master.delete_table",
                                      {"name": name})
        if resp.get("code") == "not_found":
            raise NotFound(f"table {name} not found")
        if resp.get("code") != "ok":
            raise RuntimeError(f"drop_table {name}: {resp}")
        self.client.meta_cache.invalidate(name)

    def table(self, name: str) -> RemoteTable:
        t = self._tables.get(name)
        if t is None:
            resp = self.client.master_rpc("master.get_table",
                                          {"name": name})
            if resp.get("code") != "ok":
                raise NotFound(f"table {name} not found")
            t = RemoteTable(self.client, name,
                            Schema.from_dict(resp["schema"]),
                            resp.get("indexes"))
            self._tables[name] = t
        return t

    def alter_table(self, handle: RemoteTable, new_schema: Schema) -> None:
        self.client.alter_table(handle.name, new_schema.to_dict())
        handle.schema = new_schema

    def create_index(self, base: RemoteTable, name: str,
                     columns, include=()) -> str:
        if isinstance(columns, str):
            columns = [columns]
        itable = self.client.create_index(base.name, columns, name,
                                          include)
        base.indexes.append({"name": name, "column": columns[0],
                             "columns": list(columns),
                             "include": list(include),
                             "index_table": itable})
        return itable

    # -- user-defined types -------------------------------------------------
    def create_type(self, name: str, fields: list) -> None:
        from yugabyte_db_tpu_torch.utils.status import InvalidArgument

        resp = self.client.master_rpc("master.type_op", {
            "action": "create", "name": name,
            "fields": [list(f) for f in fields]})
        if resp.get("code") not in ("ok", "already_present"):
            raise InvalidArgument(f"create type {name}: {resp}")
        self._types_cache = None

    def drop_type(self, name: str) -> None:
        from yugabyte_db_tpu_torch.utils.status import InvalidArgument

        resp = self.client.master_rpc("master.type_op", {
            "action": "drop", "name": name})
        if resp.get("code") != "ok":
            raise InvalidArgument(f"drop type {name}: {resp}")
        self._types_cache = None

    def get_type(self, name: str):
        # The fetched registry is authoritative until a local type op
        # invalidates it — unknown names don't refetch per lookup.
        cache = getattr(self, "_types_cache", None)
        if cache is None:
            cache = self.list_types()
        return cache.get(name)

    def list_types(self) -> dict:
        resp = self.client.master_rpc("master.list_types", {})
        cache = self._types_cache = {
            n: [tuple(f) for f in fs]
            for n, fs in resp.get("types", {}).items()}
        return cache

    # -- keyspaces (shared registry through the master catalog) --------------
    def create_keyspace(self, name: str) -> None:
        from yugabyte_db_tpu_torch.utils.status import AlreadyPresent

        resp = self._misc_op("create_keyspace", {"name": name})
        if resp.get("code") == "already_present":
            raise AlreadyPresent(f"keyspace {name} exists")
        if resp.get("code") != "ok":
            raise RuntimeError(f"create keyspace {name}: {resp}")

    def drop_keyspace(self, name: str) -> None:
        from yugabyte_db_tpu_torch.utils.status import NotFound

        resp = self._misc_op("drop_keyspace", {"name": name})
        if resp.get("code") == "not_found":
            raise NotFound(f"keyspace {name} not found")

    def list_keyspaces(self) -> set:
        resp = self._misc_op("list_keyspaces", {})
        return set(resp.get("keyspaces", ()))

    # -- views / sequences --------------------------------------------------
    def _misc_op(self, action: str, payload: dict) -> dict:
        resp = self.client.master_rpc("master.misc_op",
                                      dict(payload, action=action))
        return resp

    def create_view(self, name: str, query_sql: str,
                    replace: bool = False) -> None:
        from yugabyte_db_tpu_torch.utils.status import AlreadyPresent

        resp = self._misc_op("create_view", {
            "name": name, "query": query_sql, "replace": replace})
        if resp.get("code") == "already_present":
            raise AlreadyPresent(f"view {name} exists")
        if resp.get("code") != "ok":
            raise RuntimeError(f"create view {name}: {resp}")

    def drop_view(self, name: str) -> None:
        from yugabyte_db_tpu_torch.utils.status import NotFound

        resp = self._misc_op("drop_view", {"name": name})
        if resp.get("code") == "not_found":
            raise NotFound(f"view {name} not found")

    def get_view(self, name: str):
        resp = self._misc_op("get_view", {"name": name})
        return resp.get("query") if resp.get("code") == "ok" else None

    def create_sequence(self, name: str) -> None:
        from yugabyte_db_tpu_torch.utils.status import AlreadyPresent

        resp = self._misc_op("create_sequence", {"name": name})
        if resp.get("code") == "already_present":
            raise AlreadyPresent(f"sequence {name} exists")
        if resp.get("code") != "ok":
            raise RuntimeError(f"create sequence {name}: {resp}")

    def drop_sequence(self, name: str) -> None:
        from yugabyte_db_tpu_torch.utils.status import NotFound

        resp = self._misc_op("drop_sequence", {"name": name})
        if resp.get("code") == "not_found":
            raise NotFound(f"sequence {name} not found")

    def sequence_next(self, name: str, n: int = 1) -> int:
        from yugabyte_db_tpu_torch.utils.status import NotFound

        resp = self._misc_op("sequence_next", {"name": name, "n": n})
        if resp.get("code") == "not_found":
            raise NotFound(f"sequence {name} not found")
        if resp.get("code") != "ok":
            raise RuntimeError(f"nextval {name}: {resp}")
        return resp["base"]

    def drop_index(self, base: RemoteTable, name: str) -> None:
        idx = next(i for i in base.indexes if i["name"] == name)
        resp = self.client.master_rpc("master.drop_index", {
            "table": base.name, "name": name})
        if resp.get("code") != "ok":
            raise NotFound(f"index {name}: {resp}")
        base.indexes.remove(idx)

    # On the distributed path the base tablet's LEADER maintains indexes
    # in its write handler (tablet_server._maintain_indexes) — the
    # reference's placement — so the processor-side hook is absent.
    maintain_indexes = None

    def tablet_for_hash(self, handle: RemoteTable,
                        hash_code: int) -> RemoteTablet:
        loc = self.client.meta_cache.lookup_by_hash(handle.name, hash_code)
        return RemoteTablet(self.client, handle.name, loc)

    def transaction_manager(self):
        """The shared TransactionManager over this cluster's client
        (reference: the TransactionManager the SQL layer's PgTxnManager
        drives, pg_txn_manager.cc) — distributed seam only."""
        if getattr(self, "_txn_manager", None) is None:
            from yugabyte_db_tpu_torch.client.transaction import TransactionManager

            self._txn_manager = TransactionManager(self.client)
            self._txn_manager.ensure_status_table()
        return self._txn_manager

    def open_yb_table(self, name: str):
        """A client YBTable handle (the transaction API's table type)."""
        return self.client.open_table(name)

    def close(self) -> None:
        self._tables.clear()
