"""YBClient: the cluster entry point.

Reference analog: src/yb/client/client.cc — master RPCs with leader
failover, table handles, and the tablet-RPC retry engine
(TabletInvoker, tablet_rpc.cc): try the known leader, learn from
NOT_THE_LEADER hints, fall back to other replicas, refresh locations.

The port's copy of the JAX package's ``client/client.py``. Its one
departure: a table's engine defaults to ``"gpu"`` (the JAX default
``"cpu"`` is not registered in the port; ROADMAP.md §1 item 16).
"""

from __future__ import annotations

import time

from yugabyte_db_tpu_torch.client.meta_cache import MetaCache, TabletLocation
from yugabyte_db_tpu_torch.consensus.transport import TransportError
from yugabyte_db_tpu_torch.models.partition import compute_hash_code
from yugabyte_db_tpu_torch.models.schema import ColumnSchema, Schema
from yugabyte_db_tpu_torch.utils.metrics import count_swallowed
from yugabyte_db_tpu_torch.utils.retry import RetryPolicy
from yugabyte_db_tpu_torch.utils.status import TabletSplit


class MasterUnavailable(Exception):
    pass


# Response codes no retry can change: surface immediately.
TERMINAL_CODES = frozenset(
    {"invalid_read_time", "conflict", "aborted", "committed", "error",
     "duplicate_key"})


class TabletOpFailed(Exception):
    pass


class YBTable:
    """A table handle: schema + key helpers (reference: YBTable)."""

    def __init__(self, name: str, table_id: str, schema: Schema,
                 engine: str = "gpu"):
        self.name = name
        self.table_id = table_id
        self.schema = schema
        self.engine = engine
        self.col_id = {c.name: c.col_id for c in schema.columns}

    def hash_code(self, key_values: dict) -> int:
        hc = compute_hash_code(self.schema, key_values)
        return 0 if hc is None else hc

    def encode_key(self, key_values: dict) -> bytes:
        hc = compute_hash_code(self.schema, key_values)
        return self.schema.encode_primary_key(key_values, hc)


class YBClient:
    def next_request_id(self) -> int:
        """Monotonic per-client write request id (exactly-once dedup:
        retryable_requests.h:34 — retries reuse the SAME id)."""
        with self._req_lock:
            self._req_counter += 1
            return self._req_counter

    def __init__(self, transport, master_uuids: list[str],
                 default_rpc_timeout_s: float = 10.0, cloud_info=None):
        import threading
        import uuid as uuid_mod

        self.transport = transport
        self.master_uuids = list(master_uuids)
        self.default_rpc_timeout_s = default_rpc_timeout_s
        # The client's own locality labels: stale follower reads prefer
        # a replica in the same (cloud, region, zone) — the reference's
        # read-replica / closest-replica selection (TabletInvoker with
        # YBConsistencyLevel + CloudInfoPB proximity).
        self.cloud_info = cloud_info or {}
        self.meta_cache = MetaCache(self)
        self._master_leader_hint: str | None = None
        # Exactly-once write identity: every write carries
        # (client_id, request_id); servers dedup replayed ids.
        self.client_id = uuid_mod.uuid4().hex
        self._req_lock = threading.Lock()
        self._req_counter = 0
        # HLC propagation (the ConsistentReadPoint/session-causality
        # contract): the largest hybrid time this client has OBSERVED in
        # any response; piggybacked on tablet RPCs so every touched
        # server's clock ratchets past it — a read after a write (or
        # after a transaction commit) can never miss it.
        self.last_observed_ht = 0
        # One retry/deadline policy for every blocking loop in this
        # client (utils.retry): jittered exponential backoff between
        # failover sweeps, every attempt debiting the call's one
        # deadline. The reference's RpcRetrier/TabletInvoker shape.
        self.retry_policy = RetryPolicy(
            timeout_s=default_rpc_timeout_s,
            initial_backoff_s=0.05, max_backoff_s=0.5)

    @classmethod
    def connect(cls, master_addrs: str) -> "YBClient":
        """Bootstrap a client over TCP from comma-separated master
        host:port addresses (the driver connection string); tserver
        addresses are learned from the master registry (and refreshed
        whenever a lookup misses)."""
        from yugabyte_db_tpu_torch.rpc import SocketTransport

        transport = SocketTransport()
        uuids = []
        for addr in master_addrs.split(","):
            addr = addr.strip()
            if not addr:
                continue
            host, port = addr.rsplit(":", 1)
            uuid = f"master@{addr}"
            transport.set_address(uuid, host, int(port))
            uuids.append(uuid)
        if not uuids:
            raise ValueError("no master addresses given")
        c = cls(transport, uuids)
        c.refresh_tserver_addresses()
        return c

    def refresh_tserver_addresses(self) -> None:
        """Learn tserver uuid -> address mappings (socket mode only)."""
        if not hasattr(self.transport, "set_address"):
            return
        for d in self.list_tservers():
            addr = d.get("addr")
            if isinstance(addr, (list, tuple)) and len(addr) == 2:
                self.transport.set_address(d["uuid"], addr[0],
                                           int(addr[1]))

    # -- master path ---------------------------------------------------------
    def master_rpc(self, method: str, payload: dict,
                   timeout_s: float | None = None) -> dict:
        """Call the master leader, following NOT_THE_LEADER hints and
        retrying through the master set until the RetryPolicy's deadline
        budget runs out (each failover sweep debits it; backoff between
        sweeps is jittered so clients don't re-converge in lockstep)."""
        last = None
        for attempt in self.retry_policy.attempts(timeout_s=timeout_s):
            targets = ([self._master_leader_hint]
                       if self._master_leader_hint else []) + \
                [u for u in self.master_uuids
                 if u != self._master_leader_hint]
            for target in targets:
                try:
                    resp = self.transport.send(target, method, payload,
                                               timeout=attempt.timeout(2.0))
                except (TransportError, TimeoutError) as e:
                    last = e
                    continue
                if resp.get("code") == "not_leader":
                    self._master_leader_hint = resp.get("leader_hint")
                    last = resp
                    continue
                self._master_leader_hint = target
                return resp
            attempt.note(last)
        raise MasterUnavailable(f"{method}: no master leader ({last})")

    # -- ddl ----------------------------------------------------------------
    def create_table(self, name: str, columns: list[ColumnSchema],
                     num_tablets: int = 4, replication_factor: int = 3,
                     engine: str = "gpu", timeout_s: float = 30.0) -> YBTable:
        schema = Schema(columns, table_id=name)
        resp = self.master_rpc("master.create_table", {
            "name": name, "schema": schema.to_dict(),
            "num_tablets": num_tablets,
            "replication_factor": replication_factor,
            "engine": engine,
        }, timeout_s=timeout_s)
        if resp.get("code") not in ("ok", "partial", "already_present"):
            raise RuntimeError(f"create_table {name}: {resp}")
        return self.open_table(name)

    def create_index(self, table: str, columns,
                     index_name: str | None = None, include=()) -> str:
        """Create a secondary index on one or more columns, optionally
        covering (INCLUDE) extra value columns; returns the index
        table's name."""
        if isinstance(columns, str):
            columns = [columns]
        resp = self.master_rpc("master.create_index", {
            "table": table, "columns": list(columns),
            "include": list(include), "index_name": index_name})
        if resp.get("code") not in ("ok", "already_present"):
            raise RuntimeError(
                f"create_index on {table}{tuple(columns)}: {resp}")
        return resp["index_table"]

    def alter_table(self, name: str, new_schema_dict: dict) -> None:
        """Push an evolved schema (version = current + 1) to the master,
        which replicates it to the catalog and every tablet leader."""
        resp = self.master_rpc("master.alter_table",
                               {"name": name, "schema": new_schema_dict})
        if resp.get("code") not in ("ok", "partial"):
            raise RuntimeError(f"alter_table {name}: {resp}")

    def delete_table(self, name: str) -> None:
        resp = self.master_rpc("master.delete_table", {"name": name})
        if resp.get("code") not in ("ok", "not_found"):
            raise RuntimeError(f"delete_table {name}: {resp}")
        self.meta_cache.invalidate(name)

    def open_table(self, name: str) -> YBTable:
        resp = self.master_rpc("master.get_table", {"name": name})
        if resp.get("code") != "ok":
            raise KeyError(f"table {name!r} not found")
        return YBTable(name, resp["table_id"],
                       Schema.from_dict(resp["schema"]),
                       resp.get("engine", "gpu"))

    def list_tables(self) -> list[dict]:
        return self.master_rpc("master.list_tables", {})["tables"]

    def list_tservers(self) -> list[dict]:
        return self.master_rpc("master.list_tservers", {})["tservers"]

    # -- tablet path (TabletInvoker) -----------------------------------------
    def tablet_rpc(self, table_name: str, loc: TabletLocation, method: str,
                   payload: dict, timeout_s: float | None = None,
                   prefer: str | None = None,
                   mark_leader: bool = True) -> dict:
        """Invoke a tablet RPC against its leader, with hint-following and
        replica fallback (reference: TabletInvoker::Execute). ``prefer``
        puts one replica first in the try order (stale same-zone reads);
        ``mark_leader=False`` suppresses leader learning for responses a
        follower may legitimately serve.

        Deadline propagation: every attempt debits ONE RetryPolicy
        budget, and the remaining budget rides in ``payload["timeout"]``
        so the server's read gate / engine batch give up before the
        client stops waiting (the clean "timed_out" reply reaches the
        caller instead of a transport error)."""
        payload = dict(payload, tablet_id=loc.tablet_id)
        payload.setdefault("propagated_ht", self.last_observed_ht)
        tried_refresh = False
        last = None
        for attempt in self.retry_policy.attempts(timeout_s=timeout_s):
            targets = ([loc.leader] if loc.leader else []) + \
                [r for r in loc.replicas if r != loc.leader]
            if prefer is not None and prefer in loc.replicas:
                targets = [prefer] + [t for t in targets if t != prefer]
            for target in targets:
                transport_timeout = attempt.timeout(5.0)
                # Server-side budget: stay below the transport timeout
                # so the server's own timed_out beats the socket's.
                payload["timeout"] = max(0.05,
                                         round(transport_timeout * 0.8, 3))
                try:
                    resp = self.transport.send(target, method, payload,
                                               timeout=transport_timeout)
                except (TransportError, TimeoutError) as e:
                    last = e
                    continue
                code = resp.get("code")
                if code == "not_leader":
                    hint = resp.get("leader_hint")
                    loc.leader = hint
                    self.meta_cache.mark_leader(table_name, loc.tablet_id,
                                                hint)
                    last = resp
                    continue
                if code == "not_found":
                    last = resp
                    continue  # replica being moved/created: try others
                if code == "tablet_split":
                    # The addressed tablet was split: invalidate exactly
                    # that cache entry (siblings keep their locations +
                    # leader hints) and hand re-planning to the caller —
                    # the key now maps to a child tablet the server
                    # can't name for us.
                    self.meta_cache.invalidate_tablet(
                        table_name, resp.get("tablet_id") or loc.tablet_id)
                    raise TabletSplit(resp.get("tablet_id")
                                      or loc.tablet_id)
                if code == "ok":
                    if mark_leader:
                        self.meta_cache.mark_leader(table_name,
                                                    loc.tablet_id, target)
                        loc.leader = target
                    seen = max(resp.get("ht") or 0,
                               resp.get("read_ht") or 0,
                               resp.get("commit_ht") or 0)
                    if seen > self.last_observed_ht:
                        self.last_observed_ht = seen
                    return resp
                if code in TERMINAL_CODES:
                    # Retrying cannot change these outcomes (conflicts,
                    # terminal txn states, rejected read points).
                    err = TabletOpFailed(
                        f"{method} on {loc.tablet_id}: {resp}")
                    err.resp = resp
                    raise err
                last = resp
            if not tried_refresh:
                # Replica set may have changed (re-replication): refresh
                # locations AND tserver addresses (socket mode: a
                # restarted tserver binds a new port).
                tried_refresh = True
                try:
                    self.refresh_tserver_addresses()
                except Exception as e:  # noqa: BLE001 — best effort
                    count_swallowed("client.refresh_tserver_addresses", e)
                locs = None
                try:
                    locs = self.meta_cache.locations(table_name, refresh=True)
                except Exception as e:  # noqa: BLE001
                    last = e
                if locs is not None:
                    found = False
                    for t in locs.tablets:
                        if t.tablet_id == loc.tablet_id:
                            loc = t
                            found = True
                            break
                    if not found and any(
                            t.contains(loc.partition_start)
                            for t in locs.tablets):
                        # The tablet vanished from the table's location
                        # list AND other tablets now own its range: a
                        # split committed while our cache named the
                        # (now-deleted) parent. Hand re-planning to the
                        # caller, same as the tablet_split wire code. A
                        # listing that does NOT cover the range is a
                        # transient partial view (master catching up) —
                        # keep retrying, don't misreport a split.
                        raise TabletSplit(loc.tablet_id)
            attempt.note(last)
        raise TabletOpFailed(
            f"{method} on {loc.tablet_id} failed before deadline: {last}")
