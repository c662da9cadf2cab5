"""Client-side transactions: TransactionManager + YBTransaction.

Reference analog: src/yb/client/transaction.cc (YBTransaction) and
transaction_manager.cc (status-tablet picker). A transaction:

    txn = manager.begin()
    txn.insert(table, {...}); txn.update(...); txn.delete_row(...)
    txn.flush()                  # intents to participant tablets
    commit_ht = txn.commit()     # coordinator decides; applies push async

Reads inside the transaction use txn.snapshot_spec()/txn.get() — a
snapshot at the txn's read point, with the txn's OWN buffered and
flushed writes overlaid for read-your-writes point lookups.

A read AFTER commit that must observe the transaction (causal
read-your-writes across sessions) passes read_ht >= commit_ht explicitly;
the server pins that read point and waits for the apply (the
ConsistentReadPoint contract).

This module lives in ``client/`` (not ``txn/``) because it is client
code: it drives YBClient RPCs and sits above the tablet/consensus layer
exactly like the reference's YBTransaction sits in src/yb/client/. The
server-side machinery (coordinator, participant) stays in ``txn/``; the
shared exception types live in ``txn/errors.py`` so both layers reach
them downward.

The port's copy of the JAX package's ``client/transaction.py``, whole.
"""

from __future__ import annotations

import random
import threading
import time
import uuid as uuid_mod

from yugabyte_db_tpu_torch.client.client import TabletOpFailed, YBClient, YBTable
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema
from yugabyte_db_tpu_torch.storage import wire
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT, RowVersion
from yugabyte_db_tpu_torch.utils.status import TabletSplit
from yugabyte_db_tpu_torch.txn.coordinator import TXN_STATUS_TABLE
from yugabyte_db_tpu_torch.txn.errors import (TransactionAborted,
                                        TransactionConflict)
from yugabyte_db_tpu_torch.utils.metrics import count_swallowed

__all__ = ["TransactionAborted", "TransactionConflict",
           "TransactionManager", "YBTransaction"]


class TransactionManager:
    """Creates transactions against the shared status table."""

    def __init__(self, client: YBClient, num_status_tablets: int = 2,
                 heartbeat_interval_s: float = 2.0):
        self.client = client
        self.heartbeat_interval_s = heartbeat_interval_s
        self._ensured = False
        self.num_status_tablets = num_status_tablets
        # Background heartbeater: keeps every live txn from being expired
        # by the coordinator while the app reads/thinks between flushes
        # (reference: YBTransaction's heartbeat poller, transaction.cc).
        self._live_lock = threading.Lock()
        self._live: dict[str, "YBTransaction"] = {}
        self._hb_thread: threading.Thread | None = None

    def _register(self, txn: "YBTransaction") -> None:
        with self._live_lock:
            self._live[txn.txn_id] = txn
            if self._hb_thread is None:
                self._hb_thread = threading.Thread(
                    target=self._heartbeat_loop, name="txn-heartbeats",
                    daemon=True)
                self._hb_thread.start()

    def _deregister(self, txn_id: str) -> None:
        with self._live_lock:
            self._live.pop(txn_id, None)

    def _heartbeat_loop(self) -> None:
        while True:
            time.sleep(self.heartbeat_interval_s)
            with self._live_lock:
                txns = list(self._live.values())
            for txn in txns:
                if txn._state != "pending":
                    self._deregister(txn.txn_id)
                    continue
                try:
                    self.client.tablet_rpc(
                        TXN_STATUS_TABLE, txn.status_loc,
                        "ts.txn_heartbeat", {"txn_id": txn.txn_id},
                        timeout_s=3.0)
                except Exception as e:  # noqa: BLE001 — retried next tick
                    if getattr(e, "resp", {}).get("code") == "aborted":
                        txn._state = "aborted"
                        self._deregister(txn.txn_id)

    def ensure_status_table(self) -> None:
        # Lock-free: create_table is idempotent (already_present swallowed),
        # so concurrent first-callers racing the RPC is harmless and nobody
        # waits on a lock held across it. `_ensured` is a monotonic bool —
        # the benign double-set is cheaper than serializing begin().
        if self._ensured:
            return
        cols = [ColumnSchema("txn_id", DataType.STRING, ColumnKind.HASH)]
        try:
            self.client.create_table(
                TXN_STATUS_TABLE, cols,
                num_tablets=self.num_status_tablets)
        except Exception as e:  # noqa: BLE001
            if "already_present" not in str(e):
                raise
        self._ensured = True

    def begin(self) -> "YBTransaction":
        self.ensure_status_table()
        locs = self.client.meta_cache.locations(TXN_STATUS_TABLE)
        loc = random.choice(locs.tablets)
        txn_id = uuid_mod.uuid4().hex
        try:
            resp = self.client.tablet_rpc(
                TXN_STATUS_TABLE, loc, "ts.txn_create",
                {"txn_id": txn_id})
        except TabletSplit:
            # The cached status tablet was superseded (a split committed,
            # or a concurrent first-begin recreated the table): re-resolve
            # once against a fresh listing and retry.
            locs = self.client.meta_cache.locations(
                TXN_STATUS_TABLE, refresh=True)
            loc = random.choice(locs.tablets)
            resp = self.client.tablet_rpc(
                TXN_STATUS_TABLE, loc, "ts.txn_create",
                {"txn_id": txn_id})
        txn = YBTransaction(self, txn_id, loc, resp["read_ht"])
        self._register(txn)
        return txn


class YBTransaction:
    def __init__(self, manager: TransactionManager, txn_id: str,
                 status_loc, read_ht: int):
        self.manager = manager
        self.client = manager.client
        self.txn_id = txn_id
        self.status_loc = status_loc
        self.read_ht = read_ht
        self.priority = random.getrandbits(32)
        self._ops: list[tuple[YBTable, int, RowVersion]] = []
        # tablet_id -> leader hint for every tablet holding our intents
        self._participants: dict[str, str | None] = {}
        # own-writes overlay for read-your-writes point gets: key -> row
        self._own: dict[bytes, RowVersion] = {}
        self._own_tables: dict[bytes, YBTable] = {}
        self._state = "pending"
        # SAVEPOINT marks over the CLIENT-BUFFERED write set (ops flush
        # as intents only at commit, so rolling back to a savepoint is a
        # pure buffer truncation — reference: PG subtransaction aborts).
        self._savepoints: list[tuple[str, tuple]] = []
        self._flush_count = 0
        self._last_heartbeat = time.monotonic()
        # Max hybrid time observed from intent writes; propagated to the
        # coordinator at commit so commit_ht exceeds every intent write.
        self._max_write_ht = 0

    # -- write buffering (mirrors YBSession) ---------------------------------
    def insert(self, table: YBTable, values: dict,
               ttl_expire_ht: int = MAX_HT) -> None:
        key_values = {c.name: values[c.name]
                      for c in table.schema.key_columns}
        cols = {table.col_id[c.name]: values[c.name]
                for c in table.schema.value_columns if c.name in values}
        row = RowVersion(table.encode_key(key_values), ht=0, liveness=True,
                         columns=cols, expire_ht=ttl_expire_ht)
        self._buffer(table, table.hash_code(key_values), row)

    def update(self, table: YBTable, key_values: dict,
               set_values: dict) -> None:
        cols = {table.col_id[n]: v for n, v in set_values.items()}
        row = RowVersion(table.encode_key(key_values), ht=0, liveness=False,
                         columns=cols)
        self._buffer(table, table.hash_code(key_values), row)

    def delete_row(self, table: YBTable, key_values: dict) -> None:
        row = RowVersion(table.encode_key(key_values), ht=0, tombstone=True)
        self._buffer(table, table.hash_code(key_values), row)

    def _buffer(self, table: YBTable, hash_code: int, row: RowVersion) -> None:
        self._check_pending()
        self._ops.append((table, hash_code, row))
        prev = self._own.get(row.key)
        if prev is not None and not row.tombstone:
            merged_cols = dict(prev.columns)
            merged_cols.update(row.columns)
            row = RowVersion(row.key, ht=0,
                             liveness=row.liveness or prev.liveness,
                             columns=merged_cols, expire_ht=row.expire_ht)
        self._own[row.key] = row
        self._own_tables[row.key] = table

    # -- savepoints ----------------------------------------------------------
    def savepoint(self, name: str) -> None:
        self._check_pending()
        self._savepoints.append(
            (name, (len(self._ops), self._flush_count, dict(self._own),
                    dict(self._own_tables))))

    def rollback_to_savepoint(self, name: str) -> None:
        self._check_pending()
        for i in range(len(self._savepoints) - 1, -1, -1):
            if self._savepoints[i][0] == name:
                n_ops, fc, own, own_tables = self._savepoints[i][1]
                if fc != self._flush_count:
                    # Intents sent since the savepoint cannot be
                    # retracted (they live at the participants); refuse
                    # rather than silently committing them.
                    raise KeyError(
                        f"savepoint {name} predates a flush of intents")
                del self._ops[n_ops:]
                self._own = dict(own)
                self._own_tables = dict(own_tables)
                # the savepoint itself survives (PG semantics); later
                # ones are destroyed
                del self._savepoints[i + 1:]
                return
        raise KeyError(f"savepoint {name} does not exist")

    def release_savepoint(self, name: str) -> None:
        self._check_pending()
        for i in range(len(self._savepoints) - 1, -1, -1):
            if self._savepoints[i][0] == name:
                del self._savepoints[i:]
                return
        raise KeyError(f"savepoint {name} does not exist")

    # -- intents flush -------------------------------------------------------
    def flush(self, timeout_s: float = 15.0) -> int:
        """Send buffered rows as intents, one RPC per tablet."""
        self._check_pending()
        ops, self._ops = self._ops, []
        if ops:
            self._flush_count += 1
        by_tablet: dict[str, tuple[YBTable, object, list]] = {}
        for table, hash_code, row in ops:
            loc = self.client.meta_cache.lookup_by_hash(table.name,
                                                        hash_code)
            if loc.tablet_id not in by_tablet:
                by_tablet[loc.tablet_id] = (table, loc, [])
            by_tablet[loc.tablet_id][2].append(row)

        written = 0
        for table, loc, rows in by_tablet.values():
            try:
                resp = self.client.tablet_rpc(
                    table.name, loc, "ts.write_intents", {
                        "txn_id": self.txn_id,
                        "status_tablet": self.status_loc.tablet_id,
                        "priority": self.priority,
                        "read_ht": self.read_ht,
                        "rows": wire.encode_rows(rows),
                    }, timeout_s=timeout_s)
                self._max_write_ht = max(self._max_write_ht,
                                         resp.get("ht", 0))
            except TabletOpFailed as e:
                if getattr(e, "resp", {}).get("code") == "conflict":
                    self.abort()
                    raise TransactionConflict(str(e)) from e
                raise
            self._participants[loc.tablet_id] = loc.leader
            written += len(rows)
        return written

    # -- reads ---------------------------------------------------------------
    def get(self, table: YBTable, key_values: dict):
        """Point read at the txn snapshot with read-your-writes."""
        self._check_pending()
        key = table.encode_key(key_values)
        own = self._own.get(key)
        if own is not None:
            if own.tombstone:
                return None
            # Overlay own write onto the committed snapshot value.
            base = self._snapshot_get(table, key_values)
            merged = list(base) if base is not None else None
            names = [c.name for c in table.schema.columns]
            if merged is None:
                if not own.liveness:
                    return None  # update of a non-existent row
                merged = [key_values.get(n) for n in names]
            rev = {cid: n for n, cid in table.col_id.items()}
            for cid, v in own.columns.items():
                merged[names.index(rev[cid])] = v
            return tuple(merged)
        return self._snapshot_get(table, key_values)

    def _snapshot_get(self, table: YBTable, key_values: dict):
        from yugabyte_db_tpu_torch.client.session import YBSession
        from yugabyte_db_tpu_torch.models.encoding import prefix_successor
        from yugabyte_db_tpu_torch.storage.scan_spec import ScanSpec

        key = table.encode_key(key_values)
        spec = ScanSpec(lower=key, upper=prefix_successor(key),
                        read_ht=self.read_ht, limit=1)
        res = YBSession(self.client).scan(table, spec)
        return res.rows[0] if res.rows else None

    def own_rows(self, table: YBTable) -> dict:
        """This txn's buffered/flushed writes to ``table``, merged per
        key (the _own overlay) — range-reading statements need to see
        earlier statements' effects."""
        return {k: row for k, row in self._own.items()
                if self._own_tables[k].name == table.name}

    def snapshot_spec(self, **kwargs):
        """A ScanSpec pinned to the txn read point (range reads see the
        snapshot; own uncommitted writes are NOT merged into range
        scans — the reference's docdb does that in IntentAwareIterator;
        here apps read-own-writes via get())."""
        from yugabyte_db_tpu_torch.storage.scan_spec import ScanSpec

        kwargs.setdefault("read_ht", self.read_ht)
        return ScanSpec(**kwargs)

    # -- lifecycle -----------------------------------------------------------
    def _check_pending(self) -> None:
        if self._state != "pending":
            raise TransactionAborted(f"transaction is {self._state}")

    def commit(self, timeout_s: float = 15.0) -> int:
        """Flush remaining intents and commit. Returns the commit hybrid
        time (pass as read_ht to later reads that must observe this txn)."""
        self._check_pending()
        if self._ops:
            self.flush(timeout_s=timeout_s)
        participants = [[tid, hint]
                        for tid, hint in self._participants.items()]
        try:
            resp = self.client.tablet_rpc(
                TXN_STATUS_TABLE, self.status_loc, "ts.txn_commit", {
                    "txn_id": self.txn_id, "participants": participants,
                    "propagated_ht": self._max_write_ht,
                }, timeout_s=timeout_s)
        except TabletOpFailed as e:
            self._state = "aborted"
            self.manager._deregister(self.txn_id)
            raise TransactionAborted(str(e)) from e
        self._state = "committed"
        self.manager._deregister(self.txn_id)
        return resp["commit_ht"]

    def abort(self) -> None:
        if self._state != "pending":
            return
        self._state = "aborted"
        self.manager._deregister(self.txn_id)
        participants = [[tid, hint]
                        for tid, hint in self._participants.items()]
        try:
            self.client.tablet_rpc(
                TXN_STATUS_TABLE, self.status_loc, "ts.txn_abort", {
                    "txn_id": self.txn_id, "participants": participants,
                })
        except Exception as e:  # noqa: BLE001 — expiry will abort it anyway
            count_swallowed("txn.abort", e)
