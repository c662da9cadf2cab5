"""TransactionParticipant: per-tablet provisional writes (intents).

Reference analog: src/yb/tablet/transaction_participant.cc and the
intents RocksDB of src/yb/tablet/tablet.h:644-646. Here intents are a
small host-side store (dict keyed by txn and by row key) whose mutations
ride the tablet's Raft log as dedicated op types:

    "intents"         txn writes its provisional rows
    "apply_intents"   commit: move the txn's rows into the engine at the
                      coordinator-chosen commit hybrid time
    "remove_intents"  abort cleanup

State is rebuilt from the log on bootstrap; flush() snapshots it to a
sidecar (intents.json) before the WAL replay frontier advances, exactly
like the engine's flushed runs.

Conflict rules (src/yb/docdb/conflict_resolution.cc):
- write-write against a COMMITTED version newer than the writer's read
  point -> conflict (first committer wins; snapshot isolation);
- against another txn's PENDING intent -> priority duel: the would-be
  writer loses unless its priority is strictly higher (the caller then
  aborts the other txn through the coordinator and retries).

The port's copy of the JAX package's ``txn/participant.py``, whole: the
sidecar (``intents.bin``) is the JAX tablet's byte for byte.
"""

from __future__ import annotations

import os
import threading

from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.storage.wire import decode_rows, encode_rows


class IntentConflict(Exception):
    """Write-write conflict. .conflicting carries (txn_id, status_tablet,
    priority) triples of pending foreign intents on the contested keys
    (empty when the conflict is against committed data)."""

    def __init__(self, message: str, conflicting=()):
        super().__init__(message)
        self.conflicting = tuple(conflicting)


class TransactionParticipant:
    """Host-side intent store of one tablet."""

    def __init__(self, tablet_dir: str):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.path = os.path.join(tablet_dir, "intents.bin")
        # txn_id -> {"rows": [RowVersion...], "status_tablet": str,
        #            "priority": int, "read_ht": int}
        self.txns: dict[str, dict] = {}
        # row key -> set of txn ids holding intents on it
        self.by_key: dict[bytes, set[str]] = {}
        self.load()

    # -- persistence (sidecar snapshot at flush) ----------------------------
    def load(self) -> None:
        from yugabyte_db_tpu_torch.utils import codec

        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            d = codec.decode(f.read())
        for txn_id, rec in d.items():
            rows = decode_rows(rec["rows"])
            self._add_locked(txn_id, rec["status_tablet"], rec["priority"],
                             rec["read_ht"], rows)

    def dump(self) -> dict:
        """Serializable snapshot of every txn's intents (sidecar format,
        also the remote-bootstrap payload)."""
        with self._lock:
            return {
                txn_id: {
                    "rows": encode_rows(rec["rows"]),
                    "status_tablet": rec["status_tablet"],
                    "priority": rec["priority"],
                    "read_ht": rec["read_ht"],
                }
                for txn_id, rec in self.txns.items()
            }

    def snapshot(self) -> None:
        """Durably snapshot current intents (called under the tablet's
        write lock by flush(), before the WAL frontier advances)."""
        from yugabyte_db_tpu_torch.utils import codec

        d = self.dump()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(codec.encode(d))
            f.flush()
            # Runs under the tablet's flush barrier (see docstring):
            # intents must be durable before the WAL frontier advances
            # past the segments they replay from.
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- log-applied mutations ----------------------------------------------
    def _add_locked(self, txn_id, status_tablet, priority, read_ht, rows):
        rec = self.txns.setdefault(txn_id, {
            "rows": [], "status_tablet": status_tablet,
            "priority": priority, "read_ht": read_ht,
        })
        rec["rows"].extend(rows)
        for r in rows:
            self.by_key.setdefault(r.key, set()).add(txn_id)

    def apply_intents_op(self, body: dict) -> None:
        """Raft-apply of an "intents" entry."""
        rows = decode_rows(body["rows"])
        with self._lock:
            self._add_locked(body["txn_id"], body["status_tablet"],
                             body["priority"], body["read_ht"], rows)

    def apply_commit_op(self, body: dict, engine_apply) -> None:
        """Raft-apply of "apply_intents": move rows to the engine at the
        commit hybrid time. Idempotent: a retried notification finds no
        intents and is a no-op. The engine apply happens BEFORE the
        intents disappear / waiters wake — a reader released by wait_gone
        must find the rows already in the engine."""
        txn_id = body["txn_id"]
        commit_ht = body["commit_ht"]
        with self._lock:
            rec = self.txns.get(txn_id)
            if rec is None:
                return
            rows = [
                RowVersion(r.key, ht=commit_ht, tombstone=r.tombstone,
                           liveness=r.liveness, columns=r.columns,
                           expire_ht=r.resolve_ttl(commit_ht))
                for r in rec["rows"]
            ]
        engine_apply(rows)
        with self._lock:
            rec = self.txns.pop(txn_id, None)
            if rec is not None:
                self._unindex_locked(txn_id, rec)
                self._cond.notify_all()

    def apply_remove_op(self, body: dict) -> None:
        """Raft-apply of "remove_intents" (abort cleanup). Idempotent."""
        with self._lock:
            rec = self.txns.pop(body["txn_id"], None)
            if rec is not None:
                self._unindex_locked(body["txn_id"], rec)
                self._cond.notify_all()

    def _unindex_locked(self, txn_id, rec) -> None:
        for r in rec["rows"]:
            s = self.by_key.get(r.key)
            if s is not None:
                s.discard(txn_id)
                if not s:
                    del self.by_key[r.key]

    # -- conflict detection (leader-side, before replication) ---------------
    def check_conflicts(self, txn_id: str, keys: list[bytes],
                        read_ht: int, latest_committed_ht) -> None:
        """Raise IntentConflict if writing ``keys`` conflicts.

        ``latest_committed_ht(key)`` -> newest committed version ht (0 if
        none) — supplied by the tablet so the store stays engine-agnostic.
        """
        pending = {}
        with self._lock:
            for key in keys:
                for other in self.by_key.get(key, ()):  # foreign intents
                    if other != txn_id:
                        rec = self.txns[other]
                        pending[other] = (rec["status_tablet"],
                                          rec["priority"])
        for key in keys:
            ht = latest_committed_ht(key)
            if ht > read_ht:
                raise IntentConflict(
                    f"committed write at ht {ht} is newer than txn read "
                    f"point {read_ht} (first committer wins)")
        if pending:
            raise IntentConflict(
                "pending intents held by other transactions",
                conflicting=[(t, st, pr)
                             for t, (st, pr) in pending.items()])

    def pending_on_keys(self, keys: list[bytes],
                        exclude: str | None = None) -> list[tuple]:
        """(txn_id, status_tablet, priority) of foreign intents on keys."""
        out = {}
        with self._lock:
            for key in keys:
                for t in self.by_key.get(key, ()):
                    if t != exclude:
                        rec = self.txns[t]
                        out[t] = (rec["status_tablet"], rec["priority"])
        return [(t, st, pr) for t, (st, pr) in out.items()]

    # -- read-side ----------------------------------------------------------
    def txns_overlapping(self, lower: bytes, upper: bytes) -> dict[str, dict]:
        """Foreign-intent metadata for txns with intents in [lower, upper)."""
        out = {}
        with self._lock:
            for key, txn_ids in self.by_key.items():
                if key < lower or (upper and key >= upper):
                    continue
                for t in txn_ids:
                    rec = self.txns[t]
                    out[t] = {"status_tablet": rec["status_tablet"]}
        return out

    def wait_gone(self, txn_id: str, timeout: float) -> bool:
        """Wait until a txn's intents are applied or removed locally."""
        import time

        deadline = time.monotonic() + timeout
        with self._lock:
            while txn_id in self.txns:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def has_intents(self, txn_id: str) -> bool:
        with self._lock:
            return txn_id in self.txns

    def stats(self) -> dict:
        with self._lock:
            return {"txns_with_intents": len(self.txns),
                    "intent_keys": len(self.by_key)}
