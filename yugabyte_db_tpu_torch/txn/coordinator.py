"""TransactionCoordinator: the status-tablet state machine.

Reference analog: src/yb/tablet/transaction_coordinator.cc — transaction
status records live in a dedicated status tablet and every state change
is Raft-replicated through that tablet's log (op type "txn_status"), so
the record survives leader failover. States:

    PENDING ──commit──> COMMITTED(commit_ht)   (terminal)
        └────abort────> ABORTED                (terminal)

The commit hybrid time is chosen by the coordinator AT REPLICATION of the
COMMITTED record. Status queries carry the asker's read time and the
coordinator ratchets its clock past it first — so a "pending" answer is a
guarantee: if the txn commits later, its commit_ht will exceed the
asker's read time, and the asker may safely ignore the intents
(the reference's StatusRequest serving_ht contract).

After commit/abort the leader pushes apply/remove notifications to every
participant tablet until each acknowledges (resumed from scratch by a new
leader — notifications are idempotent on the participant).

The port's copy of the JAX package's ``txn/coordinator.py``, whole
(``txn_state.json`` is the JAX tablet's sidecar); its default expiry is
the port's ``txn_expiry_s`` flag.
"""

from __future__ import annotations

import json
import os
import threading
import time

TXN_STATUS_TABLE = "sys.transactions"

# Txns whose client stops heartbeating are presumed dead and aborted by
# the coordinator so conflicting writers / waiting readers make progress
# (reference: FLAGS_transaction_check_interval_ms + expiration); the
# default expiry comes from the txn_expiry_s runtime flag.


class TransactionCoordinator:
    """State machine + notifier for one status tablet."""

    def __init__(self, tablet_dir: str, expiry_s: float | None = None):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # Leader-side soft state: commits whose Raft entry is in flight.
        # A status query must NOT answer "pending" while one of these
        # exists — the entry may commit with commit_ht below the asker's
        # read time, breaking the "pending means any future commit lands
        # above your read time" promise.
        self._committing: dict[str, int] = {}
        from yugabyte_db_tpu_torch.utils.flags import FLAGS

        if expiry_s is None:
            expiry_s = FLAGS.get("txn_expiry_s")
        self.path = os.path.join(tablet_dir, "txn_state.json")
        # txn_id -> local time its record became fully applied (soft
        # state driving the replicated GC after the retention window).
        self._done_seen: dict[str, float] = {}
        self.done_retention_s = 15.0
        # txn_id -> {"status": "pending"|"committed"|"aborted",
        #            "commit_ht": int,
        #            "participants": [[tablet_id, leader_hint]...],
        #            "unacked": [[tablet_id, leader_hint]...]}
        self.txns: dict[str, dict] = {}
        self._heartbeats: dict[str, float] = {}  # local soft state
        self.expiry_s = expiry_s
        self.load()

    # -- persistence --------------------------------------------------------
    def load(self) -> None:
        if os.path.exists(self.path):
            with open(self.path) as f:
                loaded = json.load(f)
            with self._lock:
                self.txns = loaded

    def dump(self) -> dict:
        with self._lock:
            return {k: {**v,
                        "participants": [list(p) for p in v["participants"]],
                        "unacked": [list(u) for u in v["unacked"]]}
                    for k, v in self.txns.items()}

    def snapshot(self) -> None:
        d = self.dump()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- Raft-applied state changes -----------------------------------------
    def apply_status_op(self, body: dict) -> None:
        action = body["action"]
        txn_id = body["txn_id"]
        with self._lock:
            rec = self.txns.get(txn_id)
            if action == "create":
                if rec is None:
                    self.txns[txn_id] = {"status": "pending", "commit_ht": 0,
                                         "participants": [], "unacked": []}
                    self._heartbeats[txn_id] = time.monotonic()
            elif action == "commit":
                # Commit applies ONLY onto an existing pending record: a
                # missing record means the txn was aborted (record dropped
                # by a participant-less abort) or already fully applied —
                # committing onto None would resurrect an aborted txn whose
                # intents a wounding writer already removed (partial
                # commit). The ordered log arbitrates commit-vs-abort.
                if rec is not None and rec["status"] == "pending":
                    parts = list(body.get("participants", []))
                    self.txns[txn_id] = {
                        "status": "committed",
                        "commit_ht": body["commit_ht"],
                        "participants": parts,
                        "unacked": list(parts),
                    }
            elif action == "abort":
                if rec is None or rec["status"] == "pending":
                    parts = list(body.get("participants", []))
                    if parts:
                        self.txns[txn_id] = {
                            "status": "aborted", "commit_ht": 0,
                            "participants": parts, "unacked": list(parts),
                        }
                    else:
                        # No known participants: drop the record — an
                        # unknown txn reads as aborted, and stray intents
                        # are cleaned lazily on conflict/read resolution.
                        self.txns.pop(txn_id, None)
                        self._heartbeats.pop(txn_id, None)
            elif action == "ack":
                if rec is not None:
                    rec["unacked"] = [u for u in rec["unacked"]
                                      if u[0] != body["tablet_id"]]
                    # Fully-applied records are NOT dropped here: a client
                    # retrying a commit whose response was lost must still
                    # read "committed". The notifier GCs them after a
                    # retention window via a replicated "gc" op.
            elif action == "gc":
                if rec is not None and rec["status"] != "pending" and \
                        not rec["unacked"]:
                    del self.txns[txn_id]
                    self._heartbeats.pop(txn_id, None)
                    self._done_seen.pop(txn_id, None)

    # -- commit-time choreography -------------------------------------------
    def choose_commit_ht(self, txn_id: str, clock) -> int:
        """Pick the commit hybrid time and mark the commit in flight —
        atomically with respect to resolve_status()'s clock ratchet, so
        a status query either sees the in-flight commit or has already
        ratcheted the clock above its own read time."""
        with self._lock:
            ht = clock.now().value
            self._committing[txn_id] = ht
            return ht

    def finish_commit_attempt(self, txn_id: str) -> None:
        with self._lock:
            self._committing.pop(txn_id, None)
            self._cond.notify_all()

    def resolve_status(self, txn_id: str, read_ht: int, clock,
                       timeout: float = 3.0) -> dict | None:
        """Status at the asker's read time. Ratchets the clock past
        read_ht first (the promise), then waits out any in-flight commit
        of this txn. None = could not resolve within the timeout."""
        from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime

        deadline = time.monotonic() + timeout
        with self._lock:
            clock.update(HybridTime(read_ht))
            while txn_id in self._committing:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
        return self.status(txn_id)

    # -- queries ------------------------------------------------------------
    def status(self, txn_id: str) -> dict:
        with self._lock:
            rec = self.txns.get(txn_id)
            if rec is None:
                # Unknown: never created, or committed+fully applied, or
                # aborted+cleaned. For a reader this is indistinguishable
                # from "aborted" EXCEPT that a fully-applied commit's rows
                # are already in the engines — both answers read correctly.
                return {"status": "aborted", "commit_ht": 0}
            return {"status": rec["status"], "commit_ht": rec["commit_ht"]}

    def heartbeat(self, txn_id: str) -> bool:
        with self._lock:
            rec = self.txns.get(txn_id)
            if rec is None or rec["status"] != "pending":
                return False
            self._heartbeats[txn_id] = time.monotonic()
            return True

    def expired_txns(self) -> list[str]:
        """Pending txns whose client went silent (leader-side soft check;
        the abort itself is replicated like any other)."""
        now = time.monotonic()
        out = []
        with self._lock:
            for txn_id, rec in self.txns.items():
                if rec["status"] != "pending":
                    continue
                hb = self._heartbeats.get(txn_id)
                if hb is None:
                    # Seen via replay/failover with no local heartbeat yet:
                    # start the clock now.
                    self._heartbeats[txn_id] = now
                elif now - hb > self.expiry_s:
                    out.append(txn_id)
        return out

    def pending_notifications(self) -> list[tuple[str, str, int, list[str]]]:
        """(txn_id, action, commit_ht, unacked tablets) for resolved txns
        whose participants haven't all acknowledged."""
        out = []
        with self._lock:
            for txn_id, rec in self.txns.items():
                if rec["status"] == "committed" and rec["unacked"]:
                    out.append((txn_id, "apply", rec["commit_ht"],
                                list(rec["unacked"])))
                elif rec["status"] == "aborted" and rec["unacked"]:
                    out.append((txn_id, "remove", 0, list(rec["unacked"])))
        return out

    def gc_candidates(self) -> list[str]:
        """Fully-applied records past the retention window (kept that
        long so commit retries stay answerable)."""
        now = time.monotonic()
        out = []
        with self._lock:
            for txn_id, rec in self.txns.items():
                if rec["status"] == "pending" or rec["unacked"]:
                    self._done_seen.pop(txn_id, None)
                    continue
                first = self._done_seen.setdefault(txn_id, now)
                if now - first > self.done_retention_s:
                    out.append(txn_id)
        return out

    def stats(self) -> dict:
        with self._lock:
            by_status: dict[str, int] = {}
            for rec in self.txns.values():
                by_status[rec["status"]] = by_status.get(rec["status"], 0) + 1
            return {"txn_records": len(self.txns), **by_status}
