"""Server-side transaction plumbing: status resolution + apply push.

Reference analogs: the status-resolution clients inside
src/yb/tablet/transaction_participant.cc (StatusRequest to the txn's
status tablet) and the coordinator's poller that pushes apply/cleanup to
participants (transaction_coordinator.cc polling + UpdateTransaction
RPCs, src/yb/tserver/tserver_service.proto:59).

The port's copy of the JAX package's ``tserver/txn_service.py``, whole.
"""

from __future__ import annotations

import threading

from yugabyte_db_tpu_torch.utils.metrics import count_swallowed
from yugabyte_db_tpu_torch.utils.retry import Deadline


class TxnRpcRouter:
    """Leader-following RPC helper for per-tablet transaction RPCs.

    Routes by trying a hint first, following "not_leader" hints, and —
    when candidates run out — asking the master where the tablet lives
    (master.locate_tablet), so notifications survive leader moves and
    re-replication."""

    def __init__(self, transport, master_uuids: list[str]):
        self.transport = transport
        self.master_uuids = list(master_uuids)
        self._lock = threading.Lock()
        self._leader_cache: dict[str, str] = {}     # tablet_id -> uuid
        self._replica_cache: dict[str, list[str]] = {}

    # -- master lookups ------------------------------------------------------
    def _locate(self, tablet_id: str) -> None:
        targets = list(self.master_uuids)
        for target in targets:
            try:
                resp = self.transport.send(
                    target, "master.locate_tablet",
                    {"tablet_id": tablet_id}, timeout=2.0)
            except Exception as e:  # noqa: BLE001 — try next master
                count_swallowed("txn_router.locate", e)
                continue
            if resp.get("code") == "not_leader":
                hint = resp.get("leader_hint")
                if hint and hint not in targets:
                    targets.append(hint)
                continue
            if resp.get("code") != "ok":
                return
            with self._lock:
                if resp.get("leader"):
                    self._leader_cache[tablet_id] = resp["leader"]
                self._replica_cache[tablet_id] = list(resp["replicas"])
            return

    def tablet_rpc(self, tablet_id: str, method: str, payload: dict,
                   hint: str | None = None,
                   timeout: float = 2.0) -> dict | None:
        """Send a per-tablet RPC to its leader. Returns the ok response or
        None when no leader answered."""
        payload = dict(payload, tablet_id=tablet_id)
        # One propagated budget for the whole leader hunt: the hint, the
        # cached leader, every replica, and (once) a master re-locate all
        # debit it; per-send waits are capped at the remainder.
        deadline = Deadline.after(timeout * 3)
        seen = set()
        located = False
        with self._lock:
            cached = self._leader_cache.get(tablet_id)
            replicas = list(self._replica_cache.get(tablet_id, []))
        targets = []
        for t in (hint, cached, *replicas):
            if t and t not in targets:
                targets.append(t)
        while not deadline.expired():
            if not targets:
                if located:
                    return None
                located = True
                self._locate(tablet_id)
                with self._lock:
                    cached = self._leader_cache.get(tablet_id)
                    replicas = list(self._replica_cache.get(tablet_id, []))
                targets = [t for t in (cached, *replicas)
                           if t and t not in seen]
                if not targets:
                    return None
                continue
            target = targets.pop(0)
            if target in seen:
                continue
            seen.add(target)
            try:
                resp = self.transport.send(target, method, payload,
                                           timeout=deadline.timeout(timeout))
            except Exception as e:  # noqa: BLE001 — next candidate
                count_swallowed("txn_router.call", e)
                continue
            if resp.get("code") == "not_leader":
                nxt = resp.get("leader_hint")
                if nxt and nxt not in seen:
                    targets.insert(0, nxt)
                continue
            if resp.get("code") == "ok":
                with self._lock:
                    self._leader_cache[tablet_id] = target
                return resp
            return resp  # terminal non-ok (conflict, aborted, ...)
        return None


class TxnNotifier:
    """Coordinator-side background worker of one tserver: aborts expired
    transactions and pushes apply/remove notifications to participants
    until acknowledged. Runs against every status-tablet peer this server
    currently leads."""

    def __init__(self, server, router: TxnRpcRouter,
                 interval_s: float = 0.25):
        self.server = server
        self.router = router
        self.interval_s = interval_s
        self._running = False
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name=f"txn-notify-{self.server.uuid}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def trigger(self) -> None:
        self._wake.set()

    def _loop(self) -> None:
        while self._running:
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()
            if not self._running:
                return
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — next tick retries
                count_swallowed("txn_service.tick", e)

    def _tick(self) -> None:
        for peer in self.server.tablet_manager.peers():
            coord = peer.tablet.coordinator
            if coord is None or not peer.raft.is_leader():
                continue
            for txn_id in coord.expired_txns():
                try:
                    peer.replicate_txn_op("txn_status", {
                        "action": "abort", "txn_id": txn_id,
                        "participants": [],
                    })
                except Exception as e:  # noqa: BLE001 — next tick retries
                    count_swallowed("txn_service.expire_abort", e)
            for txn_id, action, commit_ht, unacked in \
                    coord.pending_notifications():
                for tablet_id, hint in unacked:
                    method = ("ts.apply_txn" if action == "apply"
                              else "ts.remove_txn")
                    resp = self.router.tablet_rpc(
                        tablet_id, method,
                        {"txn_id": txn_id, "commit_ht": commit_ht},
                        hint=hint)
                    if resp is not None and resp.get("code") == "ok":
                        try:
                            peer.replicate_txn_op("txn_status", {
                                "action": "ack", "txn_id": txn_id,
                                "tablet_id": tablet_id,
                            })
                        except Exception as e:  # noqa: BLE001 — re-notified
                            count_swallowed("txn_service.ack", e)
            for txn_id in coord.gc_candidates():
                try:
                    peer.replicate_txn_op("txn_status", {
                        "action": "gc", "txn_id": txn_id})
                except Exception as e:  # noqa: BLE001 — next tick retries
                    count_swallowed("txn_service.gc", e)
