"""Heartbeater: periodic tserver -> master liveness + tablet reports.

Reference analog: src/yb/tserver/heartbeater.{h,cc} — finds the master
leader (trying each master, following NOT_THE_LEADER hints), registers on
first contact, and ships incremental tablet reports; the master answers
with the catalog's view (e.g. tablets to delete).

The port's copy of the JAX package's ``tserver/heartbeater.py``, whole.
"""

from __future__ import annotations

import threading
import time

from yugabyte_db_tpu_torch.utils.locking import guarded_by
from yugabyte_db_tpu_torch.utils.retry import RetryPolicy


# The heartbeat thread and the server's start/stop/trigger callers share
# these; _wake/-thread lifecycle needs no lock (Event is self-locking,
# _thread is written before start() returns).
@guarded_by("_lock", "_leader_hint", "_running", "last_response",
            "consecutive_failures")
class Heartbeater:
    def __init__(self, server, master_uuids: list[str],
                 interval_s: float = 0.5):
        self.server = server
        self.master_uuids = list(master_uuids)
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._leader_hint: str | None = None
        self._running = False
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self.last_response: dict | None = None
        self.consecutive_failures = 0
        # Per-heartbeat budget: a couple of failover sweeps with jittered
        # backoff, bounded well below the stop() join timeout so a
        # leaderless master quorum can't wedge shutdown.
        self.retry_policy = RetryPolicy(
            timeout_s=max(2.0, interval_s * 4),
            initial_backoff_s=0.05, max_backoff_s=0.5)

    def start(self) -> None:
        with self._lock:
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, name=f"heartbeat-{self.server.uuid}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def trigger(self) -> None:
        """Heartbeat now (e.g. right after a tablet state change)."""
        self._wake.set()

    def _loop(self) -> None:
        while self._running:
            try:
                self._heartbeat_once()
                with self._lock:
                    self.consecutive_failures = 0
            except Exception:
                with self._lock:
                    self.consecutive_failures += 1
                    self._leader_hint = None
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()

    def _heartbeat_once(self) -> None:
        req = {
            "ts_uuid": self.server.uuid,
            "addr": self.server.advertised_addr,
            "cloud_info": getattr(self.server, "cloud_info", None) or {},
            "tablets": self.server.tablet_manager.tablet_reports(),
            "num_live_tablets": len(self.server.tablet_manager.peers()),
        }
        last: object = None
        for attempt in self.retry_policy.attempts():
            if not self._running:
                return
            # A fresh hint learned mid-sweep gets tried first next sweep.
            targets = ([self._leader_hint] if self._leader_hint else []) + [
                u for u in self.master_uuids if u != self._leader_hint]
            for target in targets:
                try:
                    resp = self.server.transport.send(
                        target, "master.ts_heartbeat", req,
                        timeout=attempt.timeout(2.0))
                except Exception as e:  # noqa: BLE001 — try the next master
                    last = e
                    continue
                if resp.get("code") == "not_leader":
                    with self._lock:
                        self._leader_hint = resp.get("leader_hint")
                    last = resp
                    continue
                with self._lock:
                    self._leader_hint = target
                    self.last_response = resp
                self.server.process_heartbeat_response(resp)
                return
            attempt.note(last)
        if isinstance(last, Exception):
            raise last
        raise ConnectionError(f"no master leader reachable ({last})")
