"""TSManager: tserver liveness + soft cluster state from heartbeats.

Reference analog: src/yb/master/ts_manager.{h,cc} + TSDescriptor — last
heartbeat time, reported tablets, and the per-tablet leader hints the
location cache serves. Soft state: NOT replicated, rebuilt from heartbeats
after master failover (exactly the reference's design).

The port's copy of the JAX package's ``master/ts_manager.py``, whole.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class TSDescriptor:
    uuid: str
    addr: object = None
    last_heartbeat: float = 0.0
    num_live_tablets: int = 0
    tablet_roles: dict = field(default_factory=dict)  # tablet_id -> role
    # Topology labels (reference: CloudInfoPB, master.proto:172):
    # {"cloud", "region", "zone"} — empty for unlabeled tservers.
    cloud_info: dict = field(default_factory=dict)


class TSManager:
    def __init__(self, unresponsive_timeout_s: float | None = None):
        if unresponsive_timeout_s is None:
            from yugabyte_db_tpu_torch.utils.flags import FLAGS

            unresponsive_timeout_s = FLAGS.get(
                "follower_unavailable_considered_failed_sec")
        self._lock = threading.Lock()
        self._descs: dict[str, TSDescriptor] = {}
        # tablet_id -> (leader uuid, term): freshest leadership seen.
        self._tablet_leaders: dict[str, tuple[str, int]] = {}
        # tablet_id -> (raft config peers, term) as reported by the
        # freshest leader replica — the authoritative membership view the
        # repair paths compare against the catalog.
        self._tablet_configs: dict[str, tuple[tuple, int]] = {}
        # Split-manager inputs, from the LEADER replica's heartbeat
        # stats: on-disk size, and the raw data-op counter differentiated
        # across successive samples into an ops/s rate (soft state, like
        # everything else here).
        self._tablet_sizes: dict[str, int] = {}
        self._tablet_ops: dict[str, tuple[int, float]] = {}
        self._tablet_rates: dict[str, float] = {}
        self.unresponsive_timeout_s = unresponsive_timeout_s

    def heartbeat(self, req: dict) -> None:
        now = time.monotonic()
        with self._lock:
            d = self._descs.get(req["ts_uuid"])
            if d is None:
                d = TSDescriptor(req["ts_uuid"])
                self._descs[d.uuid] = d
            d.addr = req.get("addr")
            d.cloud_info = req.get("cloud_info") or {}
            d.last_heartbeat = now
            d.num_live_tablets = req.get("num_live_tablets", 0)
            # Normalize roles at the ingestion boundary: raft reports
            # "LEADER"/"FOLLOWER" (Role enum values) while every
            # consumer here compares lowercase.
            d.tablet_roles = {t["tablet_id"]: str(t.get("role", "")).lower()
                              for t in req.get("tablets", [])}
            for t in req.get("tablets", []):
                role = str(t.get("role", "")).lower()
                leader, term = t.get("leader"), t.get("term", 0)
                if leader:
                    cur = self._tablet_leaders.get(t["tablet_id"])
                    if cur is None or term >= cur[1]:
                        self._tablet_leaders[t["tablet_id"]] = (leader, term)
                if role == "leader" and t.get("peers"):
                    cur = self._tablet_configs.get(t["tablet_id"])
                    if cur is None or term >= cur[1]:
                        self._tablet_configs[t["tablet_id"]] = (
                            tuple(t["peers"]), term)
                st = t.get("stats")
                if st and role == "leader":
                    tid = t["tablet_id"]
                    self._tablet_sizes[tid] = st.get("size_bytes", 0)
                    ops = st.get("ops_seen", 0)
                    prev = self._tablet_ops.get(tid)
                    self._tablet_ops[tid] = (ops, now)
                    if prev is not None and now > prev[1]:
                        delta = ops - prev[0]
                        if delta < 0:
                            # counter restarted (tserver bounce or
                            # leadership moved to a fresh replica)
                            delta = ops
                        self._tablet_rates[tid] = \
                            delta / (now - prev[1])

    def live_tservers(self) -> list[TSDescriptor]:
        cutoff = time.monotonic() - self.unresponsive_timeout_s
        with self._lock:
            return [d for d in self._descs.values()
                    if d.last_heartbeat >= cutoff]

    def dead_tservers(self) -> list[TSDescriptor]:
        cutoff = time.monotonic() - self.unresponsive_timeout_s
        with self._lock:
            return [d for d in self._descs.values()
                    if d.last_heartbeat < cutoff]

    def all_tservers(self) -> list[TSDescriptor]:
        with self._lock:
            return list(self._descs.values())

    def leader_of(self, tablet_id: str) -> str | None:
        with self._lock:
            v = self._tablet_leaders.get(tablet_id)
            return v[0] if v else None

    def config_of(self, tablet_id: str) -> tuple | None:
        """Raft config peers as last reported by the tablet's leader."""
        with self._lock:
            v = self._tablet_configs.get(tablet_id)
            return v[0] if v else None

    def addr_of(self, uuid: str):
        with self._lock:
            d = self._descs.get(uuid)
            return d.addr if d else None

    def cloud_info_of(self, uuid: str) -> dict:
        with self._lock:
            d = self._descs.get(uuid)
            return dict(d.cloud_info) if d else {}

    def tablet_load(self, tablet_id: str) -> tuple[int, float]:
        """(size_bytes, ops_per_sec) from the leader's latest heartbeat
        stats — the split manager's trigger inputs."""
        with self._lock:
            return (self._tablet_sizes.get(tablet_id, 0),
                    self._tablet_rates.get(tablet_id, 0.0))

    def forget_tablet(self, tablet_id: str) -> None:
        """Drop soft per-tablet state after a split removes the tablet
        (stale rate samples must not re-trigger on a reused id)."""
        with self._lock:
            self._tablet_sizes.pop(tablet_id, None)
            self._tablet_ops.pop(tablet_id, None)
            self._tablet_rates.pop(tablet_id, None)
            self._tablet_leaders.pop(tablet_id, None)
            self._tablet_configs.pop(tablet_id, None)

    def leader_counts(self) -> dict[str, int]:
        """LIVE tserver uuid -> number of tablet leaders it hosts (the
        leader balancer's skew input). Every live tserver appears, even
        with zero leaders — an idle node is the balancer's best target."""
        cutoff = time.monotonic() - self.unresponsive_timeout_s
        with self._lock:
            return {d.uuid: sum(1 for r in d.tablet_roles.values()
                                if r == "leader")
                    for d in self._descs.values()
                    if d.last_heartbeat >= cutoff}
