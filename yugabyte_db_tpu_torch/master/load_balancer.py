"""LeaderBalancer: the leader-balancing half of the cluster balancer.

Reference analog: the leader-move side of src/yb/master/cluster_balance.cc
(HandleLeaderMoves): compute per-tserver leader counts from heartbeat soft
state, and when the spread between the most- and least-loaded live
tservers reaches 2, step ONE leader down toward the least-loaded tserver.
One move per pass bounds churn — leadership transfer costs an election
round and a client re-route, so the balancer walks toward even rather
than jumping.

The port's copy of the JAX package's ``master/load_balancer.py``, whole.
"""

from __future__ import annotations

import time

from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.metrics import count_leader_move, count_swallowed


class LeaderBalancer:
    def __init__(self, master, min_move_interval_s: float = 1.0):
        self.m = master
        self.moves_done = 0  # observability / tests
        # Debounce between moves: the skew input is heartbeat-fed soft
        # state, so a transfer needs a heartbeat round to show up in the
        # counts — moving again before that re-fixes stale skew.
        self.min_move_interval_s = min_move_interval_s
        self._last_move = 0.0

    def run_pass(self, force: bool = False) -> dict | None:
        """One balancing pass; returns the move made (or None). ``force``
        (the master.rebalance admin RPC) ignores the enable flag."""
        if not force and not FLAGS.get("enable_leader_balancing"):
            return None
        if not self.m.raft.leader_ready():
            return None
        if time.monotonic() - self._last_move < self.min_move_interval_s:
            return None
        counts = self.m.ts_manager.leader_counts()
        if len(counts) < 2:
            return None
        hi = max(counts, key=lambda u: counts[u])
        lo = min(counts, key=lambda u: counts[u])
        if counts[hi] - counts[lo] < 2:
            return None  # balanced enough; a 1-leader spread is parity
        # Find a tablet the loaded tserver leads whose replica set
        # includes the underloaded one (the target must hold a replica to
        # be electable).
        for t in self.m.catalog.list_tables():
            for info in self.m.catalog.tablets_of(t.table_id):
                if lo not in info.replicas:
                    continue
                if self.m.ts_manager.leader_of(info.tablet_id) != hi:
                    continue
                try:
                    resp = self.m.transport.send(
                        hi, "ts.transfer_leadership",
                        {"tablet_id": info.tablet_id, "target": lo},
                        timeout=5.0)
                except Exception as e:  # noqa: BLE001 — next pass retries
                    count_swallowed("master.leader_move", e)
                    return None
                if resp.get("code") != "ok":
                    count_swallowed("master.leader_move",
                                    resp.get("code"))
                    return None
                count_leader_move()
                self.moves_done += 1
                self._last_move = time.monotonic()
                return {"tablet_id": info.tablet_id,
                        "from": hi, "to": lo}
        return None
