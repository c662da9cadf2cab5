"""SplitManager: master-driven tablet splitting.

Reference analog: src/yb/master/tablet_split_manager.cc — the background
pass over heartbeat-reported tablet stats that picks oversized / overloaded
tablets and drives the split state machine, plus the manual SplitTablet
admin RPC entry point.

Split protocol (each numbered phase is restartable — the replicated
lineage record in CatalogState.splits is the recovery point):

  1. ts.get_split_key     parent leader flushes and returns the median
                          resident key hash (split point).
  2. split_tablet op      children + lineage registered in the replicated
                          catalog BEFORE any child replica exists, so the
                          heartbeat orphan-GC never deletes a half-created
                          child. Lookups still resolve to the parent.
  3. ts.create_tablet     empty children dispatched to the parent's
                          replica set; wait for each child to elect a
                          leader (heartbeat-fed ts_manager).
  4. ts.split_seal        parent stops admitting writes by replicating a
                          seal entry through its OWN Raft log — every
                          acked write sits below the seal.
  5. ts.split_fork/seed   frozen parent rows, range-clamped per child,
                          replicated through each CHILD leader's Raft log
                          with their original hybrid times (identical
                          state on every child replica).
  6. split_commit op      parent -> children swapped in the table's
                          serving list; the parent's replicas are
                          tombstoned (explicit delete + heartbeat GC).

Clients addressing the parent after phase 4 get the "tablet_split" wire
code and re-plan from fresh locations at TABLET granularity.

The port's copy of the JAX package's ``master/split_manager.py``, whole.
"""

from __future__ import annotations

import threading
import time
import uuid as uuid_mod

from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.metrics import count_swallowed, count_tablet_split


class SplitError(Exception):
    pass


class SplitManager:
    def __init__(self, master):
        self.m = master
        self._lock = threading.Lock()
        self._splitting: set[str] = set()  # parent ids with a split driving
        self.splits_done = 0  # observability / tests

    # -- automatic pass (called from the master's balancer loop) -------------
    def run_pass(self) -> None:
        size_thr = FLAGS.get("tablet_split_size_bytes")
        rate_thr = FLAGS.get("tablet_split_ops_per_sec")
        if not self.m.raft.leader_ready():
            return
        # Resume any split interrupted mid-protocol (master failover /
        # crashed pass): the lineage record is the durable to-do item.
        for rec in self.m.catalog.split_lineage():
            if rec["state"] == "SPLITTING":
                self._try_split(rec["parent"])
                return  # one split per pass
        if not size_thr and not rate_thr:
            return  # automatic splitting disabled
        for t in self.m.catalog.list_tables():
            for info in self.m.catalog.tablets_of(t.table_id):
                if info.partition_end - info.partition_start < 2:
                    continue  # single-hash range: nothing to split
                size, rate = self.m.ts_manager.tablet_load(info.tablet_id)
                if (size_thr and size >= size_thr) or \
                        (rate_thr and rate >= rate_thr):
                    self._try_split(info.tablet_id)
                    return  # one split per pass (bounded churn)

    def _try_split(self, tablet_id: str) -> None:
        try:
            self.split(tablet_id)
        except Exception as e:  # noqa: BLE001 — next pass retries
            count_swallowed("master.split_tablet", e)

    # -- the split state machine ---------------------------------------------
    def split(self, tablet_id: str, timeout: float = 30.0) -> dict:
        """Drive one tablet split end to end (synchronous). Safe to call
        again after a partial failure: every phase is idempotent and the
        lineage record carries the chosen children across retries."""
        with self._lock:
            if tablet_id in self._splitting:
                raise SplitError(f"split of {tablet_id} already running")
            self._splitting.add(tablet_id)
        try:
            return self._split_locked(tablet_id, timeout)
        finally:
            with self._lock:
                self._splitting.discard(tablet_id)

    def _split_locked(self, tablet_id: str, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        cat = self.m.catalog
        info = cat.tablets.get(tablet_id)
        if info is None:
            raise SplitError(f"tablet {tablet_id} not in catalog")
        table = cat.tables.get(info.table_id)
        if table is None:
            raise SplitError(f"table of {tablet_id} not in catalog")

        rec = cat.splits.get(tablet_id)
        if rec is None:
            # Phase 1: the parent leader's median resident key hash.
            resp = self._leader_rpc(tablet_id, info.replicas,
                                    "ts.get_split_key",
                                    {"tablet_id": tablet_id}, deadline)
            h = resp["split_hash"]
            if not (info.partition_start < h < info.partition_end):
                raise SplitError(
                    f"split hash {h} outside ({info.partition_start}, "
                    f"{info.partition_end})")
            # Phase 2: replicate children + lineage. Low child first so
            # the committed tablet_ids list stays partition-ordered.
            children = [
                {"tablet_id": f"{table.table_id}-s{uuid_mod.uuid4().hex[:8]}",
                 "partition_start": info.partition_start,
                 "partition_end": h,
                 "replicas": list(info.replicas)},
                {"tablet_id": f"{table.table_id}-s{uuid_mod.uuid4().hex[:8]}",
                 "partition_start": h,
                 "partition_end": info.partition_end,
                 "replicas": list(info.replicas)},
            ]
            self.m.raft.replicate("catalog", {
                "op": "split_tablet", "table_id": table.table_id,
                "tablet_id": tablet_id, "split_hash": h,
                "children": children})
            rec = cat.splits.get(tablet_id)
            if rec is None:
                raise SplitError(f"lineage for {tablet_id} did not apply")

        child_ids = list(rec["children"])
        child_infos = [cat.tablets[c] for c in child_ids]

        # Phase 3: empty child replicas on the parent's replica set.
        for ci in child_infos:
            for replica in ci.replicas:
                try:
                    resp = self.m.transport.send(
                        replica, "ts.create_tablet",
                        self.m._create_tablet_req(
                            ci.tablet_id, table.name, table.schema,
                            ci.partition_start, ci.partition_end,
                            table.engine, list(ci.replicas),
                            indexes=table.indexes),
                        timeout=5.0)
                    if resp.get("code") != "ok":
                        count_swallowed("master.split_create_child",
                                        resp.get("code"))
                except Exception as e:  # noqa: BLE001 — leader wait gates
                    count_swallowed("master.split_create_child", e)
        for ci in child_infos:
            self._wait_child_leader(ci.tablet_id, deadline)

        # Phase 4: seal the parent (idempotent on the peer).
        self._leader_rpc(tablet_id, info.replicas, "ts.split_seal",
                         {"tablet_id": tablet_id}, deadline)

        # Phase 5: fork the frozen rows per child range and seed each
        # child through its own leader.
        for ci in child_infos:
            fork = self._leader_rpc(
                tablet_id, info.replicas, "ts.split_fork",
                {"tablet_id": tablet_id, "lower": ci.partition_start,
                 "upper": ci.partition_end}, deadline)
            self._leader_rpc(
                ci.tablet_id, ci.replicas, "ts.split_seed",
                {"tablet_id": ci.tablet_id, "rows": fork["rows"]},
                deadline, timeout_each=30.0)

        # Phase 6: commit the swap; the parent leaves the serving list.
        self.m.raft.replicate("catalog", {
            "op": "split_commit", "table_id": table.table_id,
            "tablet_id": tablet_id, "children": child_ids})
        count_tablet_split()
        self.splits_done += 1
        self.m.ts_manager.forget_tablet(tablet_id)
        # Prompt tombstone; the heartbeat orphan-GC is the backstop.
        for replica in info.replicas:
            try:
                resp = self.m.transport.send(replica, "ts.delete_tablet",
                                             {"tablet_id": tablet_id},
                                             timeout=5.0)
                if resp.get("code") != "ok":
                    count_swallowed("master.split_delete_parent",
                                    resp.get("code"))
            except Exception as e:  # noqa: BLE001 — GC retries
                count_swallowed("master.split_delete_parent", e)
        return {"tablet_id": tablet_id, "split_hash": rec["split_hash"],
                "children": child_ids}

    # -- helpers -------------------------------------------------------------
    def _wait_child_leader(self, tablet_id: str, deadline: float) -> str:
        while time.monotonic() < deadline:
            leader = self.m.ts_manager.leader_of(tablet_id)
            if leader is not None:
                return leader
            time.sleep(0.05)
        raise SplitError(f"child {tablet_id} elected no leader in time")

    def _leader_rpc(self, tablet_id: str, replicas, method: str,
                    payload: dict, deadline: float,
                    timeout_each: float = 10.0) -> dict:
        """Send one RPC to the tablet's leader, following not_leader
        hints and re-resolving through heartbeats until the deadline."""
        last = "no attempt"
        while time.monotonic() < deadline:
            candidates = []
            hinted = self.m.ts_manager.leader_of(tablet_id)
            if hinted:
                candidates.append(hinted)
            candidates.extend(r for r in replicas if r not in candidates)
            for dst in candidates:
                try:
                    resp = self.m.transport.send(
                        dst, method, payload,
                        timeout=min(timeout_each,
                                    max(0.1, deadline - time.monotonic())))
                except Exception as e:  # noqa: BLE001 — try the next
                    last = str(e)
                    continue
                if resp.get("code") == "ok":
                    return resp
                last = f"{dst}: {resp.get('message', resp.get('code'))}"
                if resp.get("code") == "error":
                    # definitive refusal (e.g. no interior split point):
                    # retrying cannot help within this attempt
                    raise SplitError(
                        f"{method} on {tablet_id} failed: {last}")
                hint = resp.get("leader_hint")
                if hint and hint not in candidates:
                    candidates.append(hint)
            time.sleep(0.05)
        raise SplitError(f"{method} on {tablet_id} failed: {last}")
