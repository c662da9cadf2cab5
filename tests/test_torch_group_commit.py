"""The port's write-path pipeline: group commit, ack-at-commit with
pipelined apply, and the append->apply backpressure window.

Mirrors of the 4 tests of ``tests/test_group_commit.py`` (:121-202) on a
port group: three ``TabletPeer``s of the port over its
``LocalTransport``, each tablet on the ``gpu`` engine over CPU tensors,
against the port's flags (``raft_group_commit_window_us``,
``raft_max_inflight_ops``, ``fault.raft_apply_stall``) and metrics
(``yb_group_commit_batch_size`` in ``BATCH_SIZE_BUCKETS``,
``yb_faults_fired``). ``Group.leader`` also waits for the leader's own
no_op to apply (``leader_ready``), which a write needs.
"""

from __future__ import annotations

import threading
import time

import pytest

from yugabyte_db_tpu_torch.consensus import LocalTransport, RaftOptions
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.partition import compute_hash_code
from yugabyte_db_tpu_torch.models.schema import (ColumnKind, ColumnSchema,
                                                 Schema)
from yugabyte_db_tpu_torch.storage import RowVersion, ScanSpec
from yugabyte_db_tpu_torch.tablet import TabletMetadata, TabletPeer
from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.metrics import (BATCH_SIZE_BUCKETS,
                                                 _write_path_entity,
                                                 faults_fired)

FAST = RaftOptions(election_timeout_s=0.15, heartbeat_interval_s=0.03,
                   lease_s=0.4, rpc_timeout_s=0.5)


def make_schema():
    return Schema([
        ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
        ColumnSchema("v", DataType.INT64),
    ], table_id="t")


def enc(schema, k):
    return schema.encode_primary_key({"k": k},
                                     compute_hash_code(schema, {"k": k}))


def wait_for(pred, timeout=5.0, interval=0.01, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


class Group:
    """A 3-replica raft group of the port over a LocalTransport, its
    tablets on the ``gpu`` engine over CPU tensors."""

    def __init__(self, tmp_path, n=3):
        self.schema = make_schema()
        self.transport = LocalTransport()
        self.tmp_path = tmp_path
        self.nodes = [f"node-{i}" for i in range(n)]
        self.peers = {}
        for uuid in self.nodes:
            meta = TabletMetadata("tablet-1", "t", self.schema, 0, 65536)
            peer = TabletPeer(uuid, meta, str(tmp_path / uuid),
                              self.transport.bind(uuid), self.nodes,
                              fsync=False, raft_opts=FAST,
                              engine_options={"device": "cpu"})
            self.transport.register(
                uuid, lambda m, p, _pr=peer: _pr.raft.handle(m, p))
            self.peers[uuid] = peer
            peer.start()

    def leader(self):
        return wait_for(
            lambda: next((p for p in self.peers.values()
                          if p.raft.is_leader() and p.raft.has_lease()
                          and p.raft.leader_ready()),
                         None),
            msg="leader election")

    def shutdown(self):
        for p in self.peers.values():
            p.shutdown()

    def row(self, k, v):
        cid = {c.name: c.col_id for c in self.schema.columns}
        return RowVersion(enc(self.schema, k), ht=0, liveness=True,
                          columns={cid["v"]: v})

    def read_all(self, peer):
        res = peer.scan(ScanSpec(read_ht=peer.tablet.clock.now().value),
                        allow_stale=True)
        return sorted(res.rows)


@pytest.fixture
def group(tmp_path):
    g = Group(tmp_path)
    yield g
    g.shutdown()


@pytest.fixture
def apply_stall():
    """Arm/disarm the --fault.raft_apply_stall apply-stage stall."""
    yield lambda on: FLAGS.set("fault.raft_apply_stall",
                               1.0 if on else 0.0, force=True)
    FLAGS.set("fault.raft_apply_stall", 0.0, force=True)


@pytest.fixture
def inflight_flag():
    old = FLAGS.get("raft_max_inflight_ops")
    yield lambda v: FLAGS.set("raft_max_inflight_ops", int(v))
    FLAGS.set("raft_max_inflight_ops", old)


@pytest.fixture
def window_flag():
    old = FLAGS.get("raft_group_commit_window_us")
    yield lambda v: FLAGS.set("raft_group_commit_window_us", int(v))
    FLAGS.set("raft_group_commit_window_us", old)


def test_ack_at_commit_precedes_apply(group, apply_stall):
    """A write acks once COMMITTED; the apply stage may lag behind it
    (pipelined apply) and drains without further traffic once the stall
    clears."""
    leader = group.leader()
    leader.write([group.row("warm", 0)])
    base = faults_fired("fault.raft_apply_stall")
    apply_stall(True)
    try:
        leader.write([group.row("a", 1)], timeout=5.0)  # returns at commit
        s = leader.raft.stats()
        assert s["commit_index"] > s["applied_index"]
        assert faults_fired("fault.raft_apply_stall") > base
    finally:
        apply_stall(False)
    wait_for(lambda: leader.raft.stats()["commit_index"]
             == leader.raft.stats()["applied_index"],
             msg="apply drain after stall clears")
    assert len(group.read_all(leader)) == 2


def test_backpressure_bounds_apply_window(group, apply_stall,
                                          inflight_flag):
    """With apply stalled, admission blocks once last_index -
    applied_index reaches --raft_max_inflight_ops, and recovers when
    the queue drains."""
    leader = group.leader()
    leader.write([group.row("warm", 0)])
    wait_for(lambda: leader.raft.stats()["commit_index"]
             == leader.raft.stats()["applied_index"], msg="warm apply")
    inflight_flag(4)
    apply_stall(True)
    try:
        for i in range(4):
            leader.write([group.row(f"fill{i}", i)], timeout=5.0)
        with pytest.raises(TimeoutError, match="backpressure"):
            leader.write([group.row("overflow", 9)], timeout=0.5)
    finally:
        apply_stall(False)
    wait_for(lambda: leader.raft.stats()["commit_index"]
             == leader.raft.stats()["applied_index"], msg="drain")
    leader.write([group.row("after", 10)], timeout=5.0)
    assert len(group.read_all(leader)) == 6  # overflow write never landed


def test_concurrent_writes_share_commit_rounds(group, window_flag):
    """Concurrent writers inside one group-commit window coalesce into
    shared WAL-sync + AppendEntries rounds: the batch-size histogram
    must record rounds with more than one entry."""
    window_flag(5000)
    leader = group.leader()
    h = _write_path_entity().histogram("yb_group_commit_batch_size",
                                       buckets=BATCH_SIZE_BUCKETS)
    before = list(h.counts)

    errors = []

    def writer(t):
        try:
            for i in range(10):
                leader.write([group.row(f"k{t}-{i}", i)], timeout=10.0)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    delta = [a - b for a, b in zip(h.counts, before)]
    # Bucket 0 holds batch==1 rounds; anything beyond it coalesced.
    assert sum(delta[1:]) > 0, f"no multi-entry commit round: {delta}"
    assert len(group.read_all(leader)) == 80
    for p in group.peers.values():
        wait_for(lambda p=p: p.raft.stats()["applied_index"]
                 >= leader.raft.stats()["applied_index"],
                 msg="replica catchup")
        assert group.read_all(p) == group.read_all(leader)


def test_window_zero_restores_inline_signaling(group, window_flag):
    """--raft_group_commit_window_us=0 keeps the pre-pipeline behaviour:
    every append signals peers immediately and everything still
    replicates/applies."""
    window_flag(0)
    leader = group.leader()
    for i in range(20):
        leader.write([group.row(f"k{i}", i)])
    want = group.read_all(leader)
    assert len(want) == 20
    for p in group.peers.values():
        wait_for(lambda p=p: p.raft.stats()["applied_index"]
                 >= leader.raft.stats()["applied_index"],
                 msg="replica catchup")
        assert group.read_all(p) == want
