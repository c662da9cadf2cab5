"""Log-cache eviction, remote bootstrap and exactly-once retries on the
port's cluster, under the assertions of the JAX package's
``tests/test_bootstrap_retry.py`` in their ``MiniCluster`` forms
(``tests/test_torch_tserver.py`` holds their RPC-level forms), and the
``MiniCluster`` forms of ``tests/test_rpc.py:142`` (a Raft group over
sockets) and ``tests/test_fs_identity_deploy.py:31`` (daemons refuse a
foreign data directory). The tablets run on the ``gpu`` engine over CPU
tensors.
"""

import time

import pytest

from test_torch_data import cpu_mini_cluster as MiniCluster
from yugabyte_db_tpu_torch.client import YBSession
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema
from yugabyte_db_tpu_torch.storage import wire
from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.storage.scan_spec import ScanSpec
from yugabyte_db_tpu_torch.utils.fault_injection import arm_fault_once
from yugabyte_db_tpu_torch.utils.metrics import faults_fired

COLUMNS = [
    ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
    ColumnSchema("v", DataType.INT64),
]


def wait_for(pred, timeout=30.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r = pred()
        if r:
            return r
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def test_exactly_once_duplicate_write(tmp_path):
    """The same (client_id, request_id) applied twice writes ONCE and the
    duplicate returns the original hybrid time."""
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("once", COLUMNS, num_tablets=1)
        loc = client.meta_cache.locations("once").tablets[0]
        rows = [{"k": "dup", "v": 1}]
        enc = wire.encode_rows([
            __import__("yugabyte_db_tpu_torch.storage.row_version",
                       fromlist=["RowVersion"]).RowVersion(
                table.encode_key({"k": "dup"}), ht=0, liveness=True,
                columns={table.col_id["v"]: 1})])
        payload = {"rows": enc, "client_id": client.client_id,
                   "request_id": 7}
        r1 = client.tablet_rpc("once", loc, "ts.write", dict(payload))
        r2 = client.tablet_rpc("once", loc, "ts.write", dict(payload))
        assert r1["ht"] == r2["ht"], "duplicate must return original ht"
        # exactly one version of the row exists on the leader
        ts = next(ts for ts in c.tservers.values()
                  if any(p.tablet_id == loc.tablet_id and p.is_leader()
                         for p in ts.tablet_manager.peers()))
        peer = ts.tablet_manager.get(loc.tablet_id)
        versions = peer.tablet.engine.memtable.versions(
            table.encode_key({"k": "dup"}))
        assert len(list(versions)) == 1
        # dedup state survives flush + restart replay
        peer.flush()
        assert peer.tablet.retryable.seen(client.client_id, 7) == r1["ht"]
    finally:
        c.shutdown()


def test_log_cache_eviction_bounded(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("ev", COLUMNS, num_tablets=1)
        s = YBSession(client)
        for i in range(300):
            s.insert(table, {"k": f"x{i}", "v": i})
            if i % 50 == 49:
                s.flush()
        s.flush()
        loc = client.meta_cache.locations("ev").tablets[0]
        for ts in c.tservers.values():
            try:
                peer = ts.tablet_manager.get(loc.tablet_id)
            except Exception:
                continue
            before = len(peer.raft._entries)
            peer.flush()
            after = len(peer.raft._entries)
            assert after <= before
            assert after < 250, f"cache not bounded: {after}"
        # reads still correct after eviction
        res = s.scan(table, ScanSpec(projection=["k", "v"]))
        assert len(res.rows) == 300
    finally:
        c.shutdown()


def test_remote_bootstrap_after_log_gc(tmp_path):
    """Kill a replica, write + flush past log GC on the survivors,
    restart it: it must catch up via remote bootstrap (install), not log
    replay, and serve identical data."""
    c = MiniCluster(str(tmp_path) + "/rb", num_masters=1,
                    num_tservers=3)
    c.start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("rb", COLUMNS, num_tablets=1)
        s = YBSession(client)
        for i in range(50):
            s.insert(table, {"k": f"a{i}", "v": i})
        s.flush()
        loc = client.meta_cache.locations("rb", refresh=True).tablets[0]
        leader = next(
            ts.uuid for ts in c.tservers.values()
            if any(p.tablet_id == loc.tablet_id and p.is_leader()
                   for p in ts.tablet_manager.peers()))
        victim = next(r for r in loc.replicas if r != leader)
        c.stop_tserver(victim)

        # Many separate write BATCHES (one raft entry each) so the
        # victim's position falls far below the eviction floor — normal
        # cached catch-up must be impossible, only bootstrap can work.
        def write_batch(start):
            for i in range(start, start + 5):
                s.insert(table, {"k": f"b{i}", "v": i})
            s.flush()
        wait_for(lambda: _try(write_batch, 0), msg="writes after kill")
        for r in range(1, 30):
            write_batch(r * 5)
        for ts in c.tservers.values():
            for p in ts.tablet_manager.peers():
                if p.tablet_id == loc.tablet_id:
                    p.flush()
                    assert min(p.raft._entries, default=10**9) > 3

        c.start_tserver(victim)

        def caught_up():
            try:
                ts = c.tservers[victim]
                peer = ts.tablet_manager.get(loc.tablet_id)
            except Exception:
                return False
            if ts.tablet_manager.bootstrap_installs < 1:
                return False
            st = peer.raft.stats()
            leaders = [p for t2 in c.tservers.values()
                       for p in t2.tablet_manager.peers()
                       if p.tablet_id == loc.tablet_id and p.is_leader()]
            if not leaders:
                return False
            return st["applied_index"] >= \
                leaders[0].raft.stats()["commit_index"] - 1
        wait_for(caught_up, timeout=60.0, msg="remote bootstrap catch-up")

        # The re-seeded replica holds the full data set.
        ts = c.tservers[victim]
        peer = ts.tablet_manager.get(loc.tablet_id)
        res = peer.tablet.engine.scan(ScanSpec(projection=["k"]))
        assert len(res.rows) == 200  # 50 a-keys + 150 b-keys
    finally:
        c.shutdown()


def _try(fn, *args):
    try:
        fn(*args)
        return True
    except Exception:
        return False


def test_crash_recovery_replays_wal_and_dedups_retries(tmp_path):
    """WAL sync fault mid-workload, then crash-restart the leader: the
    tablet must come back via bootstrap WAL replay with every acked row,
    and a re-sent (client_id, request_id) write must dedup to the
    ORIGINAL hybrid time — RetryableRequests state is rebuilt by replay,
    so a client retrying across the crash still gets exactly-once."""
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("cr", COLUMNS, num_tablets=1)
        s = YBSession(client)
        for i in range(30):
            s.insert(table, {"k": f"a{i}", "v": i})
        s.flush()

        # Mid-workload: the next WAL sync fails. On the leader raft
        # swallows it (the majority acks via follower appends), so the
        # writes below must still be acked and durable cluster-wide.
        fired0 = faults_fired("fault.wal_sync_failed")
        arm_fault_once("fault.wal_sync_failed")
        for i in range(30, 60):
            s.insert(table, {"k": f"a{i}", "v": i})
        s.flush()
        assert faults_fired("fault.wal_sync_failed") == fired0 + 1

        # One write with an explicit request id (the retry-dedup probe).
        loc = client.meta_cache.locations("cr", refresh=True).tablets[0]
        enc = wire.encode_rows([RowVersion(
            table.encode_key({"k": "dup"}), ht=0, liveness=True,
            columns={table.col_id["v"]: 999})])
        payload = {"rows": enc, "client_id": client.client_id,
                   "request_id": 4242}
        r1 = client.tablet_rpc("cr", loc, "ts.write", dict(payload))
        assert r1["code"] == "ok"

        # Crash-restart the leader.
        leader = next(
            ts.uuid for ts in c.tservers.values()
            if any(p.tablet_id == loc.tablet_id and p.is_leader()
                   for p in ts.tablet_manager.peers()))
        c.stop_tserver(leader)
        c.start_tserver(leader)

        # The restarted replica replays its WAL: all 61 acked rows back.
        def replayed():
            try:
                peer = c.tservers[leader].tablet_manager.get(loc.tablet_id)
                res = peer.tablet.engine.scan(ScanSpec(projection=["k"]))
            except Exception:
                return False
            return len(res.rows) == 61
        wait_for(replayed, timeout=60.0, msg="bootstrap WAL replay")

        # The client's RETRY of the same request (same client_id +
        # request_id, re-sent because the crash made the first ack
        # uncertain from its point of view) must be absorbed by dedup.
        loc = client.meta_cache.locations("cr", refresh=True).tablets[0]
        r2 = client.tablet_rpc("cr", loc, "ts.write", dict(payload))
        assert r2["code"] == "ok"
        assert r2["ht"] == r1["ht"], \
            "replayed RetryableRequests must return the original ht"

        # And the cluster still serves every acked row exactly once.
        res = s.scan(table, ScanSpec(projection=["k", "v"]))
        assert len(res.rows) == 61
        assert sum(1 for row in res.rows if row[0] == "dup") == 1
    finally:
        c.shutdown()


def test_raft_group_over_sockets(tmp_path):
    """``tests/test_rpc.py:142`` in its ``MiniCluster`` form: an RF-3
    tablet over the socket transport, written through the client; every
    replica converges on the last value."""
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3,
                    transport="socket").start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("sock", COLUMNS, num_tablets=1,
                                    replication_factor=3)
        s = YBSession(client)
        for i in range(10):
            s.insert(table, {"k": "sock", "v": i})
            s.flush()
        loc = client.meta_cache.locations("sock", refresh=True).tablets[0]
        peers = [ts.tablet_manager.get(loc.tablet_id)
                 for ts in c.tservers.values()]
        leader = wait_for(lambda: next((p for p in peers if p.is_leader()),
                                       None), msg="a leader")
        target = leader.raft.stats()["applied_index"]
        wait_for(lambda: all(p.raft.stats()["applied_index"] >= target
                             for p in peers), msg="every replica applied")
        for p in peers:
            res = p.scan(ScanSpec(read_ht=p.tablet.clock.now().value),
                         allow_stale=True)
            assert res.rows == [("sock", 9)], (p.node_uuid, res.rows)
    finally:
        c.shutdown()


def test_daemons_refuse_foreign_data_dir(tmp_path):
    """``tests/test_fs_identity_deploy.py:31`` in its ``MiniCluster``
    form: a tablet server or a master started on a data directory that
    another daemon of the cluster formatted refuses it."""
    from yugabyte_db_tpu_torch import fs as yfs
    from yugabyte_db_tpu_torch.consensus.transport import LocalTransport
    from yugabyte_db_tpu_torch.master.master import Master
    from yugabyte_db_tpu_torch.tserver.tablet_server import TabletServer

    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=1).start()
    try:
        with pytest.raises(yfs.FsMismatch):
            TabletServer("ts-b", str(tmp_path / "ts-0"), LocalTransport(),
                         ["m-0"], fsync=False)
        with pytest.raises(yfs.FsMismatch):
            Master("m-b", str(tmp_path / "m-0"), LocalTransport(), ["m-b"],
                   fsync=False)
        assert c.tservers["ts-0"].instance["server_uuid"] == "ts-0"
        assert c.masters["m-0"].instance["server_uuid"] == "m-0"
    finally:
        c.shutdown()
