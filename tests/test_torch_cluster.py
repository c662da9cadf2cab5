"""The port's cluster (``yugabyte_db_tpu_torch.integration.MiniCluster``:
the port's master, tablet servers and client) under the assertions of
the JAX package's ``tests/test_mini_cluster.py``: DDL, writes and reads
through the client, a tserver kill with failover and re-replication,
master failover, a full restart, the socket transport, and the repair of
a replica missing from a live tserver. The tablets run on the ``gpu``
engine over CPU tensors. The JAX file's two mesh tests (:266, :316) wait
for the mesh scans (ROADMAP.md §1 item 14).
"""

import time

import pytest

from test_torch_data import cpu_mini_cluster as MiniCluster
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema
from yugabyte_db_tpu_torch.storage.scan_spec import AggSpec, Predicate, ScanSpec


COLUMNS = [
    ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
    ColumnSchema("r", DataType.INT64, ColumnKind.RANGE),
    ColumnSchema("v", DataType.INT64),
    ColumnSchema("s", DataType.STRING),
]


def wait_for(pred, timeout=10.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def cluster(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    c.wait_tservers_registered()
    yield c
    c.shutdown()


def load_rows(client, table, n, start=0):
    session = client.session() if hasattr(client, "session") else None
    from yugabyte_db_tpu_torch.client import YBSession
    s = YBSession(client)
    for i in range(start, start + n):
        s.insert(table, {"k": f"key{i % 17}", "r": i, "v": i * 10,
                         "s": f"val-{i}"})
    return s.flush()


def test_ddl_write_read_roundtrip(cluster):
    client = cluster.client()
    table = client.create_table("kv", COLUMNS, num_tablets=4,
                                replication_factor=3)
    assert load_rows(client, table, 100) == 100
    from yugabyte_db_tpu_torch.client import YBSession
    s = YBSession(client)
    res = s.scan(table, ScanSpec())
    assert len(res.rows) == 100
    assert res.columns == ["k", "r", "v", "s"]
    # point get
    row = s.get(table, {"k": "key3", "r": 3})
    assert row == ("key3", 3, 30, "val-3")
    assert s.get(table, {"k": "nope", "r": 999}) is None
    # predicate + projection + limit
    res = s.scan(table, ScanSpec(predicates=[Predicate("v", ">=", 500)],
                                 projection=["r", "v"]))
    assert all(v >= 500 for _, v in res.rows)
    assert len(res.rows) == 50
    res = s.scan(table, ScanSpec(limit=7))
    assert len(res.rows) == 7
    # update + delete
    s.update(table, {"k": "key3", "r": 3}, {"v": -1})
    s.delete(table, {"k": "key4", "r": 4})
    s.flush()
    assert s.get(table, {"k": "key3", "r": 3})[2] == -1
    assert s.get(table, {"k": "key4", "r": 4}) is None
    assert len(s.scan(table, ScanSpec()).rows) == 99
    # tables listing
    assert [t["name"] for t in client.list_tables()] == ["kv"]


def test_multi_tablet_aggregates(cluster):
    client = cluster.client()
    table = client.create_table("agg", COLUMNS, num_tablets=4)
    load_rows(client, table, 200)
    from yugabyte_db_tpu_torch.client import YBSession
    s = YBSession(client)
    res = s.scan(table, ScanSpec(aggregates=[
        AggSpec("count", None), AggSpec("sum", "v"), AggSpec("min", "v"),
        AggSpec("max", "v"), AggSpec("avg", "v")]))
    count, total, vmin, vmax, avg = res.rows[0]
    assert count == 200
    assert total == sum(i * 10 for i in range(200))
    assert (vmin, vmax) == (0, 1990)
    assert avg == total / 200
    # group by
    res = s.scan(table, ScanSpec(aggregates=[AggSpec("count", None)],
                                 group_by=["k"]))
    assert sum(r[1] for r in res.rows) == 200
    assert len(res.rows) == 17


def test_tserver_kill_failover_and_rereplication(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=4).start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("ha", COLUMNS, num_tablets=2,
                                    replication_factor=3)
        load_rows(client, table, 30)
        # Find a tserver holding a replica and kill it.
        locs = client.meta_cache.locations("ha", refresh=True)
        victim = locs.tablets[0].replicas[0]
        c.stop_tserver(victim)
        # Writes and reads keep working through failover.
        from yugabyte_db_tpu_torch.client import YBSession
        s = YBSession(client)

        def can_write():
            try:
                load_rows(client, table, 10, start=1000)
                return True
            except Exception:
                return False
        wait_for(can_write, timeout=15.0, msg="writes after ts kill")
        assert len(s.scan(table, ScanSpec()).rows) == 40
        # Master re-replicates onto the spare tserver.
        def rereplicated():
            locs2 = client.meta_cache.locations("ha", refresh=True)
            return all(victim not in t.replicas and len(t.replicas) == 3
                       for t in locs2.tablets)
        wait_for(rereplicated, timeout=30.0, msg="re-replication")
    finally:
        c.shutdown()


def test_master_failover(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=3, num_tservers=3).start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("mf", COLUMNS, num_tablets=2)
        load_rows(client, table, 20)
        leader = c.leader_master()
        # Kill the master leader (unregister + shutdown).
        c.transport.unregister(leader.uuid)
        c.masters.pop(leader.uuid).shutdown()
        # A new master leader takes over with the full catalog; the client
        # can still resolve tables and write.
        def catalog_served():
            try:
                client.meta_cache.locations("mf", refresh=True)
                return True
            except Exception:
                return False
        wait_for(catalog_served, timeout=15.0, msg="new master serves catalog")
        load_rows(client, table, 20, start=100)
        from yugabyte_db_tpu_torch.client import YBSession
        s = YBSession(client)
        assert len(s.scan(table, ScanSpec()).rows) == 40
        # New DDL needs the new leader's soft TS registry, rebuilt from
        # heartbeats (the reference's master failover behaves the same).
        new_leader = c.leader_master()
        wait_for(lambda: len(new_leader.ts_manager.live_tservers()) >= 3,
                 timeout=15.0, msg="tservers re-register with new master")
        client.create_table("mf2", COLUMNS, num_tablets=1)
        assert {t["name"] for t in client.list_tables()} == {"mf", "mf2"}
    finally:
        c.shutdown()


def test_full_cluster_restart_preserves_data(tmp_path):
    c = MiniCluster(str(tmp_path) + "/a", num_masters=1, num_tservers=3)
    c.start()
    c.wait_tservers_registered()
    client = c.client()
    table = client.create_table("persist", COLUMNS, num_tablets=2)
    load_rows(client, table, 50)
    c.shutdown()

    c2 = MiniCluster(str(tmp_path) + "/a", num_masters=1, num_tservers=3)
    c2.start()
    try:
        c2.wait_tservers_registered()
        client2 = c2.client()
        table2 = client2.open_table("persist")
        from yugabyte_db_tpu_torch.client import YBSession
        s = YBSession(client2)

        def all_rows():
            try:
                return len(s.scan(table2, ScanSpec()).rows) == 50
            except Exception:
                return False
        wait_for(all_rows, timeout=15.0, msg="data after full restart")
    finally:
        c2.shutdown()


def test_socket_transport_cluster(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3,
                    transport="socket").start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("sock", COLUMNS, num_tablets=2)
        load_rows(client, table, 25)
        from yugabyte_db_tpu_torch.client import YBSession
        s = YBSession(client)
        res = s.scan(table, ScanSpec(aggregates=[AggSpec("count", None),
                                                 AggSpec("sum", "v")]))
        assert res.rows[0][0] == 25
    finally:
        c.shutdown()


def test_live_missing_replica_repaired_without_failed_creates(tmp_path):
    """A replica missing from a live tserver (e.g. the create dispatch was
    lost together with the master's in-memory _failed_creates on restart)
    is repaired through the config-cycle path: the master removes it from
    the group, re-creates it, and adds it back."""
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("fix", COLUMNS, num_tablets=1,
                                    replication_factor=3)
        load_rows(client, table, 30)
        locs = client.meta_cache.locations("fix", refresh=True)
        tinfo = locs.tablets[0]
        master = next(iter(c.masters.values()))
        leader = master.ts_manager.leader_of(tinfo.tablet_id)
        victim = next(r for r in tinfo.replicas if r != leader)
        # Simulate "create never happened / data lost" on a live tserver,
        # with no in-memory record of the failure.
        c.tservers[victim].tablet_manager.delete_tablet(tinfo.tablet_id)
        master._failed_creates.clear()
        master.missing_replica_grace_s = 1.0

        def repaired():
            ts = c.tservers[victim]
            try:
                peer = ts.tablet_manager.get(tinfo.tablet_id)
            except Exception:
                return False
            st = peer.raft.stats()
            return st["commit_index"] > 0 and \
                set(st.get("peers", tinfo.replicas)) == set(tinfo.replicas)
        wait_for(repaired, timeout=30.0, msg="config-cycle repair")
        # Data still fully readable.
        from yugabyte_db_tpu_torch.client import YBSession
        s = YBSession(client)
        assert len(s.scan(table, ScanSpec()).rows) == 30
    finally:
        c.shutdown()
